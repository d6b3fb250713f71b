"""The plain reference of the benchmark: exact shortest-path graphs by BFS
from the edge list (``spg``).  It imports nothing of the program."""
from .spg import UNREACHED, RefGraph, answer_pairs

__all__ = ["UNREACHED", "RefGraph", "answer_pairs"]
