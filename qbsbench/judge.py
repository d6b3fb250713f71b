"""The comparison that decides ``correct``: every answer the window
produced against the plain reference (``reference.spg``).

An answer is ``(u, v, dist, edge_ids)``; ``dist`` ``None`` means the
request never got one.  The served interface gives ``1 << 20`` as the
distance of a pair with no path, and the edge slots of a pair's
shortest-path graph as a sorted array.  Each number compared is a count of
answers, and its limit is 0: the answers are exact by the configuration's
guarantee.
"""
from __future__ import annotations

from collections import defaultdict

import numpy as np

from .reference import UNREACHED, RefGraph, answer_pairs

NO_PATH = 1 << 20
LIMITS = {"missing": 0, "wrong_dist": 0, "wrong_edges": 0}


def judge(edges: np.ndarray, n_vertices: int, answers, device="cpu") -> dict:
    """Counts of ``missing`` answers, answers with a ``wrong_dist`` and
    answers with ``wrong_edges``, and the number ``checked``."""
    by_key: dict[tuple[int, int], list[int]] = defaultdict(list)
    missing = 0
    for i, (u, v, dist, _) in enumerate(answers):
        if dist is None:
            missing += 1
        else:
            by_key[(min(u, v), max(u, v))].append(i)
    keys = list(by_key)
    us = np.fromiter((k[0] for k in keys), np.int64, len(keys))
    vs = np.fromiter((k[1] for k in keys), np.int64, len(keys))
    wrong_dist = wrong_edges = 0
    if keys:
        g = RefGraph(edges, n_vertices, device)
        for j, d, slots in answer_pairs(g, us, vs):
            want = NO_PATH if d == UNREACHED else d
            for i in by_key[keys[j]]:
                _, _, dist, eids = answers[i]
                wrong_dist += int(dist) != want
                wrong_edges += not np.array_equal(np.asarray(eids), slots)
    return {"checked": len(answers) - missing, "missing": missing,
            "wrong_dist": wrong_dist, "wrong_edges": wrong_edges}


def verdict(counts: dict) -> tuple[bool, dict]:
    """``(correct, {name: {"value": n, "limit": limit}})``."""
    checks = {k: {"value": int(counts[k]), "limit": lim} for k, lim in LIMITS.items()}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks
