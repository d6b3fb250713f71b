"""Query-by-Sketch in PyTorch for one NVIDIA Hopper GPU.

The port of the JAX package ``repro``: the same modules under the same
names, bit-identical answers, and the reference's Pallas TPU kernels on the
serving path rewritten as hand-written CUDA kernels (``kernels``).  Every
entry point puts its tensors on the CUDA card unless the caller passes
``device="cpu"``, which runs each kernel's plain PyTorch version.

    from repro_torch.core import QbSIndex, barabasi_albert_graph
    g = barabasi_albert_graph(100_000, 3, seed=0)
    index = QbSIndex.build(g, n_landmarks=20, backend="hybrid")
    results = index.query_batch(us, vs)
"""
from . import core, kernels, serving

__all__ = ["core", "kernels", "serving"]
