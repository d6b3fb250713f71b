"""Query-by-Sketch in PyTorch for one NVIDIA Hopper GPU.

The port of the JAX package ``repro``: the same modules under the same
names, bit-identical answers, and the reference's Pallas TPU kernels on the
serving path rewritten as hand-written CUDA kernels (``kernels``).  Every
entry point puts its tensors on the CUDA card unless the caller passes
``device="cpu"``, which runs each kernel's plain PyTorch version.  The LM
substrate (``models``, ``configs``; serving: the prefill/decode steps and
``greedy_generate`` in ``serving``; training: ``training``, ``data``,
``checkpoint``, ``distributed`` and ``launch.train``) runs on torch ops and
cuBLAS; its production-mesh dry run (``launch.dryrun``) traces every cell
on the meta device and needs no card.

    from repro_torch.core import QbSIndex, barabasi_albert_graph
    g = barabasi_albert_graph(100_000, 3, seed=0)
    index = QbSIndex.build(g, n_landmarks=20, backend="hybrid")
    results = index.query_batch(us, vs)

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving import greedy_generate
    model = build_model(get_config("qwen1.5-4b"))     # random weights, seed 0
    tokens = greedy_generate(model, prompt_tokens, n_new=32)

    from repro_torch.training import adamw, make_train_step, warmup_cosine
    opt = adamw(warmup_cosine(3e-4, 100, 1000))
    opt_state = opt.init(dict(model.named_parameters()))
    step = make_train_step(model, opt)
    model, opt_state, metrics = step(model, opt_state, {"tokens": tokens})
"""
from . import checkpoint, configs, core, data, distributed, kernels, models, serving, training

__all__ = ["checkpoint", "configs", "core", "data", "distributed", "kernels", "models",
           "serving", "training"]
