"""End-to-end training driver.  Counterpart of ``repro.launch.train``, with
the same flags, data, checkpoint/resume and printed lines, plus
``--device``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-4b \\
      --reduced --steps 200 --ckpt-dir /tmp/run1 [--resume]     # on the card
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-4b \\
      --reduced --steps 12 --device cpu

Features: deterministic sharded data (a prefetch thread), checkpoint/resume
(preemption-safe), async checkpoint writes, gradient accumulation, bf16
gradient compression.  Weights are drawn from ``--seed`` on the device.
"""
from __future__ import annotations

import argparse
import time

import torch

from .. import checkpoint as ckpt
from ..configs import get_config
from ..core.graph import resolve_device
from ..data import Prefetcher, SyntheticLM, SyntheticLMConfig
from ..models import build_model
from ..training import adamw, compress_bf16, make_train_step, warmup_cosine


def to_device(batch: dict, dev: torch.device) -> dict:
    """A numpy batch as tensors on ``dev`` (through pinned host memory and
    asynchronous copies toward a card)."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(v)
        if dev.type == "cuda":
            t = t.pin_memory()
        out[k] = t.to(dev, non_blocking=True)
    return out


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the CUDA card; 'cpu' trains "
                         "on the host)")
    args = ap.parse_args(argv)

    dev = resolve_device(None if args.device == "cuda" else args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(args.seed))
    opt = adamw(warmup_cosine(args.lr, max(args.steps // 20, 5), args.steps))
    opt_state = opt.init(dict(model.named_parameters()))
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[train] arch={cfg.name} params={n_params/1e6:.1f}M device={dev}")

    data_cfg = SyntheticLMConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq_len,
        global_batch=args.global_batch, seed=args.seed,
        frontend=cfg.frontend, frontend_dim=cfg.frontend_dim,
    )
    start_step = 0
    if args.resume and args.ckpt_dir and ckpt.latest_step(args.ckpt_dir) is not None:
        start_step, tree, extra = ckpt.restore(
            args.ckpt_dir, {"params": model.state_dict(), "opt": opt_state})
        model.load_state_dict(tree["params"])
        opt_state = tree["opt"]
        print(f"[train] resumed from step {start_step}")

    source = SyntheticLM(data_cfg)
    pf = Prefetcher(source, start_step=start_step, depth=2)
    step_fn = make_train_step(
        model, opt, microbatches=args.microbatches, remat=args.remat,
        compress=compress_bf16 if args.compress_grads else None)

    pending = None
    t0 = time.perf_counter()
    try:
        for step in range(start_step, args.steps):
            got_step, batch = pf.next()
            if got_step != step:
                raise RuntimeError(f"the prefetcher gave step {got_step} for {step}")
            model, opt_state, metrics = step_fn(model, opt_state, to_device(batch, dev))
            if (step + 1) % args.log_every == 0 or step == start_step:
                dt = (time.perf_counter() - t0) / max(step - start_step + 1, 1)
                print(f"[train] step {step + 1} loss={float(metrics['loss']):.4f} "
                      f"gnorm={float(metrics['grad_norm']):.3f} "
                      f"lr={float(metrics['lr']):.2e} {dt * 1e3:.0f} ms/step",
                      flush=True)
            if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
                if pending is not None:
                    pending.join()
                pending = ckpt.save_async(
                    args.ckpt_dir, step + 1,
                    {"params": model.state_dict(), "opt": opt_state},
                    extra={"data_step": step + 1})
    finally:
        pf.close()
        if pending is not None:
            pending.join()
    if args.ckpt_dir:
        ckpt.save(args.ckpt_dir, args.steps,
                  {"params": model.state_dict(), "opt": opt_state},
                  extra={"data_step": args.steps})
    print("[train] done")


if __name__ == "__main__":
    main()
