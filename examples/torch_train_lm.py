"""End-to-end training on the PyTorch/CUDA port (the twin of
``examples/train_lm.py``): a dense LM for a few hundred steps on the
deterministic synthetic stream, with checkpointing and restore.
(A tiny config by default; pass --full-ish for the ~100M-parameter one.)

  PYTHONPATH=src python examples/torch_train_lm.py [--steps 300] [--full-ish]
  PYTHONPATH=src python examples/torch_train_lm.py --device cpu    # plain torch
"""
import argparse
import tempfile
import time
from dataclasses import replace

import torch

from repro_torch import checkpoint as ckpt
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLM, SyntheticLMConfig
from repro_torch.launch.train import to_device
from repro_torch.models import build_model
from repro_torch.training import adamw, make_train_step, warmup_cosine

ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
ap.add_argument("--steps", type=int, default=200)
ap.add_argument("--full-ish", action="store_true",
                help="~100M params (slow on CPU; default is a tiny config)")
ap.add_argument("--device", default=None, help="cpu, or a CUDA device (default: the card)")
args = ap.parse_args()

cfg = get_config("deepseek-7b")
if args.full_ish:
    cfg = replace(cfg, n_layers=10, d_model=768, n_heads=12, n_kv_heads=12,
                  d_ff=2048, vocab_size=32_000)   # ~0.1B params
    seq, batch = 256, 8
else:
    cfg = cfg.reduced()
    seq, batch = 64, 8

model = build_model(cfg, device=args.device)       # weights from seed 0
n = sum(p.numel() for p in model.parameters())
print(f"model: {cfg.name}-derived, {n / 1e6:.1f}M params on {model.device}")

opt = adamw(warmup_cosine(3e-3, 20, args.steps))
opt_state = opt.init(dict(model.named_parameters()))
data = SyntheticLM(SyntheticLMConfig(cfg.vocab_size, seq, batch, seed=0))
step_fn = make_train_step(model, opt)

ckpt_dir = tempfile.mkdtemp(prefix="repro_torch_ckpt_")
t0 = time.time()
for step in range(args.steps):
    model, opt_state, metrics = step_fn(model, opt_state,
                                        to_device(data.batch_at(step), model.device))
    if (step + 1) % 20 == 0:
        print(f"step {step + 1:4d} loss={float(metrics['loss']):.4f} "
              f"({(time.time() - t0) / (step + 1) * 1e3:.0f} ms/step)")
    if (step + 1) % 100 == 0:
        ckpt.save(ckpt_dir, step + 1, {"params": model.state_dict(), "opt": opt_state},
                  extra={"data_step": step + 1})

print(f"final loss {float(metrics['loss']):.4f}; checkpoints in {ckpt_dir}")
s, tree, extra = ckpt.restore(ckpt_dir, {"params": model.state_dict(), "opt": opt_state})
same = all(torch.equal(tree["params"][k], v) for k, v in model.state_dict().items())
print(f"restore check: step {s} {'OK' if same else 'MISMATCH'}")
