"""Batched LM serving on the PyTorch/CUDA port (the twin of
``examples/serve_decode.py``): prefill a prompt batch, then greedy-decode
continuation tokens with bf16-layout and int8-quantized KV caches.

  PYTHONPATH=src python examples/torch_serve_decode.py                # the CUDA card
  PYTHONPATH=src python examples/torch_serve_decode.py --device cpu   # plain torch
"""
import argparse
import time

import numpy as np

from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.serving import greedy_generate

ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
ap.add_argument("--device", default=None, help="cpu, or a CUDA device (default: the card)")
ap.add_argument("--arch", default="phi3-medium-14b")
args = ap.parse_args()

cfg = get_config(args.arch).reduced()
model = build_model(cfg, device=args.device)       # weights from seed 0

rng = np.random.default_rng(0)
prompts = rng.integers(0, cfg.vocab_size, (4, 32)).astype(np.int32)

t0 = time.time()
out_bf16 = greedy_generate(model, prompts, n_new=16)
t1 = time.time()
out_int8 = greedy_generate(model, prompts, n_new=16, kv_quant=True)
t2 = time.time()

print(f"bf16 KV: {tuple(out_bf16.shape)} in {t1 - t0:.2f}s on {model.device}")
print(f"int8 KV: {tuple(out_int8.shape)} in {t2 - t1:.2f}s")
agree = float((out_bf16 == out_int8).float().mean())
print(f"greedy-token agreement bf16 vs int8 KV: {agree * 100:.0f}% "
      "(random-weight model; production models agree far more)")
print("sample continuation (bf16):", out_bf16[0].tolist())
