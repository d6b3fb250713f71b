"""Checkpoint/restart with atomic rotation and async writes, for the
port's trees.  Counterpart of ``repro.checkpoint.checkpoint``, with its
protocol:

Layout:  <root>/step_<N>/   leaf files  arr_<k>.npy  +  manifest.json
         <root>/LATEST      (atomic pointer, written last)

A checkpoint is staged under ``<root>/.tmp_step_<N>`` and ``os.rename``d
into place (POSIX-atomic), then LATEST is rewritten, so a killed writer
never leaves a half checkpoint that ``restore`` would pick up.  The
manifest holds the step, the leaf count, each leaf's key path and dtype,
and the caller's ``extra``; bfloat16 leaves are stored as float32 (exact)
and restored bit for bit.

A tree is nested dicts of tensors, for example ``{"params":
model.state_dict(), "opt": opt_state}``, flattened in sorted-key order
(the order ``jax.tree_util`` gives a dict).  The files are not the
reference's: reading its checkpoints is not a goal.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch


def _flatten(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    if isinstance(tree, Mapping):
        out = []
        for k in sorted(tree):
            out += _flatten(tree[k], f"{prefix}{k}/")
        return out
    return [(prefix.rstrip("/"), tree)]


def _unflatten(tree: Any, leaves: list) -> Any:
    """``leaves`` (in ``_flatten`` order) in the structure of ``tree``."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, Mapping):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)
    return build(tree)


def _host(leaf) -> torch.Tensor:
    """A CPU copy of a leaf that later in-place writes cannot reach."""
    return torch.as_tensor(leaf).detach().to("cpu", copy=True)


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def save(root: str | Path, step: int, tree: Any, *, extra: dict | None = None,
         keep: int = 3) -> Path:
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    final = root / f"step_{step:010d}"
    tmp = root / f".tmp_step_{step:010d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()

    flat = _flatten(tree)
    dtypes = []
    for i, (_, leaf) in enumerate(flat):
        t = torch.as_tensor(leaf).detach().cpu()
        dtypes.append(_dtype_name(t.dtype))
        if t.dtype == torch.bfloat16:
            t = t.float()       # exact; restored through .to(bfloat16)
        np.save(tmp / f"arr_{i:05d}.npy", t.numpy())
    manifest = {
        "step": step,
        "n_leaves": len(flat),
        "keys": [k for k, _ in flat],
        "dtypes": dtypes,
        "extra": extra or {},
    }
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)
    (root / ".LATEST_tmp").write_text(final.name)
    os.rename(root / ".LATEST_tmp", root / "LATEST")

    # rotation
    ckpts = sorted(p for p in root.iterdir() if p.name.startswith("step_"))
    for old in ckpts[:-keep]:
        shutil.rmtree(old)
    return final


def save_async(root: str | Path, step: int, tree: Any, **kw) -> threading.Thread:
    """The device-to-host copy happens now (so the caller may go on writing
    its tensors in place), the disk write on a thread; ``join`` it."""
    flat = _flatten(tree)
    host_tree = _unflatten(tree, [_host(leaf) for _, leaf in flat])
    t = threading.Thread(target=save, args=(root, step, host_tree), kwargs=kw)
    t.start()
    return t


def latest_step(root: str | Path) -> int | None:
    root = Path(root)
    ptr = root / "LATEST"
    if not ptr.exists():
        return None
    name = ptr.read_text().strip()
    if not (root / name / "manifest.json").exists():
        return None
    return int(name.split("_")[1])


def restore(root: str | Path, example_tree: Any, *, step: int | None = None,
            device=None) -> tuple[int, Any, dict]:
    """``(step, tree, extra)``: the checkpoint at ``step`` (the latest when
    None) in the structure of ``example_tree``, each leaf in the example
    leaf's dtype and on ``device`` (the example leaf's device when None).
    Raises ``ValueError`` when the keys or a leaf's shape or dtype differ."""
    root = Path(root)
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {root}")
    d = root / f"step_{step:010d}"
    manifest = json.loads((d / "manifest.json").read_text())
    flat = _flatten(example_tree)
    keys = [k for k, _ in flat]
    if manifest["n_leaves"] != len(flat) or manifest["keys"] != keys:
        raise ValueError(f"tree structure changed: the checkpoint holds "
                         f"{manifest['n_leaves']} leaves, the example {len(flat)}")
    out = []
    for i, (key, leaf) in enumerate(flat):
        want = torch.as_tensor(leaf)
        arr = torch.from_numpy(np.load(d / f"arr_{i:05d}.npy"))
        saved = manifest["dtypes"][i]
        if tuple(arr.shape) != tuple(want.shape) or saved != _dtype_name(want.dtype):
            raise ValueError(f"{key}: the checkpoint holds {tuple(arr.shape)} "
                             f"{saved}, the example {tuple(want.shape)} "
                             f"{_dtype_name(want.dtype)}")
        out.append(arr.to(device=want.device if device is None else device,
                          dtype=want.dtype))
    return step, _unflatten(example_tree, out), manifest["extra"]
