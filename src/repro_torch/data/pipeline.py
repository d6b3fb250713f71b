"""Deterministic sharded data pipeline: a copy of ``repro.data.pipeline``
(numpy only; the port never imports the JAX package), giving the same
batches bit for bit.  The train loop moves each batch to its device.

Keyed generation: batch(step, host) is a pure function of (seed, step,
host), so

* any host subset can replay its shard after a failure (fault tolerance),
* elastic re-scaling re-partitions deterministically (the global batch for
  a step is identical regardless of host count),
* no coordination traffic is needed between hosts.

A file-backed dataset (token shards on disk, memory-mapped) and a prefetch
thread cover the production path; the synthetic stream drives tests and
benchmarks (the paper's workloads are graphs, not corpora — LM data here
exercises the substrate).
"""
from __future__ import annotations

import hashlib
import queue
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator

import numpy as np


def _seed_for(base_seed: int, step: int, host: int) -> int:
    h = hashlib.blake2b(
        f"{base_seed}:{step}:{host}".encode(), digest_size=8
    ).digest()
    return int.from_bytes(h, "little") % (2**63)


@dataclass(frozen=True)
class SyntheticLMConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    # [audio]/[vlm] stubs
    frontend: str = "none"
    frontend_dim: int = 0
    n_patches: int = 256


class SyntheticLM:
    """Markov-ish synthetic token stream (learnable: next token depends on
    the current one, so loss decreases measurably within a few steps)."""

    def __init__(self, cfg: SyntheticLMConfig, host: int = 0, n_hosts: int = 1):
        if cfg.global_batch % n_hosts:
            raise ValueError("global_batch must divide across hosts")
        self.cfg = cfg
        self.host = host
        self.n_hosts = n_hosts
        self.local_batch = cfg.global_batch // n_hosts

    def batch_at(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng(_seed_for(cfg.seed, step, self.host))
        b, s, v = self.local_batch, cfg.seq_len, cfg.vocab_size
        start = rng.integers(0, v, size=(b, 1))
        drift = rng.integers(1, 17, size=(b, s))
        toks = (start + np.cumsum(drift, axis=1) - drift) % v
        noise = rng.random((b, s)) < 0.05
        toks = np.where(noise, rng.integers(0, v, size=(b, s)), toks)
        toks = toks.astype(np.int32)
        if cfg.frontend == "audio_frames":
            feats = rng.normal(size=(b, s, cfg.frontend_dim)).astype(np.float32)
            return {
                "features": feats,
                "targets": toks,
                "loss_mask": (rng.random((b, s)) < 0.3),
            }
        if cfg.frontend == "vision_patches":
            return {
                "patches": rng.normal(size=(b, cfg.n_patches, cfg.frontend_dim)).astype(np.float32),
                "tokens": toks,
            }
        return {"tokens": toks}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class FileBackedLM:
    """Token shards on disk (one .npy per host-shard), memory-mapped reads,
    deterministic step->window addressing."""

    def __init__(self, root: str | Path, seq_len: int, local_batch: int,
                 host: int = 0, n_hosts: int = 1):
        self.root = Path(root)
        self.seq_len = seq_len
        self.local_batch = local_batch
        path = self.root / f"shard_{host:05d}_of_{n_hosts:05d}.npy"
        self.tokens = np.load(path, mmap_mode="r")

    @staticmethod
    def write_corpus(root: str | Path, tokens: np.ndarray, n_hosts: int) -> None:
        root = Path(root)
        root.mkdir(parents=True, exist_ok=True)
        shards = np.array_split(tokens, n_hosts)
        for h, sh in enumerate(shards):
            np.save(root / f"shard_{h:05d}_of_{n_hosts:05d}.npy", sh)

    def batch_at(self, step: int) -> dict:
        n = self.tokens.shape[0]
        need = self.local_batch * (self.seq_len + 1)
        start = (step * need) % max(n - need, 1)
        window = np.asarray(self.tokens[start:start + need])
        window = window[: self.local_batch * (self.seq_len + 1)]
        return {"tokens": window.reshape(self.local_batch, self.seq_len + 1)[:, :-1].astype(np.int32)}


class Prefetcher:
    """Background-thread prefetch (straggler slack: the host pipeline runs
    ``depth`` steps ahead of the device step)."""

    def __init__(self, source, start_step: int = 0, depth: int = 2):
        self.source = source
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        step = self._step
        while not self._stop.is_set():
            try:
                self.q.put((step, self.source.batch_at(step)), timeout=0.2)
                step += 1
            except queue.Full:
                continue

    def next(self) -> tuple[int, dict]:
        return self.q.get()

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2)
