"""Smoke run of the PyTorch/CUDA port on one GPU: build the kernels, hold
each against its plain PyTorch version, drive the main path
(``QbSIndex.build`` -> ``query_batch``) at full size on every relay backend,
the SPG serve step, the dense expansion's path, the live serving tier
(stream, replicas, metrics), the epoch-versioned edge updates, the
multi-device paths (four shards on the one card), the baselines, the
serving CLI, the LM serving path and the LM training path (``qwen1.5-4b``
at full width), and check the answers.

    python3 chip_smoke.py                      # 1.1 M-vertex BA graph, R = 20
    python3 chip_smoke.py --n-vertices 100000  # a quicker rehearsal

Phases (each raises on failure; nothing is caught):

1. the card's ``name, power.limit`` and the CUDA version;
2. build the kernels (one ``nvcc`` per source, in parallel);
3. each kernel against its plain version on the card, exact equality,
   with kernel / plain / library-call times (median of 30 timed runs):
   ``minplus``; ``sketch_batch`` at B in {32, 256}, R in {20, 64}, uint8
   and uint16 tables, and at the multi-device paths' own shapes (B = 32,
   R = 20 on int32 tables, as the sharded lanes widen them; B = 8, R = 20
   uint8, a chunk split four ways), beside the PyTorch ops it replaced
   (not one call);
   ``bitmap_expand_packed``; ``bitmap_expand`` beside ``torch.matmul`` on
   f32 casts and ``torch._int_mm`` (cuBLASLt's int8 GEMM) on the int8 views;
   the fused ``hybrid_relay`` is checked on the real graph once the hybrid
   index exists (after its path's counts are read): on the full-graph and
   the G- engines at K = 1, 32 and 40, against its plain version and
   timed beside cuSPARSE's SpMM (``torch.sparse.mm``) on the relay as an
   f32 CSR matrix, the one library call that computes it, and the PyTorch
   ops that relayed before it (not one call);
4. the main path: ``barabasi_albert_graph(1_100_000, 3, seed=0)``,
   ``QbSIndex.build(backend="hybrid")`` and ``query_batch`` on every lane,
   then the same with ``backend="segment"`` and with ``backend="csr"``
   (``block_size = 1 << 21``, so the blocked loop runs), which must give
   the same tables and answers; the launch counters are set to 0 just
   before each backend's run and read just after (hybrid must launch
   ``sketch_batch`` and ``hybrid_relay``, segment and csr ``sketch_batch``
   only);
   then the SPG serve step on the hybrid index (``spg_serve_step``):
   ``make_spg_serve_step`` on one 32-row general chunk and
   ``serve_spg_batch`` on the 274 queries, each equal to ``query_batch``'s
   answers; ``sketch_batch`` once per general chunk, ``hybrid_relay``;
5. the min-plus kernel's path: ``core.sketch.d_top_only`` (one ``minplus``
   launch and nothing else) on the hybrid index's label rows of the
   general pairs, which must equal the fused kernel's d_top and the plain
   version's six fields;
   the dense expansion's path: ``kernels.ops.bitmap_expand_packed`` and
   ``kernels.ops.bitmap_expand`` (its oracle, on the block unpacked) on the
   hybrid index's real hub block and the landmarks' level-1 and level-2
   frontier rows; it must launch those two and nothing else;
   then, on the hybrid index, each with the counters set to 0 just before
   it and read just after:
   the stream (``make_stream`` under ``ManualClock``, two QoS classes, the
   hub cache with reuse admission; the 274 queries in bursts, twice; every
   future equal to ``query_batch``; ``sketch_batch`` and ``hybrid_relay``
   only), then one ``SystemClock`` stream whose lone query its deadline
   timer must resolve (not counted);
   the replicas (``ReplicaRouter``, 2 replicas, drain and restore of one,
   the Prometheus text scraped over HTTP; the same answers and kernels);
   the updates: an incremental batch (4 inserts closing 2-paths, 4
   deletes; 1-10 landmarks recomputed, E unchanged; ``hybrid_relay`` only)
   and a rebuild batch (the churn branch; the net insert doubles E), each
   equal to a fresh build of the new graph on tables and answers with the
   source index unchanged, and an epoch straddle (``submit_update`` with a
   chunk in flight: old futures answer for epoch 0, later ones for 1);
   the multi-device paths on a mesh of every visible card when there are
   several, else on ``Mesh([cuda] * 4)`` (four shards of the one card),
   each counted the same way: ``sharded`` (``distributed_build_labelling`` in the bool, bitmap
   and pull exchanges, each equal to the hybrid index's scheme, not
   counted; then ``ShardedIndex.build`` and ``query_batch`` on every lane,
   equal to the hybrid answers, ``sketch_batch`` only; ``max_levels`` and
   ``max_chain`` sized from the landmarks' measured eccentricity), then
   ``mesh_service`` (``ServingService(idx_h, mesh=...)``: general chunks
   split over the shards, ``sketch_batch`` and ``hybrid_relay``) and
   ``scale_serve`` (one chunk of general pairs, ``sketch_batch`` only);
6. 8 sampled answers against a scipy BFS oracle; the baselines on the
   card: Bi-BFS on 32 general pairs and the two-BFS oracle on 2 pairs of
   the 1.1 M-vertex graph must give the QbS answers, and PPL (with and
   without parents; host numpy with a dense (V, V) table, which is why the
   paper shows it does not scale, so it runs on a 1,000-vertex graph) must
   agree with a QbS index of the same graph;
7. the serving CLI (``repro_torch.launch.serve.main``) in process, at
   ``--n 20000`` on the ``ba`` graph (through ``--replicas 2
   --metrics-port 0``, and with ``--shards 1``) and the ``cliques`` graph;
   the LM serving path (``lm``): ``qwen1.5-4b`` at full width (40 layers,
   d_model 2560, vocab 151936, 3.95 B parameters) in bf16 with random
   weights from a seeded generator on the card, ``greedy_generate`` at
   batch 4, prompt 64, 32 new tokens with bf16-layout and int8 KV caches,
   every step's logits held against the full-sequence ``forward``
   (``LM_TOL``), prefill and decode times, tokens/s and peak memory; then
   every architecture's reduced float32 config on the card against the
   same weights on the CPU (``LM_F32_TOL``; greedy tokens equal, the
   encoder-only model through ``make_prefill_step``); it must launch none
   of the port's kernels;
   the LM training path (``train``, ``train_phase``): the ``lm`` model
   freed, ``qwen1.5-4b`` at full width and depth in bf16, 8 AdamW steps of
   batch 2 x 512 fed by ``SyntheticLM`` through ``Prefetcher`` (every loss
   and grad norm finite, the loss falling; ms per step, tokens/s,
   model-FLOP share, peak memory), then 2 steps with
   ``remat_policy="layer"``; every reduced float32 config, 2 steps with
   ``microbatches=2`` (``remat`` on alternate ones) on the card and on the
   CPU from the same state, held to the CPU tests' tolerances
   (``TRAIN_GRAD_TOL``, ``adam_allowance``); a checkpoint at step 3 of 6,
   restored and replayed on the card, bit-identical under
   ``torch.use_deterministic_algorithms``; it must launch none of the
   port's kernels;
8. the kernels' JSON line, then the device line last.

It imports nothing of JAX or of the JAX package, and exits nonzero without
a CUDA device.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

# cuBLAS reads this when it creates its first handle, at the first matmul on
# the card (importing torch creates none): the train phase's resume check
# runs under torch.use_deterministic_algorithms, which needs it
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
CUDA_CORE_OPS_PER_S = 67e12  # H100 SXM non-tensor-core peak (float32 rate)
INT8_TC_OPS_PER_S = 1979e12  # H100 SXM dense int8 tensor-core peak


def log(msg: str) -> None:
    print(msg, flush=True)


def bound_ms(n_bytes: float, n_ops: float,
             ops_per_s: float = CUDA_CORE_OPS_PER_S) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(fn, reps: int = 30, calls: int = 50, warmup: int = 5) -> float:
    """Wall time of one call as a caller sees it: CUDA events around
    ``calls`` back-to-back calls, divided by ``calls``; the median of
    ``reps`` such runs after warm-up.  Small kernels are launch-bound here."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def _device_us(event) -> float:
    return getattr(event, "self_device_time_total",
                   getattr(event, "self_cuda_time_total", 0.0))


def device_events(prof):
    """The profiler's averaged device-side events (kernels and copies)."""
    return [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]


def device_ms(fn, calls: int = 200) -> float:
    """Device time of one call: the summed device time of every kernel the
    calls launched, from a torch.profiler trace, divided by ``calls``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(_device_us(e) for e in device_events(prof)) / calls / 1e3


def kernel_split(fn, calls: int = 20):
    """Device time per call of each kernel ``fn`` launches, by name (from a
    torch.profiler trace of ``calls`` calls)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    names = [re.search(r"(\w+)(<[^>]*>)?\(", e.key) for e in device_events(prof)]
    return [(m.group(1) if m else e.key[:40], _device_us(e) / calls)
            for m, e in zip(names, device_events(prof))]


def rand_dist(rng, shape, dev, inf):
    x = rng.integers(0, 64, size=shape)
    x = np.where(rng.random(shape) < 0.2, inf, x)
    return torch.as_tensor(x, dtype=torch.int32, device=dev)


def measure(name, fns, reps=30, calls=50, profiled=200):
    """Wall per call and device time per call of each named callable."""
    out = {k: (time_ms(fn, reps, calls), device_ms(fn, profiled))
           for k, fn in fns.items()}
    log(f"{name}: equal; " + ", ".join(
        f"{k} {w * 1e3:.1f} us/call ({d * 1e3:.2f} us device)"
        for k, (w, d) in out.items()))
    return {k: d for k, (_, d) in out.items()}


def sketch_inputs(rng, b, r, dtype, dev, INF):
    """(lu, lv, meta_w, meta_dist) on the card, packed into ``dtype`` (the
    dtype max as the INF sentinel): label rows with 20% INF entries, a
    random meta graph (weights 1-3 x 2 for uint8, x 50 for uint16 and
    int32) and its APSP, as the labelling would give them; int32 keeps INF
    as its sentinel, as ``widen_dist`` leaves it."""
    hi, scale = (40, 2) if dtype == np.uint8 else (400, 50)
    tabs = []
    for _ in range(2):
        x = rng.integers(0, hi, size=(b, r))
        tabs.append(np.where(rng.random((b, r)) < 0.2, INF, x))
    w = rng.integers(1, 4, size=(r, r)) * scale
    w = np.where(rng.random((r, r)) < 0.5, w, INF)
    w = np.minimum(w, w.T)
    np.fill_diagonal(w, INF)
    d = w.copy()
    np.fill_diagonal(d, 0)
    for k in range(r):
        d = np.minimum(d, d[:, k:k + 1] + d[k:k + 1, :])
    tabs += [w, np.minimum(d, INF)]
    sent = INF if dtype == np.int32 else np.iinfo(dtype).max
    return [torch.as_tensor(np.where(x >= INF, sent, x).astype(dtype)).to(dev)
            for x in tabs]


def attaining_pairs(lu, lv, md, INF):
    """The number of attaining landmark pairs of a batch, summed (the
    meta-edge test's share of the sketch's operations)."""
    from repro_torch.core.packing import widen_dist

    lu, lv, md = (widen_dist(t) for t in (lu, lv, md))
    pi = torch.clamp(lu[:, :, None] + md[None] + lv[:, None, :], max=INF)
    d_top = pi.amin(dim=(1, 2))
    att = (pi == d_top[:, None, None]) & (d_top < INF)[:, None, None]
    return int(att.sum())


def check_sketch_batch(dev, ref, INF, rng):
    """The fused sketch kernel against its plain version (all six fields,
    exactly) at the serving shape and beyond, with kernel / plain times and
    those of the PyTorch ops it replaced (the old body of
    ``compute_sketch_batch``, d_top on the ``minplus`` kernel; not one
    call) and the bound.  Returns the JSON row (B = 32, R = 20, uint8)."""
    from repro_torch.kernels.minplus import minplus_cuda
    from repro_torch.kernels.sketch import sketch_batch_cuda, smem_layout

    row = None
    for b, r, dtype in [(32, 20, np.uint8), (32, 20, np.uint16),
                        (256, 20, np.uint8), (256, 20, np.uint16),
                        (32, 64, np.uint8), (32, 64, np.uint16),
                        (256, 64, np.uint8), (256, 64, np.uint16),
                        # the sharded lanes' widened tables, and a 32-row
                        # chunk split over four shards
                        (32, 20, np.int32), (8, 20, np.uint8)]:
        lu, lv, mw, md = sketch_inputs(rng, b, r, dtype, dev, INF)
        got = sketch_batch_cuda(lu, lv, mw, md)
        want = ref.sketch_batch_ref(lu, lv, mw, md)
        torch.cuda.synchronize()
        err = max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
                  for g, w in zip(got, want))
        if err != 0 or any(g.dtype != w.dtype for g, w in zip(got, want)):
            raise AssertionError(f"sketch_batch B={b} R={r} {dtype.__name__}: "
                                 f"max |kernel - plain| = {err}")
        n_att = attaining_pairs(lu, lv, md, INF)
        t = measure(f"sketch_batch B={b} R={r} {dtype.__name__} ({n_att} "
                    f"attaining pairs, {int(got[3].sum())} meta edges; staged "
                    f"{smem_layout(r)})", {
                        "kernel": lambda: sketch_batch_cuda(lu, lv, mw, md),
                        "plain": lambda: ref.sketch_batch_ref(lu, lv, mw, md),
                        "PyTorch ops replaced, not one call":
                            lambda: ref.sketch_batch_ref(lu, lv, mw, md,
                                                         minplus=minplus_cuda)})
        elem = np.dtype(dtype).itemsize
        n_bytes = elem * (2 * b * r + 2 * r * r) + b * (2 * r * 4 + r * r + 12)
        b_ms, b_by = bound_ms(n_bytes, 3 * r * r * (b + n_att))
        log(f"  bound {b_ms * 1e3:.4f} us by {b_by} ({n_bytes} bytes)")
        if (b, r, dtype) == (32, 20, np.uint8):     # a general chunk's sketch
            row = dict(
                name="sketch_batch", route="cuda",
                source="src/repro_torch/kernels/csrc/sketch_batch.cu",
                replaces="src/repro/kernels/minplus.py:81",
                max_abs_err=err, ms=t["kernel"], plain_ms=t["plain"],
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                pytorch_ops_ms=t["PyTorch ops replaced, not one call"])
    return row


def check_kernels(dev, ref, INF):
    """Phase 3: every kernel against its plain version on the card, exact
    equality; the kernels' JSON rows at the main path's shapes."""
    from repro_torch.core.packing import pack_bits, unpack_bits
    from repro_torch.kernels.frontier import bitmap_expand_cuda, bitmap_expand_packed_cuda
    from repro_torch.kernels.minplus import minplus_cuda

    rng = np.random.default_rng(0)
    rows = {}
    for m, k, n in [(32, 20, 20), (130, 200, 50), (4, 4, 4)]:
        if (m, k, n) == (4, 4, 4):
            a = torch.full((4, 4), INF, dtype=torch.int32, device=dev)
            b = a.clone()
        else:
            a = rand_dist(rng, (m, k), dev, INF)
            b = rand_dist(rng, (k, n), dev, INF)
        got = minplus_cuda(a, b)
        want = ref.minplus_ref(a, b)
        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - want).abs().max())
        if err != 0:
            raise AssertionError(f"minplus {m}x{k}x{n}: max |kernel - plain| = {err}")
        if (m, k, n) == (4, 4, 4) and not bool((got >= 2 * INF).all()):
            raise AssertionError("minplus all-INF: result below 2*INF")
        t = measure(f"minplus ({m},{k})x({k},{n})", {
            "kernel": lambda: minplus_cuda(a, b),
            "plain": lambda: ref.minplus_ref(a, b)})
        if (m, k, n) == (32, 20, 20):    # the main path's shape
            b_ms, b_by = bound_ms(4 * (m * k + k * n + m * n), 2 * m * n * k)
            rows["minplus"] = dict(
                name="minplus", route="cuda",
                source="src/repro_torch/kernels/csrc/minplus.cu",
                replaces="src/repro/kernels/minplus.py:81",
                max_abs_err=err, ms=t["kernel"], plain_ms=t["plain"],
                bound_ms=b_ms, bound_by=b_by, library_ms=None)

    rows["sketch_batch"] = check_sketch_batch(dev, ref, INF, rng)

    for k, v, n_cols in [(40, 128, 128), (32, 128, 128), (64, 128, 128),
                         (40, 128, 100), (32, 2048, 128)]:
        f = torch.as_tensor(rng.random((k, v)) < 0.3, device=dev)
        adj = torch.as_tensor(rng.random((v, n_cols)) < 0.1, device=dev)
        words = pack_bits(adj).contiguous()
        nw = words.shape[1]
        if not bool((unpack_bits(words, n_cols) == adj).all()):
            raise AssertionError("pack_bits/unpack_bits round trip")
        got = bitmap_expand_packed_cuda(f, words, n_cols)
        want = ref.bitmap_expand_packed_ref(f, words, n_cols)
        torch.cuda.synchronize()
        err = int((got.to(torch.int32) - want.to(torch.int32)).abs().max())
        if err != 0:
            raise AssertionError(f"bitmap_expand_packed ({k},{v}) n_cols={n_cols}: "
                                 f"max |kernel - plain| = {err}")
        ff = f.to(torch.float32)
        aa = adj.to(torch.float32)
        t = measure(f"bitmap_expand_packed ({k},{v})x({v},{nw}) n_cols={n_cols}", {
            "kernel": lambda: bitmap_expand_packed_cuda(f, words, n_cols),
            "plain": lambda: ref.bitmap_expand_packed_ref(f, words, n_cols),
            "torch.matmul on unpacked f32": lambda: torch.matmul(ff, aa)})
        if (k, v, n_cols) == (32, 128, 128):   # a query chunk's relay level
            b_ms, b_by = bound_ms(k * v + v * nw * 4 + k * n_cols, 2 * k * v * nw)
            rows["bitmap_expand_packed"] = dict(
                name="bitmap_expand_packed", route="cuda",
                source="src/repro_torch/kernels/csrc/bitmap_expand_packed.cu",
                replaces="src/repro/kernels/frontier.py:148",
                max_abs_err=err, ms=t["kernel"], plain_ms=t["plain"],
                bound_ms=b_ms, bound_by=b_by,
                library_ms=t["torch.matmul on unpacked f32"])

    # the dense expansion: the reference's test shapes, the roofline shape,
    # the dense-oracle path's shape (40 frontier rows x 128 hubs), an
    # all-False frontier and a ragged W != V block; bound at the int8
    # tensor-core rate (the OR-AND is an exact int8 product)
    dense_cases = [((1, 1, 1), 0.1), ((20, 100, 100), 0.1), ((20, 257, 257), 0.1),
                   ((64, 512, 512), 0.1), ((64, 2048, 2048), 0.1),
                   ((40, 128, 128), 0.1), ((64, 512, 512), 0.0),
                   ((33, 1000, 77), 0.1)]
    for (r, v, w), f_density in dense_cases:
        f = torch.as_tensor(rng.random((r, v)) < f_density, device=dev)
        adj = rng.random((v, w)) < 0.05
        if v == w:
            adj = np.triu(adj, 1)
            adj = adj | adj.T
        adj = torch.as_tensor(adj, device=dev)
        got = bitmap_expand_cuda(f, adj)
        want = ref.bitmap_expand_ref(f, adj)
        torch.cuda.synchronize()
        err = int((got.to(torch.int32) - want.to(torch.int32)).abs().max())
        if err != 0:
            raise AssertionError(f"bitmap_expand ({r},{v})x({v},{w}): "
                                 f"max |kernel - plain| = {err}")
        if f_density == 0.0 and bool(got.any()):
            raise AssertionError("bitmap_expand: all-False frontier expanded")
        ff = f.to(torch.float32)
        aa = adj.to(torch.float32)
        fns = {"kernel": lambda: bitmap_expand_cuda(f, adj),
               "plain": lambda: ref.bitmap_expand_ref(f, adj),
               "torch.matmul on f32": lambda: torch.matmul(ff, aa)}
        fi, ai = f.view(torch.int8), adj.view(torch.int8)
        try:
            counts = torch._int_mm(fi, ai)
        except RuntimeError as e:
            log(f"  torch._int_mm refuses ({r},{v})x({v},{w}): "
                f"{str(e).splitlines()[0][:120]}")
        else:
            if not torch.equal(counts > 0, got):
                raise AssertionError(f"torch._int_mm > 0 disagrees with "
                                     f"bitmap_expand at ({r},{v})x({v},{w})")
            fns["torch._int_mm on int8"] = lambda: torch._int_mm(fi, ai)
        what = "all-False frontier " if f_density == 0.0 else ""
        t = measure(f"bitmap_expand {what}({r},{v})x({v},{w}), "
                    f"{int(got.sum())} of {got.numel()} true", fns)
        n_bytes = r * v + v * w + r * w
        b_ms, b_by = bound_ms(n_bytes, 2 * r * v * w, INT8_TC_OPS_PER_S)
        log(f"  bound {b_ms * 1e3:.4f} us by {b_by} ({n_bytes} bytes)")
        if (r, v, w) == (40, 128, 128):      # the dense-oracle path's shape
            rows["bitmap_expand"] = dict(
                name="bitmap_expand", route="cuda",
                source="src/repro_torch/kernels/csrc/bitmap_expand.cu",
                replaces="src/repro/kernels/frontier.py:79",
                max_abs_err=err, ms=t["kernel"], plain_ms=t["plain"],
                bound_ms=b_ms, bound_by=b_by,
                library_ms=t["torch.matmul on f32"],
                int_mm_ms=t.get("torch._int_mm on int8"))
    return rows


def old_relay(eng, segment_or, ops):
    """The PyTorch ops that ran the hybrid relay before the fused kernel
    (gather, int32 ``scatter_reduce`` over the tail, the hub block through
    ``bitmap_expand_packed``, ``index_put``), on the engine's arrays."""
    a = eng.arrays
    v = eng.n_vertices
    ptr = a["tail_ptr"].long()
    tail_src = torch.repeat_interleave(torch.arange(v, device=ptr.device),
                                       ptr[1:] - ptr[:-1])
    tail_dst = a["tail_col"]
    hubs = a["hub_ids"].long()
    words = a["adj_hh_words"]

    def run(f):
        out = segment_or(f[:, tail_src], tail_dst, v)
        out[:, hubs] |= ops.bitmap_expand_packed(f[:, hubs].contiguous(), words,
                                                 n_cols=hubs.numel())
        return out
    return run


def relay_matrix(core, eng):
    """The engine's relay as one (V, V) float32 CSR matrix A, for the
    library yardstick ``torch.sparse.mm(A, f.T) > 0`` (cuSPARSE SpMM): row w
    holds tail row w and, for hub p, the hub block's row p at the hubs'
    columns.  Built once, outside every timed window; the port never calls
    it."""
    a = eng.arrays
    v = eng.n_vertices
    ptr = a["tail_ptr"].long()
    rows = torch.repeat_interleave(torch.arange(v, device=ptr.device), ptr.diff())
    hubs = a["hub_ids"].long()
    hp, hq = torch.nonzero(core.unpack_bits(a["adj_hh_words"], hubs.numel()),
                           as_tuple=True)
    idx = torch.stack([torch.cat([rows, hubs[hp]]),
                       torch.cat([a["tail_col"].long(), hubs[hq]])])
    ones = torch.ones((idx.shape[1],), dtype=torch.float32, device=ptr.device)
    return torch.sparse_coo_tensor(idx, ones, (v, v)).coalesce().to_sparse_csr()


def check_hybrid_relay(core, ops, ref, idx_h):
    """The fused relay on the real hybrid index: the full-graph engine (the
    labelling's and the one-sided lane's) and the G- engine (the search's),
    at K = 1, 32 and 40 rows of the landmarks' level-1..3 frontiers, against
    its plain version and the library yardstick (cuSPARSE SpMM on the f32
    relay matrix), exactly; kernel, plain, library and old-ops times; the
    bound from the arrays the kernel must read and write.  Returns the JSON
    row (G- engine, K = 32: a query chunk's relay level)."""
    from repro_torch.core.frontier import segment_or
    from repro_torch.kernels.frontier import cached_schedule, hybrid_relay_cuda

    lm = core.widen_dist(idx_h.packed.lm_dist)                  # (R, V)
    levels = torch.cat([lm == 1, lm == 2, lm == 3])
    row = None
    for label, eng in (("full graph", idx_h._full_engine),
                       ("G-", idx_h.ctx.engine)):
        a = eng.arrays
        v = eng.n_vertices
        args = (a["tail_ptr"], a["tail_col"], a["hub_ids"], a["adj_hh_words"])
        old = old_relay(eng, segment_or, ops)
        mat = relay_matrix(core, eng)
        e_tail = a["tail_col"].numel()
        n_warp_rows = cached_schedule(a["tail_ptr"], a["hub_ids"])[0].numel()
        for k in (1, 32, 40):
            f = levels[20:20 + k].contiguous() if k == 1 else levels[:k].contiguous()
            ft = f.T.to(torch.float32).contiguous()
            got = hybrid_relay_cuda(f, *args)
            want = ref.hybrid_relay_ref(f, *args)
            lib = (torch.sparse.mm(mat, ft) > 0).T
            torch.cuda.synchronize()
            err = int((got.to(torch.int32) - want.to(torch.int32)).abs().max())
            if err != 0 or not torch.equal(got, old(f)) or not torch.equal(got, lib):
                raise AssertionError(f"hybrid_relay ({label}, K={k}): kernel, "
                                     f"plain, library and old ops disagree "
                                     f"(max err {err})")
            t = measure(f"hybrid_relay {label} K={k} ({v} vertices, {e_tail} "
                        f"tail slots, {n_warp_rows} warp rows; "
                        f"{int(f.sum())} frontier bits -> {int(got.sum())})", {
                            "kernel": lambda: hybrid_relay_cuda(f, *args),
                            "plain": lambda: ref.hybrid_relay_ref(f, *args),
                            "torch.sparse.mm on f32 CSR": lambda: torch.sparse.mm(mat, ft),
                            "PyTorch ops, not one call": lambda: old(f)},
                        reps=10, calls=10, profiled=20)
            w = (k + 31) // 32
            h = a["hub_ids"].numel()
            n_bytes = (2 * k * v + 4 * e_tail + 4 * (v + 1) + 4 * h
                       + a["adj_hh_words"].numel() * 4)
            n_ops = w * (e_tail + int(core.unpack_bits(a["adj_hh_words"], h).sum()))
            b_ms, b_by = bound_ms(n_bytes, n_ops)
            log(f"  bound {b_ms * 1e3:.2f} us by {b_by} ({n_bytes} bytes); per "
                "launch " + ", ".join(f"{n} {us:.2f} us" for n, us in kernel_split(
                    lambda: hybrid_relay_cuda(f, *args))))
            if label == "G-" and k == 32:
                row = dict(
                    name="hybrid_relay", route="cuda",
                    source="src/repro_torch/kernels/csrc/hybrid_relay.cu",
                    replaces="src/repro/kernels/frontier.py:148",
                    max_abs_err=err, ms=t["kernel"], plain_ms=t["plain"],
                    bound_ms=b_ms, bound_by=b_by,
                    library_ms=t["torch.sparse.mm on f32 CSR"],
                    pytorch_ops_ms=t["PyTorch ops, not one call"])
        del mat
    return row


def bfs_oracle(graph, pairs, INF):
    """Independent host oracle: two scipy BFSs per query; edge (x, y) is on
    the SPG iff du[x] + 1 + dv[y] == d, symmetrized by edge-slot pairing."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import shortest_path

    src = graph.src.cpu().numpy().astype(np.int64)
    dst = graph.dst.cpu().numpy().astype(np.int64)
    n = graph.n_vertices
    real = src != dst
    adj = csr_matrix((np.ones(int(real.sum())), (src[real], dst[real])),
                     shape=(n, n))
    ends = sorted({x for p in pairs for x in p})
    dist = shortest_path(adj, unweighted=True, indices=ends)
    row = {x: i for i, x in enumerate(ends)}
    key = src * n + dst
    order = np.argsort(key, kind="stable")
    rev = order[np.searchsorted(key[order], dst * n + src)]
    out = []
    for u, v in pairs:
        if u == v:
            out.append((0, np.zeros((0,), np.int64)))
            continue
        du = dist[row[u]]
        dv = dist[row[v]]
        if not np.isfinite(du[v]):
            out.append((INF, np.zeros((0,), np.int64)))
            continue
        d = int(du[v])
        mask = (du[src] + 1 + dv[dst]) == d
        mask &= real
        mask |= mask[rev]
        out.append((d, np.flatnonzero(mask)))
    return out


def run_backend(core, ops, g, backend, us, vs, n_landmarks, chunk,
                engine_opts=None):
    """The main path once: build an index, answer the whole batch.  The
    peak-memory figure counts from this backend's start, with the indexes
    of the earlier backends still alive."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    idx = core.QbSIndex.build(g, n_landmarks=n_landmarks, backend=backend,
                              chunk=chunk, engine_opts=engine_opts)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    log(f"[{backend}] build {t_build:.2f} s; packed tables "
        f"{idx.packed.dtype}, {idx.packed.nbytes / 1e6:.1f} MB; kernel "
        f"launches so far {dict(ops.LAUNCHES)}")
    t0 = time.perf_counter()
    res = idx.query_batch(us, vs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    log(f"[{backend}] query_batch of {len(us)} queries: {dt:.2f} s, "
        f"{len(us) / dt:.1f} queries/s; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return idx, res


def time_lanes(idx, ops, us, vs, lanes, chunk, label=None):
    """Per-lane serving time and kernel launches per chunk: each lane's
    queries alone through the service (after the main path's count)."""
    svc = idx.make_service()
    label = label or idx.backend
    for name, sel in lanes.items():
        if not sel.size:
            continue
        before = dict(ops.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        svc.query_batch(us[sel], vs[sel])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        n_chunks = -(-sel.size // chunk)
        per_chunk = {k: (ops.LAUNCHES[k] - before[k]) / n_chunks for k in before}
        log(f"[{label}] lane {name}: {sel.size} queries, {n_chunks} "
            f"chunks, {dt / n_chunks * 1e3:.1f} ms per chunk; kernel launches "
            f"per chunk {per_chunk}")


def breakdown(core, idx, us, vs):
    """Where a general-lane chunk's time goes: host-timed stages (each ends
    in a synchronize), then a torch.profiler trace of one ``serve_step`` for
    the device's busy share and the top kernels by device time."""
    from repro_torch.core import search, sketch
    from repro_torch.core.packing import take
    from repro_torch.core.qbs import _symmetrize

    us_t = torch.as_tensor(us, dtype=torch.int32, device=idx.device)
    vs_t = torch.as_tensor(vs, dtype=torch.int32, device=idx.device)
    idx.serve_step(us_t, vs_t)            # warm
    torch.cuda.synchronize()
    stages = {}

    def stage(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stages[name] = stages.get(name, 0.0) + time.perf_counter() - t0
        return out

    t_all = time.perf_counter()
    ctx, V = idx.ctx, idx.graph.n_vertices
    sk = stage("sketch", lambda: sketch.compute_sketch_batch(
        take(idx.packed.label_dist, us_t.long()), take(idx.packed.label_dist, vs_t.long()),
        idx.packed.meta_w, idx.packed.meta_dist))
    q = search.Query(u=us_t, v=vs_t, d_top=sk.d_top, du_land=sk.du_land,
                     dv_land=sk.dv_land, meta_edge=sk.meta_edge,
                     d_star_u=sk.d_star_u, d_star_v=sk.d_star_v)
    du, dv, _, _, _, _, met = stage("bidirectional_bfs", lambda: search.bidirectional_bfs(
        ctx, q, V, idx.max_levels))
    common = (du < core.INF) & (dv < core.INF)
    d_minus = torch.where(common, du + dv, core.INF).amin(dim=1)
    rev_rows = torch.nonzero(met & (d_minus <= q.d_top) & (us_t != vs_t))[:, 0]
    rec_rows = torch.nonzero((q.d_top < core.INF) & (q.d_top <= d_minus)
                             & (us_t != vs_t))[:, 0]
    if rev_rows.numel():
        stage("reverse_search", lambda: search.reverse_search(
            ctx, du[rev_rows], dv[rev_rows], d_minus[rev_rows]))
    if rec_rows.numel():
        sub = search.Query(*(t[rec_rows] for t in q))
        stage("side_attach_u", lambda: search._side_attach(
            ctx, du[rec_rows], sub.du_land, V, idx.max_chain))
        stage("side_attach_v", lambda: search._side_attach(
            ctx, dv[rec_rows], sub.dv_land, V, idx.max_chain))
        stage("delta_edges", lambda: search._delta_edges(ctx, sub.meta_edge))
    mask = torch.zeros((us_t.shape[0], idx.graph.n_edges), dtype=torch.bool,
                       device=idx.device)
    stage("symmetrize", lambda: _symmetrize(d_minus, mask, idx._rev_edge_t))
    total = time.perf_counter() - t_all
    log(f"[{idx.backend}] general chunk of {us.size}: {total * 1e3:.1f} ms; "
        f"reverse rows {rev_rows.numel()}, recover rows {rec_rows.numel()}; "
        + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in stages.items()))

    profile_step(idx.backend, lambda: idx.serve_step(us_t, vs_t))


def profile_step(label, step, top: int = 8, what: str = "serve_step"):
    """One call of ``step`` under torch.profiler: wall time, the device's
    busy share of it and the top kernels by device time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = device_events(prof)
    dev_total = sum(_device_us(e) for e in events)
    log(f"[{label}] profiled {what}: wall {wall * 1e3:.1f} ms, device "
        f"busy {dev_total / 1e3:.1f} ms ({dev_total / 1e4 / wall:.1f}% of wall)")
    for e in sorted(events, key=lambda e: -_device_us(e))[:top]:
        log(f"    {_device_us(e) / 1e3:8.2f} ms  x{e.count:<6d} {e.key[:90]}")


def same_as_hybrid(idx_h, res_h, idx_b, res_b, backend):
    """Another backend's tables and answers against hybrid's, exactly."""
    for f in ("label_dist", "meta_w", "meta_dist", "lid", "is_landmark"):
        if not torch.equal(getattr(idx_h.scheme, f), getattr(idx_b.scheme, f)):
            raise AssertionError(f"{backend} and hybrid disagree on scheme.{f}")
    if not all(torch.equal(a, b) for a, b in zip(idx_h.packed, idx_b.packed)):
        raise AssertionError(f"{backend} and hybrid disagree on the packed tables")
    same_answers(res_b, res_h, f"{backend} against hybrid")
    log(f"hybrid == {backend} on tables and on all {len(res_h)} answers")


def sketch_oracle(ops, ref, idx_h, us, vs):
    """The min-plus kernel's path: ``core.sketch.d_top_only`` (two chained
    min-plus contractions, the first on the ``minplus`` kernel) on the
    hybrid index's label rows of the general pairs, against the fused
    ``sketch_batch`` kernel's d_top and the plain version's six fields.  The
    counters are set to 0 just before the ``d_top_only`` call and read just
    after; the comparison's own launches come after that."""
    from repro_torch.core import sketch
    from repro_torch.core.packing import take

    lab = idx_h.packed.label_dist
    lu = take(lab, torch.as_tensor(us, device=idx_h.device).long())
    lv = take(lab, torch.as_tensor(vs, device=idx_h.device).long())
    mw, md = idx_h.packed.meta_w, idx_h.packed.meta_dist
    ops.reset_launches()
    d_top = sketch.d_top_only(lu, lv, md)
    torch.cuda.synchronize()
    counts = dict(ops.LAUNCHES)
    fused = ops.sketch_batch(lu, lv, mw, md)
    plain = ref.sketch_batch_ref(lu, lv, mw, md)
    torch.cuda.synchronize()
    if not (torch.equal(d_top, fused[0]) and torch.equal(d_top, plain[0])
            and all(torch.equal(a, b) for a, b in zip(fused, plain))):
        raise AssertionError("d_top_only, sketch_batch and its plain version "
                             "disagree on the real label rows")
    log(f"sketch oracle: d_top_only (minplus) == sketch_batch d_top == plain "
        f"on {lu.shape[0]} general pairs ({lab.dtype} rows, R = {lu.shape[1]}; "
        f"{int((d_top < 1 << 20).sum())} finite, {int(fused[3].sum())} meta "
        f"edges), all six fields equal; launches {counts}")
    return counts


def dense_oracle(core, ops, ref, idx_h):
    """The dense expansion's path: ``ops.bitmap_expand_packed`` over the
    hybrid index's hub block and ``ops.bitmap_expand`` over the same block
    unpacked (its oracle), on the landmarks' level-1 and level-2 frontier
    rows (hub columns).  The counters are set to 0 just before the two calls
    and read just after."""
    eng = idx_h.ctx.engine
    hub_ids = eng.arrays["hub_ids"].to(torch.int64)
    words = eng.arrays["adj_hh_words"]
    h = hub_ids.numel()
    adj = core.unpack_bits(words, h).contiguous()
    lm = core.widen_dist(idx_h.packed.lm_dist)                  # (R, V)
    rows = torch.cat([lm == 1, lm == 2])[:, hub_ids].contiguous()
    plain = ref.bitmap_expand_ref(rows, adj)
    ops.reset_launches()
    want = ops.bitmap_expand_packed(rows, words, n_cols=h)
    got = ops.bitmap_expand(rows, adj)
    torch.cuda.synchronize()
    counts = dict(ops.LAUNCHES)
    if not (torch.equal(got, want) and torch.equal(got, plain)):
        raise AssertionError("bitmap_expand disagrees with bitmap_expand_packed "
                             "on the hub block")
    log(f"dense oracle: bitmap_expand == bitmap_expand_packed == plain on "
        f"({rows.shape[0]},{h})x({h},{h}) hub rows ({int(rows.sum())} frontier "
        f"bits, {int(adj.sum())} hub edges, {int(got.sum())} next bits); "
        f"launches {counts}")
    return counts


def baselines(core, g, us, vs, general, res_h, oracle_pairs):
    """Bi-BFS and the two-BFS oracle on the card against the QbS answers;
    PPL against a QbS index of a 1,000-vertex graph."""
    from repro_torch.core import baselines as bl

    t0 = time.perf_counter()
    bi = bl.bibfs_spg_batch(g, us[general], vs[general])
    for i, b in zip(general, bi):
        q = res_h[i]
        if b.dist != q.dist or not np.array_equal(b.edge_ids, q.edge_ids.astype(np.int64)):
            raise AssertionError(f"Bi-BFS disagrees with QbS on ({q.u}, {q.v})")
    log(f"[baselines] bibfs_spg_batch == QbS on {len(bi)} general pairs "
        f"({time.perf_counter() - t0:.2f} s)")
    t0 = time.perf_counter()
    for u, v, d, eids in oracle_pairs:
        o = bl.bfs_spg(g, u, v)
        if o.dist != d or not np.array_equal(o.edge_ids, eids):
            raise AssertionError(f"bfs_spg disagrees with scipy on ({u}, {v})")
    log(f"[baselines] bfs_spg == scipy oracle on {len(oracle_pairs)} pairs "
        f"({time.perf_counter() - t0:.2f} s)")

    # PPL keeps a dense (V, V) host table: the paper's point is that this
    # family does not scale, so it runs at 1,000 vertices only
    g1 = core.barabasi_albert_graph(1000, 3, seed=0)
    idx1 = core.QbSIndex.build(g1, n_landmarks=20, backend="hybrid")
    rng = np.random.default_rng(2)
    pu = rng.integers(0, 1000, size=64).astype(np.int32)
    pv = rng.integers(0, 1000, size=64).astype(np.int32)
    res = idx1.query_batch(pu, pv)
    for parents in (False, True):
        t0 = time.perf_counter()
        ppl = bl.PPLIndex(g1, store_parents=parents)
        t_build = time.perf_counter() - t0
        for r in res:
            p = ppl.query(r.u, r.v)
            if p.dist != r.dist or not np.array_equal(p.edge_ids, r.edge_ids):
                raise AssertionError(f"PPL (parents={parents}) disagrees with "
                                     f"QbS on ({r.u}, {r.v})")
        log(f"[baselines] PPLIndex(store_parents={parents}) == QbS on "
            f"{len(res)} pairs of BA(1000, 3): {ppl.label_entries()} label "
            f"entries, {ppl.memory_bytes()} bytes, built in {t_build:.2f} s")


def same_answers(got, want, what: str) -> None:
    """Answers (``SPGResult``s) equal on u, v, dist, d_top and edge ids."""
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} answers for {len(want)} queries")
    for a, b in zip(got, want):
        if (a.u, a.v, a.dist, a.d_top) != (b.u, b.v, b.dist, b.d_top) \
                or not np.array_equal(a.edge_ids, b.edge_ids):
            raise AssertionError(f"{what}: query ({b.u}, {b.v}) disagrees")


def stream_phase(ops, idx_h, us, vs, res_h, general):
    """The streaming scheduler on the hybrid index under ``ManualClock``: two
    QoS classes, the hub cache with reuse admission, the 274 queries in
    bursts of 16 alternating between the classes (1 ms apart), then all of
    them again, a 100 ms step and a drain.  The counters are set to 0 just
    before the first submit and read just after the drain.  Then one
    ``SystemClock`` stream with a lone general query, which its class's
    deadline timer must admit and resolve (its launches are not counted)."""
    from repro_torch.serving import AdmissionPolicy, ManualClock, QoSClass

    clock = ManualClock()
    st = idx_h.make_stream(
        clock=clock, cache_size=4096, cache_policy="hub", cache_admission="reuse",
        qos=(QoSClass("interactive", max_wait=0.002, weight=3.0),
             QoSClass("batch", max_wait=0.05, weight=1.0)))
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    futs = []
    for _ in range(2):
        for k in range(0, us.size, 16):
            futs += st.submit_batch(us[k:k + 16], vs[k:k + 16],
                                    qos=("interactive", "batch")[k // 16 % 2])
            clock.advance(0.001)
    clock.advance(0.1)
    st.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(ops.LAUNCHES)
    same_answers([f.result() for f in futs], res_h + res_h, "stream")
    if {f.epoch for f in futs} != {0}:
        raise AssertionError("stream futures resolved under another epoch")
    s = dict(st.stats)
    if s["cache_hits"] + s["joined"] == 0 or st.n_pending or st.n_inflight:
        raise AssertionError(f"stream: no cache hit or join, or work left: {s}")
    waits = {c: max(st.qos_stats[c]["waits"], default=0.0) for c in st.qos_stats}
    log(f"[stream] {len(futs)} futures == query_batch in {wall:.2f} s "
        f"({len(futs) / wall:.1f} queries/s); {s['chunks']} chunks "
        f"({s['padded_rows']} padded rows), {s['cache_hits']} cache hits, "
        f"{s['joined']} joins, {len(st.admission_log)} admission rounds in "
        f"{s['admissions']} flushes ({s['deadline_flushes']} by deadline); "
        f"max wait per class (simulated s) {waits}; launches {counts}")
    log(f"[stream] stats {s}")
    st.close()

    i = int(general[0])
    lone = idx_h.make_stream(qos=(QoSClass("interactive", max_wait=0.005),),
                             policy=AdmissionPolicy(adaptive=False, chunk=64))
    t0 = time.perf_counter()
    fut = lone.submit(int(us[i]), int(vs[i]), qos="interactive")
    while not fut.done() and time.perf_counter() - t0 < 60.0:
        time.sleep(0.001)
    if not fut.done():
        raise AssertionError("SystemClock stream: the lone query did not resolve")
    waited = time.perf_counter() - t0
    same_answers([fut.result()], [res_h[i]], "SystemClock stream")
    lone.close()
    log(f"[stream] SystemClock lone query ({us[i]}, {vs[i]}), max_wait 5 ms: "
        f"resolved by its deadline timer in {waited * 1e3:.1f} ms")
    return counts


def replicas_phase(ops, idx_h, us, vs, res_h):
    """``ReplicaRouter(idx_h, n_replicas=2, cache_size=4096)`` (both replicas
    on the one card) on the 274 queries; ``drain_replica(0)`` and
    ``restore_replica(0)`` (pending pairs and packed cache entries moved),
    the queries again; the Prometheus text scraped over HTTP from
    ``serve_metrics`` on 127.0.0.1 (port 0).  The counters are set to 0 just
    before the first submit and read just after the second drain."""
    import urllib.request

    from repro_torch.serving import MetricsRegistry, ReplicaRouter, serve_metrics

    router = ReplicaRouter(idx_h, n_replicas=2, cache_size=4096)
    registry = MetricsRegistry()
    for i, rep in enumerate(router.replicas):
        registry.register(f"replica{i}", rep)
    server = serve_metrics(registry, port=0, host="127.0.0.1")
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    first = router.submit_batch(us, vs)
    router.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    router.drain_replica(0)
    router.restore_replica(0)
    t1 = time.perf_counter()
    second = router.submit_batch(us, vs)
    router.drain()
    torch.cuda.synchronize()
    wall2 = time.perf_counter() - t1
    counts = dict(ops.LAUNCHES)
    same_answers([f.result() for f in first], res_h, "replicas")
    same_answers([f.result() for f in second], res_h, "replicas after restore")
    port = server.server_address[1]
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=30) as r:
        text = r.read().decode()
    server.shutdown()
    server.server_close()
    observed = sum(int(m) for m in re.findall(
        r"^qbs_latency_us_count\{[^}]*\} (\d+)$", text, re.M))
    if observed != len(first) + len(second):
        raise AssertionError(f"metrics: {observed} latency observations for "
                             f"{len(first) + len(second)} resolved futures")
    per = {i: (rep.stats["submitted"], rep.stats["chunks"],
               rep.service.cache.bytes) for i, rep in enumerate(router.replicas)}
    log(f"[replicas] 2 replicas == query_batch on {len(first)} queries in "
        f"{wall:.2f} s ({len(first) / wall:.1f} queries/s); after drain and "
        f"restore of replica 0 ({router.stats['cache_shipped']} cache entries "
        f"shipped) again in {wall2:.3f} s ({len(second) / wall2:.1f} queries/s); "
        f"per replica (submitted, chunks, cache bytes) {per}; scraped "
        f"{len(text.splitlines())} metric lines, latency counts {observed}; "
        f"launches {counts}")
    router.close()
    return counts


def incremental_batch(core, idx_h, rng, k: int = 4):
    """``k`` inserts that close 2-paths (u - w - x -> u - x) and ``k``
    deletes, all endpoints distinct, chosen so that the batch touches 1-10
    landmarks.  Each candidate is judged alone by ``affected_landmarks`` on
    host copies of the tables; with distinct endpoints the batch's affected
    set is the union of its edges' sets.  A delete is judged on the CSR
    rows of its two endpoints without the edge, which is all of the new
    graph that the criterion reads."""
    from types import SimpleNamespace

    g = idx_h.graph
    scheme = core.LabellingScheme(*(t.cpu().numpy() for t in idx_h.scheme))
    lm = idx_h._lm_dist_host
    indptr = g.indptr.cpu().numpy()
    dst = g.dst.cpu().numpy()
    is_lm = scheme.is_landmark
    host = SimpleNamespace(indptr=indptr, dst=dst)
    nbrs = lambda x: dst[indptr[x]:indptr[x + 1]]            # noqa: E731
    used: set = set()
    aff = np.zeros((lm.shape[0],), bool)
    ins = []
    for _ in range(100_000):
        if len(ins) == k:
            break
        w = int(rng.integers(0, g.n_vertices))
        nb = [int(x) for x in nbrs(w) if not is_lm[x] and x not in used]
        if len(nb) < 2 or is_lm[w]:
            continue
        u, x = (int(a) for a in rng.choice(nb, 2, replace=False))
        if x in nbrs(u) or u == x:
            continue
        got = core.affected_landmarks(scheme, lm, host, inserts=[(u, x)])
        n = int(got.sum())
        if n > 2 or (not ins and n == 0) or (aff | got).sum() > 8:
            continue
        ins.append((min(u, x), max(u, x)))
        used |= {u, x}
        aff |= got
    dels = []
    for _ in range(100_000):
        if len(dels) == k:
            break
        a = int(rng.integers(0, g.n_vertices))
        nb = [int(x) for x in nbrs(a) if x not in used and x != a]
        if a in used or not nb:
            continue
        b = nb[int(rng.integers(len(nb)))]
        lo, hi = min(a, b), max(a, b)
        rows = [nbrs(lo)[nbrs(lo) != hi], nbrs(hi)[nbrs(hi) != lo]]
        ptr = np.zeros((g.n_vertices + 1,), np.int64)
        ptr[lo + 1] = rows[0].size
        ptr[hi] = rows[0].size
        ptr[hi + 1] = rows[0].size + rows[1].size
        view = SimpleNamespace(indptr=ptr, dst=np.concatenate(rows))
        got = core.affected_landmarks(scheme, lm, view, deletes=[(lo, hi)])
        if got.sum() > 1 or (aff | got).sum() > 8:
            continue
        dels.append((lo, hi))
        used |= {lo, hi}
        aff |= got
    if len(ins) < k or len(dels) < k:
        raise AssertionError("no incremental update batch found")
    return np.asarray(ins), np.asarray(dels), int(aff.sum())


def update_phase(core, ops, idx_h, us, vs, res_h, lms, chunk):
    """Epoch-versioned updates on the hybrid index: an incremental batch
    (equal inserts and deletes, E unchanged, 1-10 landmarks recomputed; the
    counters are set to 0 just before its ``apply_update`` and read just
    after) and a rebuild batch (64 random inserts, 16 deletes: the churn
    branch, and the net insert doubles E).  Each is held against a fresh
    ``QbSIndex.build`` of the new graph with the same landmarks (packed
    tables, lm_dist, the 274 answers), and the source index's tables must
    be unchanged.  Last, the epoch straddle: a stream with chunks in flight
    (``async_depth=2``) takes ``submit_update``; its old-epoch futures must
    equal ``res_h`` and later submits the new index's answers."""
    from repro_torch.serving import AdmissionPolicy, ManualClock

    g = idx_h.graph
    rng = np.random.default_rng(3)
    t0 = time.perf_counter()
    ins, dels, predicted = incremental_batch(core, idx_h, rng)
    log(f"[update] incremental batch: {len(ins)} inserts closing 2-paths, "
        f"{len(dels)} deletes ({predicted} landmarks touched by the edges "
        f"alone; chosen in {time.perf_counter() - t0:.1f} s)")
    src = [t.clone() for t in (*idx_h.graph, *idx_h.scheme, *idx_h.packed)]
    src_lm = idx_h._lm_dist_host.copy()

    def check(new, what):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fresh = core.QbSIndex.build(new.graph, landmarks=lms, backend="hybrid",
                                    chunk=chunk, device=idx_h.device)
        torch.cuda.synchronize()
        t_fresh = time.perf_counter() - t0
        if not all(torch.equal(a, b) for a, b in zip(new.packed, fresh.packed)):
            raise AssertionError(f"{what}: packed tables differ from a fresh build")
        if not np.array_equal(new._lm_dist_host, fresh._lm_dist_host):
            raise AssertionError(f"{what}: lm_dist differs from a fresh build")
        t0 = time.perf_counter()
        got = new.query_batch(us, vs)
        torch.cuda.synchronize()
        t_q = time.perf_counter() - t0
        same_answers(got, fresh.query_batch(us, vs), f"{what} vs a fresh build")
        now = (*idx_h.graph, *idx_h.scheme, *idx_h.packed)
        if not (all(torch.equal(a, b) for a, b in zip(src, now))
                and np.array_equal(src_lm, idx_h._lm_dist_host)):
            raise AssertionError(f"{what}: the source index's tables changed")
        return fresh, got, t_fresh, t_q

    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    inc = idx_h.apply_update(inserts=ins, deletes=dels)
    torch.cuda.synchronize()
    t_inc = time.perf_counter() - t0
    counts = dict(ops.LAUNCHES)
    info = inc.last_update_info
    if info["full_rebuild"] or not 1 <= info["n_affected"] <= 10 \
            or inc.graph.n_edges != g.n_edges or inc.epoch != 1:
        raise AssertionError(f"incremental batch: {info}, {inc.graph.n_edges} slots")
    _, res_inc, t_fresh, t_q = check(inc, "incremental update")
    log(f"[update] incremental: apply_update {t_inc:.2f} s (fresh build "
        f"{t_fresh:.2f} s); n_affected {info['n_affected']} "
        f"{info['affected'].tolist()}, full_rebuild False, {inc.graph.n_edges} "
        f"edge slots; tables and {len(us)} answers == fresh build "
        f"(query_batch {t_q:.2f} s); source index unchanged; launches {counts}")

    present = set(map(tuple, core.edge_set(g)[rng.choice(g.n_edges // 2, 16,
                                                          replace=False)].tolist()))
    new_ins = rng.integers(0, g.n_vertices, size=(64, 2))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    reb = idx_h.apply_update(inserts=new_ins, deletes=sorted(present))
    torch.cuda.synchronize()
    t_reb = time.perf_counter() - t0
    info = reb.last_update_info
    if not info["full_rebuild"] or reb.graph.n_edges != 2 * g.n_edges:
        raise AssertionError(f"rebuild batch: {info}, {reb.graph.n_edges} slots")
    fresh, _, t_fresh, t_q = check(reb, "rebuild update")
    log(f"[update] rebuild: apply_update {t_reb:.2f} s (fresh build "
        f"{t_fresh:.2f} s); n_affected {info['n_affected']}, full_rebuild True; "
        f"E {g.n_edges} -> {reb.graph.n_edges} edge slots; tables and "
        f"{len(us)} answers == fresh build (query_batch {t_q:.2f} s); peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        f"({before / 2**30:.2f} GiB held before the batch)")
    del reb, fresh

    st = idx_h.make_stream(clock=ManualClock(), async_depth=2,
                           policy=AdmissionPolicy(adaptive=False, chunk=chunk))
    old = st.submit_batch(us, vs)
    in_flight = st.n_inflight
    if in_flight == 0:
        raise AssertionError("epoch straddle: no chunk in flight at the update")
    t0 = time.perf_counter()
    st.submit_update(inserts=ins, deletes=dels)
    t_sub = time.perf_counter() - t0
    later = st.submit_batch(us, vs)
    st.drain()
    if {f.epoch for f in old} != {0} or {f.epoch for f in later} != {1}:
        raise AssertionError("epoch straddle: futures resolved under the wrong epoch")
    same_answers([f.result() for f in old], res_h, "epoch 0 futures")
    same_answers([f.result() for f in later], res_inc, "epoch 1 futures")
    log(f"[update] epoch straddle: {in_flight} chunk(s) in flight at "
        f"submit_update ({t_sub:.2f} s); {len(old)} epoch-0 futures == the old "
        f"index, {len(later)} epoch-1 futures == the new index")
    st.close()
    return counts


def search_depth(core, idx_h) -> int:
    """``max_levels`` and ``max_chain`` for the sharded lanes, from the
    measured eccentricity of the landmarks: on a connected graph every
    distance, and so every level, sweep and recover chain, is at most
    twice the largest landmark distance."""
    lm = core.widen_dist(idx_h.packed.lm_dist)
    if not bool((lm[0] < core.INF).all()):
        raise AssertionError("the graph is not connected; the depth bound needs it")
    return 2 * int(lm.max()) + 1


def sharded_phase(core, ops, g, idx_h, us, vs, res_h, lanes, chunk, mesh,
                  breakdown=False):
    """The vertex-sharded paths on ``mesh``: ``distributed_build_labelling``
    in the three frontier modes, each equal to the hybrid index's scheme;
    then the counted path: ``ShardedIndex.build`` (bitmap exchange, born
    sharded) and ``query_batch`` over the queries, every answer equal to the
    hybrid index's; the counters are set to 0 just before the build and read
    just after the batch.  Then each lane's ms per chunk (not counted) and,
    with ``breakdown``, a torch.profiler trace of one general chunk."""
    from repro_torch.core.distributed import distributed_build_labelling
    from repro_torch.core.sharded import ShardedIndex

    lms = idx_h.scheme.landmarks.cpu().numpy()
    depth = search_depth(core, idx_h)
    for mode in ("bool", "bitmap", "pull"):
        sync_all()
        t0 = time.perf_counter()
        sc = distributed_build_labelling(g, lms, mesh, frontier_mode=mode)
        sync_all()
        dt = time.perf_counter() - t0
        for f in sc._fields:
            if not torch.equal(getattr(sc, f), getattr(idx_h.scheme, f)):
                raise AssertionError(f"distributed labelling ({mode}) disagrees "
                                     f"with the hybrid index on {f}")
        log(f"[sharded] distributed_build_labelling over {mesh.n_shards} shards, "
            f"{mode} exchange: {dt:.2f} s; the scheme == the hybrid index's")
    sync_all()
    ops.reset_launches()
    t0 = time.perf_counter()
    sh = ShardedIndex.build(g, landmarks=lms, mesh=mesh, frontier_mode="bitmap",
                            chunk=chunk, max_levels=depth, max_chain=depth)
    sync_all()
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = sh.query_batch(us, vs)
    sync_all()
    dt = time.perf_counter() - t0
    counts = dict(ops.LAUNCHES)
    same_answers(res, res_h, "sharded against hybrid")
    info = sh.sharded_size_bytes()
    log(f"[sharded] ShardedIndex.build over {info['n_shards']} shards "
        f"({sh.labels.pack_dtype}, v_loc {sh.labels.v_loc}, e_max {sh.part.e_max}, "
        f"max_levels = max_chain = {depth}): {t_build:.2f} s; per shard "
        f"{info['per_device_bytes'] / 1e6:.1f} MB (labels "
        f"{info['per_device_label_bytes'] / 1e6:.1f} MB + CSR "
        f"{info['per_device_csr_bytes'] / 1e6:.1f} MB) = "
        f"{info['per_device_frac']:.3f} of the replicated "
        f"{info['replicated_bytes'] / 1e6:.1f} MB")
    log(f"[sharded] query_batch of {len(us)} queries == hybrid: {dt:.2f} s, "
        f"{len(us) / dt:.1f} queries/s; launches {counts}")
    time_lanes(sh, ops, us, vs, lanes, chunk, label="sharded")
    if breakdown:
        first = lanes["general"][:chunk]
        us_t = torch.as_tensor(us[first], device=sh.device)
        vs_t = torch.as_tensor(vs[first], device=sh.device)
        profile_step("sharded", lambda: sh.serve_step(us_t, vs_t), top=12)
    return counts


def mesh_service_phase(ops, idx_h, us, vs, res_h, mesh):
    """The batch-sharded service on the hybrid index: ``ServingService(idx_h,
    mesh=mesh)`` splits every general chunk over the mesh's shards (the index
    replicated per device); every answer equal to the hybrid index's.  The
    counters are set to 0 just before ``query_batch`` and read just after."""
    import warnings

    from repro_torch.serving import ServingService

    with warnings.catch_warnings(record=True) as warned:
        warnings.simplefilter("always")
        svc = ServingService(idx_h, mesh=mesh)
    rounding = (f"chunk {idx_h.chunk} -> {svc.chunk}" if warned
                else f"chunk {svc.chunk} divides over {mesh.n_shards} shards, not rounded")
    sync_all()
    ops.reset_launches()
    t0 = time.perf_counter()
    res = svc.query_batch(us, vs)
    sync_all()
    dt = time.perf_counter() - t0
    counts = dict(ops.LAUNCHES)
    same_answers(res, res_h, "mesh service against hybrid")
    log(f"[mesh_service] {len(us)} queries == hybrid over {mesh.n_shards} "
        f"shards: {dt:.2f} s, {len(us) / dt:.1f} queries/s; {rounding}; "
        f"chunk_roundings {svc.stats['chunk_roundings']}; launches {counts}")
    return counts


def scale_serve_phase(core, ops, g, idx_h, us, vs, res_h, rows, mesh):
    """``scale_serve`` (edge-aligned int16 source labels) on one chunk of
    general pairs with the hybrid index's scheme; distances and undirected
    SPG edges equal to the hybrid index's answers.  The counters are set to
    0 just before the call and read just after."""
    from repro_torch.core.scale_serve import scale_serve

    depth = search_depth(core, idx_h)
    sync_all()
    ops.reset_launches()
    t0 = time.perf_counter()
    pairs, dist = scale_serve(g, idx_h.scheme, mesh, us[rows], vs[rows],
                              max_levels=depth, max_chain=depth)
    sync_all()
    dt = time.perf_counter() - t0
    counts = dict(ops.LAUNCHES)
    src = g.src.cpu().numpy()
    dst = g.dst.cpu().numpy()
    for k, i in enumerate(rows):
        r = res_h[i]
        want = {(int(min(a, b)), int(max(a, b)))
                for a, b in zip(src[r.edge_ids], dst[r.edge_ids])}
        if int(dist[k]) != r.dist or pairs[k] != want:
            raise AssertionError(f"scale_serve disagrees with hybrid on ({r.u}, {r.v})")
    log(f"[scale_serve] {rows.size} general pairs over {mesh.n_shards} shards "
        f"== hybrid (dist and SPG edges): {dt:.2f} s including the host "
        f"partition; launches {counts}")
    return counts


def spg_serve_step_phase(ops, idx_h, us, vs, res_h, general, chunk):
    """The SPG serve step on the hybrid index: ``make_spg_serve_step`` on
    one ``chunk``-row general chunk (dist and symmetrized edge mask equal to
    that chunk's ``query_batch`` answers), then ``serve_spg_batch`` on the
    whole batch (equal to every ``query_batch`` answer).  The counters are
    set to 0 just before the step and read just after the batch."""
    from repro_torch.serving import make_spg_serve_step, serve_spg_batch

    rows = general[:chunk]
    u_t = torch.as_tensor(us[rows], dtype=torch.int32, device=idx_h.device)
    v_t = torch.as_tensor(vs[rows], dtype=torch.int32, device=idx_h.device)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    dist, mask = make_spg_serve_step(idx_h)(u_t, v_t)
    torch.cuda.synchronize()
    t_step = time.perf_counter() - t0
    step_counts = dict(ops.LAUNCHES)
    dist, mask = dist.cpu().numpy(), mask.cpu().numpy()
    for k, i in enumerate(rows):
        r = res_h[i]
        if int(dist[k]) != r.dist or not np.array_equal(np.flatnonzero(mask[k]),
                                                        r.edge_ids):
            raise AssertionError(f"make_spg_serve_step disagrees with query_batch "
                                 f"on ({r.u}, {r.v})")
    t0 = time.perf_counter()
    d_all, m_all = serve_spg_batch(idx_h, us, vs)
    torch.cuda.synchronize()
    t_batch = time.perf_counter() - t0
    counts = dict(ops.LAUNCHES)
    for i, r in enumerate(res_h):
        if int(d_all[i]) != r.dist or not np.array_equal(np.flatnonzero(m_all[i]),
                                                         r.edge_ids):
            raise AssertionError(f"serve_spg_batch disagrees with query_batch on "
                                 f"({r.u}, {r.v})")
    log(f"[spg_serve_step] make_spg_serve_step on {rows.size} general rows == "
        f"query_batch in {t_step * 1e3:.1f} ms, launches {step_counts}; "
        f"serve_spg_batch on {us.size} queries == query_batch in {t_batch:.2f} s "
        f"({us.size / t_batch:.1f} queries/s, host (N, E) mask included); "
        f"launches {counts}")
    return step_counts, counts


# The LM phase's tolerances, fixed before its first run on the card
# (PERF.md, PR 17).  Full width, bf16: the greedy steps' logits against
# the full-sequence forward at the same positions (logits reach ~5; one
# bf16 step there is 0.03); int8 KV adds the quantisation error.
LM_TOL = {"bf16": 0.25, "int8": 0.5}
# Reduced configs, float32 (TF32 off): card against the port's own CPU
# logits, abs and rel, per family.  The recurrent scans difference running
# sums of log decays, so f32 rounding of their inputs is magnified (a
# one-ulp perturbation of the weights moves the reference's own logits by
# 4.4e-6 dense, 3.4e-5 rwkv6, 2.2e-4 zamba2); the same bounds as the CPU
# tests' (tests/helpers/torch_lm.py).
LM_F32_TOL = {"dense": 1e-4, "moe": 1e-4, "audio": 1e-4, "vlm": 1e-4,
              "ssm": 5e-4, "hybrid": 5e-3}


def _greedy_tokens_agree(got, want, want_logits, tol, what):
    """Greedy tokens equal, except after a step where the reference side's
    top two logits lie within ``2 * tol`` (a tie the tolerance allows):
    there the sequences may part, and the rest is not compared."""
    for t in range(want.shape[1]):
        if torch.equal(got[:, t], want[:, t]):
            continue
        top2 = want_logits[:, t].topk(2, dim=-1).values
        gap = float((top2[:, 0] - top2[:, 1]).min())
        if gap >= 2 * tol:
            raise AssertionError(f"{what}: greedy tokens differ at step {t} "
                                 f"(top-2 gap {gap:.2e})")
        return f"tokens equal to step {t}, then a tie within tolerance (gap {gap:.1e})"
    return "tokens equal"


def lm_phase(ops, seed: int = 0):
    """The LM serving path: ``qwen1.5-4b`` at full width in bf16 on the card
    with random weights from a seeded generator, ``greedy_generate`` at batch
    4, prompt 64, 32 new tokens, with bf16-layout and int8 KV caches, each
    step's logits held against the full-sequence ``forward`` (``LM_TOL``);
    then every architecture's reduced float32 config, weights made on the
    CPU and moved to the card, card logits against the port's own CPU
    logits (``LM_F32_TOL``) and greedy tokens equal.  The counters are set
    to 0 before the model is built and read at the end: the LM path runs
    none of the port's kernels (its matmuls are cuBLAS, its attention torch
    ops)."""
    from repro_torch.configs import ARCHS, get_config
    from repro_torch.models import build_model, forward
    from repro_torch.serving import (greedy_generate, make_decode_step,
                                     make_prefill_step)

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on: the float32 checks need them off")
    dev = torch.device("cuda")
    cfg = get_config("qwen1.5-4b")
    b, s, n_new = 4, 64, 32
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(seed))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    w_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    log(f"[lm] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, QKV bias; "
        f"{n_params / 1e9:.3f} B parameters, {w_bytes / 1e9:.2f} GB bf16, built "
        f"on the card in {time.perf_counter() - t0:.1f} s")
    prompt = torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)), dtype=torch.int32, device=dev)
    greedy_generate(model, prompt, 2)                      # warm-up
    prefill_step = make_prefill_step(model)
    t_pre = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill_step({"tokens": prompt})
        torch.cuda.synchronize()
        t_pre.append(time.perf_counter() - t0)
    t_prefill = statistics.median(t_pre)
    out = {}
    for mode in ("bf16", "int8"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks, logits = greedy_generate(model, prompt, n_new, kv_quant=mode == "int8",
                                       return_logits=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        seq = torch.cat([prompt, toks[:, :-1]], dim=1)
        with torch.inference_mode():
            full, _ = forward(model, {"tokens": seq})
        want = full[:, s - 1:s - 1 + n_new]
        gap = (logits - want).abs()
        if not torch.isfinite(logits).all() or float(gap.max()) > LM_TOL[mode]:
            raise AssertionError(f"[lm] {mode} KV: prefill+decode logits off the "
                                 f"forward by {float(gap.max()):.3f} (tolerance "
                                 f"{LM_TOL[mode]})")
        same_top = float((want.argmax(-1) == toks).float().mean())
        decode_ms = (wall - t_prefill) / (n_new - 1) * 1e3
        out[mode] = toks
        log(f"[lm] {mode} KV: greedy_generate {b} x ({s} + {n_new}) in "
            f"{wall * 1e3:.1f} ms, {b * n_new / wall:.1f} tokens/s; decode "
            f"{decode_ms:.2f} ms per token (greedy wall less the prefill's, over "
            f"{n_new - 1} steps); logits vs forward: max |diff| "
            f"{float(gap.max()):.4f} (tolerance {LM_TOL[mode]}), mean "
            f"{float(gap.mean()):.5f}, max |logit| {float(want.abs().max()):.2f}; "
            f"forward's argmax == greedy token on {same_top * 100:.1f}%")
    agree = float((out["bf16"] == out["int8"]).float().mean())
    # the bounds count the matmul weights (every parameter but the embedding
    # table, of which a step gathers b rows) read once, and 2 flops per
    # weight per token; a decode step also reads the bf16 KV cache once
    n_mm = n_params - model.embed.numel()
    kv_bytes = cfg.n_layers * 2 * b * (s + n_new) * cfg.n_kv_heads * cfg.hd * 2
    t_dec, by_dec = bound_ms(2 * n_mm + kv_bytes, 2 * n_mm * b, 989e12)
    t_pf, by_pf = bound_ms(2 * n_mm, 2 * n_mm * b * s, 989e12)
    log(f"[lm] prefill {b} x {s}: {t_prefill * 1e3:.2f} ms (median of 5; bound "
        f"{t_pf:.3f} ms by {by_pf}); a decode step's bound {t_dec:.3f} ms by "
        f"{by_dec} (matmul weights + bf16 KV once, 3.35 TB/s; 989 TFLOP/s bf16); "
        f"int8/bf16 greedy-token agreement {agree * 100:.1f}%; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del model, full, logits, want, gap
    gc.collect()
    torch.cuda.empty_cache()

    for name in sorted(ARCHS):
        cfg = ARCHS[name].reduced(dtype="float32")
        tol = LM_F32_TOL[cfg.family]
        cpu_model = build_model(cfg, device="cpu",
                                generator=torch.Generator().manual_seed(seed))
        card = build_model(cfg, device="meta").to_empty(device=dev)
        card.load_state_dict(cpu_model.state_dict())
        rng = np.random.default_rng(seed)
        if cfg.frontend == "audio_frames":
            batch = {"features": rng.normal(size=(2, s, cfg.frontend_dim)).astype(np.float32)}
        else:
            batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, s)).astype(np.int32)}
            if cfg.frontend == "vision_patches":
                batch["patches"] = rng.normal(size=(2, 8, cfg.frontend_dim)).astype(np.float32)
        # prefill (the forward for the encoder-only model) on both sides
        want, c_cache = make_prefill_step(cpu_model)(
            {k: torch.as_tensor(v) for k, v in batch.items()})
        got, g_cache = make_prefill_step(card)(
            {k: torch.as_tensor(v, device=dev) for k, v in batch.items()})
        worst = float((got.cpu() - want).abs().max())
        torch.testing.assert_close(got.cpu(), want, rtol=tol, atol=tol)
        what = "prefill" if not cfg.encoder_only else "forward (make_prefill_step)"
        if cfg.frontend == "vision_patches":
            # greedy_generate takes tokens only; one decode step on the caches
            cache_len = 8 + s
            tok = torch.full((2, 1), 5)
            c = cpu_model.init_decode_cache(2, cache_len + 1)
            g = card.init_decode_cache(2, cache_len + 1)
            with torch.inference_mode():
                for (kb, vb), (kp, vp) in zip(c["layers"], c_cache["layers"]):
                    kb[:, :cache_len], vb[:, :cache_len] = kp, vp
                for (kb, vb), (kp, vp) in zip(g["layers"], g_cache["layers"]):
                    kb[:, :cache_len], vb[:, :cache_len] = kp, vp
            w2, _ = make_decode_step(cpu_model)(c, cache_len, tok)
            g2, _ = make_decode_step(card)(g, cache_len, tok.to(dev))
            torch.testing.assert_close(g2.cpu(), w2, rtol=tol, atol=tol)
            worst = max(worst, float((g2.cpu() - w2).abs().max()))
            what += " and one decode_step"
        elif not cfg.encoder_only:
            for kvq in (False, True):
                tw, lw = greedy_generate(cpu_model, batch["tokens"], 8, kv_quant=kvq,
                                         return_logits=True)
                tg, lg = greedy_generate(card, batch["tokens"], 8, kv_quant=kvq,
                                         return_logits=True)
                note = _greedy_tokens_agree(tg.cpu(), tw, lw, tol,
                                            f"[lm] {name} kv_quant={kvq}")
                worst = max(worst, float((lg.cpu() - lw)[:, :1].abs().max()))
                what += f", greedy {'int8' if kvq else 'bf16-layout'} KV ({note})"
        log(f"[lm] {name} reduced, float32: card == CPU within {tol:g} on the "
            f"{what}; max |diff| {worst:.2e}")
        del cpu_model, card
    counts = dict(ops.LAUNCHES)
    return counts


# The train phase's gradient tolerances, card against the port's own CPU
# path, per family: the CPU tests' (tests/helpers/torch_lm.py, GRAD_TOL),
# relative to each leaf's largest |gradient|; a one-ulp perturbation of
# the weights moves the reference's own gradients by 1.2e-6 to 2.4e-6 of
# that on the attention families, 1.4e-5 on rwkv6 and 1.8e-4 on zamba2.
TRAIN_GRAD_TOL = {"dense": 5e-5, "moe": 5e-5, "audio": 5e-5, "vlm": 5e-5,
                  "ssm": 3e-4, "hybrid": 4e-3}
# float32 parameters after one step, away from the elements whose update
# Adam's normalisation amplifies (``adam_allowance``)
TRAIN_P_ATOL = 1e-6
BF16_TC_FLOPS = 989e12      # H100 SXM dense bf16 tensor-core peak


def adam_allowance(g, m_prev, v_prev, step: int, lr: float, dg,
                   b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8):
    """How far AdamW's update ``lr * mhat / (sqrt(vhat) + eps)`` can move
    (elementwise, float64) when the gradient ``g`` moves by up to ``dg``
    from moments ``m_prev``, ``v_prev`` at ``step``: the largest change over
    nine points spanning ``[g - dg, g + dg]``.  Where ``|g| <= dg`` the
    first step's +-lr move may flip (``2 * lr``); where ``|g|`` is far above
    ``dg`` and ``eps``, about nothing.  The CPU tests' rule
    (tests/helpers/torch_lm.py)."""
    g, m_prev, v_prev, dg = (t.double() for t in (g, m_prev, v_prev, dg))
    bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step

    def upd(gp):
        m = b1 * m_prev + (1 - b1) * gp
        v = b2 * v_prev + (1 - b2) * gp * gp
        return (m / bc1) / (torch.sqrt(v / bc2) + eps)

    u0 = upd(g)
    return lr * torch.stack([(upd(g + t * dg) - u0).abs()
                             for t in np.linspace(-1.0, 1.0, 9)]).amax(0)


def _train_batch(cfg, step: int, seed: int = 0):
    from repro_torch.data import SyntheticLM, SyntheticLMConfig
    return SyntheticLM(SyntheticLMConfig(
        cfg.vocab_size, seq_len=64, global_batch=4, seed=seed, frontend=cfg.frontend,
        frontend_dim=cfg.frontend_dim, n_patches=8)).batch_at(step)


def _card_vs_cpu_step(name, cfg, cpu, card, cpu_state, card_state, cpu_step,
                      card_step, batch, step, dev):
    """One train step on each side from the same parameters and state;
    then the card's loss, grad norm, moments and parameters against the
    CPU's, and the CPU's state copied onto the card for the next step."""
    from repro_torch.launch.train import to_device

    fam = cfg.family
    mu_prev = {k: v.clone() for k, v in cpu_state["mu"].items()}
    nu_prev = {k: v.clone() for k, v in cpu_state["nu"].items()}
    _, _, want = cpu_step(cpu, cpu_state, to_device(batch, torch.device("cpu")))
    _, _, got = card_step(card, card_state, to_device(batch, dev))
    tol = TRAIN_GRAD_TOL[fam]
    worst = {}
    for k in ("loss", "nll", "aux"):
        d = abs(float(got[k]) - float(want[k]))
        if not d <= LM_F32_TOL[fam] * max(1.0, abs(float(want[k]))):
            raise AssertionError(f"[train] {name} step {step}: {k} {float(got[k])} "
                                 f"on the card, {float(want[k])} on the CPU")
        worst[k] = d
    gn_w = float(want["grad_norm"])
    if not abs(float(got["grad_norm"]) - gn_w) <= tol * gn_w:
        raise AssertionError(f"[train] {name} step {step}: grad_norm "
                             f"{float(got['grad_norm'])} vs {gn_w}")
    lr = float(want["lr"])
    params = dict(card.named_parameters())
    for n, p_cpu in cpu.named_parameters():
        mu, nu = cpu_state["mu"][n], cpu_state["nu"][n]
        g = (mu - 0.9 * mu_prev[n]) / (1 - 0.9)
        dg = torch.full_like(g, tol * float(g.abs().max()))
        for key, want_t, bound in (
                ("mu", mu, (1 - 0.9) * dg),
                ("nu", nu, (1 - 0.95) * 2 * dg * (g.abs() + dg))):
            d = (card_state[key][n].cpu() - want_t).abs()
            if not bool((d <= bound + 1e-30).all()):
                raise AssertionError(f"[train] {name} step {step}: {key}[{n}] off "
                                     f"by {float(d.max()):.3e}")
        allow = adam_allowance(g, mu_prev[n], nu_prev[n], step, lr, dg) + TRAIN_P_ATOL
        d = (params[n].detach().cpu().double() - p_cpu.detach().double()).abs()
        if not bool((d <= allow).all()):
            i = int(torch.argmax(d - allow))
            raise AssertionError(f"[train] {name} step {step}: {n} off by "
                                 f"{float(d.flatten()[i]):.3e} (bound "
                                 f"{float(allow.flatten()[i]):.3e})")
        worst["params"] = max(worst.get("params", 0.0), float(d.max()))
    with torch.no_grad():
        card.load_state_dict(cpu.state_dict())
        for key in ("mu", "nu"):
            for n, t in cpu_state[key].items():
                card_state[key][n].copy_(t)
    return worst


def train_phase(ops, seed: int = 0):
    """The LM training path on the card: ``qwen1.5-4b`` at full width and
    depth in bf16 (random weights from a seeded generator), ``SyntheticLM``
    through ``Prefetcher``, ``adamw(warmup_cosine(3e-4, 2, 8))``, 8 steps of
    batch 2 x 512 (loss falling, every loss and grad norm finite; ms per
    step, tokens/s, model-FLOP share and peak memory), then 2 steps with
    ``remat_policy="layer"``; every architecture's reduced float32 config,
    2 steps on the card and on the CPU with ``microbatches=2`` (``remat``
    on alternate ones), each step from the same state, held to the CPU
    tests' tolerances; and a checkpoint resume on the card, bit-identical
    under ``torch.use_deterministic_algorithms``.  The counters are set to 0
    before the model is built and read at the end: no kernel of the port
    runs on this path."""
    import dataclasses
    import tempfile

    from repro_torch import checkpoint as ckpt
    from repro_torch.configs import ARCHS, get_config
    from repro_torch.data import Prefetcher, SyntheticLM, SyntheticLMConfig
    from repro_torch.launch.train import to_device
    from repro_torch.models import build_model, loss_fn
    from repro_torch.training import adamw, make_train_step, warmup_cosine

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on: the float32 checks need them off")
    dev = torch.device("cuda")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()

    # 1. full width: qwen1.5-4b, bf16, batch 2 x 512
    cfg = get_config("qwen1.5-4b")
    b, s, n_steps = 2, 512, 8
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(seed))
    opt = adamw(warmup_cosine(3e-4, 2, 8))
    opt_state = opt.init(dict(model.named_parameters()))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[train] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, QKV bias; "
        f"{n_params / 1e9:.3f} B parameters in bf16, AdamW moments in float32; "
        f"built in {time.perf_counter() - t0:.1f} s; batch {b} x {s}")
    source = SyntheticLM(SyntheticLMConfig(cfg.vocab_size, seq_len=s, global_batch=b,
                                           seed=0))
    step_fn = make_train_step(model, opt)
    times, metrics = [], []
    pf = Prefetcher(source, start_step=0, depth=2)
    try:
        for step in range(n_steps):
            got_step, batch = pf.next()
            if got_step != step:
                raise AssertionError(f"the prefetcher gave step {got_step} for {step}")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model, opt_state, met = step_fn(model, opt_state, to_device(batch, dev))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            metrics.append(met)
    finally:
        pf.close()
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [float(m["loss"]) for m in metrics]
    gnorms = [float(m["grad_norm"]) for m in metrics]
    if not (np.isfinite(losses).all() and np.isfinite(gnorms).all()):
        raise AssertionError(f"[train] a loss or grad norm is not finite: {losses} {gnorms}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"[train] the loss did not fall: {losses}")
    # FLOPs: 6 per matmul weight per token (forward and backward; every
    # 2-D parameter but the embedding table, which is a gather) plus the
    # attention products, QK^T and AV over the full (S, S) square, which
    # the naive attention computes
    n_mm = sum(p.numel() for n, p in model.named_parameters()
               if p.dim() == 2 and n != "embed")
    attn = 3 * 4 * b * s * s * cfg.n_heads * cfg.hd * cfg.n_layers
    flops = 6 * n_mm * b * s + attn
    # AdamW: read p, g (bf16), mu, nu (f32); write p, mu, nu
    opt_bytes = n_params * (2 + 2 + 4 + 4 + 2 + 4 + 4)
    step_s = statistics.median(times[2:])
    t_flops = flops / BF16_TC_FLOPS * 1e3
    t_bytes = opt_bytes / HBM_BYTES_PER_S * 1e3
    log(f"[train] losses {', '.join(f'{x:.4f}' for x in losses)}; grad norms "
        f"{', '.join(f'{x:.3f}' for x in gnorms)}; lr {float(metrics[-1]['lr']):.2e} "
        f"at step {n_steps}")
    log(f"[train] step ms {', '.join(f'{t * 1e3:.1f}' for t in times)}; median of "
        f"steps 3-{n_steps} {step_s * 1e3:.2f} ms, {b * s / step_s:.0f} tokens/s; "
        f"{flops:.4g} FLOPs per step ({n_mm / 1e9:.3f} B matmul weights), "
        f"model-FLOP share {flops / (step_s * BF16_TC_FLOPS) * 100:.1f}% of 989 "
        f"TFLOP/s (bound {t_flops:.2f} ms); the AdamW update's bytes bound "
        f"{t_bytes:.2f} ms ({opt_bytes / 1e9:.1f} GB at 3.35 TB/s); peak device "
        f"memory {peak:.2f} GiB")
    params = dict(model.named_parameters())

    def split_step(step):
        """One step in its two halves, each timed and its peak read: the
        loss and gradients, then the AdamW update (the step's own work)."""
        batch = to_device(source.batch_at(step), dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss, _ = loss_fn(model, batch)
        grads = torch.autograd.grad(loss, list(params.values()))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        peak_grad = torch.cuda.max_memory_allocated() / 2**30
        opt.update(dict(zip(params, grads)), opt_state, params)
        torch.cuda.synchronize()
        return ((t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3, peak_grad,
                torch.cuda.max_memory_allocated() / 2**30)

    def log_split(label, split):
        log(f"[train] {label}: loss and gradients {split[0]:.1f} ms (peak "
            f"{split[2]:.2f} GiB), the AdamW update {split[1]:.1f} ms (bytes bound "
            f"{t_bytes:.2f} ms; peak {split[3]:.2f} GiB)")

    log_split("one step split", split_step(n_steps))
    batch = to_device(source.batch_at(n_steps + 1), dev)
    profile_step("train", lambda: step_fn(model, opt_state, batch), top=10,
                 what="train step")

    model.cfg = dataclasses.replace(cfg, remat_policy="layer")
    step_fn = make_train_step(model, opt)
    torch.cuda.reset_peak_memory_stats()
    retries = torch.cuda.memory_stats().get("num_alloc_retries", 0)
    remat_times = []
    for step in range(n_steps + 2, n_steps + 5):
        batch = to_device(source.batch_at(step), dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model, opt_state, met = step_fn(model, opt_state, batch)
        torch.cuda.synchronize()
        remat_times.append(time.perf_counter() - t0)
        if not np.isfinite(float(met["loss"])):
            raise AssertionError("[train] a remat step's loss is not finite")
    log(f"[train] remat_policy=layer: step ms {', '.join(f'{t * 1e3:.1f}' for t in remat_times)} "
        f"(without: {step_s * 1e3:.2f}); peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (without: {peak:.2f}); "
        f"allocator retries "
        f"{torch.cuda.memory_stats().get('num_alloc_retries', 0) - retries}")
    log_split("remat_policy=layer, one step split", split_step(n_steps + 5))
    del model, opt_state, step_fn, metrics, met, batch, params
    gc.collect()
    torch.cuda.empty_cache()

    # 2. every reduced float32 config, card against CPU, 2 steps each
    for i, name in enumerate(sorted(ARCHS)):
        cfg = ARCHS[name].reduced(dtype="float32")
        remat = i % 2 == 1
        cpu = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(seed))
        card = build_model(cfg, device="meta").to_empty(device=dev)
        card.load_state_dict(cpu.state_dict())
        opt = adamw(warmup_cosine(1e-3, 1, 10))
        cpu_state = opt.init(dict(cpu.named_parameters()))
        card_state = opt.init(dict(card.named_parameters()))
        cpu_step = make_train_step(cpu, opt, microbatches=2, remat=remat)
        card_step = make_train_step(card, opt, microbatches=2, remat=remat)
        worst = {}
        for step in (1, 2):
            w = _card_vs_cpu_step(name, cfg, cpu, card, cpu_state, card_state, cpu_step,
                                  card_step, _train_batch(cfg, step - 1, seed), step, dev)
            worst = {k: max(v, worst.get(k, 0.0)) for k, v in w.items()}
        log(f"[train] {name} reduced, float32, microbatches=2, remat={remat}: card "
            f"== CPU over 2 steps; max |diff| loss {worst['loss']:.2e}, params "
            f"{worst['params']:.2e} (gradient tolerance {TRAIN_GRAD_TOL[cfg.family]:g})")
        del cpu, card

    # 3. resume on the card, bit-identical under deterministic algorithms
    cfg = get_config("qwen1.5-4b").reduced()
    opt = adamw(warmup_cosine(2e-2, 3, 100), weight_decay=0.01)
    source = SyntheticLM(SyntheticLMConfig(cfg.vocab_size, seq_len=32, global_batch=8))

    def fresh():
        m = build_model(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(seed))
        return m, opt.init(dict(m.named_parameters()))

    torch.use_deterministic_algorithms(True)
    try:
        with tempfile.TemporaryDirectory() as root:
            model, opt_state = fresh()
            step_fn = make_train_step(model, opt)
            for step in range(6):
                model, opt_state, _ = step_fn(model, opt_state,
                                              to_device(source.batch_at(step), dev))
                if step == 2:
                    ckpt.save(root, 3, {"params": model.state_dict(), "opt": opt_state},
                              extra={"data_step": 3})
            want = {k: v.detach().clone() for k, v in model.named_parameters()}
            model, opt_state = fresh()
            got_step, tree, extra = ckpt.restore(
                root, {"params": model.state_dict(), "opt": opt_state})
            model.load_state_dict(tree["params"])
            opt_state = tree["opt"]
            step_fn = make_train_step(model, opt)
            for step in range(extra["data_step"], 6):
                model, opt_state, _ = step_fn(model, opt_state,
                                              to_device(source.batch_at(step), dev))
            same = [torch.equal(p.detach(), want[k]) for k, p in model.named_parameters()]
            if got_step != 3 or not all(same):
                raise AssertionError(f"[train] resume from step {got_step}: "
                                     f"{same.count(False)} of {len(same)} parameters differ")
    finally:
        torch.use_deterministic_algorithms(False)
    log(f"[train] resume: 6 steps with a checkpoint at 3, restored and replayed "
        f"4-6 on the card under deterministic algorithms: all {len(same)} "
        f"parameters bit-identical")
    return dict(ops.LAUNCHES)


def graph_and_queries(core, n_vertices, n_random, n_landmarks=20):
    """The 1.1 M-vertex graph and the query batch: ``n_random`` random
    pairs, 8 landmark pairs, 8 one-sided pairs and 2 ``u == v``."""
    t0 = time.perf_counter()
    g = core.barabasi_albert_graph(n_vertices, 3, seed=0)
    log(f"graph: BA({n_vertices}, 3), {g.n_edges} edge slots, "
        f"{time.perf_counter() - t0:.1f} s to generate")
    lms = core.select_landmarks(g, n_landmarks)
    is_lm = np.zeros((g.n_vertices,), bool)
    is_lm[lms] = True
    rng = np.random.default_rng(1)
    us = rng.integers(0, g.n_vertices, size=n_random)
    vs = rng.integers(0, g.n_vertices, size=n_random)
    non = np.flatnonzero(~is_lm)
    pick = rng.choice(non, size=10, replace=False)
    lm_a, lm_b = rng.choice(lms, size=8), rng.choice(lms, size=8)
    lm_b = np.where(lm_a == lm_b, lms[(np.searchsorted(lms, lm_b) + 1) % n_landmarks], lm_b)
    us = np.concatenate([us, lm_a, pick[:8], pick[8:10]]).astype(np.int32)
    vs = np.concatenate([vs, lm_b, rng.choice(lms, size=8), pick[8:10]]).astype(np.int32)
    lane = np.full((us.size,), "general", object)
    lane[(is_lm[us] & is_lm[vs])] = "landmark_pair"
    lane[is_lm[us] ^ is_lm[vs]] = "one_sided"
    lane[us == vs] = "trivial"
    lanes = {k: np.flatnonzero(lane == k) for k in
             ("general", "landmark_pair", "one_sided", "trivial")}
    log("queries: " + ", ".join(f"{k} {v.size}" for k, v in lanes.items()))
    return g, lms, rng, us, vs, lanes


def shard_mesh(core):
    """The multi-device paths' mesh: every visible card when there are
    several, else four shards of the one card."""
    n_cards = torch.cuda.device_count()
    if n_cards > 1:
        return core.Mesh([torch.device("cuda", i) for i in range(n_cards)])
    return core.Mesh([torch.device("cuda", 0)] * 4)


def sync_all() -> None:
    """Wait for every card (a mesh may span several)."""
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n-vertices", type=int, default=1_100_000)
    ap.add_argument("--n-random", type=int, default=256)
    ap.add_argument("--breakdown", action="store_true",
                    help="also time the general lane's stages on one chunk and "
                         "trace it with torch.profiler")
    args = ap.parse_args()
    t_start = time.perf_counter()

    def clock(label: str) -> None:
        log(f"[clock] {label} at {time.perf_counter() - t_start:.1f} s")

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch import core
    from repro_torch.kernels import _build, ops, ref

    dev = torch.device("cuda")
    INF = core.INF
    # phase 1: the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    # phase 2: build
    t0 = time.perf_counter()
    _build.build_all()
    log(f"kernel build: {time.perf_counter() - t0:.1f} s")
    for name, text in _build.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "error" in line.lower():
                log(f"  ptxas {name}: {line.strip()}")

    clock("kernel checks start")
    # phase 3: kernels against their plain versions
    rows = check_kernels(dev, ref, INF)

    clock("main path starts")
    # phase 4: the main path
    g, lms, rng, us, vs, lanes = graph_and_queries(core, args.n_vertices,
                                                   args.n_random)
    n_landmarks, chunk = 20, 32

    # each path once, with the launch counters set to 0 just before it and
    # read just after
    ops.reset_launches()
    idx_h, res_h = run_backend(core, ops, g, "hybrid", us, vs, n_landmarks, chunk)
    launches = {"hybrid": dict(ops.LAUNCHES)}
    log(f"launches on the hybrid path (build + query_batch): {launches['hybrid']}")
    time_lanes(idx_h, ops, us, vs, lanes, chunk)
    rows["hybrid_relay"] = check_hybrid_relay(core, ops, ref, idx_h)

    ops.reset_launches()
    idx_s, res_s = run_backend(core, ops, g, "segment", us, vs, n_landmarks, chunk)
    launches["segment"] = dict(ops.LAUNCHES)
    log(f"launches on the segment path (build + query_batch): {launches['segment']}")
    same_as_hybrid(idx_h, res_h, idx_s, res_s, "segment")
    time_lanes(idx_s, ops, us, vs, lanes, chunk)

    ops.reset_launches()
    idx_c, res_c = run_backend(core, ops, g, "csr", us, vs, n_landmarks, chunk,
                               engine_opts={"block_size": 1 << 21})
    launches["csr"] = dict(ops.LAUNCHES)
    log(f"launches on the csr path (build + query_batch): {launches['csr']}")
    log(f"[csr] {idx_c.ctx.engine.arrays['csr_bounds'].shape[0]} blocks of "
        f"{idx_c.ctx.engine.block_size} edge slots per relay")
    same_as_hybrid(idx_h, res_h, idx_c, res_c, "csr")
    time_lanes(idx_c, ops, us, vs, lanes, chunk)

    general = lanes["general"]
    launches["sketch_oracle"] = sketch_oracle(ops, ref, idx_h, us[general],
                                              vs[general])
    launches["dense_oracle"] = dense_oracle(core, ops, ref, idx_h)
    expect = {"hybrid": ("sketch_batch", "hybrid_relay"),
              "segment": ("sketch_batch",), "csr": ("sketch_batch",),
              "sketch_oracle": ("minplus",),
              "dense_oracle": ("bitmap_expand_packed", "bitmap_expand")}
    for path, names in expect.items():
        for name, count in launches[path].items():
            if name in names and count <= 0:
                raise AssertionError(f"kernel {name} was not launched on the {path} path")
            if name not in names and count != 0:
                raise AssertionError(f"kernel {name} was launched {count} times "
                                     f"on the {path} path")
    clock("spg_serve_step starts")
    step_counts, launches["spg_serve_step"] = spg_serve_step_phase(
        ops, idx_h, us, vs, res_h, lanes["general"], chunk)
    if (step_counts["sketch_batch"] != 1 or launches["spg_serve_step"]["sketch_batch"]
            != 1 + launches["hybrid"]["sketch_batch"]):
        raise AssertionError("spg_serve_step: sketch_batch not once per general chunk")
    if args.breakdown:
        first = lanes["general"][:chunk]
        for idx in (idx_h, idx_s, idx_c):
            breakdown(core, idx, us[first], vs[first])
    # an index and its default service reference each other, so only the
    # cycle collector frees them: collect now, or the memory figures below
    # depend on when it happens to run
    del idx_s, idx_c, res_s, res_c
    gc.collect()
    torch.cuda.empty_cache()

    # the live serving tier and the dynamic updates, on the hybrid index
    clock("serving tier starts")
    launches["stream"] = stream_phase(ops, idx_h, us, vs, res_h, lanes["general"])
    launches["replicas"] = replicas_phase(ops, idx_h, us, vs, res_h)
    launches["update"] = update_phase(core, ops, idx_h, us, vs, res_h, lms, chunk)

    # the multi-device paths
    clock("multi-device paths start")
    mesh = shard_mesh(core)
    log(f"mesh: {mesh}")
    launches["sharded"] = sharded_phase(core, ops, g, idx_h, us, vs, res_h, lanes,
                                        chunk, mesh, args.breakdown)
    launches["mesh_service"] = mesh_service_phase(ops, idx_h, us, vs, res_h, mesh)
    launches["scale_serve"] = scale_serve_phase(core, ops, g, idx_h, us, vs, res_h,
                                                lanes["general"][:chunk], mesh)
    gc.collect()
    torch.cuda.empty_cache()
    for path, names in (("spg_serve_step", ("sketch_batch", "hybrid_relay")),
                        ("stream", ("sketch_batch", "hybrid_relay")),
                        ("replicas", ("sketch_batch", "hybrid_relay")),
                        ("update", ("hybrid_relay",)),
                        ("sharded", ("sketch_batch",)),
                        ("mesh_service", ("sketch_batch", "hybrid_relay")),
                        ("scale_serve", ("sketch_batch",))):
        for name, count in launches[path].items():
            if (name in names) != (count > 0):
                raise AssertionError(f"kernel {name} was launched {count} times "
                                     f"on the {path} path")

    clock("oracle and baselines start")
    sample = np.concatenate([rng.choice(lanes["general"], size=5, replace=False),
                             lanes["landmark_pair"][:1], lanes["one_sided"][:1],
                             lanes["trivial"][:1]])
    t0 = time.perf_counter()
    want = bfs_oracle(g, [(int(us[i]), int(vs[i])) for i in sample], INF)
    for i, (d, eids) in zip(sample, want):
        r = res_h[i]
        if r.dist != d or not np.array_equal(r.edge_ids, eids):
            raise AssertionError(f"query ({r.u}, {r.v}) disagrees with the "
                                 f"BFS oracle: dist {r.dist} vs {d}")
    log(f"scipy BFS oracle agrees on {sample.size} queries "
        f"({time.perf_counter() - t0:.1f} s)")

    # phase 6: the baselines on the card (and PPL on the host)
    baselines(core, g, us, vs, lanes["general"][:chunk], res_h,
              [(int(us[i]), int(vs[i]), d, eids) for i, (d, eids)
               in zip(sample[:2], want[:2])])

    clock("CLI starts")
    # phase 7: the serving CLI, in process, on the card
    from repro_torch.launch import serve
    for graph, backend, extra in (("ba", "hybrid", ["--replicas", "2",
                                                    "--metrics-port", "0"]),
                                  ("cliques", "csr", []),
                                  ("ba", "sharded", ["--shards", "1"])):
        t0 = time.perf_counter()
        serve.main(["--graph", graph, "--n", "20000", "--landmarks", "20",
                    "--queries", "200", *extra]
                   + ([] if backend == "sharded" else ["--backend", backend]))
        log(f"[cli] {graph} on {backend}: {time.perf_counter() - t0:.1f} s")

    # the LM serving path (no kernel of the port's runs there)
    clock("lm starts")
    launches["lm"] = lm_phase(ops)
    if any(launches["lm"].values()):
        raise AssertionError(f"the LM path launched {launches['lm']}")

    # the LM training path (no kernel of the port's runs there either)
    clock("train starts")
    launches["train"] = train_phase(ops)
    if any(launches["train"].values()):
        raise AssertionError(f"the training path launched {launches['train']}")

    clock("results")
    # phase 8: results
    kernels = []
    for name, main_path in (("minplus", "sketch_oracle"),
                            ("sketch_batch", "hybrid"),
                            ("hybrid_relay", "hybrid"),
                            ("bitmap_expand_packed", "dense_oracle"),
                            ("bitmap_expand", "dense_oracle")):
        row = rows[name]
        kernels.append({**row, "launches": launches[main_path][name],
                        "launches_by_path": {p: c[name] for p, c in launches.items()}})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0

if __name__ == "__main__":
    sys.exit(main())
