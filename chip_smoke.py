"""Smoke run of the PyTorch/CUDA port on one GPU: build the kernels, hold
each against its plain PyTorch version, drive the main path
(``QbSIndex.build`` -> ``query_batch``) at full size, check the answers.

    python3 chip_smoke.py                      # 1.1 M-vertex BA graph, R = 20
    python3 chip_smoke.py --n-vertices 100000  # a quicker rehearsal

Phases (each raises on failure; nothing is caught):

1. the card's ``name, power.limit`` and the CUDA version;
2. build the kernels (one ``nvcc`` per source, in parallel);
3. each kernel against its plain version on the card, exact equality,
   with kernel / plain / library-call times (median of 30 timed runs);
4. the main path: ``barabasi_albert_graph(1_100_000, 3, seed=0)``,
   ``QbSIndex.build(backend="hybrid")`` and ``query_batch`` on every lane,
   then the same with ``backend="segment"``, which must give the same tables
   and answers; the launch counters are set to 0 just before each backend's
   run and read just after (hybrid must launch both kernels, segment
   ``minplus`` and no ``bitmap_expand_packed``);
   8 sampled answers against a scipy BFS oracle;
5. the kernels' JSON line, then the device line last.

It imports nothing of JAX or of the JAX package, and exits nonzero without
a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
CUDA_CORE_OPS_PER_S = 67e12  # H100 SXM non-tensor-core peak (float32 rate)


def log(msg: str) -> None:
    print(msg, flush=True)


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / CUDA_CORE_OPS_PER_S * 1e3
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


def rand_dist(rng, shape, dev, inf):
    x = rng.integers(0, 64, size=shape)
    x = np.where(rng.random(shape) < 0.2, inf, x)
    return torch.as_tensor(x, dtype=torch.int32, device=dev)


def measure(name, fns):
    """Wall per call and device time per call of each named callable."""
    out = {k: (time_ms(fn), device_ms(fn)) for k, fn in fns.items()}
    log(f"{name}: equal; " + ", ".join(
        f"{k} {w * 1e3:.1f} us/call ({d * 1e3:.2f} us device)"
        for k, (w, d) in out.items()))
    return {k: d for k, (_, d) in out.items()}


def check_kernels(dev, ref, INF):
    """Phase 3: every kernel against its plain version on the card, exact
    equality; the kernels' JSON rows at the main path's shapes."""
    from repro_torch.core.packing import pack_bits, unpack_bits
    from repro_torch.kernels.frontier import bitmap_expand_packed_cuda
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

    for k, v, n_cols in [(40, 128, 128), (32, 128, 128), (64, 128, 128),
                         (40, 128, 100)]:
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
    return rows


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


def run_backend(core, ops, g, backend, us, vs, n_landmarks, chunk):
    """The main path once: build an index, answer the whole batch."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    idx = core.QbSIndex.build(g, n_landmarks=n_landmarks, backend=backend,
                              chunk=chunk)
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


def time_lanes(idx, ops, us, vs, lanes, chunk):
    """Per-lane serving time and kernel launches per chunk: each lane's
    queries alone through the service (after the main path's count)."""
    svc = idx.make_service()
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
        log(f"[{idx.backend}] lane {name}: {sel.size} queries, {n_chunks} "
            f"chunks, {dt / n_chunks * 1e3:.1f} ms per chunk; kernel launches "
            f"per chunk {per_chunk}")


def breakdown(core, idx, us, vs):
    """Where a general-lane chunk's time goes: host-timed stages (each ends
    in a synchronize), then a torch.profiler trace of one ``serve_step`` for
    the device's busy share and the top kernels by device time."""
    from repro_torch.core import search, sketch
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
        idx.packed.label_dist[us_t.long()], idx.packed.label_dist[vs_t.long()],
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

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        idx.serve_step(us_t, vs_t)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = device_events(prof)
    dev_total = sum(_device_us(e) for e in events)
    log(f"[{idx.backend}] profiled serve_step: wall {wall * 1e3:.1f} ms, device "
        f"busy {dev_total / 1e3:.1f} ms ({dev_total / 1e4 / wall:.1f}% of wall)")
    for e in sorted(events, key=lambda e: -_device_us(e))[:8]:
        log(f"    {_device_us(e) / 1e3:8.2f} ms  x{e.count:<6d} {e.key[:90]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n-vertices", type=int, default=1_100_000)
    ap.add_argument("--n-random", type=int, default=256)
    ap.add_argument("--breakdown", action="store_true",
                    help="also time the general lane's stages on one chunk and "
                         "trace it with torch.profiler")
    args = ap.parse_args()

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

    # phase 3: kernels against their plain versions
    rows = check_kernels(dev, ref, INF)

    # phase 4: the main path
    t0 = time.perf_counter()
    g = core.barabasi_albert_graph(args.n_vertices, 3, seed=0)
    log(f"graph: BA({args.n_vertices}, 3), {g.n_edges} edge slots, "
        f"{time.perf_counter() - t0:.1f} s to generate")
    n_landmarks, chunk = 20, 32
    lms = core.select_landmarks(g, n_landmarks)
    is_lm = np.zeros((g.n_vertices,), bool)
    is_lm[lms] = True
    rng = np.random.default_rng(1)
    us = rng.integers(0, g.n_vertices, size=args.n_random)
    vs = rng.integers(0, g.n_vertices, size=args.n_random)
    non = np.flatnonzero(~is_lm)
    pick = rng.choice(non, size=10, replace=False)
    lm_a, lm_b = rng.choice(lms, size=8), rng.choice(lms, size=8)
    lm_b = np.where(lm_a == lm_b, lms[(np.searchsorted(lms, lm_b) + 1) % n_landmarks], lm_b)
    us = np.concatenate([us, lm_a, pick[:8], pick[8:10]]).astype(np.int32)
    vs = np.concatenate([vs, lm_b, rng.choice(lms, size=8), pick[8:10]]).astype(np.int32)
    n = us.size
    lane = np.full((n,), "general", object)
    lane[(is_lm[us] & is_lm[vs])] = "landmark_pair"
    lane[is_lm[us] ^ is_lm[vs]] = "one_sided"
    lane[us == vs] = "trivial"
    lanes = {k: np.flatnonzero(lane == k) for k in
             ("general", "landmark_pair", "one_sided", "trivial")}
    log("queries: " + ", ".join(f"{k} {v.size}" for k, v in lanes.items()))

    # each path once, with the launch counters set to 0 just before it and
    # read just after: hybrid runs both kernels, segment only minplus
    ops.reset_launches()
    idx_h, res_h = run_backend(core, ops, g, "hybrid", us, vs, n_landmarks, chunk)
    launches = {"hybrid": dict(ops.LAUNCHES)}
    log(f"launches on the hybrid path (build + query_batch): {launches['hybrid']}")
    time_lanes(idx_h, ops, us, vs, lanes, chunk)

    ops.reset_launches()
    idx_s, res_s = run_backend(core, ops, g, "segment", us, vs, n_landmarks, chunk)
    launches["segment"] = dict(ops.LAUNCHES)
    log(f"launches on the segment path (build + query_batch): {launches['segment']}")
    expect = {"hybrid": ("minplus", "bitmap_expand_packed"), "segment": ("minplus",)}
    for path, names in expect.items():
        for name, count in launches[path].items():
            if name in names and count <= 0:
                raise AssertionError(f"kernel {name} was not launched on the {path} path")
            if name not in names and count != 0:
                raise AssertionError(f"kernel {name} was launched {count} times "
                                     f"on the {path} path")
    for f in ("label_dist", "meta_w", "meta_dist", "lid", "is_landmark"):
        if not torch.equal(getattr(idx_h.scheme, f), getattr(idx_s.scheme, f)):
            raise AssertionError(f"backends disagree on scheme.{f}")
    if not all(torch.equal(a, b) for a, b in zip(idx_h.packed, idx_s.packed)):
        raise AssertionError("backends disagree on the packed tables")
    if len(res_h) != n or len(res_s) != n:
        raise AssertionError("query_batch returned the wrong number of answers")
    for a, b in zip(res_h, res_s):
        if a.dist != b.dist or not np.array_equal(a.edge_ids, b.edge_ids):
            raise AssertionError(f"backends disagree on query ({a.u}, {a.v})")
    log(f"hybrid == segment on tables and on all {n} answers")
    time_lanes(idx_s, ops, us, vs, lanes, chunk)
    if args.breakdown:
        first = lanes["general"][:chunk]
        for idx in (idx_h, idx_s):
            breakdown(core, idx, us[first], vs[first])

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

    # phase 5: results
    kernels = []
    for name in ("minplus", "bitmap_expand_packed"):
        row = rows[name]
        kernels.append({**row, "launches": launches["hybrid"][name],
                        "launches_by_path": {p: c[name] for p, c in launches.items()}})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
