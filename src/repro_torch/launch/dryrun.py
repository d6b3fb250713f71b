"""The production-mesh dry run of the port: every cell of the reference's
grid, laid out on the (16, 16) and (2, 16, 16) meshes and traced on the
meta device.  Counterpart of ``repro.launch.dryrun``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --cells all --mesh both

The reference lowers and compiles each cell with XLA for 512 forced host
devices and reads the compiled program's cost and memory analyses.  The
port has no compiler and no SPMD partitioner: it runs one real step of its
own code on the meta device (shapes and dtypes only, nothing allocated)
under ``hlo_stats.CostCounter``, and lays the step's arguments out by the
reference's partition specs (``models.registry``).  A cell's JSON, written
to ``results/dryrun_torch/<cell>.json``, holds:

LM cells (``lm__<arch>__<shape>__<mesh>[__<variant>]``)

* ``memory.argument_bytes``: the bytes one device holds of the step's
  arguments (train: the parameters, AdamW's ``mu``, ``nu`` and ``step``,
  the batch; prefill: the parameters and the batch; decode: the
  parameters, the cache, ``cache_len`` and the tokens), each tensor's
  elements divided by its sanitized spec's axis sizes, times its itemsize.
  An input the step never reads is no argument, as XLA drops it: the
  attention-free (rwkv6) decode's ``cache_len``.  Exact: it equals XLA's
  ``argument_size_in_bytes`` of the reference's compiled step on the same
  mesh.
* ``flops_global``, ``bytes_accessed_global``, ``transcendentals_global``:
  the counter's totals over the whole step (every layer traced; there is
  no scan body to extrapolate from, so no ``depth_extrapolated``).
* ``flops``, ``bytes_accessed``, ``transcendentals``: those totals divided
  by ``n_devices``, an even split: the port partitions no program, so this
  is what each device would do if the work divided perfectly.
* ``collectives``: bytes per device by kind, from ``lm_collectives``'s
  rule over the specs: a model of the layout, not a trace of a compiled
  program.
* ``temp_bytes``, ``compile_s``, ``n_hlo_lines``: ``null``; ``why`` says
  why for each.

QbS cells (``qbs-label``, ``qbs-serve``, ``qbs-scale-serve``) at the
paper's graph sizes (``configs.qbs_graphs``)

* ``memory.argument_bytes``: the per-shard bytes of the inputs the
  reference lowers its step with (its ``ShapeDtypeStruct`` lists, the
  pull plan's ``p_pad`` included), less the one the pull step never reads
  (``src``).
* ``collectives``: the bytes per kind that one level of the port's own
  step moves through ``core.mesh``'s collectives, from the shapes of
  ``core.distributed``'s exchanges and ``core.scale_serve``'s phase C.
* ``graph``: V, E (directed slots) and R, as the reference reports them.
* ``flops``: ``null``: the port's QbS loops read a reduced stop flag on
  the host every level, so they do not trace on the meta device.

Cells are skipped exactly where the reference skips them
(``models.config.cell_applicable``); a cell that raises is recorded with
its error and the run goes on (the exit code counts the failures).
"""
from __future__ import annotations

import argparse
import functools
import json
import math
import time
import traceback
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

from ..configs import ARCHS, get_config
from ..configs.qbs_graphs import GRAPHS, GraphScale
from ..core.mesh import NamedMesh
from ..distributed.sharding import P, axis_product, leaves, shard_numel, tree_map
from ..models import (
    SHAPES,
    ShapeCell,
    batch_pspecs,
    build_model,
    cache_pspecs,
    cell_applicable,
    input_specs,
    param_pspecs,
    sanitize_pspecs,
)
from ..models.config import ModelConfig
from ..models.registry import row_parallel
from ..serving.serve_step import make_decode_step, make_prefill_step
from ..training import adamw, make_train_step, warmup_cosine
from .hlo_stats import CostCounter
from .mesh import dp_axes, make_production_mesh

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"

WHY_NULL = {
    "temp_bytes": "the port compiles no program, so there is no buffer "
                  "assignment to read temporaries from",
    "compile_s": "nothing is compiled: the step is traced on the meta device",
    "n_hlo_lines": "the port emits no HLO",
}


def _param_count(cfg) -> tuple[float, float]:
    """(total params, active params) analytically from the config (a copy
    of the reference's ``benchmarks.roofline._param_count``)."""
    d, f, v, l = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.n_layers
    hd = cfg.hd
    attn = d * hd * (cfg.n_heads + 2 * cfg.n_kv_heads) + cfg.n_heads * hd * d
    if cfg.family == "ssm":  # rwkv6: 4 d^2 timemix + d*f*2 + d^2 channelmix
        per_layer = 5 * d * d + 2 * d * f
        total = l * per_layer + 2 * v * d
        return total, total
    mlp = 3 * d * f
    if cfg.moe_experts:
        dense_part = attn
        expert_part = cfg.moe_experts * mlp
        active_part = cfg.moe_top_k * mlp
        total = l * (dense_part + expert_part) + 2 * v * d
        active = l * (dense_part + active_part) + 2 * v * d
        return total, active
    if cfg.family == "hybrid":
        d_in = d * cfg.ssm_expand
        n = cfg.ssm_state
        heads = cfg.ssm_heads or max(1, d_in // 64)
        mamba = d * (2 * d_in + 2 * n * heads + heads) + d_in * d
        shared = 2 * d * d + attn + mlp + d * d
        total = l * mamba + shared + 2 * v * d
        return total, total
    total = l * (attn + mlp) + 2 * v * d
    return total, total


# ---------------------------------------------------------------------------
# argument bytes
# ---------------------------------------------------------------------------

def argument_bytes(pairs, axis_sizes: dict[str, int]) -> int:
    """Per-device bytes of ``(tree, spec tree)`` pairs: each tensor's
    elements under its spec (``sharding.shard_numel``) times its itemsize."""
    total = 0
    for tree, specs in pairs:
        for path, t in leaves(tree):
            spec = _at(specs, path)
            total += shard_numel(t.shape, spec, axis_sizes) * t.element_size()
    return total


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------

def layer_stack(cfg: ModelConfig, name: str) -> tuple[int, ...]:
    """The reference's leading layer-stack dims of a parameter, which the
    port holds as list indices: (n_layers,) for a block's parameter,
    (n_groups, period) for a hybrid core layer's, () otherwise."""
    if not name.startswith("blocks."):
        return ()
    if cfg.family == "hybrid":
        return (cfg.n_layers // cfg.hybrid_period, cfg.hybrid_period)
    return (cfg.n_layers,)


def zero1_pspecs(cfg: ModelConfig, pspec: dict, params: dict, dpx, dp_total: int) -> dict:
    """ZeRO-1: each optimizer moment cut over the DP axes on the first
    dimension they divide (parameters stay TP-sharded and DP-replicated).
    As in the reference, the layer-stack dims come first: where the stack
    takes the cut, the spec spells the stack dims before the tensor's own
    (``sharding.shard_numel`` reads such a spec: each DP group then holds
    1/dp of the layers' moments)."""
    out = {}
    for name, spec in pspec.items():
        stack = layer_stack(cfg, name)
        dims = [None] * len(stack) + list(spec)
        shape = stack + tuple(params[name].shape)
        out[name] = spec
        for i, d in enumerate(dims):
            if d is None and shape[i] % dp_total == 0:
                dims[i] = dpx
                out[name] = P(*(dims if i < len(stack) else dims[len(stack):]))
                break
    return out


def kv_relayout(c_spec, cache, dpx, kv_layout: str):
    """The decode KV layout study: ``"seq"`` cuts the cache's sequence over
    the otherwise idle model axis; ``"rep"`` replicates it over model."""
    def relayout(path, spec, leaf):
        nd = leaf.dim()
        if nd >= 4 and "model" in [d for d in spec if isinstance(d, str)]:
            if kv_layout == "seq":
                return P(*([None] * (nd - 4) + [dpx, "model", None, None]))
            return P(*([None] * (nd - 4) + [dpx, None, None, None]))
        return spec

    return tree_map(relayout, c_spec, cache)


def sp_cache_pspecs(cfg, cache, dpx):
    """Sequence-parallel cache specs for batch-1 long-context decode."""

    def rule(path, leaf):
        keys = [k for k in path if isinstance(k, str)]
        nd = leaf.dim()
        name = keys[-1] if keys else ""
        if name in {"shift", "cm", "conv"}:
            return P(*([None] * (nd - 3) + [None, None, "model"]))
        if nd >= 4 and name in {"wkv", "ssm"}:
            return P(*([None] * (nd - 4) + [None, "model", None, None]))
        if nd >= 4 and name == "scale":
            return P(*([None] * (nd - 4) + [None, dpx, None, None]))
        if nd >= 4:  # KV (B, S, Hkv, hd): shard S over DP axes
            return P(*([None] * (nd - 4) + [None, dpx, None, "model"]))
        return P(*([None] * nd))

    return tree_map(rule, cache)


def _adamw():
    return adamw(warmup_cosine(3e-4, 2000, 100_000))


def lm_layout(cfg: ModelConfig, shape: ShapeCell, mesh: NamedMesh, *,
              kv_quant: bool = False, zero1: bool = False,
              kv_layout: str = "hd") -> dict:
    """The step's arguments (meta tensors) and their sanitized specs, as
    the reference lays them out: ``{"args": [(tree, specs), ...], "params",
    "pspec", "mom_spec", "act_spec"}``, and ``"c_spec"`` for decode."""
    dpx = dp_axes(mesh)
    dp_total = int(np.prod([mesh.shape[a] for a in dpx]))
    axis_sizes = dict(mesh.shape)
    params = dict(_meta_model(cfg).named_parameters())
    pspec = sanitize_pspecs(param_pspecs(cfg, params), params, axis_sizes)
    specs = input_specs(cfg, shape, kv_quant=kv_quant)
    out = {"params": params, "pspec": pspec, "mom_spec": None}
    if shape.kind == "train":
        opt_state = _adamw().init(params)
        mom_spec = zero1_pspecs(cfg, pspec, params, dpx, dp_total) if zero1 else pspec
        opt_spec = {"mu": mom_spec, "nu": mom_spec, "step": P()}
        b_spec = sanitize_pspecs(batch_pspecs(cfg, specs["batch"], dpx),
                                 specs["batch"], axis_sizes)
        out.update(mom_spec=mom_spec,
                   args=[(params, pspec), (opt_state, opt_spec),
                         (specs["batch"], b_spec)],
                   act_spec=next(iter(b_spec.values())))
    elif shape.kind == "prefill":
        b_spec = sanitize_pspecs(batch_pspecs(cfg, specs["batch"], dpx),
                                 specs["batch"], axis_sizes)
        out.update(args=[(params, pspec), (specs["batch"], b_spec)],
                   act_spec=next(iter(b_spec.values())))
    else:
        if shape.global_batch % dp_total == 0:
            c_spec = cache_pspecs(cfg, specs["cache"], dpx)
            if kv_layout != "hd":
                c_spec = kv_relayout(c_spec, specs["cache"], dpx, kv_layout)
            t_spec = P(dpx, None)
        else:
            # SP fallback (long_500k, B=1): replicate batch, shard the cache
            # sequence dim over the DP axes
            c_spec = sp_cache_pspecs(cfg, specs["cache"], dpx)
            t_spec = P(None, None)
        c_spec = sanitize_pspecs(c_spec, specs["cache"], axis_sizes)
        args = [(params, pspec), (specs["cache"], c_spec), (specs["tokens"], t_spec)]
        if not cfg.attention_free:
            # an attention-free decode never reads cache_len, and an input
            # the step does not read is no argument (XLA drops it)
            args.insert(2, (specs["cache_len"], P()))
        out.update(args=args, c_spec=c_spec, act_spec=t_spec)
    return out


@functools.lru_cache(maxsize=2)
def _meta_model(cfg: ModelConfig):
    return build_model(cfg, device="meta")


@functools.lru_cache(maxsize=64)
def trace_step(cfg: ModelConfig, shape: ShapeCell, *, kv_quant: bool = False,
               microbatches: int = 1) -> dict:
    """One real step of the port on meta tensors under ``CostCounter``:
    its totals, the trace's wall seconds, and the bytes of the row-parallel
    matmuls' outputs (forward) and incoming gradients (backward) by
    parameter name.  The trace does not depend on the mesh, so a process
    traces each (config, shape, variant) once and every caller shares the
    returned dict (read it, do not change it)."""
    model = _meta_model(cfg)
    params = dict(model.named_parameters())
    track = {n: p for n, p in params.items() if row_parallel(n)}
    specs = input_specs(cfg, shape, kv_quant=kv_quant)
    opt = _adamw()
    opt_state = opt.init(params) if shape.kind == "train" else None
    t0 = time.perf_counter()
    with CostCounter(track) as c:
        if shape.kind == "train":
            step = make_train_step(model, opt, microbatches=microbatches)
            step(model, opt_state, specs["batch"])
        elif shape.kind == "prefill":
            make_prefill_step(model)(specs["batch"])
        else:
            # the port's decode takes cache_len as an int: a full cache
            make_decode_step(model)(specs["cache"], shape.seq_len - 1, specs["tokens"])
    return {**c.totals(), "trace_s": time.perf_counter() - t0,
            "row_outputs": dict(c.row_outputs), "row_grads": dict(c.row_grads)}


def lm_collectives(kind: str, layout: dict, trace: dict, axis_sizes: dict,
                   dp_total: int, *, seq_shard: str = "") -> dict:
    """Per-device collective bytes by kind, by this rule over the specs (a
    model of the layout, not a trace of a compiled program):

    * tensor parallel (Megatron's pair): every forward matmul of a
      row-parallel weight (``registry.row_parallel``, its input dimension
      cut over ``model`` after sanitizing) leaves a partial sum that is
      all-reduced over ``model``: its output's bytes on one device (the
      batch cut by the activations' DP spec).  In backward, each such
      matmul's incoming gradient (the same size) is all-reduced once more:
      the gradient entering the block's column-parallel projections.
      Recomputed forwards count again.  Under ``seq_shard="sp"`` each of
      these is a reduce-scatter over ``model`` (1/tp of it) and an
      all-gather (all of it), Megatron-SP's pair.
    * data parallel (train): each parameter's gradient, its shard under the
      parameter spec in the parameter dtype, is all-reduced over the DP
      axes; under ``zero1`` a parameter whose moments are cut is instead
      reduce-scattered to the moment spec and its update all-gathered back
      to the parameter spec.

    Not modelled: the MoE's expert-parallel all-to-alls, the attention's
    partial sums over a KV cache cut on ``head_dim``, and whatever else a
    partitioner would insert."""
    out: dict = {}
    counts: dict = {}

    def add(k, nbytes):
        if nbytes:
            out[k] = out.get(k, 0) + int(nbytes)
            counts[k] = counts.get(k, 0) + 1

    tp = axis_sizes.get("model", 1)
    act = axis_product(layout["act_spec"][0], axis_sizes)
    pspec = layout["pspec"]
    for source in ("row_outputs", "row_grads"):
        for name, sizes in trace[source].items():
            # the weight's input dimension cut over model: a partial sum
            if tp == 1 or axis_product(pspec[name][0], {"model": tp}) == 1:
                continue
            for nbytes in sizes:
                local = nbytes // act
                if seq_shard == "sp":
                    add("reduce-scatter", local // tp)
                    add("all-gather", local)
                else:
                    add("all-reduce", local)
    if kind == "train" and dp_total > 1:
        mom = layout["mom_spec"]
        for name, p in layout["params"].items():
            local = shard_numel(p.shape, pspec[name], axis_sizes) * p.element_size()
            if mom[name] != pspec[name]:
                add("reduce-scatter",
                    shard_numel(p.shape, mom[name], axis_sizes) * p.element_size())
                add("all-gather", local)
            else:
                add("all-reduce", local)
    out["_counts"] = counts
    return out


def lm_cell(arch, shape, mesh: NamedMesh, *, remat: bool = False,
            kv_quant: bool = False, zero1: bool = False, moe_sort: bool = False,
            moe_group: bool = False, flash: bool = False, seq_shard: str = "",
            microbatches: int = 1, kv_layout: str = "hd") -> dict:
    """One LM cell: ``arch`` a config name or a ``ModelConfig``, ``shape`` a
    ``SHAPES`` name or a ``ShapeCell``."""
    cfg = get_config(arch) if isinstance(arch, str) else arch
    if moe_sort:
        cfg = replace(cfg, moe_dispatch="sort", moe_ep_anchor=True)
    if moe_group:
        cfg = replace(cfg, moe_group_size=1024)
    if flash:
        cfg = replace(cfg, attn_impl="chunked")
    if remat:
        cfg = replace(cfg, remat_policy="layer")  # per-layer remat
    if seq_shard == "dp":      # anchor activations to DP-only sharding
        cfg = replace(cfg, act_spec=(tuple(dp_axes(mesh)), None, None))
    elif seq_shard == "sp":    # Megatron-SP: sequence sharded over model
        cfg = replace(cfg, act_spec=(tuple(dp_axes(mesh)), "model", None))
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    ok, why = cell_applicable(cfg, shape)
    if not ok:
        return {"skipped": why}

    axis_sizes = dict(mesh.shape)
    dp_total = int(np.prod([mesh.shape[a] for a in dp_axes(mesh)]))
    n_dev = mesh.n_shards
    trace = trace_step(cfg, shape, kv_quant=kv_quant, microbatches=microbatches)
    layout = lm_layout(cfg, shape, mesh, kv_quant=kv_quant, zero1=zero1,
                       kv_layout=kv_layout)
    return {
        "flops": trace["flops"] / n_dev,
        "bytes_accessed": trace["bytes_accessed"] / n_dev,
        "transcendentals": trace["transcendentals"] / n_dev,
        "flops_global": trace["flops"],
        "bytes_accessed_global": trace["bytes_accessed"],
        "transcendentals_global": trace["transcendentals"],
        "memory": {"argument_bytes": argument_bytes(layout["args"], axis_sizes),
                   "temp_bytes": None},
        "collectives": lm_collectives(shape.kind, layout, trace, axis_sizes,
                                      dp_total, seq_shard=seq_shard),
        "compile_s": None,
        "n_hlo_lines": None,
        "why": WHY_NULL,
        "trace_s": round(trace["trace_s"], 3),
        "n_ops": trace["n_ops"],
        "n_devices": n_dev,
        "variant": {"remat": remat, "kv_quant": kv_quant, "zero1": zero1,
                    "moe_sort": moe_sort, "moe_group": moe_group, "flash": flash,
                    "seq_shard": seq_shard, "microbatches": microbatches,
                    "kv_layout": kv_layout},
    }


# ---------------------------------------------------------------------------
# QbS engine cells (paper-scale labelling + serving)
# ---------------------------------------------------------------------------

I32, I16, BOOL = 4, 2, 1


def _graph(graph) -> GraphScale:
    return GRAPHS[graph] if isinstance(graph, str) else graph


def _graph_info(g: GraphScale) -> dict:
    return {"V": g.n_vertices, "E_directed": g.n_edge_slots, "R": g.n_landmarks}


def _sum_calls(calls) -> dict:
    out: dict = {}
    counts: dict = {}
    for kind, nbytes in calls:
        out[kind] = out.get(kind, 0) + nbytes
        counts[kind] = counts.get(kind, 0) + 1
    out["_counts"] = counts
    return out


def pull_p_pad(e_max: int, n_shards: int) -> int:
    """The pull plan's per-pair list length from the uniform-spread
    estimate (each shard's edge sources spread evenly over the owners), as
    the reference sizes it."""
    return (math.ceil(e_max / n_shards) + 31) // 32 * 32


def labelling_args(frontier_mode: str, n_shards: int, e_max: int, r: int,
                   p_pad: int = 0) -> int:
    """Per-shard argument bytes of the labelling step: the edge blocks
    (src, dst), the shard's ``vstart`` entry and the replicated landmarks;
    ``pull`` adds its plan (the (S, p_pad) send lists, the per-edge word
    and bit) and reads no ``src`` (the plan's word and bit stand in for
    it), and an input the step does not read is no argument (XLA drops
    it)."""
    nbytes = 2 * e_max * I32 + I32 + r * I32
    if frontier_mode == "pull":
        nbytes += n_shards * p_pad * I32 + e_max * I32
    return nbytes


def labelling_level_calls(frontier_mode: str, n_shards: int, r: int, v_loc: int,
                          p_pad: int = 0) -> list[tuple[str, int]]:
    """The collectives of one level of ``core.distributed``'s labelling
    loop, as ``(kind, bytes one shard receives)``: the frontier exchange,
    then the ``psum`` of the int32 stop flag."""
    if frontier_mode == "bool":       # all_gather of (2, R, V_loc) bool
        ex = ("all-gather", n_shards * 2 * r * v_loc * BOOL)
    elif frontier_mode == "bitmap":   # all_gather of (2R, ceil(V_loc/32)) words
        ex = ("all-gather", n_shards * 2 * r * ((v_loc + 31) // 32) * I32)
    else:                             # all_to_all of (S, 2R, p_pad/32) words
        ex = ("all-to-all", n_shards * 2 * r * (p_pad // 32) * I32)
    return [ex, ("all-reduce", I32)]


def qbs_label_cell(graph, mesh: NamedMesh, *, frontier_mode: str = "bitmap") -> dict:
    g = _graph(graph)
    n_shards = mesh.n_shards
    vloc = math.ceil(g.n_vertices / n_shards)
    emax = math.ceil(g.n_edge_slots / n_shards)
    p_pad = pull_p_pad(emax, n_shards) if frontier_mode == "pull" else 0
    calls = labelling_level_calls(frontier_mode, n_shards, g.n_landmarks, vloc, p_pad)
    return {
        "flops": None,
        "why": {"flops": "the port's QbS loops read a reduced stop flag on the "
                         "host every level, so they do not trace on meta"},
        "memory": {"argument_bytes": labelling_args(frontier_mode, n_shards, emax,
                                                    g.n_landmarks, p_pad)},
        "collectives": _sum_calls(calls),
        "collectives_per": "one level of the labelling loop",
        "n_devices": n_shards,
        "variant": {"frontier_mode": frontier_mode, "v_loc": vloc, "e_max": emax,
                    "p_pad": p_pad},
        "graph": _graph_info(g),
    }


def serve_args(n_vertices: int, n_edges: int, r: int, batch: int, n_shards: int) -> int:
    """Per-device argument bytes of the replicated-label serve step: the
    search context (src, dst, the G- edge flags, is_landmark, lid, the
    int32 label table, meta_w, the relay engine's src, dst and mask), the
    scheme's label table and meta pair, and each device's rows of the
    query batch."""
    v, e = n_vertices, n_edges
    ctx = (2 * e * I32 + e * BOOL + v * BOOL + v * I32 + v * r * I32 + r * r * I32
           + 2 * e * I32 + e * BOOL)
    return ctx + v * r * I32 + 2 * r * r * I32 + 2 * (batch // n_shards) * I32


def qbs_serve_cell(graph, mesh: NamedMesh, *, batch: int | None = None) -> dict:
    """Replicated-label batched serving (graphs that fit per-device): the
    index replicated, the batch split over every device.  The cell models
    the reference's replicated-label step
    (``repro.core.distributed.make_serve_step``); the port serves on several
    cards through the vertex-sharded index only."""
    g = _graph(graph)
    if batch is None:  # one query per device
        batch = mesh.n_shards
    return {
        "flops": None,
        "why": {"flops": "the port's guided search waits on the host every level, "
                         "so it does not trace on meta",
                "collectives": "each shard searches its own rows against its own "
                               "replica: the step calls no collective"},
        "memory": {"argument_bytes": serve_args(g.n_vertices, g.n_edge_slots,
                                                g.n_landmarks, batch, mesh.n_shards)},
        "collectives": {"_counts": {}},
        "n_devices": mesh.n_shards,
        "variant": {"mode": "replicated-labels", "batch": batch},
        "graph": _graph_info(g),
    }


def scale_serve_args(v_loc: int, e_max: int, r: int, batch: int) -> int:
    """Per-shard argument bytes of the vertex-sharded serve step: the edge
    blocks (src, dst int32), the shard's ``vstart`` entry, its int16 label
    block (v_loc, R) and edge-aligned source labels (E_max, R), and the
    replicated landmarks, meta pair and query batch."""
    return (2 * e_max * I32 + I32 + v_loc * r * I16 + e_max * r * I16 + r * I32
            + 2 * r * r * I32 + 2 * batch * I32)


def scale_serve_level_calls(n_shards: int, v_loc: int, batch: int) -> list[tuple[str, int]]:
    """The collectives of one level of the sketch-bounded Bi-BFS (phase C
    of ``core.sharded.general_lane``, which ``core.scale_serve`` runs), in
    order: the two int64 ``psum``s of the sides' reached counts, the
    ``replicate`` of the chosen sides and depths (``broadcast``), the
    bit-packed frontier's ``all_gather`` (the halo exchange), and three
    int32 ``psum``s (either side still growing; met)."""
    b = batch
    return [("all-reduce", 8 * b), ("all-reduce", 8 * b),
            ("broadcast", b * BOOL), ("broadcast", b * BOOL),
            ("broadcast", b * I32), ("broadcast", b * I32),
            ("all-gather", n_shards * b * ((v_loc + 31) // 32) * I32),
            ("all-reduce", b * I32), ("all-reduce", b * I32),
            ("all-reduce", b * I32)]


def qbs_scale_serve_cell(graph, mesh: NamedMesh, *, batch: int = 32) -> dict:
    """Vertex-sharded serving (labels and state sharded): the layout that
    scales to ClueWeb09 (its labels alone are 68 GB)."""
    g = _graph(graph)
    n_shards = mesh.n_shards
    vloc = math.ceil(g.n_vertices / n_shards)
    emax = math.ceil(g.n_edge_slots / n_shards)
    return {
        "flops": None,
        "why": {"flops": "the port's Bi-BFS reads reduced flags on the host every "
                         "level, so it does not trace on meta"},
        "memory": {"argument_bytes": scale_serve_args(vloc, emax, g.n_landmarks, batch)},
        "collectives": _sum_calls(scale_serve_level_calls(n_shards, vloc, batch)),
        "collectives_per": "one level of the sketch-bounded Bi-BFS (phase C)",
        "n_devices": n_shards,
        "variant": {"mode": "vertex-sharded", "batch": batch, "v_loc": vloc,
                    "e_max": emax},
        "graph": _graph_info(g),
    }


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------

QBS_LABELLING_GRAPHS = ["youtube", "livejournal", "orkut", "twitter",
                        "friendster", "uk2007", "clueweb09"]
QBS_SERVE_GRAPHS = ["youtube", "livejournal", "orkut"]
QBS_SCALE_SERVE_GRAPHS = ["twitter", "clueweb09"]


def run_cell(kind: str, key: str, shape: str, mesh_name: str, *,
             force: bool = False, results: Path = RESULTS, **kw) -> tuple[str, dict]:
    variant = kw.pop("variant_tag", "")
    name = f"{kind}__{key}__{shape}__{mesh_name}" + (f"__{variant}" if variant else "")
    results = Path(results)
    out = results / f"{name}.json"
    if out.exists() and not force:
        prior = json.loads(out.read_text())
        if "error" not in prior:  # re-attempt recorded failures
            return name, prior
    mesh = make_production_mesh(multi_pod=(mesh_name == "multi"))
    try:
        if kind == "lm":
            stats = lm_cell(key, shape, mesh, **kw)
        elif kind == "qbs-label":
            stats = qbs_label_cell(key, mesh, **kw)
        elif kind == "qbs-serve":
            stats = qbs_serve_cell(key, mesh, **kw)
        elif kind == "qbs-scale-serve":
            stats = qbs_scale_serve_cell(key, mesh, **kw)
        else:
            raise ValueError(kind)
    except Exception as e:  # noqa: BLE001 — record failures, they are bugs
        stats = {"error": repr(e), "traceback": traceback.format_exc()[-4000:]}
    results.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(stats, indent=1))
    status = "SKIP" if "skipped" in stats else ("FAIL" if "error" in stats else "ok")
    print(f"[dryrun] {name}: {status} (trace {stats.get('trace_s', '-')}s)", flush=True)
    return name, stats


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cells", default="all", choices=["all", "lm", "qbs"])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--results", default=str(RESULTS),
                    help="directory the cells' JSON files go to")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--kv-quant", action="store_true")
    ap.add_argument("--moe-sort", action="store_true")
    ap.add_argument("--moe-group", action="store_true")
    ap.add_argument("--flash", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--qbs-frontier", default="", choices=["", "bool", "bitmap", "pull"])
    ap.add_argument("--zero1", action="store_true")
    ap.add_argument("--kv-layout", default="hd", choices=["hd", "seq", "rep"])
    ap.add_argument("--seq-shard", default="", choices=["", "dp", "sp"])
    args = ap.parse_args(argv)

    meshes = {"single": ["single"], "multi": ["multi"],
              "both": ["single", "multi"]}[args.mesh]
    variant_tag = ""
    kw: dict = {}
    if args.remat:
        kw["remat"] = True
        variant_tag += "remat"
    if args.kv_quant:
        kw["kv_quant"] = True
        variant_tag += "kvq"
    if args.moe_sort:
        kw["moe_sort"] = True
        variant_tag += "moesort"
    if args.moe_group:
        kw["moe_group"] = True
        variant_tag += "moegroup"
    if args.flash:
        kw["flash"] = True
        variant_tag += "flash"
    if args.microbatches > 1:
        kw["microbatches"] = args.microbatches
        variant_tag += f"mb{args.microbatches}"
    if args.seq_shard:
        kw["seq_shard"] = args.seq_shard
        variant_tag += f"act{args.seq_shard}"
    if args.zero1:
        kw["zero1"] = True
        variant_tag += "zero1"
    if args.kv_layout != "hd":
        kw["kv_layout"] = args.kv_layout
        variant_tag += f"kv{args.kv_layout}"

    results = Path(args.results)
    tally = {"ok": 0, "skipped": 0, "failed": 0}

    def note(stats):
        tally["failed" if "error" in stats else
              "skipped" if "skipped" in stats else "ok"] += 1

    t0 = time.perf_counter()
    if args.cells in ("all", "lm"):
        archs = [args.arch] if args.arch else sorted(ARCHS)
        shapes = [args.shape] if args.shape else list(SHAPES)
        for mesh_name in meshes:
            for arch in archs:
                for shape in shapes:
                    note(run_cell("lm", arch, shape, mesh_name, force=args.force,
                                  results=results, variant_tag=variant_tag, **kw)[1])
    if args.cells in ("all", "qbs"):
        qkw = {}
        qtag = ""
        if args.qbs_frontier:
            qkw["frontier_mode"] = args.qbs_frontier
            qtag = args.qbs_frontier
        for mesh_name in meshes:
            for gname in QBS_LABELLING_GRAPHS:
                note(run_cell("qbs-label", gname, "label", mesh_name, force=args.force,
                              results=results, variant_tag=qtag, **qkw)[1])
            for gname in QBS_SERVE_GRAPHS:
                note(run_cell("qbs-serve", gname, "serve", mesh_name, force=args.force,
                              results=results)[1])
            for gname in QBS_SCALE_SERVE_GRAPHS:
                note(run_cell("qbs-scale-serve", gname, "serve", mesh_name,
                              force=args.force, results=results)[1])
    print(f"[dryrun] done; ok={tally['ok']} skipped={tally['skipped']} "
          f"failures={tally['failed']} in {time.perf_counter() - t0:.1f} s", flush=True)
    return 1 if tally["failed"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
