"""Roofline inputs for the production-mesh dry run.  Counterpart of
``repro.launch.hlo_stats``.

``_shape_bytes`` and ``collective_bytes`` are the reference's, as they
are: they parse the text of an XLA HLO module and sum the output-shape
bytes of every collective op, bucketed by kind.  The port compiles no HLO;
they stay so that a reference program's text reads the same in both
packages.

In place of ``summarize_compiled`` (which reads XLA's cost analysis),
``CostCounter`` counts a step as it runs: a ``TorchDispatchMode``, entered
as a context manager around one real step of the port on the meta device
(where every op propagates shapes and dtypes and allocates nothing), and
left on exit.  It sees every aten op the step dispatches, the backward
and any recomputation included, after the decompositions that
``torch.utils.flop_counter.FlopCounterMode`` also takes.  Its totals:

* ``flops``: the matmul-class FLOPs (mm, bmm, addmm, baddbmm, convolution,
  the attention kernels ...), each from the formula that
  ``torch.utils.flop_counter``'s registry holds for its op, so the total
  equals ``FlopCounterMode``'s over the same step on a real device;
* ``bytes_accessed``: the bytes of every tensor operand plus the bytes of
  every tensor result of every aten op that moves memory, each op counted
  as if its operands were read once from memory and its results written
  once: no fusion, no cache.  Views (ops whose schema returns an alias of
  an input: ``view``, ``t``, ``expand``, ``detach``, ``slice`` ...) and
  ``_unsafe_view`` move nothing and count no bytes.  This is the traffic
  of the step run op by op, unfused intermediates included: an estimate
  of what an eager step moves, not a lower bound on the work;
* ``transcendentals``: the elements that pass through one of the
  ``TRANSCENDENTAL`` ops (the exp, log, tanh, sigmoid, rsqrt and erf
  families, ``silu``, the softmaxes and the trig functions RoPE uses):
  each op's result elements, or its input's for the softmaxes;
* ``n_ops``: the aten ops counted.

Some ops have no meta kernel.  ``aten::bincount`` is one (the MoE's
load-balancing loss calls it); its result's length depends on the data
(``max(x) + 1`` or ``minlength``, whichever is larger).  Inside the counter
a meta ``bincount`` with ``minlength`` returns ``minlength`` counts, which
is exact where every value lies below ``minlength``, as the expert
indices of the MoE do; without ``minlength`` it raises.  Outside the
counter nothing changes.

``row_outputs`` records, for the parameters named in ``track``, the bytes
of the output of every forward matmul that takes the parameter as its
weight (recomputation included), and ``row_grads`` the bytes of the
incoming gradient of every backward matmul against its transpose: the dry
run's model of the tensor-parallel all-reduces reads them.
"""
from __future__ import annotations

import re
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16, "f8e4m3fn": 1, "f8e5m2": 1, "s4": 1, "u4": 1,
}

_COLLECTIVES = (
    "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
    "collective-permute",
)

_SHAPE_RE = re.compile(r"(\w+)\[([0-9,]*)\]")


def _shape_bytes(type_str: str) -> int:
    total = 0
    for dt, dims in _SHAPE_RE.findall(type_str):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def collective_bytes(hlo_text: str) -> dict[str, int]:
    """Sum output bytes of every collective instruction, by kind.

    Matches lines like
      ``%x = bf16[8,128]{1,0} all-reduce(%y), replica_groups=...``
      ``%t = (f32[4], f32[4]) all-to-all(...)``
    Excludes `-start/-done` duplicates (counts the -start only).
    """
    out: dict[str, int] = defaultdict(int)
    counts: dict[str, int] = defaultdict(int)
    for line in hlo_text.splitlines():
        s = line.strip()
        if " = " not in s:
            continue
        lhs, rhs = s.split(" = ", 1)
        for kind in _COLLECTIVES:
            # opcode appears immediately after the result type
            m = re.match(r"^((?:\([^)]*\))|(?:[\w\[\],{}: ]+?))\s+" + kind + r"(-start)?\(", rhs)
            if m:
                if f"{kind}-done" in rhs:
                    break
                out[kind] += _shape_bytes(m.group(1))
                counts[kind] += 1
                break
    out_total = dict(out)
    out_total["_counts"] = dict(counts)  # type: ignore[assignment]
    return out_total


# ---------------------------------------------------------------------------
# the cost counter
# ---------------------------------------------------------------------------

aten = torch.ops.aten

TRANSCENDENTAL = {
    aten.exp, aten.exp2, aten.expm1, aten.log, aten.log2, aten.log10,
    aten.log1p, aten.tanh, aten.sigmoid, aten.rsqrt, aten.sqrt, aten.erf,
    aten.erfc, aten.erfinv, aten.silu, aten.silu_backward, aten.gelu,
    aten.sin, aten.cos, aten.pow, aten._softmax, aten._log_softmax,
    aten._foreach_sqrt, aten._foreach_sqrt_, aten._foreach_pow,
}
_BY_INPUT = {aten._softmax, aten._log_softmax, aten._foreach_sqrt_}

# metadata queries that FlopCounterMode hands back untouched
_METADATA = {
    aten.is_contiguous.default, aten.is_contiguous.memory_format,
    aten.is_strides_like_format.default,
    aten.is_non_overlapping_and_dense.default, aten.size.default,
    aten.sym_size.default, aten.stride.default, aten.sym_stride.default,
    aten.storage_offset.default, aten.sym_storage_offset.default,
    aten.numel.default, aten.sym_numel.default, aten.dim.default,
    torch.ops.prim.layout.default,
}
_MATMUL = {aten.mm, aten.addmm, aten.bmm}
# ops that return a tensor over an input's storage without an alias
# annotation in their schema
_NO_COPY = {aten._unsafe_view}


def _tensors(tree) -> list[torch.Tensor]:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class CostCounter(TorchDispatchMode):
    """Counts ``flops``, ``bytes_accessed``, ``transcendentals`` and
    ``n_ops`` over the ops run inside ``with CostCounter() as c:``.
    ``track`` maps parameters (the tensors themselves) to names whose
    matmuls ``row_outputs`` / ``row_grads`` record."""

    def __init__(self, track: dict | None = None):
        super().__init__()
        self.flops = 0
        self.bytes_accessed = 0
        self.transcendentals = 0
        self.n_ops = 0
        self._track = {id(t): (name, t) for name, t in (track or {}).items()}
        self.row_outputs: dict[str, list[int]] = defaultdict(list)
        self.row_grads: dict[str, list[int]] = defaultdict(list)

    def totals(self) -> dict:
        return {"flops": self.flops, "bytes_accessed": self.bytes_accessed,
                "transcendentals": self.transcendentals, "n_ops": self.n_ops}

    def _tracked(self, t) -> tuple[str | None, bool]:
        """``(name, is_view)`` when ``t`` is a tracked parameter or a view of
        one (backward multiplies by the weight's transpose)."""
        for x, view in ((t, False), (getattr(t, "_base", None), True)):
            hit = self._track.get(id(x))
            if hit is not None and hit[1] is x:
                return hit[0], view
        return None, False

    def _record_matmul(self, packet, args, out) -> None:
        name, view = self._tracked(args[2] if packet is aten.addmm else args[1])
        if name is None:
            return
        if view:                             # backward: grad @ w.T
            self.row_grads[name].append(_nbytes(args[0]))
        else:
            self.row_outputs[name].append(_nbytes(out))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _METADATA:
            return NotImplemented
        packet = func._overloadpacket
        # as FlopCounterMode: an op outside the registry that decomposes is
        # counted as its decomposition
        if packet not in flop_registry and func is not torch.ops.prim.device.default:
            with self:
                r = func.decompose(*args, **kwargs)
                if r is not NotImplemented:
                    return r
        if packet is aten.bincount and _on_meta(args):
            out = _meta_bincount(*args, **kwargs)
        else:
            out = func(*args, **kwargs)
        self.n_ops += 1
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if not (func.is_view or packet in _NO_COPY):
            self.bytes_accessed += (sum(_nbytes(t) for t in ins)
                                    + sum(_nbytes(t) for t in outs))
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs, out_val=out))
        if packet in TRANSCENDENTAL:
            src = _tensors(args[0]) if packet in _BY_INPUT else outs
            self.transcendentals += sum(t.numel() for t in src)
        if self._track and packet in _MATMUL:
            self._record_matmul(packet, args, out)
        return out


def _on_meta(args) -> bool:
    return any(t.device.type == "meta" for t in _tensors(args))


def _meta_bincount(x, weights=None, minlength: int = 0):
    if not minlength or weights is not None:
        raise NotImplementedError(
            "bincount on the meta device needs minlength and no weights: its "
            "result's length depends on the data")
    return torch.empty((minlength,), dtype=torch.int64, device="meta")
