"""State carried across from the JAX package: build the port's ``Graph`` and
``QbSIndex`` from plain numpy arrays of the reference's ``Graph`` and
``LabellingScheme`` fields, so the port serves queries on exactly the
labelling the reference built, and the port's LM from the reference's
parameter tree, so both compute with the same weights (and any tree
shaped like it, gradients or AdamW state, by the port's parameter names).
Nothing here imports the reference; the caller hands over numpy arrays
(``np.asarray`` of each field or leaf)."""
from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from .core.graph import Graph, resolve_device
from .core.labelling import LabellingScheme
from .core.qbs import QbSIndex
from .models.registry import Model, build_model

GRAPH_FIELDS = Graph._fields                      # indptr, src, dst
SCHEME_FIELDS = LabellingScheme._fields           # landmarks, lid, is_landmark,
                                                  # label_dist, meta_w, meta_dist


def _fields(arrays: Mapping | Sequence, names: tuple) -> list[np.ndarray]:
    if isinstance(arrays, Mapping):
        return [np.asarray(arrays[n]) for n in names]
    arrays = list(arrays)
    if len(arrays) != len(names):
        raise ValueError(f"expected {len(names)} arrays {names}, got {len(arrays)}")
    return [np.asarray(a) for a in arrays]


def _tensor(a, dtype, dev) -> torch.Tensor:
    # a copy: arrays handed over from JAX are read-only views
    return torch.tensor(np.asarray(a, dtype), device=dev)


def graph_from_numpy(indptr, src, dst, *, device=None) -> Graph:
    """A ``Graph`` on ``device`` (the CUDA card unless named) from the
    reference graph's int32 CSR arrays."""
    dev = resolve_device(device)
    return Graph(*(_tensor(a, np.int32, dev) for a in (indptr, src, dst)))


def scheme_from_numpy(scheme_arrays, *, device=None) -> LabellingScheme:
    """A ``LabellingScheme`` on ``device`` from the reference scheme's arrays
    (a mapping by field name or a sequence in ``SCHEME_FIELDS`` order)."""
    dev = resolve_device(device)
    landmarks, lid, is_lm, label_dist, meta_w, meta_dist = _fields(
        scheme_arrays, SCHEME_FIELDS)
    return LabellingScheme(
        landmarks=_tensor(landmarks, np.int32, dev),
        lid=_tensor(lid, np.int32, dev),
        is_landmark=_tensor(is_lm, bool, dev),
        label_dist=_tensor(label_dist, np.int32, dev),
        meta_w=_tensor(meta_w, np.int32, dev),
        meta_dist=_tensor(meta_dist, np.int32, dev))


def index_from_numpy(graph_arrays, scheme_arrays, *, device=None,
                     backend: str = "segment", n_hubs: int | None = None,
                     chunk: int = 32, max_levels: int = 512,
                     max_chain: int = 512, epoch: int = 0,
                     lm_dist=None) -> QbSIndex:
    """A ``QbSIndex`` on ``device`` over the reference's graph and labelling
    arrays, with the port's relay ``backend`` (``n_hubs`` sizes the hybrid
    hub block).  ``epoch`` and ``lm_dist`` (the reference index's host
    ``(R, V)`` table, ``_lm_dist_host``) carry an updated index across: a
    reference index at epoch k converts to a port index at epoch k."""
    dev = resolve_device(device)
    graph = graph_from_numpy(*_fields(graph_arrays, GRAPH_FIELDS), device=dev)
    scheme = scheme_from_numpy(scheme_arrays, device=dev)
    engine_opts = {} if n_hubs is None else {"n_hubs": n_hubs}
    if lm_dist is not None:
        lm_dist = np.array(lm_dist, np.int32)     # a copy, like _tensor
    return QbSIndex(graph, scheme, backend=backend, engine_opts=engine_opts,
                    chunk=chunk, max_levels=max_levels, max_chain=max_chain,
                    epoch=epoch, lm_dist=lm_dist)


def _leaf_tensor(a) -> torch.Tensor:
    """A numpy leaf as a CPU tensor of the same dtype.  bfloat16 (numpy's
    ``ml_dtypes`` extension type, which ``torch.from_numpy`` refuses)
    crosses bit for bit through its 16-bit view."""
    a = np.array(a)                                # a copy: JAX views are read-only
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _flat(tree: Mapping, prefix: str, out: dict) -> dict:
    for name, val in tree.items():
        if isinstance(val, Mapping):
            _flat(val, f"{prefix}{name}.", out)
        else:
            out[f"{prefix}{name}"] = val
    return out


def _index(tree: Mapping, i) -> dict:
    return {k: _index(v, i) if isinstance(v, Mapping) else np.asarray(v)[i]
            for k, v in tree.items()}


def lm_tree_from_numpy(cfg, tree: Mapping, *, device=None) -> dict[str, torch.Tensor]:
    """Any tree shaped like the reference's parameter tree
    (``models.transformer.init_params``'s dict: the parameters, their
    gradients, AdamW's ``mu`` or ``nu``; leaves as numpy arrays) as
    ``{name: tensor}`` under the port's ``named_parameters()`` names, on
    ``device`` (the CUDA card unless named), each leaf's dtype kept.  The
    reference stacks the blocks' leaves along a leading layer axis
    (``(n_groups, period)`` for the hybrid family); each slice becomes its
    block's entry.  Every parameter must be present with its shape, or it
    raises."""
    dev = resolve_device(device)
    out = _flat({k: v for k, v in tree.items() if k != "blocks"}, "", {})
    if cfg.family == "hybrid":
        n_groups = cfg.n_layers // cfg.hybrid_period
        for i in range(n_groups):
            for j in range(cfg.hybrid_period):
                _flat(_index(tree["blocks"], (i, j)), f"blocks.{i}.{j}.", out)
    else:
        for i in range(cfg.n_layers):
            _flat(_index(tree["blocks"], i), f"blocks.{i}.", out)
    want = {n: tuple(p.shape) for n, p in
            build_model(cfg, device="meta").named_parameters()}
    if set(out) != set(want):
        raise ValueError(f"the tree's leaves {sorted(set(out) - set(want))} have no "
                         f"parameter; parameters {sorted(set(want) - set(out))} "
                         f"have no leaf")
    got = {}
    for name, val in out.items():
        t = _leaf_tensor(val)
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name}: the tree holds {tuple(t.shape)}, the model "
                             f"{want[name]}")
        got[name] = t.to(dev)
    return got


def opt_state_from_numpy(cfg, state: Mapping, *, device=None) -> dict:
    """The reference's AdamW state (``{"mu", "nu", "step"}``, numpy leaves)
    as the port's optimizer state: the moments by parameter name, the step
    an int32 scalar."""
    dev = resolve_device(device)
    return {"mu": lm_tree_from_numpy(cfg, state["mu"], device=dev),
            "nu": lm_tree_from_numpy(cfg, state["nu"], device=dev),
            "step": torch.tensor(np.asarray(state["step"]), dtype=torch.int32,
                                 device=dev)}


def lm_from_numpy(cfg, params: Mapping, *, device=None) -> Model:
    """The port's LM for ``cfg`` on ``device`` (the CUDA card unless named),
    holding exactly the weights of the reference's parameter tree
    (``models.transformer.init_params``'s dict, leaves as numpy arrays),
    through ``lm_tree_from_numpy``.  Every parameter must be filled, with
    the same shape and dtype, or it raises."""
    dev = resolve_device(device)
    tree = lm_tree_from_numpy(cfg, params, device="cpu")
    model = build_model(cfg, device="meta").to_empty(device=dev)
    with torch.no_grad():
        for name, param in model.named_parameters():
            if tree[name].dtype != param.dtype:
                raise ValueError(f"{name}: the tree holds {tree[name].dtype}, the "
                                 f"model {param.dtype}")
            param.copy_(tree[name])
    return model
