"""State carried across from the JAX package: build the port's ``Graph`` and
``QbSIndex`` from plain numpy arrays of the reference's ``Graph`` and
``LabellingScheme`` fields, so the port serves queries on exactly the
labelling the reference built.  Nothing here imports the reference; the
caller hands over numpy arrays (``np.asarray`` of each field)."""
from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from .core.graph import Graph, resolve_device
from .core.labelling import LabellingScheme
from .core.qbs import QbSIndex

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
                     max_chain: int = 512) -> QbSIndex:
    """A ``QbSIndex`` on ``device`` over the reference's graph and labelling
    arrays, with the port's relay ``backend`` (``n_hubs`` sizes the hybrid
    hub block)."""
    dev = resolve_device(device)
    graph = graph_from_numpy(*_fields(graph_arrays, GRAPH_FIELDS), device=dev)
    scheme = scheme_from_numpy(scheme_arrays, device=dev)
    engine_opts = {} if n_hubs is None else {"n_hubs": n_hubs}
    return QbSIndex(graph, scheme, backend=backend, engine_opts=engine_opts,
                    chunk=chunk, max_levels=max_levels, max_chain=max_chain)
