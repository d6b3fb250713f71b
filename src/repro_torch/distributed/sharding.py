"""Mesh-axis conventions shared by the dry run, launchers and tests, in
PyTorch.  Counterpart of ``repro.distributed.sharding``.

single-pod:  (data=16, model=16)                 256 devices
multi-pod:   (pod=2, data=16, model=16)          512 devices

DP = pod x data; TP/EP/state-sharding = model; SP variants shard sequence
over data for long-context serving.

``P`` stands in for ``jax.sharding.PartitionSpec``: one entry per tensor
dimension, each ``None`` (replicated), an axis name, or a tuple of axis
names (the dimension cut over the product of their sizes, the first axis
major).  A spec tree has the shape of the tree it describes (nested dicts,
lists and tuples, as the port's parameter dicts and decode caches are),
with a ``P`` at every tensor.  ``shard_tree`` cuts tensors by their specs
into one block per shard of a ``core.mesh.NamedMesh``.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Sequence

import torch

from ..core.graph import resolve_device
from ..core.mesh import NamedMesh, resolve_mesh


class P(tuple):
    """A partition spec: ``P("model", None)`` cuts dimension 0 over the
    ``model`` axis and keeps dimension 1 whole.  A one-axis tuple entry is
    that axis (``P(("data",))`` is ``P("data")``), as JAX's
    ``PartitionSpec`` holds it."""

    def __new__(cls, *dims):
        return super().__new__(cls, (d[0] if type(d) is tuple and len(d) == 1
                                     else d for d in dims))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


class NamedSharding(NamedTuple):
    mesh: NamedMesh
    spec: P


def is_node(x) -> bool:
    """A branch of a tree: a dict, a list, or a tuple that is not a ``P``."""
    return isinstance(x, (dict, list)) or type(x) is tuple


def tree_map(fn: Callable, tree, *rest, path: tuple = ()):
    """``fn(path, leaf, *leaves of rest)`` at every leaf of ``tree`` (the
    other trees share its structure); ``path`` holds the dict keys and list
    indices from the root.  ``None`` leaves stay ``None``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest), path=path + (k,))
                for k, v in tree.items()}
    if is_node(tree):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest), path=path + (i,))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(path, tree, *rest)


def leaves(tree, path: tuple = ()) -> list[tuple[tuple, Any]]:
    """``(path, leaf)`` for every non-``None`` leaf, in order."""
    out: list = []
    tree_map(lambda p, x: out.append((p, x)), tree, path=path)
    return out


def path_keys(path: tuple) -> list[str]:
    """The names along a path: dict keys, each cut at its dots (a
    ``named_parameters()`` name is one dotted key), without the layer
    indices."""
    out = []
    for k in path:
        if isinstance(k, str):
            out.extend(part for part in k.split(".") if not part.isdigit())
    return out


def axis_product(entry, axis_sizes: dict[str, int]) -> int:
    """How many blocks one spec entry cuts its dimension into."""
    if entry is None:
        return 1
    n = 1
    for a in ((entry,) if isinstance(entry, str) else tuple(entry)):
        n *= axis_sizes.get(a, 1)
    return n


def shard_numel(shape: Sequence[int], spec: P, axis_sizes: dict[str, int]) -> int:
    """Elements of one shard's block of a tensor of ``shape`` under ``spec``
    (the spec divides every dimension it cuts; ``sanitize_pspecs`` sees to
    that).  A spec longer than the shape spells leading dimensions that the
    port holds as list indices, as ``zero1``'s layer-stack cut does: each
    layer's tensor is then 1/n of that stack's shards' share."""
    n = 1
    for d in shape:
        n *= int(d)
    for entry in spec:
        n //= axis_product(entry, axis_sizes)
    return n


def dp_axes_of(mesh: NamedMesh) -> tuple[str, ...]:
    names = tuple(mesh.axis_names)
    return tuple(n for n in names if n != "model") or (names[0],)


def named(mesh: NamedMesh, spec: P) -> NamedSharding:
    return NamedSharding(mesh, spec)


def _block(x: torch.Tensor, spec: P, mesh: NamedMesh, s: int) -> torch.Tensor:
    if len(spec) != x.dim():
        raise ValueError(f"a spec of {len(spec)} entries for a {x.dim()}-d tensor")
    at = mesh.coords(s)
    index = []
    for dim, entry in zip(x.shape, spec):
        if entry is None:
            index.append(slice(None))
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        n, i = 1, 0
        for a in axes:                       # the first axis major
            n *= mesh.shape[a]
            i = i * mesh.shape[a] + at[a]
        if dim % n:
            raise ValueError(f"a dimension of {dim} does not split over {axes}")
        index.append(slice(i * (dim // n), (i + 1) * (dim // n)))
    return x[tuple(index)].to(mesh.devices[s], copy=True)


def shard_tree(mesh: NamedMesh, tree, spec_tree):
    """Every tensor of ``tree`` cut by its spec into one block per shard:
    the leaf becomes a list of ``mesh.n_shards`` tensors, block ``s`` on
    ``mesh.devices[s]`` (a fresh copy)."""
    return tree_map(lambda _, x, spec: [_block(x, spec, mesh, s)
                                        for s in range(mesh.n_shards)],
                    tree, spec_tree)


def local_mesh(n: int = 1, names=("data", "model"), *, device=None) -> NamedMesh:
    """``n`` devices on the first axis, every other axis of size 1: the
    first ``n`` CUDA devices, or ``n`` shards of ``device`` when one is
    named (``device="cpu"`` on the host)."""
    devs = (resolve_mesh(n).devices if device is None
            else [resolve_device(device)] * n)
    return NamedMesh(devs, names, (n,) + (1,) * (len(names) - 1))
