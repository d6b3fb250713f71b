"""The port's partition-spec rules (``repro_torch.models.registry``) against
the reference's (``repro.models.registry``) on all ten configs at full
size, after ``sanitize_pspecs``, on both production meshes: every
parameter spec (the reference's stacked layer leaves expanded to the
port's per-layer names, the stack dims dropped), every batch spec of the
train and prefill shapes, and every decode-cache spec (bf16 and int8 KV;
``long_500k`` where the reference runs it).  The reference side is
``jax.eval_shape`` in this process (``repro.models`` does not touch
``XLA_FLAGS``); the port's side is meta tensors.  Exact equality."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

import repro.models as jm  # noqa: E402
from repro.configs import ARCHS, get_config as jget  # noqa: E402
from helpers.torch_dryrun import (  # noqa: E402
    check_param_specs,
    check_tree_specs,
    port_leaves,
    ref_cache_path,
)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed.sharding import leaves  # noqa: E402
from repro_torch.models import (  # noqa: E402
    SHAPES,
    batch_pspecs,
    build_model,
    cache_pspecs,
    cell_applicable,
    input_specs,
    param_pspecs,
    sanitize_pspecs,
)

MESHES = {
    "single": ({"data": 16, "model": 16}, ("data",)),
    "multi": ({"pod": 2, "data": 16, "model": 16}, ("pod", "data")),
}


def _key(entry):
    for attr in ("key", "idx", "name"):
        if hasattr(entry, attr):
            return getattr(entry, attr)
    raise TypeError(entry)


def ref_leaves(tree, is_spec=True) -> list:
    """``(path, leaf)`` of a reference tree, its specs as tuples."""
    leaves, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=(lambda x: isinstance(x, JP)) if is_spec else None)
    return [(tuple(_key(e) for e in path), tuple(x) if is_spec else x)
            for path, x in leaves]


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_specs_equal_reference(arch):
    cfg, jcfg = get_config(arch), jget(arch)
    jmodel = jm.build_model(jcfg)
    jparams = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0)))
    params = dict(build_model(cfg, device="meta").named_parameters())
    n_cache = 0
    for axis_sizes, dpx in MESHES.values():
        check_param_specs(cfg, ref_leaves(jm.sanitize_pspecs(
            jm.param_pspecs(jcfg, jparams), jparams, axis_sizes)),
            sanitize_pspecs(param_pspecs(cfg, params), params, axis_sizes))
        for shape in SHAPES.values():
            if not cell_applicable(cfg, shape)[0]:
                continue
            if shape.kind != "decode":
                jb = jm.input_specs(jcfg, shape)["batch"]
                tb = input_specs(cfg, shape)["batch"]
                assert {k: tuple(v.shape) for k, v in tb.items()} == \
                    {k: tuple(v.shape) for k, v in jb.items()}
                check_tree_specs(
                    ref_leaves(jm.sanitize_pspecs(jm.batch_pspecs(jcfg, jb, dpx),
                                                  jb, axis_sizes)),
                    sanitize_pspecs(batch_pspecs(cfg, tb, dpx), tb, axis_sizes))
                continue
            for kv_quant in (False, True):
                jc = jm.input_specs(jcfg, shape, kv_quant=kv_quant)["cache"]
                tc = input_specs(cfg, shape, kv_quant=kv_quant)["cache"]
                got = sanitize_pspecs(cache_pspecs(cfg, tc, dpx), tc, axis_sizes)
                check_tree_specs(
                    ref_leaves(jm.sanitize_pspecs(jm.cache_pspecs(jcfg, jc, dpx),
                                                  jc, axis_sizes)), got, cache=True)
                # each port leaf is the reference's with the stack dims dropped
                jshapes = dict(ref_leaves(jc, is_spec=False))
                for path, t in leaves(tc):
                    ref = jshapes[ref_cache_path(path)].shape
                    assert tuple(ref[len(ref) - t.dim():]) == tuple(t.shape), path
                n_cache += len(port_leaves(got))
    if not cfg.encoder_only:
        assert n_cache > 0
