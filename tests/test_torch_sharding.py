"""The port's sharding rules against the reference's ``PartitionSpec``s.

Every rule of ``repro_torch/parallel/sharding.py`` is a pure function of
leaf names and shapes, so the reference's own trees (shapes from
``jax.eval_shape``, no allocation) go through both: every config in the
registry, on the meshes (1, 8), (2, 4), (4, 2) and (8, 1) of conftest's
forced 8-device CPU host, for ``param_specs`` (both profiles),
``batch_spec``, ``cache_spec`` and the serving rules, errors included.
``shard_params`` and the :class:`Mesh` grid are checked on the port's
own tensors.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import shape_by_name
from repro.launch import mesh as ref_mesh_lib
from repro.models import model as ref_model
from repro.parallel import sharding as ref_shd
from repro_torch.configs import get_config
from repro_torch.configs import _ARCH_MODULES
from repro_torch.models import model as model_lib
from repro_torch.parallel import sharding as shd

ALL_CONFIGS = tuple(_ARCH_MODULES)
MESHES = ((1, 8), (2, 4), (4, 2), (8, 1))
SHAPES = ("train_4k", "decode_32k", "long_500k")


def _ref_mesh(shape, cpu_mesh):
    return ref_mesh_lib.make_mesh(shape, ("data", "model"))


def _port_mesh(shape):
    return shd.Mesh(dict(zip(("data", "model"), shape)))


def _flat(tree):
    """{leaf name: leaf} of a tree of tensors."""
    out = {}

    def rec(path, leaf):
        out[shd._leaf_name(path)] = leaf

    shd.tree_map_with_path(rec, tree)
    return out


def _norm(spec):
    """A spec with every one-name tuple written as the name: the two mean
    the same sharding, and the reference's PartitionSpec prints
    ('data',) as 'data'."""
    return tuple(a[0] if isinstance(a, tuple) and len(a) == 1 else a
                 for a in spec)


def _ref_flat(specs, values):
    out = {}

    def rec(path, leaf, spec):
        out[ref_shd._leaf_name(path)] = _norm(spec)

    jax.tree_util.tree_map_with_path(rec, values, specs)
    return out


def _port_flat(specs, values):
    """{leaf name: spec tuple} of a port spec tree, paired with its value
    tree's leaves in order (a spec is itself a tuple, so the walk follows
    the value tree's structure)."""
    names, leaves = [], []
    shd.tree_map_with_path(lambda p, x: names.append(shd._leaf_name(p)),
                           values)

    def collect(spec, v):
        if isinstance(v, dict):
            for k in v:
                collect(spec[k], v[k])
        elif isinstance(v, tuple) and hasattr(v, "_fields"):
            for f in v._fields:
                collect(getattr(spec, f), getattr(v, f))
        elif isinstance(v, (list, tuple)):
            for s, x in zip(spec, v):
                collect(s, x)
        else:
            leaves.append(_norm(spec))

    collect(specs, values)
    return dict(zip(names, leaves))


@pytest.fixture(scope="module")
def ref_params():
    return {a: jax.eval_shape(lambda k, a=a: ref_model.init_params(
        ref_get_config(a), k), jax.random.PRNGKey(0)) for a in ALL_CONFIGS}


@pytest.mark.parametrize("mesh_shape", MESHES)
def test_param_specs_equal_reference(cpu_mesh, ref_params, mesh_shape):
    """Both profiles' specs, leaf by leaf, for every config."""
    rm, pm = _ref_mesh(mesh_shape, cpu_mesh), _port_mesh(mesh_shape)
    for arch, sds in ref_params.items():
        for profile in ("tp", "dp"):
            want = _ref_flat(ref_shd.param_specs(sds, rm, profile), sds)
            got = _port_flat(shd.param_specs(sds, pm, profile), sds)
            assert got == want, (arch, profile, mesh_shape)
        # The rules' EP and TP branches both fire somewhere in the suite.
    assert pm.shape == dict(rm.shape)


@pytest.mark.parametrize("mesh_shape", MESHES)
def test_batch_and_cache_specs_equal_reference(cpu_mesh, mesh_shape):
    rm, pm = _ref_mesh(mesh_shape, cpu_mesh), _port_mesh(mesh_shape)
    for arch in ALL_CONFIGS:
        cfg = ref_get_config(arch)
        if cfg.family not in ("dense", "moe", "ssm", "hybrid", "vlm",
                              "audio"):
            continue
        for name in SHAPES:
            shape = shape_by_name(name)
            caches = jax.eval_shape(lambda: ref_model.init_caches(
                cfg, shape.global_batch, min(shape.seq_len, 4096)))
            want = _ref_flat(ref_shd.cache_spec(cfg, shape, rm, caches),
                             caches)
            got = _port_flat(shd.cache_spec(get_config(arch), shape, pm,
                                            caches), caches)
            assert got == want, (arch, name, mesh_shape)
            K = cfg.num_codebooks if cfg.frontend == "codes" else None
            tok = ((shape.global_batch, K, 8) if K
                   else (shape.global_batch, 8))
            batch = {"tokens": jax.ShapeDtypeStruct(tok, np.int32),
                     "labels": jax.ShapeDtypeStruct((3, 8), np.int32)}
            for profile in ("tp", "dp"):
                want = _ref_flat(ref_shd.batch_spec(
                    cfg, shape, rm, batch, profile), batch)
                got = _port_flat(shd.batch_spec(
                    get_config(arch), shape, pm, batch, profile), batch)
                assert got == want, (arch, name, profile, mesh_shape)


@pytest.mark.parametrize("mesh_shape", MESHES)
def test_serving_rules_equal_reference(cpu_mesh, ref_params, mesh_shape):
    """serve_local_config, serve_param_specs (strict errors included) and
    both serving cache spec trees, for every config."""
    rm, pm = _ref_mesh(mesh_shape, cpu_mesh), _port_mesh(mesh_shape)
    tp = mesh_shape[1]
    for arch, sds in ref_params.items():
        rcfg, pcfg = ref_get_config(arch), get_config(arch)
        try:
            want_cfg = ref_shd.serve_local_config(rcfg, tp)
        except ValueError as e:
            with pytest.raises(ValueError) as got_e:
                shd.serve_local_config(pcfg, tp)
            assert str(got_e.value) == str(e)
        else:
            got_cfg = shd.serve_local_config(pcfg, tp)
            for f in ("num_heads", "num_kv_heads", "d_ff", "tp_axis"):
                assert getattr(got_cfg, f) == getattr(want_cfg, f)
            assert pcfg.tp_axis is None
            # The port pins the head dim (the reference leaves an unset
            # one to d_model // num_heads, tp times too wide on a shard).
            assert got_cfg.resolved_head_dim == pcfg.resolved_head_dim
        try:
            want = _ref_flat(ref_shd.serve_param_specs(sds, rm), sds)
        except ValueError as e:
            with pytest.raises(ValueError) as got_e:
                shd.serve_param_specs(sds, pm)
            assert str(got_e.value) == str(e)
        else:
            assert _port_flat(shd.serve_param_specs(sds, pm), sds) == want
        for fn in ("serve_paged_cache_specs", "serve_prefill_cache_specs"):
            want_t = getattr(ref_shd, fn)(rcfg)["stack"]
            got_t = getattr(shd, fn)(pcfg)["stack"]
            assert got_t._fields == want_t._fields
            for f in want_t._fields:
                assert getattr(got_t, f) == tuple(getattr(want_t, f)), (
                    arch, fn, f)


def test_small_rules_equal_reference(cpu_mesh):
    """_div at edges, odd dims falling back or raising, as the
    reference's smoke tests pin them."""
    rm, pm = _ref_mesh((2, 4), cpu_mesh), _port_mesh((2, 4))
    for dim in (0, 7, 8, 12):
        for axis in ("data", "model", "pod"):
            assert shd._div(dim, pm, axis) == ref_shd._div(dim, rm, axis)
    odd = jax.ShapeDtypeStruct((2, 64, 127), np.float32)
    for name in ("wq", "w_in", "wo", "scale", "embed", "router", "D"):
        path = (jax.tree_util.DictKey(name),)
        assert shd.param_spec((name,), odd, pm) == tuple(
            ref_shd.param_spec(path, odd, rm))
    with pytest.raises(ValueError, match="serving TP") as e:
        shd.serve_param_spec(("w_in",), odd, pm)
    with pytest.raises(ValueError) as want:
        ref_shd.serve_param_spec((jax.tree_util.DictKey("w_in"),), odd, rm)
    assert str(e.value) == str(want.value)


@pytest.mark.parametrize("mesh_shape", MESHES)
def test_mesh_grid_matches_reference_device_order(cpu_mesh, mesh_shape):
    """Rank r of the port's grid sits where the reference's mesh puts
    device r: rank 0 is (data 0, model 0) and model varies fastest."""
    rm, pm = _ref_mesh(mesh_shape, cpu_mesh), _port_mesh(mesh_shape)
    ids = np.vectorize(lambda d: d.id)(rm.devices)
    np.testing.assert_array_equal(pm.ranks, ids - ids.min())
    for r in range(pm.size):
        c = pm.coords(r)
        assert pm.rank_at(**c) == r
        assert int(ids[c["data"], c["model"]]) - int(ids.min()) == r


@pytest.mark.parametrize("mesh_shape", ((2, 1), (1, 2), (2, 2)))
def test_shard_params_cuts_the_serving_slices(mesh_shape):
    """Every rank's slice of the port's tree is the spec's chunk of the
    full tensor; the model-axis chunks concatenate back to it."""
    cfg = get_config("smollm-135m").reduced()
    params = model_lib.init_params(cfg, seed=0, device="cpu")
    pm = _port_mesh(mesh_shape)
    specs = _port_flat(shd.serve_param_specs(params, pm), params)
    full = _flat(params)
    shards = [_flat(shd.shard_params(params, pm, r)) for r in range(pm.size)]
    tp = mesh_shape[1]
    for name, t in full.items():
        spec = specs[name]
        for r in range(pm.size):
            got = shards[r][name]
            assert got.is_contiguous()
            if "model" not in spec:
                assert torch.equal(got, t)
        if "model" in spec:
            d = spec.index("model")
            cols = [shards[pm.rank_at(data=0, model=j)][name]
                    for j in range(tp)]
            assert torch.equal(torch.cat(cols, dim=d), t), name
            assert cols[0].shape[d] == t.shape[d] // tp
    # A dim that does not divide raises, as serve_param_spec does.
    with pytest.raises(ValueError, match="serving TP"):
        shd.shard_params({"w_in": torch.zeros(4, 7)}, _port_mesh((1, 2)), 1)
    local = shd.serve_local_config(cfg, tp)
    assert (local.num_heads * tp, local.d_ff * tp) == (cfg.num_heads,
                                                       cfg.d_ff)


def test_mesh_rejects_bad_axes():
    with pytest.raises(ValueError, match=">= 1"):
        shd.Mesh({"data": 0, "model": 2})
    m = shd.Mesh({"data": 2, "model": 3})
    assert m.axes_of(("model", "data")) == ("data", "model")
    assert m.group_size("model") == 3 and m.size == 6
    with pytest.raises(ValueError, match="not in mesh"):
        m.axes_of("pod")
    assert dataclasses.replace(m, rank=4).coords() == {"data": 1, "model": 1}


@pytest.mark.parametrize("reduced,tp", [(False, 3), (True, 2)])
def test_serve_local_config_keeps_the_head_dim(reduced, tp):
    """A config whose head dim is left to d_model // num_heads (the full
    smollm-135m; the reduced one with its head dim unset) keeps its head
    dim on a shard: 1/tp of the heads, each as wide as the whole
    model's."""
    cfg = get_config("smollm-135m")
    if reduced:
        cfg = dataclasses.replace(cfg.reduced(), head_dim=0)
    hd = cfg.d_model // cfg.num_heads
    assert not cfg.head_dim and cfg.resolved_head_dim == hd
    local = shd.serve_local_config(cfg, tp)
    assert local.resolved_head_dim == hd
    assert local.num_heads * tp == cfg.num_heads
