"""The dry run (``launch/dryrun.py``) and the modules it needs: the
shape-only init, ``supports_long_context``, ``roofline_terms`` and the
trace mesh's collective counters, against the reference.

- ``init_params(cfg, device="meta")`` has the shapes and dtypes of the
  reference's ``jax.eval_shape(init_params)`` for every arch of
  ``ARCH_NAMES`` at full width (the port's layers unstacked).
- ``supports_long_context`` equals the reference's on every config.
- ``roofline_terms`` equals the reference's dict on the reference's v5e
  constants, and computes on the H100's.
- The sharded training step traced on a (2, 2) trace mesh counts the
  same operand bytes and calls per kind as rank 0 of a real gloo (2, 2)
  mesh running it on the CPU.
- ``main`` writes the reference tests' two cells (``smollm-135m
  train_4k`` on ``--mesh 2,4``, ``decode_32k`` on ``--mesh 2,2,2
  --multi-pod``, ``--devices 8``); the train cell's argument bytes equal
  the reference's shard shapes of its params, opt state and batch on
  conftest's 8-device host mesh; remat "full" holds less temp than
  "none"; a (2, 4) rank does under half the FLOPs of a (1, 1) one;
  ``long_500k`` is skipped where the reference skips it.
- ``--seq-shard`` traces the train cell to ``status: ok`` with the
  reference's keys and less temp per rank than the cell without it;
  zamba2-7b's ``long_500k`` decode (batch 1: the shared attention
  block's cache rows cut over 'data') counts one all-gather of the
  softmax states a shared-block application, the merge a whole-cache
  decode needs.
- ``smollm-135m train_4k`` on ``--mesh 2,4 --no-extrapolate`` runs its
  tied embedding and head on each rank's vocab slice: its argument
  bytes equal the reference's shard shapes, its temp and FLOPs a rank
  fall against the gathered embedding's, and the embedding's all-gather
  is gone from its collectives.
- ``mamba2-2.7b train_4k`` on ``--mesh 2,4 --no-extrapolate`` runs the
  mixer on each rank's heads: its argument bytes equal the reference's
  shard shapes, its temp and FLOPs a rank fall against the gathered
  mixer's; the decode cells of the ssm and hybrid families hold ``h``
  cut as the reference's ``cache_spec`` cuts it.
"""
import functools
import json
import math

import jax
import pytest
import torch
from jax.sharding import NamedSharding

from repro.configs import get_config as ref_get_config
from repro.data.pipeline import input_specs as ref_input_specs
from repro.launch import mesh as ref_mesh_lib
from repro.models import model as ref_model
from repro.optim import adamw as ref_adamw
from repro.parallel import collectives as ref_collectives
from repro.parallel import sharding as ref_shd
from repro_torch.configs import ARCH_NAMES, get_config, shape_by_name
from repro_torch.configs import _ARCH_MODULES
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import model as model_lib
from repro_torch.parallel import collectives
import torch_train_scenarios as ts

STACKS = ("stack", "dense_stack")


# ------------------------------------------------------ shape-only init
def _ref_as_port(tree):
    """The reference's param tree of ShapeDtypeStructs as the port's
    layout of (shape, dtype name): stacked layers unstacked, the hybrid's
    groups and trailing layers too."""
    def leaf(sds, drop=0):
        return (tuple(sds.shape[drop:]), str(sds.dtype))

    def layers(sub, n, drop):
        return [jax.tree_util.tree_map(lambda s: leaf(s, drop), sub)
                for _ in range(n)]

    out = {}
    for key, val in tree.items():
        if key in STACKS:
            n = jax.tree_util.tree_leaves(val)[0].shape[0]
            out[key] = layers(val, n, 1)
        elif key == "hybrid":
            g = jax.tree_util.tree_leaves(val["groups"])[0].shape
            hyb = {"groups": [layers(val["groups"], g[1], 2)
                              for _ in range(g[0])],
                   "shared_attn": jax.tree_util.tree_map(leaf,
                                                         val["shared_attn"])}
            if "trailing" in val:
                n = jax.tree_util.tree_leaves(val["trailing"])[0].shape[0]
                hyb["trailing"] = layers(val["trailing"], n, 1)
            out[key] = hyb
        else:
            out[key] = jax.tree_util.tree_map(leaf, val)
    return out


def _port_shapes(tree):
    if isinstance(tree, dict):
        return {k: _port_shapes(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_port_shapes(v) for v in tree]
    assert tree.device.type == "meta"
    return (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_meta_init_has_reference_shapes_at_full_width(arch):
    want = jax.eval_shape(lambda: ref_model.init_params(
        ref_get_config(arch), jax.random.PRNGKey(0)))
    got = model_lib.init_params(get_config(arch), device="meta")
    assert _port_shapes(got) == _ref_as_port(want)


def test_cpu_init_is_unchanged_by_the_meta_path():
    """The same seed draws the same values on the CPU, and a meta init
    of the same config has the CPU init's shapes and dtypes."""
    cfg = get_config("smollm-135m").reduced()
    a = model_lib.init_params(cfg, seed=3, device="cpu")
    b = model_lib.init_params(cfg, seed=3, device="cpu")
    m = model_lib.init_params(cfg, seed=3, device="meta")
    from repro_torch.models.modules import iter_leaves
    for x, y, z in zip(iter_leaves(a), iter_leaves(b), iter_leaves(m)):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
        assert z.shape == x.shape and z.dtype == x.dtype
    with pytest.raises(ValueError, match="unsupported device"):
        model_lib.init_params(cfg, device="xla")


@pytest.mark.parametrize("arch", sorted(_ARCH_MODULES))
def test_supports_long_context_equals_reference(arch):
    assert (get_config(arch).supports_long_context()
            == ref_get_config(arch).supports_long_context())


# ------------------------------------------------------------- roofline
ROOF_CASES = [
    dict(flops=6.5e14, hbm_bytes=1.2e12, collective_bytes=3.0e9, chips=256),
    dict(flops=1e9, hbm_bytes=5e11, collective_bytes=0.0, chips=8),
    dict(flops=2e12, hbm_bytes=1e9, collective_bytes=4e11, chips=512,
         links_per_chip=4, duplicate_flop_factor=2.0),
]


@pytest.mark.parametrize("case", range(len(ROOF_CASES)))
def test_roofline_terms_equal_reference_on_its_constants(monkeypatch, case):
    monkeypatch.setattr(collectives, "PEAK_FLOPS", ref_collectives.PEAK_FLOPS)
    monkeypatch.setattr(collectives, "HBM_BW", ref_collectives.HBM_BW)
    monkeypatch.setattr(collectives, "NVLINK_BW", ref_collectives.ICI_BW)
    kw = ROOF_CASES[case]
    assert collectives.roofline_terms(**kw) == \
        ref_collectives.roofline_terms(**kw)


def test_roofline_terms_on_the_h100():
    r = collectives.roofline_terms(flops=9.894e14, hbm_bytes=3.35e11,
                                   collective_bytes=2.5e9, chips=8)
    assert r["t_compute"] == 9.894e14 / 989.4e12
    assert r["t_memory"] == pytest.approx(0.1)
    assert r["t_collective"] == pytest.approx(0.1)
    assert r["dominant"] == "compute" and r["t_bound"] == r["t_compute"]


# ------------------------------------------------------- trace counters
COUNT_SPEC = dict(name="count", arch="smollm-135m", B=4, S=16)


def test_trace_mesh_counts_equal_a_real_mesh():
    """The reduced smollm-135m's sharded train step: the dry run's program
    traced on a (2, 2) trace mesh against rank 0 of a gloo (2, 2) mesh
    running the same step on the CPU. The trace also moves no data and
    its FLOPs equal FlopCounterMode's."""
    real = mesh_lib.spawn_mesh(ts.count_rank, (2, 2), (COUNT_SPEC,),
                               axes=("data", "model"), timeout_s=30.0,
                               deadline_s=120.0)[0]
    cfg = ts.scenario_config(COUNT_SPEC)
    shape = ShapeConfig("t", COUNT_SPEC["S"], COUNT_SPEC["B"], "train")
    mesh = mesh_lib.trace_mesh((2, 2), ("data", "model"))
    fn, args = dryrun.build_program(cfg, shape, mesh)
    before = collectives.get_mesh()
    collectives.set_mesh(mesh)
    try:
        out, cost, mem, _ = dryrun.trace(fn, args)
        traced = collectives.stats(mesh)
        fn, args = dryrun.build_program(cfg, shape, mesh)
        from torch.utils.flop_counter import FlopCounterMode
        fc = FlopCounterMode(display=False)
        with fc:
            fn(*args)
    finally:
        collectives.set_mesh(before)
    del traced["seconds"]
    assert real["total"] > 0 and real["counts"]["all-reduce"] > 0
    assert traced == real
    assert all(s == 0.0 for s in collectives.stats(mesh)["seconds"].values())
    assert cost["flops"] == fc.get_total_flops() > 0
    assert mem["temp_size_in_bytes"] > 0
    params, state, _ = out
    assert all(t.device.type == "meta" for t in
               dryrun._tensors((params, state.mu, state.nu)))
    assert state.step.device.type == "cpu" and int(state.step) == 1


def test_mesh_without_groups_or_trace_flag_still_raises():
    from repro_torch.parallel.sharding import Mesh
    with pytest.raises(KeyError):
        collectives.psum(torch.ones(2), "model", Mesh({"model": 2}))


# ----------------------------------------------------------- dry-run cells
def _main(tmp, *flags):
    dryrun.main(list(flags) + ["--out", str(tmp)])


@functools.lru_cache(maxsize=None)
def _cell(arch, shape, mesh, *extra):
    """One cell through ``main``, its JSON (cached for the module)."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        flags = ["--arch", arch, "--shape", shape]
        flags += ["--devices", "8", "--mesh", mesh] if mesh else []
        flags += list(extra)
        _main(tmp, *flags)
        pod = "pod2" if "--multi-pod" in extra else "pod1"
        with open(f"{tmp}/{arch}_{shape}_{pod}.json") as f:
            return json.load(f)


def test_train_cell_single_pod():
    res = _cell("smollm-135m", "train_4k", "2,4", "--no-extrapolate")
    assert res["status"] == "ok"
    assert res["collectives_scanned"]["total"] > 0
    assert res["mesh"] == [2, 4] and res["chips"] == 8
    assert res["extrapolation"] is None
    assert res["roofline_source"] == dryrun.ROOF_SOURCE
    r = res["roofline"]
    assert r["t_bound"] == max(r["t_compute"], r["t_memory"],
                               r["t_collective"]) > 0
    assert res["useful_flop_ratio"] == pytest.approx(
        res["model_flops_per_device"] / res["cost_scanned"]["flops"])


def test_decode_cell_multi_pod_mesh():
    res = _cell("smollm-135m", "decode_32k", "2,2,2", "--no-extrapolate",
                "--multi-pod")
    assert res["status"] == "ok"
    assert res["mesh"] == [2, 2, 2]
    assert res["memory"]["alias_size_in_bytes"] > 0  # caches in place


def _shard_bytes(mesh, sds_tree, spec_tree):
    sds = jax.tree_util.tree_leaves(sds_tree)
    specs = jax.tree_util.tree_leaves(
        spec_tree, is_leaf=lambda s: isinstance(s, (NamedSharding,
                                                    jax.sharding.PartitionSpec)))
    assert len(sds) == len(specs)
    total = 0
    for s, spec in zip(sds, specs):
        sh = spec if isinstance(spec, NamedSharding) else NamedSharding(
            mesh, spec)
        total += math.prod(sh.shard_shape(s.shape)) * s.dtype.itemsize
    return total


def _ref_train_bytes(arch, profile="tp"):
    """The reference's shard bytes of ``arch``'s train_4k params, opt
    state and batch on a (2, 4) mesh of conftest's 8 host devices."""
    cfg = ref_get_config(arch)
    shape = shape_by_name("train_4k")
    mesh = ref_mesh_lib.make_mesh((2, 4), ("data", "model"))
    params = jax.eval_shape(lambda: ref_model.init_params(
        cfg, jax.random.PRNGKey(0)))
    pspecs = ref_shd.param_specs(params, mesh, profile=profile)
    opt = jax.eval_shape(ref_adamw.AdamW(lr=3e-4).init, params)
    oshard = ref_adamw.opt_state_shardings(opt, pspecs, mesh)
    batch = ref_input_specs(cfg, shape)
    bspecs = ref_shd.batch_spec(cfg, shape, mesh, batch, profile=profile)
    return (_shard_bytes(mesh, params, pspecs)
            + _shard_bytes(mesh, opt, oshard)
            + _shard_bytes(mesh, batch, bspecs))


@pytest.mark.parametrize("profile", ["tp", "dp"])
def test_train_cell_argument_bytes_equal_reference_shard_shapes(cpu_mesh,
                                                               profile):
    """Under 'dp' every param is whole and the batch is cut over every
    axis: the plan then runs no block tensor-parallel."""
    extra = ("--no-extrapolate",) if profile == "tp" else (
        "--profile", "dp")
    res = _cell("smollm-135m", "train_4k", "2,4", *extra)
    assert res["status"] == "ok"
    want = _ref_train_bytes("smollm-135m", profile)
    assert res["memory"]["argument_size_in_bytes"] == want


# The same cell with every model rank computing all 80 heads of the
# gathered mixer (the tree before the mixer ran tensor-parallel).
MAMBA2_GATHERED = dict(temp=24994940239896, flops=9550096005857280.0)


def test_mamba2_train_cell_runs_each_ranks_heads(cpu_mesh):
    """mamba2-2.7b train_4k on (2, 4): the argument bytes equal the
    reference's shard shapes (the stored slices are unchanged); a rank's
    temp falls below the gathered mixer's 24994940239896 B and its FLOPs
    under 0.4 of that mixer's 9.550096005857280e15 (a rank's heads need
    2836 of in_proj's 10576 columns: ~0.3 reckoned)."""
    res = _cell("mamba2-2.7b", "train_4k", "2,4", "--no-extrapolate")
    assert res["status"] == "ok"
    assert (res["memory"]["argument_size_in_bytes"]
            == _ref_train_bytes("mamba2-2.7b"))
    assert res["memory"]["temp_size_in_bytes"] < MAMBA2_GATHERED["temp"]
    assert res["cost_scanned"]["flops"] < 0.4 * MAMBA2_GATHERED["flops"]
    assert res["collectives_scanned"]["counts"]["reduce-scatter"] > 0


# The same cell with every model rank reading the embedding whole (the
# tree before the vocab ran cut): its temp and FLOPs a rank, and its
# all-gathers (each layer's 4 attention leaves, 2 KV heads over 4 ranks,
# and the embedding's bf16 slice of 12288 x 576).
SMOLLM_GATHERED = dict(temp=8068820237848, flops=680477438509056.0,
                       all_gather=27426816, all_gather_calls=121)


def test_smollm_train_cell_runs_the_vocab_cut(cpu_mesh):
    """smollm-135m train_4k on (2, 4): the argument bytes equal the
    reference's shard shapes (the stored slices are unchanged); a rank's
    temp and FLOPs fall below those of the cell that gathered the tied
    embedding whole, and its all-gathers lose exactly that gather."""
    res = _cell("smollm-135m", "train_4k", "2,4", "--no-extrapolate")
    assert res["status"] == "ok"
    assert (res["memory"]["argument_size_in_bytes"]
            == _ref_train_bytes("smollm-135m"))
    assert res["memory"]["temp_size_in_bytes"] < SMOLLM_GATHERED["temp"]
    assert res["cost_scanned"]["flops"] < SMOLLM_GATHERED["flops"]
    cfg = get_config("smollm-135m")
    c = res["collectives_scanned"]
    assert c["counts"]["all-gather"] == SMOLLM_GATHERED["all_gather_calls"] - 1
    assert c["all-gather"] == (SMOLLM_GATHERED["all_gather"]
                               - cfg.vocab_size // 4 * cfg.d_model * 2)


def _port_h_bytes(caches):
    """Bytes of the ssm state leaves ``h`` of a port cache tree."""
    total = []
    dryrun._zip_map(lambda path, leaf, _: total.append(
        leaf.numel() * leaf.element_size() if path[-1] == "h" else 0),
        caches, caches)
    return sum(total)


def _ref_h_bytes(mesh, caches, specs):
    """Bytes of one rank's shards of the ``h`` leaves of a reference
    cache tree under its spec tree."""
    flat = jax.tree_util.tree_flatten_with_path(caches)[0]
    sflat = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    assert len(flat) == len(sflat)
    return sum(math.prod(NamedSharding(mesh, spec).shard_shape(leaf.shape))
               * leaf.dtype.itemsize for (path, leaf), spec in zip(flat, sflat)
               if ref_shd._leaf_name(path).split("/")[-1] == "h")


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-7b"])
def test_decode_cell_cuts_h_as_cache_spec(cpu_mesh, arch):
    """decode_32k on (2, 4): the rank's ssm states, as the dry run lays
    them out, hold the bytes of the reference's ``cache_spec`` shard
    (batch over 'data', heads over 'model')."""
    shape = shape_by_name("decode_32k")
    tmesh = mesh_lib.trace_mesh((2, 4), ("data", "model"))
    _, args = dryrun.build_program(get_config(arch), shape, tmesh)
    got = _port_h_bytes(args[2])
    cfg = ref_get_config(arch)
    mesh = ref_mesh_lib.make_mesh((2, 4), ("data", "model"))
    caches = jax.eval_shape(lambda: ref_model.init_caches(
        cfg, shape.global_batch, shape.seq_len))
    specs = ref_shd.cache_spec(cfg, shape, mesh, caches)
    want = _ref_h_bytes(mesh, caches, specs)
    s = cfg.ssm
    whole = (cfg.num_layers * shape.global_batch * s.expand * cfg.d_model
             // s.head_dim * s.d_state * s.head_dim * 4)
    assert got == want == whole // 8


def test_remat_full_holds_less_temp_than_none():
    none = _cell("smollm-135m", "train_4k", "2,4", "--no-extrapolate")
    full = _cell("smollm-135m", "train_4k", "2,4", "--remat", "full")
    assert full["status"] == "ok"
    assert (full["memory"]["temp_size_in_bytes"]
            < none["memory"]["temp_size_in_bytes"])
    assert (full["memory"]["argument_size_in_bytes"]
            == none["memory"]["argument_size_in_bytes"])


def test_a_sharded_rank_does_under_half_the_flops_of_one():
    one = _cell("smollm-135m", "train_4k", "1,1")
    eight = _cell("smollm-135m", "train_4k", "2,4", "--no-extrapolate")
    assert eight["cost_scanned"]["flops"] < 0.5 * one["cost_scanned"]["flops"]
    assert one["collectives_scanned"]["total"] == 0


def test_long_context_cells():
    skipped = _cell("smollm-135m", "long_500k", None)
    assert skipped["status"] == "skipped"
    traced = _cell("mamba2-2.7b", "long_500k", None)
    assert traced["status"] == "ok" and traced["mesh"] == [16, 16]


def test_devices_must_cover_the_mesh(tmp_path):
    with pytest.raises(SystemExit):
        _main(tmp_path, "--arch", "smollm-135m", "--shape", "decode_32k",
              "--devices", "8")
    res = json.load(open(tmp_path / "smollm-135m_decode_32k_pod1.json"))
    assert res["status"] == "error" and "256 devices" in res["error"]


REF_KEYS = ("arch", "shape", "status", "mesh", "chips", "multi_pod",
            "lower_s", "compile_s", "memory", "cost_scanned",
            "collectives_scanned", "roofline", "roofline_source",
            "roofline_inputs", "extrapolation", "model_flops",
            "model_flops_per_device", "useful_flop_ratio", "params_active",
            "params_total")


def test_seq_shard_train_cell():
    res = _cell("smollm-135m", "train_4k", "2,4", "--no-extrapolate",
                "--seq-shard")
    assert res["status"] == "ok"
    assert tuple(res) == REF_KEYS
    assert res["mesh"] == [2, 4] and res["chips"] == 8
    counts = res["collectives_scanned"]["counts"]
    assert counts["reduce-scatter"] > 0 and counts["all-gather"] > 0


def test_seq_shard_holds_less_temp_per_rank():
    none = _cell("smollm-135m", "train_4k", "2,4", "--no-extrapolate")
    sp = _cell("smollm-135m", "train_4k", "2,4", "--no-extrapolate",
               "--seq-shard")
    assert (sp["memory"]["temp_size_in_bytes"]
            < none["memory"]["temp_size_in_bytes"])
    assert (sp["memory"]["argument_size_in_bytes"]
            == none["memory"]["argument_size_in_bytes"])
    assert sp["cost_scanned"]["flops"] == none["cost_scanned"]["flops"]


def test_long_context_decode_counts_the_row_merge(monkeypatch):
    """zamba2-7b ``long_500k`` on the (16, 16) production mesh: against
    the same trace with the caches' row cut hidden from the plan (each
    rank then attends over its own rows only), one more all-gather an
    application of the shared block, of the (m, l, acc) state of this
    rank's heads in f32."""
    kw = dict(multi_pod=False, mesh_override=None, remat=None, zero1=False,
              print_hlo=False, profile="tp", devices=512)
    merged = dryrun._cell("zamba2-7b", "long_500k", **kw)
    monkeypatch.setattr(dryrun, "_row_axes", lambda caches, specs: ())
    alone = dryrun._cell("zamba2-7b", "long_500k", **kw)
    assert merged["status"] == alone["status"] == "ok"
    cfg = get_config("zamba2-7b")
    n_super = cfg.num_layers // cfg.attn_every
    M = merged["mesh"][-1]
    kv, g = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads
    if cfg.num_heads % M == 0 and kv % M == 0:
        kv //= M  # tensor-parallel heads
    state = kv * g * (2 + cfg.resolved_head_dim) * 4
    a, b = merged["collectives_scanned"], alone["collectives_scanned"]
    assert a["counts"]["all-gather"] - b["counts"]["all-gather"] == n_super
    assert a["all-gather"] - b["all-gather"] == n_super * state
    for kind in ("all-reduce", "reduce-scatter", "collective-permute"):
        assert a["counts"][kind] == b["counts"][kind]
