"""Sequence parallelism in the port's manual SPMD (``cfg.seq_shard``:
the residual stream cut along the sequence over 'model' between blocks)
and decode over attention caches whose rows are cut over 'data', on
gloo meshes of CPU ranks.

- The sharded training step with ``seq_shard`` equals the single-host
  port (which the reference's tests hold against jax) on (1, 2), (2, 2)
  and (1, 4): loss, aux loss, grad norm, skip counters summed over the
  mesh, gathered gradients and updated params, at
  ``test_torch_train_mesh.py``'s tolerances, for smollm-135m with the
  GLU under ``mode="kernel"`` and relu under ``mode="fused"``,
  deepseek-v3-671b (MLA, expert-parallel MoE), mamba2-2.7b and
  zamba2-7b, all ``reduced()``, f32. On (1, 4) smollm's 2 KV heads do
  not divide, so its attention is a gathered region.
- Prefill under a plan with ``seq_shard`` equals the single host's:
  logits and every cache leaf.
- On the reference's weights, the SP step on (2, 4) equals the
  reference's ``make_train_step`` with ``seq_shard`` jitted on
  conftest's 8 devices as a (1, 2, 4) (pod, data, model) mesh, where its
  constraint of the residual to ``P(("pod", "data"), "model", None)``
  takes hold (on a mesh without 'pod' it raises inside the reference's
  ``constrain`` and is dropped).
- Three mutants of the layout fail those checks.
- On a (2, 4) trace mesh the step swaps each tensor-parallel region's
  all-reduces for a reduce-scatter and an all-gather, counted exactly.
- A sequence that does not divide over 'model' raises.
- Decode over caches whose rows are cut over 2 and 4 data ranks
  (zamba2-7b ``reduced()``, batch 1) equals decode over the whole cache
  on one host, and only the rank owning the new row writes it.

One spawn per mesh runs every scenario; every process group has a
timeout and every spawn a deadline.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding

from repro.configs import get_config as ref_get_config
from repro.configs.base import ShapeConfig as RefShapeConfig
from repro.launch import mesh as ref_mesh_lib
from repro.models import model as ref_model
from repro.optim import adamw as ref_adamw
from repro.parallel import sharding as ref_shd
from repro.runtime import trainer as ref_trainer
from repro_torch.bridge import params_from_reference
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.modules import iter_leaves, tree_map
from repro_torch.parallel import collectives
import torch_sp_scenarios as sps
import torch_train_scenarios as ts
from test_torch_train_mesh import _check

TIMEOUT_S = 30.0  # every process group's
DEADLINE_S = 240.0  # every spawn's
SMALL = dict(block_m=8, block_k=32, block_n=32)
SP = dict(seq_shard=True)

CASES = {
    "glu-kernel": dict(arch="smollm-135m", mask_tail=8, fields=dict(
        SP, sparsity=dict(enabled=True, mode="kernel", **SMALL))),
    "relu-fused": dict(arch="smollm-135m", mask_tail=4, fields=dict(
        SP, mlp_act="relu", sparsity=dict(enabled=True, mode="fused",
                                          **SMALL))),
    "deepseek": dict(arch="deepseek-v3-671b", B=4, S=8, fields=SP),
    "mamba2": dict(arch="mamba2-2.7b", fields=SP),
    "zamba2": dict(arch="zamba2-7b", fields=SP),
}
PREFILL = {
    "smollm": dict(arch="smollm-135m", fields=SP),
    "deepseek": dict(arch="deepseek-v3-671b", B=4, S=8, fields=SP),
    "mamba2": dict(arch="mamba2-2.7b", fields=SP),
    "zamba2": dict(arch="zamba2-7b", fields=SP),
}
PREFILL_ROWS = 24
MESHES = [(1, 2), (2, 2), (1, 4)]
MUTANT_MESH = (1, 4)
MUTANT_SPEC = dict(arch="smollm-135m", B=4, S=16, fields=SP)
# Decode: a 13-token prompt in 32 rows, then 6 steps writing rows 13-18:
# across the 16-row edge on 2 data ranks, and the 8- and 16-row edges on 4.
DECODE = dict(name="decode", kind="decode", arch="zamba2-7b", S=13,
              rows=32, steps=6)
DECODE_MESHES = {2: (2, 2), 4: (4, 1)}
PRIMS_MESH = (1, 2)


def _scenarios(shape):
    out = [dict(CASES[n], name=n, kind="train") for n in sorted(CASES)]
    out += [dict(PREFILL[n], name=f"prefill-{n}", kind="prefill",
                 rows=PREFILL_ROWS) for n in sorted(PREFILL)]
    if shape == MUTANT_MESH:
        out += [dict(MUTANT_SPEC, name=f"mutant-{m}", kind="train",
                     sp_mutant=m) for m in [None] + sorted(sps.SP_MUTANTS)]
    if shape in DECODE_MESHES.values():
        out.append(DECODE)
    if shape == PRIMS_MESH:
        out.append(dict(name="prims", kind="prims", device="cpu"))
    return out


@functools.lru_cache(maxsize=None)
def _mesh_run(shape):
    specs = _scenarios(shape)
    outs = mesh_lib.spawn_mesh(sps.sp_rank, shape, (specs,),
                               axes=("data", "model"), timeout_s=TIMEOUT_S,
                               deadline_s=DEADLINE_S)
    return {s["name"]: [rank[i] for rank in outs]
            for i, s in enumerate(specs)}


def test_sp_primitives_forward_and_backward():
    """The four primitives over 'model' on 2 ranks against numpy: each
    output and the gradient of sum(out * cot), and their collectives
    (the all-gathers and reduce-scatters each way)."""
    ranks = _mesh_run(PRIMS_MESH)["prims"]
    shard, whole, cot_whole, cot_shard = sps.prim_inputs(2)
    half = sps.PRIM_SHAPE[1] // 2

    def mine(a, r):
        return a[:, r * half:(r + 1) * half]

    gathered = np.concatenate(list(shard), axis=1)
    for r, got in enumerate(ranks):
        want = {
            "seq_split": (mine(whole[r], r),
                          np.concatenate(list(cot_shard), axis=1)),
            "seq_gather": (gathered, mine(cot_whole[r], r)),
            "sp_open": (gathered, mine(cot_whole.sum(0), r)),
            "sp_close": (mine(whole.sum(0), r),
                         np.concatenate(list(cot_shard), axis=1)),
        }
        for name, (y, g) in want.items():
            np.testing.assert_allclose(got[name][0], y, rtol=1e-6,
                                       atol=1e-6, err_msg=name)
            np.testing.assert_allclose(got[name][1], g, rtol=1e-6,
                                       atol=1e-6, err_msg=name)
        counts = got["stats"]["counts"]
        assert counts["all-gather"] == 4 and counts["reduce-scatter"] == 2
        assert counts["all-reduce"] == 0


@functools.lru_cache(maxsize=None)
def _single(name):
    return ts.run_single(dict(CASES[name], name=name))


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
def test_sp_step_matches_single_host(shape, case):
    ranks = _mesh_run(shape)[case]
    single = _single(case)
    _check(single, ranks[0], case)
    assert ranks[0]["skip"] == single["skip"]  # summed over the mesh
    if case in ("glu-kernel", "relu-fused"):
        assert single["skip"][1] > 0
    counts = ranks[0]["stats"]["counts"]
    # Every tensor-parallel region closes with a reduce-scatter, the ssm
    # family's mixer among them.
    assert counts["reduce-scatter"] > 0, counts
    for r, res in enumerate(ranks):
        assert res["digest"] == ranks[r % shape[-1]]["digest"], (case, r)


@functools.lru_cache(maxsize=None)
def _prefill_single(name):
    return sps.run_prefill(dict(PREFILL[name], name=name, rows=PREFILL_ROWS))


@pytest.mark.parametrize("name", sorted(PREFILL))
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
def test_sp_prefill_matches_single_host(shape, name):
    got = _mesh_run(shape)[f"prefill-{name}"][0]
    want = _prefill_single(name)
    scale = float(np.abs(want["logits"]).max())
    np.testing.assert_allclose(got["logits"], want["logits"], rtol=2e-4,
                               atol=2e-6 * scale)
    assert len(got["caches"]) == len(want["caches"])
    for i, (a, b) in enumerate(zip(got["caches"], want["caches"])):
        assert a.shape == b.shape, (name, i)
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-6 * max(
            float(np.abs(b).max()), 1e-30), err_msg=f"{name} cache {i}")
    assert got["stats"]["counts"]["all-gather"] > 0


def test_sp_step_matches_reference_seq_shard_step(cpu_mesh):
    """``smollm-135m.reduced()`` with ``seq_shard`` on (2, 4), 8 rows of
    32 tokens (8 a model rank; its 2 KV heads do not divide 4, so
    attention is a gathered region and the MLP tensor-parallel), on the
    reference's weights: against the single-host port, and against the
    reference's ``make_train_step`` with ``seq_shard`` under the
    planner's shardings on conftest's 8 devices as a (1, 2, 4) mesh, at
    the reference's tolerances (loss rtol 1e-4, grad norm rtol 1e-3).
    The reference's residual constraint must be in its lowered step."""
    ref_cfg = dataclasses.replace(
        ref_get_config("smollm-135m").reduced(), seq_shard=True)
    ref_params = ref_model.init_params(ref_cfg, jax.random.PRNGKey(0))
    weights = [p.numpy() for p in iter_leaves(params_from_reference(
        jax.tree_util.tree_map(np.asarray, ref_params), device="cpu"))]
    spec = dict(name="ref-sp", arch="smollm-135m", B=8, S=32, fields=SP)
    full = ts.scenario_params(ts.scenario_config(spec), spec)
    it = iter(weights)
    spec["weights"] = tree_map(lambda _: next(it), full)
    got = mesh_lib.spawn_mesh(sps.sp_rank, (2, 4), ([dict(
        spec, kind="train")],), axes=("data", "model"), timeout_s=TIMEOUT_S,
        deadline_s=DEADLINE_S)[0][0]
    _check(ts.run_single(spec), got, "ref-sp")
    assert got["stats"]["counts"]["reduce-scatter"] > 0

    mesh = ref_mesh_lib.make_mesh((1, 2, 4), ("pod", "data", "model"))
    opt = ref_adamw.AdamW(lr=1e-3)
    opt_state = opt.init(ref_params)
    batch = {k: jnp.asarray(v) for k, v in ts.scenario_batch(
        get_config("smollm-135m").reduced(), spec).items()}
    shape = RefShapeConfig("t", seq_len=32, global_batch=8, kind="train")
    pspecs = ref_shd.param_specs(ref_params, mesh)

    def ns(t):
        return jax.tree_util.tree_map(lambda s: NamedSharding(mesh, s), t)
    oshard = ref_adamw.opt_state_shardings(opt_state, pspecs, mesh)
    bshard = ns(ref_shd.batch_spec(ref_cfg, shape, mesh, batch))
    constraints = {}
    with mesh:
        for flag in (False, True):
            step = jax.jit(ref_trainer.make_train_step(
                dataclasses.replace(ref_cfg, seq_shard=flag), opt),
                in_shardings=(ns(pspecs), oshard, bshard),
                out_shardings=(ns(pspecs), oshard, None))
            lowered = step.lower(ref_params, opt_state, batch)
            constraints[flag] = lowered.as_text().count("sharding_constraint")
        _, _, m = step(ref_params, opt_state, batch)
    assert constraints[True] > constraints[False], constraints
    assert got["loss"] == pytest.approx(float(m["loss"]), rel=1e-4)
    assert got["grad_norm"] == pytest.approx(float(m["grad_norm"]), rel=1e-3)


@pytest.mark.parametrize("mutant", sorted(sps.SP_MUTANTS))
def test_sp_mutants_fail_the_parity_checks(mutant):
    """A region computed alike opened as a tensor-parallel one and closed
    by a plain slice, a norm whose scale gradient is not summed over
    'model', and seq_split as a plain slice each break the step the
    unbroken layout passes (on (1, 4): a gathered attention, a
    tensor-parallel MLP)."""
    runs = _mesh_run(MUTANT_MESH)
    single = ts.run_single(dict(MUTANT_SPEC, name="single"))
    _check(single, runs["mutant-None"][0], "unbroken")
    with pytest.raises(AssertionError):
        _check(single, runs[f"mutant-{mutant}"][0], mutant)


def _trace_counts(cfg, shape, mesh):
    fn, args = dryrun.build_program(cfg, shape, mesh)
    before = collectives.get_mesh()
    collectives.set_mesh(mesh)
    try:
        dryrun.trace(fn, args)
    finally:
        collectives.set_mesh(before)
    return collectives.stats(mesh)["counts"]


def test_trace_mesh_swaps_all_reduces_for_reduce_scatter_and_all_gather():
    """smollm-135m ``reduced()`` on a (2, 4) trace mesh: its MLP is
    tensor-parallel (d_ff 128), its attention gathered (2 KV heads). Per
    layer the MLP's open and close each trade an all-reduce (the close's
    forward, the open's backward) for a reduce-scatter, and add an
    all-gather (the open's forward, the close's backward); the gathered
    attention adds an all-gather each way, each norm's scale an
    all-reduce, and the stack's two ends an all-gather each. The vocab
    of 256 is cut over the 4 model ranks, so the embedding's partial
    rows close with a reduce-scatter in place of an all-reduce (its
    backward the first end's all-gather)."""
    cfg = ts.scenario_config(dict(arch="smollm-135m"))
    shape = ShapeConfig("t", 16, 4, "train")
    mesh = mesh_lib.trace_mesh((2, 4), ("data", "model"))
    plain = _trace_counts(cfg, shape, mesh)
    mesh = mesh_lib.trace_mesh((2, 4), ("data", "model"))
    sp = _trace_counts(dataclasses.replace(cfg, **SP), shape, mesh)
    L = cfg.num_layers
    closes = opens = L  # the MLP's, one of each a layer
    embed = 1  # the vocab-cut embedding's close
    assert sp["reduce-scatter"] == closes + opens + embed
    assert plain["reduce-scatter"] == 0
    assert sp["all-reduce"] == (plain["all-reduce"] - (closes + opens)
                                + 2 * L - embed)
    assert sp["all-gather"] == (plain["all-gather"] + opens + closes
                                + 2 * L + 2)


def test_sequence_that_does_not_divide_raises():
    cfg = ts.scenario_config(dict(arch="smollm-135m", fields=SP))
    mesh = mesh_lib.trace_mesh((2, 4), ("data", "model"))
    with pytest.raises(ValueError, match="14 tokens .* 4 ranks"):
        _trace_counts(cfg, ShapeConfig("t", 14, 4, "train"), mesh)


@functools.lru_cache(maxsize=None)
def _decode_single():
    return sps.run_decode(DECODE)


@pytest.mark.parametrize("n", sorted(DECODE_MESHES))
def test_row_cut_decode_matches_whole_cache(n):
    """zamba2-7b ``reduced()`` at batch 1 (its shared attention block's
    caches cut over n data ranks by rows, as ``cache_spec`` cuts
    ``long_500k``'s): every step's logits and the final caches equal a
    decode over the whole cache on one host, each step's new row is
    written by the rank owning it and by no other, and each step merges
    the ranks' softmax states with one all-gather an application of the
    shared block."""
    ranks = _mesh_run(DECODE_MESHES[n])["decode"]
    want = _decode_single()
    S = DECODE["S"]
    for r, got in enumerate(ranks):
        assert got["cache_rows"] == ("data",)
        assert got["rows_here"] == DECODE["rows"] // n
        for k, (a, b) in enumerate(zip(got["logits"], want["logits"])):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5 * float(
                np.abs(b).max()), err_msg=f"rank {r} step {k}")
        for a, b in zip(got["caches"], want["caches"]):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
        for k, rows in enumerate(got["changed"]):
            owns = got["first"] <= S + k < got["first"] + got["rows_here"]
            assert rows == ([S + k] if owns else []), (r, k, rows)
    owners = {r for r, got in enumerate(ranks) for rows in got["changed"]
              if rows}
    assert len(owners) > 1  # the steps crossed a rank's edge
    # One merge a step and application of the shared block; on (4, 1)
    # nothing else gathers.
    cfg = ts.scenario_config(DECODE)
    merges = DECODE["steps"] * (cfg.num_layers // cfg.attn_every)
    counts = ranks[0]["stats"]["counts"]
    if DECODE_MESHES[n][1] == 1:
        assert counts["all-gather"] == merges, counts
    else:
        assert counts["all-gather"] > merges, counts
