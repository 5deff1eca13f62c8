"""The sharded training step on a (pod, data, model) mesh over
``torch.distributed`` (gloo, CPU) against the single-host port and the
reference.

Every family (dense ``smollm-135m`` with the MLP off, relu under
``mode="fused"`` and the GLU under ``mode="kernel"``; moe
``deepseek-v3-671b``, MLA and expert-parallel MoE; ``mamba2-2.7b``;
``zamba2-7b``; ``pixtral-12b``; ``musicgen-large``; all ``reduced()``,
f32; the GLU kernel and deepseek under remat; dense under ZeRO-1 for
two steps) trains one step on
(2, 2), (1, 4), (4, 1) and (2, 1, 2): the loss, the aux loss, the grad norm, the skip counters summed over the mesh and
the gathered gradients equal the single-host port's on the same weights
and batch; after the update the gathered params equal it where the
gradient is above the sum-order noise (Adam's first step turns a
gradient near zero into +-lr). Every rank stores the slices the specs
give it. The reference's own case (``smollm-135m.reduced()`` on (2, 4),
2 KV heads over 4 model ranks: the gather path) is held against the
single-host port and against the reference's single-device
``make_train_step`` at the reference's tolerances.

Mutants of the collectives (a psum whose backward all-reduces, a mirror
without its backward all-reduce, a grad norm that sums a replicated leaf
over 'model') must fail the same checks. ZeRO-1: the moments' specs
equal the reference's ``opt_state_shardings`` on conftest's mesh, a
rank's moment bytes fall by the data size, and a ZeRO-1 step equals the
same mesh's step without it bit for bit.

One spawn per mesh runs every scenario (each rank loops over them);
every process group has a timeout and every spawn a deadline. The
moe scenario's size keeps each shard drop-free (T_loc <= 16 tokens: the
capacity of 8-row multiples holds every assignment), so the EP path's
per-shard capacity equals the global path's.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.launch import mesh as ref_mesh_lib
from repro.models import model as ref_model
from repro.optim import adamw as ref_adamw
from repro.parallel import sharding as ref_shd
from repro.runtime import trainer as ref_trainer
from repro_torch.bridge import params_from_reference
from repro_torch.configs import get_config
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.modules import iter_leaves
from repro_torch.optim import adamw
from repro_torch.parallel import sharding as shd
import torch_train_scenarios as ts

TIMEOUT_S = 30.0  # every process group's
DEADLINE_S = 240.0  # every spawn's
# f32, through two layers: the shards sum in other orders.
LOSS_RTOL = 2e-6
RTOL, ATOL = 2e-4, 2e-6
SMALL = dict(block_m=8, block_k=32, block_n=32)

CASES = {
    "dense-off": dict(arch="smollm-135m", steps=2),
    "relu-fused": dict(arch="smollm-135m", mask_tail=4, fields=dict(
        mlp_act="relu", sparsity=dict(enabled=True, mode="fused", **SMALL))),
    "glu-kernel": dict(arch="smollm-135m", mask_tail=8, fields=dict(
        sparsity=dict(enabled=True, mode="kernel", **SMALL))),
    "deepseek": dict(arch="deepseek-v3-671b", B=4, S=8, steps=2),
    # Under remat the backward recomputes each block, issuing its
    # forward's collectives again in the same order on every rank.
    "remat-full": dict(arch="smollm-135m", mask_tail=8, fields=dict(
        remat="full", sparsity=dict(enabled=True, mode="kernel", **SMALL))),
    "remat-dots": dict(arch="deepseek-v3-671b", B=4, S=8,
                       fields=dict(remat="dots")),
    # ZeRO-1: each data rank updates its slices of the moments and
    # params, then the updated slices are gathered back over 'data'.
    "dense-zero1": dict(arch="smollm-135m", zero1=True, B=8, steps=2),
    "mamba2": dict(arch="mamba2-2.7b"),
    "zamba2": dict(arch="zamba2-7b"),
    "pixtral": dict(arch="pixtral-12b", mask_tail=4),
    "musicgen": dict(arch="musicgen-large", mask_tail=4),
}
MESHES = [(2, 2), (1, 4), (4, 1), (2, 1, 2)]


def _axes(shape):
    return ("pod", "data", "model")[-len(shape):]


def _spawn(shape, specs):
    return mesh_lib.spawn_mesh(ts.train_rank, shape, (specs,),
                               axes=_axes(shape), timeout_s=TIMEOUT_S,
                               deadline_s=DEADLINE_S)


@functools.lru_cache(maxsize=None)
def _mesh_run(shape):
    names = sorted(CASES)
    outs = _spawn(shape, [dict(CASES[n], name=n) for n in names])
    return {n: [rank[i] for rank in outs] for i, n in enumerate(names)}


@functools.lru_cache(maxsize=None)
def _single(name):
    return ts.run_single(dict(CASES[name], name=name))


def _check(single, got, name=""):
    """The sharded run's first step and state against the single host's."""
    assert got["loss"] == pytest.approx(single["loss"], rel=LOSS_RTOL), name
    assert got["aux_loss"] == pytest.approx(single["aux_loss"], rel=1e-5,
                                            abs=1e-9), name
    assert got["grad_norm"] == pytest.approx(single["grad_norm"],
                                             rel=LOSS_RTOL), name
    assert len(got["grads"]) == len(single["grads"])
    for i, (g, w) in enumerate(zip(got["grads"], single["grads"])):
        assert g.shape == w.shape, (name, i)
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL * scale,
                                   err_msg=f"{name} grad {i}")
    for i, (p, q, g) in enumerate(zip(got["params"], single["params"],
                                      single["grads"])):
        # Where |g| is above the sum-order noise, Adam's steps agree.
        live = np.abs(g) > 1e-3 * max(float(np.abs(g).max()), 1e-30)
        np.testing.assert_allclose(p[live], q[live], rtol=1e-5, atol=1e-6,
                                   err_msg=f"{name} param {i}")


def _specs_of(name, shape):
    cfg = ts.scenario_config(CASES[name])
    full = ts.scenario_params(cfg, CASES[name])
    mesh = shd.Mesh(dict(zip(_axes(shape), shape)))
    return full, mesh, shd.param_specs(full, mesh)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
def test_sharded_step_matches_single_host(shape, case):
    ranks = _mesh_run(shape)[case]
    single = _single(case)
    _check(single, ranks[0], case)
    assert ranks[0]["skip"] == single["skip"]  # summed over the mesh
    if case in ("relu-fused", "glu-kernel", "remat-full"):
        assert single["skip"][1] > 0
    # Every rank stores exactly its slices of the specs.
    full, mesh, specs = _specs_of(case, shape)
    for r, res in enumerate(ranks):
        want = [tuple(shd.shard_of(p, s, mesh, r).shape) for p, s in zip(
            iter_leaves(full), shd.iter_leaves_specs(specs))]
        assert res["param_shapes"] == want, (case, r)
    # The replicas of a model shard end bit-identical.
    for r, res in enumerate(ranks):
        assert res["digest"] == ranks[r % shape[-1]]["digest"], (case, r)


def test_reference_case_2x4_takes_the_gather_path():
    """``smollm-135m.reduced()`` on (2, 4), seq 32 x batch 8 (the
    reference's tests/test_distributed.py case): its 2 KV heads do not
    divide 4, so attention gathers its weights on use while the MLP is
    tensor-parallel. Against the single-host port, and one step against
    the reference's single-device ``make_train_step`` at the reference's
    tolerances (loss rtol 1e-4, grad norm rtol 1e-3)."""
    ref_cfg = ref_get_config("smollm-135m").reduced()
    ref_params = ref_model.init_params(ref_cfg, jax.random.PRNGKey(0))
    np_params = jax.tree_util.tree_map(np.asarray, ref_params)
    weights = [p.numpy() for p in iter_leaves(params_from_reference(
        np_params, device="cpu"))]
    spec = dict(name="ref", arch="smollm-135m", B=8, S=32, steps=1)
    full = ts.scenario_params(ts.scenario_config(spec), spec)
    it = iter(weights)
    from repro_torch.models.modules import tree_map
    spec["weights"] = tree_map(lambda _: next(it), full)
    outs = _spawn((2, 4), [spec])
    got = outs[0][0]
    _check(ts.run_single(spec), got, "2x4")
    assert got["stats"]["counts"]["all-gather"] > 0  # gather on use
    # The reference's single-device step on the same weights and batch.
    opt = ref_adamw.AdamW(lr=1e-3)
    step = ref_trainer.make_train_step(ref_cfg, opt)
    batch = {k: jnp.asarray(v) for k, v in ts.scenario_batch(
        get_config("smollm-135m").reduced(), spec).items()}
    _, _, m = jax.jit(step)(ref_params, opt.init(ref_params), batch)
    assert got["loss"] == pytest.approx(float(m["loss"]), rel=1e-4)
    assert got["grad_norm"] == pytest.approx(float(m["grad_norm"]), rel=1e-3)


MUTANT_SPEC = dict(arch="smollm-135m", B=4, S=16)


@functools.lru_cache(maxsize=None)
def _mutant_runs():
    names = [None] + sorted(ts.MUTANTS)
    outs = _spawn((2, 2), [dict(MUTANT_SPEC, name=str(n), mutant=n)
                           for n in names])
    return dict(zip(names, outs[0]))


@pytest.mark.parametrize("mutant", sorted(ts.MUTANTS))
def test_mutant_collectives_fail_the_parity_checks(mutant):
    """A psum whose backward all-reduces multiplies the gradients behind
    it by the model size; a mirror without its backward all-reduce
    leaves each shard's partial gradient; a norm that sums a replicated
    leaf over 'model' counts it twice. Each must fail the checks the
    unbroken step passes."""
    runs = _mutant_runs()
    single = ts.run_single(dict(MUTANT_SPEC, name="single"))
    _check(single, runs[None], "unbroken")
    with pytest.raises(AssertionError):
        _check(single, runs[mutant], mutant)


@pytest.mark.parametrize("zero1", [False, True])
def test_moment_specs_equal_reference(cpu_mesh, zero1):
    """``opt_state_shardings`` leaf by leaf against the reference's on
    conftest's (2, 4) host mesh, for every family's config."""
    rm = ref_mesh_lib.make_mesh((2, 4), ("data", "model"))
    pm = shd.Mesh({"data": 2, "model": 4})
    for arch in ("smollm-135m", "deepseek-v3-671b", "mamba2-2.7b",
                 "zamba2-7b", "pixtral-12b", "musicgen-large"):
        cfg = ref_get_config(arch)
        sds = jax.eval_shape(lambda c=cfg: ref_model.init_params(
            c, jax.random.PRNGKey(0)))
        state = jax.eval_shape(ref_adamw.AdamW().init, sds)
        want = ref_adamw.opt_state_shardings(
            state, ref_shd.param_specs(sds, rm), rm, zero1=zero1)
        got = adamw.opt_state_shardings(
            adamw.AdamState(state.step, state.mu, state.nu),
            shd.param_specs(sds, pm), pm, zero1=zero1)
        flat_want = [tuple(s.spec) for s in jax.tree_util.tree_leaves(
            want.mu, is_leaf=lambda x: hasattr(x, "spec"))]
        names = []
        jax.tree_util.tree_map_with_path(
            lambda p, x: names.append(ref_shd._leaf_name(p)), state.mu)
        flat_got = list(shd.iter_leaves_specs(got.mu))
        # jax orders a dict's leaves by sorted key, as iter_leaves does.
        assert len(flat_got) == len(flat_want)
        for n, g, w in zip(names, flat_got, flat_want):
            w = tuple(a[0] if isinstance(a, tuple) and len(a) == 1 else a
                      for a in w)
            w = w + (None,) * (len(g) - len(w))
            assert g == w, (arch, n, zero1)
        assert got.step == () and tuple(want.step.spec) == ()


ZERO1_SPEC = dict(arch="smollm-135m", B=4, S=16, steps=2)


@functools.lru_cache(maxsize=None)
def _zero1_runs():
    outs = _spawn((2, 2), [dict(ZERO1_SPEC, name="plain", zero1=False),
                           dict(ZERO1_SPEC, name="zero1", zero1=True)])
    return outs


def test_zero1_step_equals_the_plain_step_bit_for_bit():
    outs = _zero1_runs()
    plain, z = outs[0]
    for key in ("params", "mu", "nu", "grads"):
        for i, (a, b) in enumerate(zip(plain[key], z[key])):
            np.testing.assert_array_equal(a, b, err_msg=f"{key} {i}")
    assert plain["loss"] == z["loss"]
    assert plain["grad_norm"] == z["grad_norm"]
    for rank in outs:
        assert rank[0]["digest"] == rank[1]["digest"]


def test_zero1_moment_bytes_fall_by_the_data_size():
    outs = _zero1_runs()
    for rank in outs:
        plain, z = (sum(int(np.prod(s)) for s in r["moment_shapes"])
                    for r in rank)
        # Every leaf of the reduced smollm has an even replicated dim.
        assert z * 2 == plain
        assert rank[0]["param_shapes"] == rank[1]["param_shapes"]
    # Against the single host's moments after the same two steps.
    single = ts.run_single(dict(ZERO1_SPEC, name="single"))
    for key in ("mu", "nu"):
        for i, (a, b, g) in enumerate(zip(outs[0][1][key], single[key],
                                          single["grads"])):
            scale = max(float(np.abs(b).max()), 1e-30)
            np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-4 * scale,
                                       err_msg=f"{key} {i}")
