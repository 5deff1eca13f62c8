"""The tensor-parallel Mamba2 mixer and MLA's down-projections cut on their
latent columns, in the port's manual SPMD, on gloo meshes of CPU ranks.

- ``mamba2-2.7b`` and ``zamba2-7b`` ``reduced()`` (f32; 8 heads of 16,
  one B/C group) on (1, 2), (2, 2) and (1, 4): the sharded training step
  with and without ``seq_shard`` equals the single-host port (loss, aux
  loss, grad norm, gathered gradients and updated params, at
  ``test_torch_train_mesh.py``'s tolerances); so do a prefill and decode
  steps under the dry run's cache layout: the logits and every cache
  leaf gathered whole, the ssm states ``h`` among them. On (1, 4)
  zamba2's 2 KV heads do not divide, so its shared attention is gathered
  while its mixers run tensor-parallel.
  A state width of 3 leaves in_proj and the conv stored whole on (1, 4),
  where the mixer is then gathered whole (``TrainPlan.mixer_tp``) and
  computed alike on every rank; on (1, 2) and (2, 2) they divide and
  the mixer runs tensor-parallel.
- Every rank stores the reference's slices, runs the mixer
  tensor-parallel, holds ``h`` cut over its heads, and holds conv
  windows bit-equal to those of the other ranks of its data shard.
- On the reference's weights, the (1, 2) step equals the reference's
  single-device ``make_train_step`` at the reference's tolerances.
- Four mutants fail those checks: ``in_proj``'s columns gathered with
  ``gather_on_use``'s slicing backward (where the weight is gathered, on
  (1, 2), and where the product is, on (2, 2)), the gated norm's
  sum of squares left local, that sum's backward not summed, and MLA's
  latents gathered with a slicing backward (``deepseek-v3-671b``).

One spawn per mesh runs every scenario; every process group has a
timeout and every spawn a deadline.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as ref_get_config
from repro.models import model as ref_model
from repro.optim import adamw as ref_adamw
from repro.runtime import trainer as ref_trainer
from repro_torch.bridge import params_from_reference
from repro_torch.configs import get_config
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.modules import iter_leaves, tree_map
from repro_torch.parallel import sharding as shd
import torch_ssm_tp_scenarios as tps
import torch_train_scenarios as ts
from test_torch_train_mesh import _check

TIMEOUT_S = 30.0  # every process group's
DEADLINE_S = 240.0  # every spawn's
SP = dict(seq_shard=True)
ARCHS = {"mamba2": "mamba2-2.7b", "zamba2": "zamba2-7b"}
TRAIN = {f"{n}{'-sp' if sp else ''}": dict(arch=a, fields=SP if sp else {})
         for n, a in ARCHS.items() for sp in (False, True)}
# A state width of 3: in_proj's 2 x 128 + 2 x 3 + 8 = 270 columns (and
# the conv's 134) divide over 2 ranks but not over 4, where every rank
# then stores them whole and the mixer is gathered, as before the
# mixer ran tensor-parallel.
TRAIN["mamba2-state3"] = dict(arch="mamba2-2.7b", fields=dict(
    ssm=dataclasses.replace(get_config("mamba2-2.7b").reduced().ssm,
                            d_state=3)))
ROWS = 24
# A 16-token prompt (one scan chunk) into 24 rows, then 3 decode steps.
CACHED = {f"{kind}-{n}": dict(arch=a, kind=kind, rows=ROWS, steps=3)
          for n, a in ARCHS.items() for kind in ("prefill", "decode")}
MESHES = [(1, 2), (2, 2), (1, 4)]
# 4 x 16 tokens: 64 rows a model rank on (1, 2), at least d_model, so
# in_proj's weight is gathered; 32 on (2, 2), so its product is.
MUTANT = dict(arch="mamba2-2.7b", B=4, S=16)
MUTANT_CASES = [("cols_slice_bwd", (1, 2)), ("cols_slice_bwd", (2, 2)),
                ("norm_local_sum", (1, 2)), ("norm_sum_bwd_identity", (1, 2)),
                ("mla_latent_slice_bwd", (1, 2))]
MLA = dict(arch="deepseek-v3-671b", B=4, S=8)
REF_MESH = (1, 2)


def _mutants(shape):
    """The mutant runs on ``shape`` and the unbroken runs they are
    held beside."""
    out = []
    for name, mesh in MUTANT_CASES:
        if mesh == shape:
            base = MLA if name == "mla_latent_slice_bwd" else MUTANT
            out.append(dict(base, name=f"mutant-{name}", kind="train",
                            mutant=name))
    if out:
        out.append(dict(MUTANT, name="mutant-None", kind="train"))
    if any(s["arch"] == MLA["arch"] for s in out):
        out.append(dict(MLA, name="mutant-mla-None", kind="train"))
    return out


@functools.lru_cache(maxsize=None)
def _ref_weights(arch):
    """The reference's init (key 0) of ``arch``'s ``reduced()`` config in
    the port's layout, as a numpy tree."""
    ref_cfg = ref_get_config(arch).reduced()
    ref_params = ref_model.init_params(ref_cfg, jax.random.PRNGKey(0))
    weights = [p.numpy() for p in iter_leaves(params_from_reference(
        jax.tree_util.tree_map(np.asarray, ref_params), device="cpu"))]
    spec = dict(arch=arch)
    it = iter(weights)
    return tree_map(lambda _: next(it), ts.scenario_params(
        ts.scenario_config(spec), spec)), ref_params


def _scenarios(shape):
    out = [dict(TRAIN[n], name=n, kind="train") for n in sorted(TRAIN)]
    out += [dict(CACHED[n], name=n) for n in sorted(CACHED)]
    out += _mutants(shape)
    if shape == REF_MESH:
        out += [dict(arch=a, name=f"ref-{n}", kind="train",
                     weights=_ref_weights(a)[0]) for n, a in ARCHS.items()]
    return out


@functools.lru_cache(maxsize=None)
def _mesh_run(shape):
    specs = _scenarios(shape)
    outs = mesh_lib.spawn_mesh(tps.tp_rank, shape, (specs,),
                               axes=("data", "model"), timeout_s=TIMEOUT_S,
                               deadline_s=DEADLINE_S)
    return {s["name"]: [rank[i] for rank in outs]
            for i, s in enumerate(specs)}


@functools.lru_cache(maxsize=None)
def _single_train(name):
    return ts.run_single(dict(TRAIN[name], name=name))


@functools.lru_cache(maxsize=None)
def _single_cached(name):
    return tps.run_cached(CACHED[name])


def _ids(s):
    return "x".join(map(str, s))


@pytest.mark.parametrize("case", sorted(TRAIN))
@pytest.mark.parametrize("shape", MESHES, ids=_ids)
def test_tp_mixer_step_matches_single_host(shape, case):
    ranks = _mesh_run(shape)[case]
    _check(_single_train(case), ranks[0], case)
    counts = ranks[0]["stats"]["counts"]
    # The gathered columns' gradients are reduce-scattered (and so is
    # every close under sequence parallelism); where in_proj is stored
    # whole the mixer is gathered, its gradients sliced.
    cfg = ts.scenario_config(TRAIN[case])
    s = cfg.ssm
    cols = 2 * s.expand * cfg.d_model + 2 * s.ngroups * s.d_state + (
        s.expand * cfg.d_model // s.head_dim)
    mesh = shd.Mesh({"data": shape[0], "model": shape[1]})
    full = ts.scenario_params(cfg, TRAIN[case])
    plan = shd.TrainPlan(mesh, cfg, shd.param_specs(full, mesh), full)
    assert plan.mixer_tp(cfg) == (cols % shape[-1] == 0), case
    gathered = cols % shape[-1] == 0 or cfg.seq_shard
    assert (counts["reduce-scatter"] > 0) == gathered, counts
    for r, res in enumerate(ranks):
        assert res["digest"] == ranks[r % shape[-1]]["digest"], (case, r)


@pytest.mark.parametrize("case", sorted(CACHED))
@pytest.mark.parametrize("shape", MESHES, ids=_ids)
def test_tp_mixer_prefill_and_decode_match_single_host(shape, case):
    got = _mesh_run(shape)[case][0]
    want = _single_cached(case)
    assert len(got["logits"]) == len(want["logits"])
    for k, (a, b) in enumerate(zip(got["logits"], want["logits"])):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-6 * float(
            np.abs(b).max()), err_msg=f"{case} logits {k}")
    assert len(got["caches"]) == len(want["caches"])
    for i, (a, b) in enumerate(zip(got["caches"], want["caches"])):
        assert a.shape == b.shape, (case, i)
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-6 * max(
            float(np.abs(b).max()), 1e-30), err_msg=f"{case} cache {i}")


@pytest.mark.parametrize("shape", MESHES, ids=_ids)
def test_every_rank_stores_its_slices_and_its_heads_state(shape):
    """The reference's slices of every leaf on every rank; the mixer
    tensor-parallel; ``h`` holding this rank's heads (H / M of them, all
    of the batch shard's rows); the conv windows whole over 'model' and
    equal bit for bit on the ranks of a data shard."""
    run = _mesh_run(shape)
    D, M = shape
    for name in sorted(TRAIN):
        spec = TRAIN[name]
        cfg = ts.scenario_config(spec)
        full = ts.scenario_params(cfg, spec)
        mesh = shd.Mesh({"data": D, "model": M})
        specs = shd.param_specs(full, mesh)
        for r, res in enumerate(run[name]):
            want = [tuple(shd.shard_of(p, s, mesh, r).shape) for p, s in zip(
                iter_leaves(full), shd.iter_leaves_specs(specs))]
            assert res["param_shapes"] == want, (name, r)
    for name in sorted(CACHED):
        cfg = ts.scenario_config(CACHED[name])
        s = cfg.ssm
        H = s.expand * cfg.d_model // s.head_dim
        ranks = run[name]
        for r, res in enumerate(ranks):
            assert res["mixer_tp"], (name, r)
            for sh in res["h_shapes"]:
                assert sh[-4:] == (4 // D, H // M, s.d_state, s.head_dim), (
                    name, r, sh)
            peer = ranks[r - r % M]  # model rank 0 of this data shard
            for a, b in zip(res["conv"], peer["conv"]):
                assert a.shape[-1] == H * s.head_dim + 2 * s.d_state
                np.testing.assert_array_equal(a, b, err_msg=f"{name} {r}")


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_tp_mixer_step_matches_reference_step(arch):
    """On the reference's weights the (1, 2) step equals the single-host
    port and the reference's single-device ``make_train_step`` at the
    reference's tolerances (loss rtol 1e-4, grad norm rtol 1e-3)."""
    got = _mesh_run(REF_MESH)[f"ref-{arch}"][0]
    weights, ref_params = _ref_weights(ARCHS[arch])
    spec = dict(arch=ARCHS[arch], weights=weights)
    _check(ts.run_single(spec), got, f"ref-{arch}")
    opt = ref_adamw.AdamW(lr=1e-3)
    step = ref_trainer.make_train_step(ref_get_config(ARCHS[arch]).reduced(),
                                       opt)
    batch = {k: jnp.asarray(v) for k, v in ts.scenario_batch(
        get_config(ARCHS[arch]).reduced(), spec).items()}
    _, _, m = jax.jit(step)(ref_params, opt.init(ref_params), batch)
    assert got["loss"] == pytest.approx(float(m["loss"]), rel=1e-4)
    assert got["grad_norm"] == pytest.approx(float(m["grad_norm"]), rel=1e-3)


@pytest.mark.parametrize("mutant,shape", MUTANT_CASES,
                         ids=[f"{m}-{_ids(s)}" for m, s in MUTANT_CASES])
def test_mutants_fail_the_parity_checks(mutant, shape):
    run = _mesh_run(shape)
    base = MLA if mutant == "mla_latent_slice_bwd" else MUTANT
    single = ts.run_single(dict(base, name="single"))
    unbroken = "mutant-mla-None" if base is MLA else "mutant-None"
    _check(single, run[unbroken][0], "unbroken")
    with pytest.raises(AssertionError):
        _check(single, run[f"mutant-{mutant}"][0], mutant)
