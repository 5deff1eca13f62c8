"""The vocab-parallel embedding, head and cross-entropy of the port's
manual SPMD, on gloo meshes of CPU ranks.

- ``smollm-135m`` (tied), ``mistral-nemo-12b`` (untied dense),
  ``qwen2-moe-a2.7b`` (expert-parallel MoE), ``musicgen-large`` (four
  codebooks) and ``pixtral-12b`` (patch rows), all ``reduced()`` (f32,
  a vocab of 256), on (1, 2), (2, 2) and (1, 4), with and without
  ``seq_shard``: the sharded training step equals the single-host port
  (loss, aux loss, grad norm, gathered gradients and updated params, at
  ``test_torch_train_mesh.py``'s tolerances). Every rank stores its
  vocab slice, the plan runs it cut, and no all-gather made under the
  plan takes a stored vocab slice (:class:`VocabGatherSpy`).
- A prefill (its last position's logits, and every position's) and
  decode steps under a plan, the caches laid out as the dry run lays
  them, return whole logits equal to the single host's.
- On (1, 3) the vocab of 256 does not divide: every rank stores it
  whole, the plan does not cut it, and the step still equals the single
  host. With the plan told the vocab does not divide on (1, 2), the
  slices are gathered whole as before: the spy sees those gathers, the
  collectives' stats count their bytes beyond the cut step's and
  nothing else, and the step equals the single host too.
- On the reference's weights, the (1, 2) step equals the reference's
  single-device ``make_train_step`` at the reference's tolerances.
- Four mutants fail those checks: the lookup's partial rows left
  unsummed, the sum of exps left local, the target's logit left on the
  rank that holds it, the head input's gradient not summed over
  'model'.
- A rank's vocab slice of the head, f32 or bf16 (upcast 24 columns at
  a time), gives the whole head's columns of the logits.
- ``collectives.pmax`` on a trace mesh counts one all-reduce of its
  operand's bytes.

One spawn per mesh runs every scenario; every process group has a
timeout and every spawn a deadline.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import model as ref_model
from repro.optim import adamw as ref_adamw
from repro.runtime import trainer as ref_trainer
from repro_torch.bridge import params_from_reference
from repro_torch.configs import get_config
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import model as model_lib
from repro_torch.models.modules import iter_leaves, tree_map
from repro_torch.parallel import collectives
from repro_torch.parallel import sharding as shd
import torch_ssm_tp_scenarios as tps
import torch_train_scenarios as ts
import torch_vocab_scenarios as tvs
from test_torch_train_mesh import _check

TIMEOUT_S = 30.0  # every process group's
DEADLINE_S = 240.0  # every spawn's
SP = dict(seq_shard=True)
# The moe scenario's 4 x 8 tokens keep each shard drop-free, as in
# test_torch_train_mesh.py.
ARCHS = {"smollm": dict(arch="smollm-135m", mask_tail=4),
         "mistral": dict(arch="mistral-nemo-12b"),
         "qwen2-moe": dict(arch="qwen2-moe-a2.7b", B=4, S=8),
         "musicgen": dict(arch="musicgen-large", mask_tail=4),
         "pixtral": dict(arch="pixtral-12b", mask_tail=4)}
TRAIN = {f"{n}{'-sp' if sp else ''}": dict(a, fields=SP if sp else {})
         for n, a in ARCHS.items() for sp in (False, True)}
# A 16-token prompt (pixtral: behind 8 patch rows) into 32 rows, then 3
# decode steps; a prefill of the last position's logits too.
ROWS = 32
CACHED = {}
for _n in ("smollm", "mistral", "musicgen", "pixtral"):
    _a = ARCHS[_n]["arch"]
    CACHED[f"prefill-{_n}"] = dict(arch=_a, kind="prefill", rows=ROWS)
    CACHED[f"prefill-last-{_n}"] = dict(arch=_a, kind="prefill", rows=ROWS,
                                        last_only=True)
    CACHED[f"decode-{_n}"] = dict(arch=_a, kind="decode", rows=ROWS,
                                  steps=3)
MESHES = [(1, 2), (2, 2), (1, 4)]
WHOLE_MESH = (1, 3)
WHOLE = ("smollm", "mistral", "musicgen")
REF_MESH = (1, 2)
REF_ARCHS = ("smollm", "musicgen", "pixtral")
MUTANT_SPEC = dict(arch="mistral-nemo-12b", B=4, S=16)


def _scenarios(shape):
    if shape == WHOLE_MESH:
        return [dict(TRAIN[n], name=n, kind="train") for n in WHOLE]
    out = [dict(TRAIN[n], name=n, kind="train") for n in sorted(TRAIN)]
    out += [dict(CACHED[n], name=n) for n in sorted(CACHED)]
    if shape == REF_MESH:
        out += [dict(MUTANT_SPEC, name=f"mutant-{m}", kind="train",
                     mutant=m) for m in [None] + sorted(tvs.MUTANTS)]
        out.append(dict(MUTANT_SPEC, name="gathered", kind="train",
                        gathered=True))
        out += [dict(arch=ARCHS[n]["arch"], name=f"ref-{n}", kind="train",
                     weights=_ref_weights(ARCHS[n]["arch"])[0])
                for n in REF_ARCHS]
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


@functools.lru_cache(maxsize=None)
def _mesh_run(shape):
    specs = _scenarios(shape)
    outs = mesh_lib.spawn_mesh(tvs.vocab_rank, shape, (specs,),
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


def _stored_shapes(spec, shape):
    """Each rank's stored leaf shapes under ``param_specs``, and the full
    params' vocab leaves' indices in leaf order."""
    cfg = ts.scenario_config(spec)
    full = ts.scenario_params(cfg, spec)
    mesh = shd.Mesh({"data": shape[0], "model": shape[1]})
    specs = shd.param_specs(full, mesh)
    want = [[tuple(shd.shard_of(p, s, mesh, r).shape) for p, s in zip(
        iter_leaves(full), shd.iter_leaves_specs(specs))]
        for r in range(mesh.size)]
    vocab = [i for i, p in enumerate(iter_leaves(full))
             if cfg.vocab_size in p.shape]
    return cfg, want, vocab


@pytest.mark.parametrize("case", sorted(TRAIN))
@pytest.mark.parametrize("shape", MESHES, ids=_ids)
def test_vocab_parallel_step_matches_single_host(shape, case):
    ranks = _mesh_run(shape)[case]
    _check(_single_train(case), ranks[0], case)
    cfg, want, vocab = _stored_shapes(TRAIN[case], shape)
    M = shape[-1]
    assert vocab  # embed (and head / heads)
    for r, res in enumerate(ranks):
        assert res["param_shapes"] == want[r], (case, r)
        for i in vocab:  # stored cut: V / M of the vocab on each rank
            assert cfg.vocab_size // M in res["param_shapes"][i], (case, i)
        assert res["vocab_cut"] == [True], (case, r)
        assert res["vocab_gathers"] == [], (case, r)
        assert res["digest"] == ranks[r % M]["digest"], (case, r)


@pytest.mark.parametrize("case", sorted(CACHED))
@pytest.mark.parametrize("shape", MESHES, ids=_ids)
def test_prefill_and_decode_return_whole_logits(shape, case):
    got = _mesh_run(shape)[case][0]
    want = _single_cached(case)
    assert got["vocab_cut"] == [True] and got["vocab_gathers"] == []
    assert len(got["logits"]) == len(want["logits"])
    for k, (a, b) in enumerate(zip(got["logits"], want["logits"])):
        assert a.shape == b.shape, (case, k)
        assert a.shape[-1] == 256
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-6 * float(
            np.abs(b).max()), err_msg=f"{case} logits {k}")
    for i, (a, b) in enumerate(zip(got["caches"], want["caches"])):
        assert a.shape == b.shape, (case, i)
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-6 * max(
            float(np.abs(b).max()), 1e-30), err_msg=f"{case} cache {i}")


@pytest.mark.parametrize("case", WHOLE)
def test_vocab_that_does_not_divide_stays_whole(case):
    """(1, 3): 256 ids do not divide over 3 ranks, so every rank stores
    and reads the embedding and head whole, as before."""
    ranks = _mesh_run(WHOLE_MESH)[case]
    _check(_single_train(case), ranks[0], case)
    cfg, want, vocab = _stored_shapes(TRAIN[case], WHOLE_MESH)
    for r, res in enumerate(ranks):
        assert res["param_shapes"] == want[r], (case, r)
        for i in vocab:
            assert cfg.vocab_size in res["param_shapes"][i], (case, i)
        assert res["vocab_cut"] == [False] and res["vocab_gathers"] == []


def test_spy_sees_the_gathers_of_a_plan_that_does_not_cut():
    """With the plan told the vocab does not divide, each forward
    gathers the stored slices whole (``gather_on_use``), which the spy
    records; the step still equals the single host's."""
    ranks = _mesh_run(REF_MESH)
    single = ts.run_single(dict(MUTANT_SPEC, name="single"))
    got = ranks["gathered"][0]
    _check(single, got, "gathered")
    cfg = ts.scenario_config(MUTANT_SPEC)
    d, half = cfg.d_model, cfg.vocab_size // 2
    assert got["vocab_cut"] == [False]
    assert sorted(got["vocab_gathers"]) == [(d, half), (half, d)]
    # Against the same step run cut: the two slices' gathers, and
    # nothing else, in the collectives' stats.
    cut = ranks["mutant-None"][0]["stats"]
    assert (got["stats"]["counts"]["all-gather"]
            - cut["counts"]["all-gather"]) == 2
    assert got["stats"]["all-gather"] - cut["all-gather"] == 2 * half * d * 4


@pytest.mark.parametrize("arch", REF_ARCHS)
def test_vocab_parallel_step_matches_reference_step(arch):
    """On the reference's weights the (1, 2) step equals the single-host
    port and the reference's single-device ``make_train_step`` at the
    reference's tolerances (loss rtol 1e-4, grad norm rtol 1e-3)."""
    name = ARCHS[arch]["arch"]
    got = _mesh_run(REF_MESH)[f"ref-{arch}"][0]
    weights, ref_params = _ref_weights(name)
    spec = dict(arch=name, weights=weights)
    _check(ts.run_single(spec), got, f"ref-{arch}")
    opt = ref_adamw.AdamW(lr=1e-3)
    step = ref_trainer.make_train_step(ref_get_config(name).reduced(), opt)
    batch = {k: jnp.asarray(v) for k, v in ts.scenario_batch(
        get_config(name).reduced(), spec).items()}
    _, _, m = jax.jit(step)(ref_params, opt.init(ref_params), batch)
    assert got["loss"] == pytest.approx(float(m["loss"]), rel=1e-4)
    assert got["grad_norm"] == pytest.approx(float(m["grad_norm"]), rel=1e-3)


@pytest.mark.parametrize("mutant", sorted(tvs.MUTANTS))
def test_mutants_fail_the_parity_checks(mutant):
    run = _mesh_run(REF_MESH)
    single = ts.run_single(dict(MUTANT_SPEC, name="single"))
    _check(single, run["mutant-None"][0], "unbroken")
    with pytest.raises(AssertionError):
        _check(single, run[f"mutant-{mutant}"][0], mutant)


@pytest.mark.parametrize("M", [2, 4])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("arch", ["smollm-135m", "mistral-nemo-12b"])
def test_rank_head_slice_gives_its_columns(monkeypatch, arch, dtype, M):
    """Each rank's vocab slice of the head (tied: of the embedding) gives
    the whole head's columns of the f32 logits: an f32 head in one
    product, a bf16 head upcast 24 columns at a time from the slice's
    first (the last piece of a rank's 256 / M columns shorter)."""
    cfg = get_config(arch).reduced()
    full = ts.scenario_params(cfg, dict(arch=arch))
    key = "embed" if cfg.tie_embeddings else "head"
    table = full[key].to(getattr(torch, dtype))
    monkeypatch.setattr(model_lib, "HEAD_SLICE_VALUES", cfg.d_model * 24)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 3, cfg.d_model)).astype(np.float32))
    head = table.T if cfg.tie_embeddings else table
    whole = x @ head.float()
    n = cfg.vocab_size // M
    for r in range(M):
        lo = r * n
        mine = (table[lo:lo + n] if cfg.tie_embeddings
                else table[:, lo:lo + n]).contiguous()
        got = model_lib._logits({key: mine}, cfg, x)
        assert got.dtype == torch.float32 and got.shape == (2, 3, n)
        torch.testing.assert_close(got, whole[..., lo:lo + n], rtol=1e-6,
                                   atol=1e-6)


def test_pmax_counts_one_all_reduce_on_a_trace_mesh():
    mesh = mesh_lib.trace_mesh((2, 4), ("data", "model"))
    x = torch.arange(6, dtype=torch.float32)
    assert collectives.pmax(x, "model", mesh) is x
    st = collectives.stats(mesh)
    assert st["counts"]["all-reduce"] == 1 and st["all-reduce"] == 24
    assert st["total"] == 24
