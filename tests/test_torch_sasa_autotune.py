"""The port's measuring autotuner (``sasa.autotune_mlp_plan``) and the
cost-model and module utilities, against the reference.

The autotuner's plan must equal the reference's in every field but the
measured ``variant``; its cache must move as the reference's does, keyed
on the device type; and the two candidates it times must give the
reference's fused kernel's bits exactly and its y within f32
``allclose`` on the same seeded numpy inputs (the reference's Pallas
kernels run in interpret mode, the port's as their plain versions).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cost_model as ref_cm
from repro.core import sasa as ref_sasa
from repro.kernels import ops as ref_kops
from repro.models import modules as ref_modules
from repro.models import model as ref_model
from repro.configs import get_config as ref_get_config
from repro_torch import bridge
from repro_torch.core import cost_model as cm
from repro_torch.core import sasa, sparse_ops
from repro_torch.kernels import ops as kops
from repro_torch.models import modules

SHAPE = (32, 64, 256, 64)  # the reference's own autotuner test


def _fields_but_variant(plan) -> dict:
    d = dataclasses.asdict(plan)
    d.pop("variant")
    return d


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_autotuner_plan_and_cache_match_reference(dtype):
    sasa.plan_cache_clear()
    ref_sasa.plan_cache_clear()
    kw = dict(measured_block_sparsity=0.5, dtype=dtype)
    got = sasa.autotune_mlp_plan(*SHAPE, device="cpu", **kw)
    want = ref_sasa.autotune_mlp_plan(*SHAPE, interpret=True, **kw)
    plan, timings = got
    ref_plan, ref_timings = want
    assert _fields_but_variant(plan) == _fields_but_variant(ref_plan)
    assert plan.variant in ("fused", "two_kernel")
    assert plan.variant == min(timings, key=timings.get)
    assert set(timings) == set(ref_timings) == {"fused", "two_kernel"}
    assert all(t > 0 for t in timings.values())
    assert sasa.plan_cache_stats() == ref_sasa.plan_cache_stats()
    # Memoised process-wide: the same object, counted as a hit.
    assert sasa.autotune_mlp_plan(*SHAPE, device="cpu", **kw) is got
    assert ref_sasa.autotune_mlp_plan(*SHAPE, interpret=True, **kw) is want
    assert sasa.plan_cache_stats() == ref_sasa.plan_cache_stats()
    # The untimed planner's plan at the same sparsity, variant aside.
    assert _fields_but_variant(plan) == _fields_but_variant(
        sasa.plan_mlp(*SHAPE, **kw))


def test_autotuner_cache_key_names_the_device():
    sasa.plan_cache_clear()
    kw = dict(measured_block_sparsity=0.5, dtype="float32")
    key = ("mlp-tuned", *SHAPE, "float32", 0.5)
    # A timing taken on a card is never handed to a CPU caller ...
    on_card = (sasa.plan_mlp(*SHAPE, **kw), {"fused": 1.0,
                                             "two_kernel": 2.0})
    sasa._PLAN_CACHE[key + ("cuda",)] = on_card
    got = sasa.autotune_mlp_plan(*SHAPE, device="cpu", **kw)
    assert got is not on_card
    assert sasa._PLAN_CACHE[key + ("cpu",)] is got
    assert sasa.plan_cache_stats()["misses"] >= 1
    # ... and near-identical sparsities share the CPU's entry.
    hits = sasa.plan_cache_stats()["hits"]
    again = sasa.autotune_mlp_plan(*SHAPE, device="cpu",
                                   measured_block_sparsity=0.501,
                                   dtype="float32")
    assert again is got
    assert sasa.plan_cache_stats()["hits"] == hits + 1
    sasa.plan_cache_clear()


def _sample(m, k, f, n, block_m, block_f, seed):
    """Nonnegative x with its last row tile zero and w_in's last
    f-stripe negative where there is more than one (dead tiles both
    ways), init-scale weights."""
    rng = np.random.default_rng(seed)
    x = np.abs(rng.standard_normal((m, k), dtype=np.float32))
    if m > block_m:
        x[(m - 1) // block_m * block_m:] = 0.0
    w_in = rng.standard_normal((k, f), dtype=np.float32) / np.sqrt(k)
    if f > block_f:
        last = (f - 1) // block_f * block_f
        w_in[:, last:] = -np.abs(w_in[:, last:])
    w_out = rng.standard_normal((f, n), dtype=np.float32) / np.sqrt(f)
    return tuple(a.astype(np.float32) for a in (x, w_in, w_out))


# (M, K, F, N): the reference's test shape, and ragged M and F whose
# plan has 2 x 2 tiles.
@pytest.mark.parametrize("shape", [SHAPE, (48, 64, 640, 96)])
def test_autotuner_candidates_match_reference_fused(shape):
    sasa.plan_cache_clear()
    ref_sasa.plan_cache_clear()
    plan0 = sasa.plan_mlp(*shape, measured_block_sparsity=0.5)
    x, w_in, w_out = _sample(*shape, plan0.block_m, plan0.block_f, seed=3)
    plan, _ = sasa.autotune_mlp_plan(
        *shape, measured_block_sparsity=0.5, sample_inputs=(x, w_in, w_out),
        device="cpu")
    ref_plan, _ = ref_sasa.autotune_mlp_plan(
        *shape, measured_block_sparsity=0.5,
        sample_inputs=tuple(jnp.asarray(a) for a in (x, w_in, w_out)),
        interpret=True)
    assert _fields_but_variant(plan) == _fields_but_variant(ref_plan)
    y_ref, bmp_ref = ref_kops.sparce_mlp_fused(
        jnp.asarray(x), jnp.asarray(w_in), jnp.asarray(w_out),
        block_m=ref_plan.block_m, block_f=ref_plan.block_f, interpret=True)
    bits_ref = np.asarray(bmp_ref.bits)
    assert not bits_ref.all()
    assert bits_ref.any() == (bits_ref.size > 1)  # dead and live tiles
    xt, wit, wot = (torch.from_numpy(a) for a in (x, w_in, w_out))
    y_f, bmp_f = kops.sparce_mlp_fused(xt, wit, wot, block_m=plan.block_m,
                                       block_f=plan.block_f)
    y_t, bits_t = sparse_ops.two_kernel_mlp(xt, wit, wot, plan)
    for y, bits in ((y_f, bmp_f.bits), (y_t, bits_t)):
        np.testing.assert_array_equal(bits.numpy(), bits_ref)
        # f32 sums over K and the live stripes in another order.
        np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=1e-5,
                                   atol=1e-5)
    sasa.plan_cache_clear()
    ref_sasa.plan_cache_clear()


@pytest.mark.parametrize("n,tokens", [(0, 7), (135_000_000, 4096),
                                      (2_700_000_000, 8 * 512), (3, 1)])
def test_model_flops_matches_reference(n, tokens):
    got = cm.model_flops(n, tokens)
    assert got == ref_cm.model_flops(n, tokens)
    assert isinstance(got, float)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_param_bytes_matches_reference(dtype):
    cfg = dataclasses.replace(ref_get_config("smollm-135m").reduced(),
                              dtype=dtype)
    ref_params = ref_model.init_params(cfg, jax.random.PRNGKey(0))
    params = bridge.params_from_reference(ref_params, device="cpu")
    got = modules.param_bytes(params)
    assert got == ref_modules.param_bytes(ref_params)
    assert modules.param_count(params) == ref_modules.param_count(
        ref_params)
