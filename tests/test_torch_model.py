"""The port's layers and dense model against the reference, on the CPU.

Weights come from the reference's ``init_params`` through the bridge;
other inputs from numpy seeds, fed to both sides. The reference's
Pallas kernels run in interpret mode. Tolerances are f32 (the reduced
configs are f32): sums in another order.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.core import sparse_ops as ref_sparse_ops
from repro.models import layers as ref_layers
from repro.models import model as ref_model
from repro_torch.bridge import params_from_reference
from repro_torch.configs import get_config
from repro_torch.core import sasa, sparse_ops
from repro_torch.core.sprf import TileBitmap
from repro_torch.kernels import ops as kops
from repro_torch.models import layers
from repro_torch.models import model as model_lib

ATOL = 1e-4  # logits / activations at f32


def _params(seed=0, act=None):
    """Reference params of the reduced config (its GLU MLP, or ``act``),
    and the same tree bridged into the port."""
    ref_cfg = ref_get_config("smollm-135m").reduced()
    if act is not None:
        ref_cfg = dataclasses.replace(ref_cfg, mlp_act=act)
    ref_params = ref_model.init_params(ref_cfg, jax.random.PRNGKey(seed))
    np_params = jax.tree_util.tree_map(np.asarray, ref_params)
    return ref_cfg, ref_params, params_from_reference(np_params,
                                                      device="cpu")


def _mlp_fwd_both(params, ref_params, x, act, sp):
    y, stats = layers.mlp_fwd(params["stack"][0]["mlp"], torch.from_numpy(x),
                              act, sparse_ops.SparsityConfig(**sp))
    ref_mlp = jax.tree_util.tree_map(lambda a: a[0],
                                     ref_params["stack"]["mlp"])
    y_ref, stats_ref = ref_layers.mlp_fwd(
        ref_mlp, jnp.asarray(x), act, ref_sparse_ops.SparsityConfig(**sp))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=ATOL,
                               atol=ATOL)
    np.testing.assert_array_equal(stats.numpy(), np.asarray(stats_ref))
    return stats


def test_rmsnorm_and_rope_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32)
    got = layers.rmsnorm({"scale": torch.from_numpy(scale)},
                         torch.from_numpy(x), 1e-5)
    want = ref_layers.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x),
                              1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    pos = rng.integers(0, 500, (2, 5)).astype(np.int32)
    got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4)
    want = ref_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("sp", [
    dict(enabled=True, mode="fused", gate_threshold=0.0),
    dict(enabled=True, mode="fused", block_m=1, expected_sparsity=0.5),
    dict(enabled=True, mode="fused", block_m=8, gate_threshold=0.05,
         expected_sparsity=0.5),
    # 16 rows, per-row tiles, measured sparsity 1/8: the planner picks
    # the 'unfused' variant (dense gate and up GEMMs, gated GEMM kernel).
    dict(enabled=True, mode="fused", block_m=1, expected_sparsity=0.125),
    dict(enabled=True, mode="kernel", block_m=1),
    dict(enabled=True, mode="reference", block_m=4),
    dict(enabled=False),
], ids=["fused-bm64", "fused-bm1", "fused-tau", "unfused-bm1", "kernel-bm1",
        "reference", "off"])
@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_mlp_fwd_values_and_skip_stats_match_reference(sp, act):
    _, ref_params, params = _params()
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 8, 64)).astype(np.float32)
    x[1, 2:6] = 0.0  # dead rows
    if sp.get("expected_sparsity") == 0.125:
        assert sasa.plan_glu_mlp_cached(
            16, 64, 128, 64, measured_block_sparsity=0.125,
            dtype="float32", block_m=1, block_f=128,
            block_n=128).variant == "unfused"
    stats = _mlp_fwd_both(params, ref_params, x, act, sp)
    if sp.get("block_m") == 1:
        assert stats[0] > 0  # the dead rows' tiles skip


@pytest.mark.parametrize("sp", [
    dict(enabled=True, mode="fused", block_m=1, block_k=32),
    dict(enabled=True, mode="fused", block_m=8, block_k=32,
         expected_sparsity=0.5),
    dict(enabled=True, mode="kernel", block_m=1, block_k=32),
    dict(enabled=True, mode="reference", block_m=1, block_k=32),
    dict(enabled=False),
], ids=["fused-bm1", "fused-bm8", "kernel-bm1", "reference-bm1", "off"])
@pytest.mark.parametrize("act", ["relu", "relu2"])
def test_relu_mlp_fwd_values_and_skip_stats_match_reference(sp, act):
    """The relu family's MLP (no w_gate), d_ff 128 in four 32-wide
    stripes: values within f32 tolerance, skip stats exactly."""
    _, ref_params, params = _params(act=act)
    assert "w_gate" not in params["stack"][0]["mlp"]
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 8, 64)).astype(np.float32)
    x[0, 3] = 0.0  # a dead slot
    x[1] = 0.0  # a dead row tile at block_m 8
    stats = _mlp_fwd_both(params, ref_params, x, act, sp)
    if sp.get("enabled"):
        assert 0 < stats[0] < stats[1]


@pytest.mark.parametrize("act", ["relu", "relu2"])
def test_two_kernel_mlp_matches_reference(act):
    """The planner's fallback pipeline: dense up-projection, relu-bitmap
    kernel, gated down-projection kernel."""
    _, ref_params, params = _params(act=act)
    mlp = params["stack"][0]["mlp"]
    ref_mlp = jax.tree_util.tree_map(lambda a: a[0],
                                     ref_params["stack"]["mlp"])
    rng = np.random.default_rng(3)
    x = rng.standard_normal((12, 64)).astype(np.float32)
    x[5:9] = 0.0
    plan = sasa.MlpPlan(variant="two_kernel", block_m=1, block_f=32,
                        block_n=128)
    ref_plan = ref_sparse_ops.sasa.MlpPlan(variant="two_kernel", block_m=1,
                                           block_f=32, block_n=128)
    y, bits = sparse_ops.two_kernel_mlp(torch.from_numpy(x), mlp["w_in"],
                                        mlp["w_out"], plan, act)
    y_ref, bits_ref = ref_sparse_ops.two_kernel_mlp(
        jnp.asarray(x), ref_mlp["w_in"], ref_mlp["w_out"], ref_plan, act)
    np.testing.assert_array_equal(bits.numpy(), np.asarray(bits_ref))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=ATOL,
                               atol=ATOL)
    assert bits.numpy()[5:9].all()


def test_mlp_fwd_raises_for_unported_paths():
    """An activation the MLP does not know raises. The compacted GEMM
    variant and two-sided gating (``gate="both"``), which raised here
    until their kernels were ported, now run: under all-zero bits
    ``ops.sparce_gemm`` and the layer's matmul (both bitmaps, no plan)
    give the dense product."""
    x = torch.ones((4, 64))
    w = torch.ones((64, 32))
    lhs = TileBitmap(torch.zeros((4, 2), dtype=torch.int32), (1, 32),
                     (4, 64))
    rhs = TileBitmap(torch.zeros((2, 1), dtype=torch.int32), (32, 128),
                     (64, 32))
    blocks = dict(block_m=1, block_k=32, block_n=128)
    dense = x @ w
    y = kops.sparce_gemm(x, w, sasa.SkipPlan(gate="lhs", variant="compacted",
                                             **blocks), lhs_bitmap=lhs)
    assert torch.equal(y, dense)
    y = kops.sparce_gemm(x, w, sasa.SkipPlan(gate="both", variant="gated",
                                             **blocks),
                         lhs_bitmap=lhs, rhs_bitmap=rhs)
    assert torch.equal(y, dense)
    scfg = sparse_ops.SparsityConfig(enabled=True, mode="kernel", block_m=1,
                                     block_k=32)
    y = sparse_ops.sparce_matmul(x, w, scfg, lhs_bitmap=lhs, rhs_bitmap=rhs)
    assert torch.equal(y, dense)
    _, _, params = _params(act="relu")
    with pytest.raises(ValueError, match="activation"):
        layers.mlp_fwd(params["stack"][0]["mlp"], x, "tanh",
                       sparse_ops.SparsityConfig())


def test_forward_logits_match_reference():
    ref_cfg, ref_params, params = _params()
    cfg = get_config("smollm-135m").reduced()
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab_size, (2, 11)).astype(np.int32)
    logits, _, aux = model_lib.forward(params, cfg,
                                       {"tokens": torch.from_numpy(toks)})
    want, _, aux_ref = ref_model.forward(ref_params, ref_cfg,
                                         {"tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), rtol=ATOL,
                               atol=ATOL)
    np.testing.assert_array_equal(aux["skip"].numpy(),
                                  np.asarray(aux_ref["skip"]))


def _paged_state(cfg, seed, B=4, max_blocks=4, bs=8):
    """Random pools, per-slot lengths (one dead slot), block tables."""
    rng = np.random.default_rng(seed)
    lengths = np.array([5, 0, 16, 23], np.int32)[:B]
    nb = B * max_blocks + 1
    shape = (cfg.num_layers, nb, bs, cfg.num_kv_heads, cfg.resolved_head_dim)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    tables = np.zeros((B, max_blocks), np.int32)
    ids = rng.permutation(np.arange(1, nb))
    nxt = 0
    for b, n in enumerate(lengths):
        kk = -(-(int(n) + 1) // bs) if n else 0
        tables[b, :kk] = ids[nxt:nxt + kk]
        nxt += kk
    active = (lengths > 0).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    length = np.broadcast_to(lengths, (cfg.num_layers, B)).copy()
    return k, v, length, tables, active, toks


@pytest.mark.parametrize("attn_kernel", ["gather", "paged"])
def test_paged_decode_step_matches_reference(attn_kernel):
    _decode_step_parity(attn_kernel, "silu", dict(
        enabled=True, mode="fused", block_m=1, expected_sparsity=0.5))


@pytest.mark.parametrize("mode", ["fused", "kernel"])
@pytest.mark.parametrize("attn_kernel", ["gather", "paged"])
def test_relu_paged_decode_step_matches_reference(attn_kernel, mode):
    _decode_step_parity(attn_kernel, "relu", dict(
        enabled=True, mode=mode, block_m=1, block_k=32))


def _decode_step_parity(attn_kernel, act, sp):
    from repro.models.attention import PagedKVCache as RefPaged
    from repro_torch.models.attention import PagedKVCache
    ref_cfg, ref_params, params = _params(1, act=act)
    ref_cfg = dataclasses.replace(
        ref_cfg, sparsity=ref_sparse_ops.SparsityConfig(**sp))
    cfg = dataclasses.replace(get_config("smollm-135m").reduced(),
                              mlp_act=act,
                              sparsity=sparse_ops.SparsityConfig(**sp))
    k, v, length, tables, active, toks = _paged_state(cfg, 3)
    ref_caches = {"stack": RefPaged(jnp.asarray(k), jnp.asarray(v),
                                    jnp.asarray(length))}
    logits_ref, new_ref, skip_ref = ref_model.serving_decode_step(
        ref_params, ref_cfg, jnp.asarray(toks), ref_caches,
        jnp.asarray(active), jnp.asarray(tables), attn_kernel=attn_kernel)
    caches = {"stack": PagedKVCache(*map(torch.from_numpy,
                                         (k.copy(), v.copy(), length)))}
    logits, new, skip = model_lib.serving_decode_step(
        params, cfg, torch.from_numpy(toks), caches,
        torch.from_numpy(active), torch.from_numpy(tables),
        attn_kernel=attn_kernel)
    live = active > 0
    np.testing.assert_allclose(logits.numpy()[live],
                               np.asarray(logits_ref)[live], rtol=ATOL,
                               atol=ATOL)
    np.testing.assert_array_equal(skip.numpy(), np.asarray(skip_ref))
    assert skip.numpy()[0] > 0  # the dead slot's gate tiles skip
    np.testing.assert_array_equal(new["stack"].length.numpy(),
                                  np.asarray(new_ref["stack"].length))
    # The appended rows landed in the same pool coordinates.
    np.testing.assert_allclose(new["stack"].k.numpy(),
                               np.asarray(new_ref["stack"].k), rtol=ATOL,
                               atol=ATOL)


def test_bucketed_prefill_equals_exact_and_matches_reference():
    ref_cfg, ref_params, params = _params(2)
    cfg = get_config("smollm-135m").reduced()
    rng = np.random.default_rng(4)
    S, S_pad = 11, 16
    toks = rng.integers(0, cfg.vocab_size, S).astype(np.int64)
    padded = np.zeros((1, S_pad), np.int64)
    padded[0, :S] = toks
    exact_caches = model_lib.init_caches(cfg, 1, S, device="cpu")
    logits_exact, c_exact, _ = model_lib.forward(
        params, cfg, {"tokens": torch.from_numpy(toks[None])}, exact_caches,
        last_only=True)
    pad_caches = model_lib.init_caches(cfg, 1, S_pad, device="cpu")
    logits_pad, c_pad, _ = model_lib.forward(
        params, cfg, {"tokens": torch.from_numpy(padded),
                      "advance": torch.tensor([S], dtype=torch.int32)},
        pad_caches, last_only=True)
    np.testing.assert_allclose(logits_pad.numpy(), logits_exact.numpy(),
                               rtol=1e-6, atol=1e-6)
    assert c_pad["stack"].length.tolist() == c_exact["stack"].length.tolist()
    np.testing.assert_allclose(c_pad["stack"].k[:, :, :S].numpy(),
                               c_exact["stack"].k.numpy(), rtol=1e-6,
                               atol=1e-6)
    want, _, _ = ref_model.forward(ref_params, ref_cfg,
                                   {"tokens": jnp.asarray(toks[None])},
                                   last_only=True)
    np.testing.assert_allclose(logits_pad.numpy(), np.asarray(want),
                               rtol=ATOL, atol=ATOL)


def test_init_params_and_caches_need_an_explicit_cpu_device():
    if torch.cuda.is_available():
        pytest.skip("the default device is usable on this host")
    cfg = get_config("smollm-135m").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model_lib.init_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model_lib.init_caches(cfg, 1, 8)


@pytest.mark.parametrize("m,k,f,n,dtype", [
    (8, 576, 1536, 576, "bfloat16"), (64, 576, 1536, 576, "bfloat16"),
    (128, 576, 1536, 576, "bfloat16"), (256, 576, 1536, 576, "bfloat16"),
    (4, 64, 128, 64, "float32"), (32, 64, 128, 64, "float32"),
])
@pytest.mark.parametrize("s", [0.0, 0.125, 0.5])
@pytest.mark.parametrize("block_m", [None, 1, 64])
def test_planner_and_byte_models_equal_reference(m, k, f, n, dtype, s,
                                                 block_m):
    from repro.core import cost_model as ref_cost
    from repro.core import sasa as ref_sasa
    from repro_torch.core import cost_model, sasa
    kw = dict(measured_block_sparsity=s, dtype=dtype, block_m=block_m)
    for name in ("plan_glu_mlp", "plan_mlp", "plan_glu_mlp_cached",
                 "plan_mlp_cached"):
        got = getattr(sasa, name)(m, k, f, n, **kw)
        want = getattr(ref_sasa, name)(m, k, f, n, **kw)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), name
    for name in ("glu_mlp_hbm_bytes", "mlp_hbm_bytes"):
        assert getattr(cost_model, name)(
            m, k, f, n, block_sparsity=s, block_m=block_m or 64) == \
            getattr(ref_cost, name)(m, k, f, n, block_sparsity=s,
                                    block_m=block_m or 64)


def test_sparsity_ema_and_tick_costs_equal_reference():
    from repro.core import cost_model as ref_cost
    from repro.core import sasa as ref_sasa
    from repro_torch.core import cost_model, sasa
    a, b = sasa.SparsityEMA(), ref_sasa.SparsityEMA()
    for skipped, total in ((0, 10), (5, 10), (0, 0), (9, 10), (3, 4)):
        assert a.update(skipped, total) == b.update(skipped, total)
        assert a.bucketed() == b.bucketed()
    for reduced in (False, True):
        cfg = get_config("smollm-135m")
        ref_cfg = ref_get_config("smollm-135m")
        if reduced:
            cfg, ref_cfg = cfg.reduced(), ref_cfg.reduced()
        got = cost_model.serve_tick_costs(cfg, 8)
        want = ref_cost.serve_tick_costs(ref_cfg, 8)
        assert (got.decode_tick_s, got.n_params, got.dtype_bytes) == (
            want.decode_tick_s, want.n_params, want.dtype_bytes)
        for rows in (1, 16, 256, 512):
            assert got.prefill_ticks(rows) == want.prefill_ticks(rows)
        assert cost_model.kv_row_bytes(cfg) == ref_cost.kv_row_bytes(ref_cfg)
