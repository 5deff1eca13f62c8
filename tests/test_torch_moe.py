"""DeepSeek-V3 (MLA + MoE) in the port against the reference, on the CPU.

``moe_forward`` against the reference's global path in a dropping and a
dropless regime (routing, ``keep`` and ``slot_sparsity`` exactly, values
``allclose``), the reduced model's forward and decode, the serving
engine (paged and gather, with and without EOS) and the launcher. The
reduced config is f32; weights come from the reference's ``init_params``
through the bridge; the reference's Pallas kernels run in interpret
mode. Tolerances are f32 sums in another order.
"""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import model as ref_model
from repro.models import moe as ref_moe
from repro.runtime import server as ref_server
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.models import model as model_lib
from repro_torch.models import modules
from repro_torch.models import moe
from repro_torch.runtime import server as port_server
from serving_harness import Traffic, make_traffic

ARCH = "deepseek-v3-671b"
ATOL = 1e-4  # f32 values through several products, sums in another order


def _cfgs(capacity_factor=None):
    ref_cfg, cfg = ref_get_config(ARCH).reduced(), get_config(ARCH).reduced()
    if capacity_factor is not None:
        ref_cfg = dataclasses.replace(ref_cfg, moe=dataclasses.replace(
            ref_cfg.moe, capacity_factor=capacity_factor))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor))
    return ref_cfg, cfg


def _model(seed=0, capacity_factor=None):
    ref_cfg, cfg = _cfgs(capacity_factor)
    ref_params = ref_model.init_params(ref_cfg, jax.random.PRNGKey(seed))
    params = bridge.params_from_reference(
        jax.tree_util.tree_map(np.asarray, ref_params), device="cpu")
    return ref_cfg, cfg, ref_params, params


# -------------------------------------------------------------------- MoE
def _ref_routing(p, x, cfg):
    """The reference global path's routing and dispatch, step by step in
    its own ops: (idx, keep in sorted order, slot)."""
    m = cfg.moe
    xf = x.reshape(-1, x.shape[-1])
    T = xf.shape[0]
    probs = jax.nn.softmax(jnp.dot(xf.astype(jnp.float32),
                                   p["router"].astype(jnp.float32)), -1)
    _, idx = jax.lax.top_k(probs, m.top_k)
    C = ref_moe.capacity(T, cfg)
    flat_e = idx.reshape(-1)
    order = jnp.argsort(flat_e, stable=True)
    se = flat_e[order]
    first = jnp.searchsorted(se, se, side="left")
    pos = jnp.arange(se.shape[0], dtype=jnp.int32) - first.astype(jnp.int32)
    keep = pos < C
    slot = jnp.where(keep, se * C + pos, m.num_experts * C)
    return np.asarray(idx), np.asarray(keep), np.asarray(slot), C


@pytest.mark.parametrize("regime,capacity_factor,T", [
    ("dropping", 0.5, 40),   # C = 16 rows for ~20 assignments per expert
    ("dropless", 16.0, 40),
    ("decode", None, 8),     # 8 slots at the published factor: C = 8
])
def test_moe_forward_matches_reference_global_path(regime, capacity_factor,
                                                   T):
    ref_cfg, cfg = _cfgs(capacity_factor)
    ref_p = jax.tree_util.tree_map(
        np.asarray, ref_moe.moe_init(jax.random.PRNGKey(3), ref_cfg,
                                     jnp.float32))
    port_p = jax.tree_util.tree_map(lambda a: torch.from_numpy(a.copy()),
                                    ref_p)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((1, T, cfg.d_model)).astype(np.float32)
    x[0, ::5] = 0.0  # dead-slot rows: all router logits equal
    y_ref, aux_ref, occ_ref = ref_moe._moe_forward_global(
        ref_p, jnp.asarray(x), ref_cfg)
    y, aux, occ = moe.moe_forward(port_p, torch.from_numpy(x), cfg)

    idx_ref, keep_ref, slot_ref, C = _ref_routing(ref_p, x, ref_cfg)
    assert moe.capacity(T, cfg) == ref_moe.capacity(T, ref_cfg) == C
    _, _, idx = moe.route(torch.from_numpy(x[0]),
                          torch.from_numpy(ref_p["router"]), cfg.moe.top_k)
    np.testing.assert_array_equal(idx.numpy(), idx_ref)
    assert (idx.numpy()[::5] == np.arange(cfg.moe.top_k)).all()  # ties
    _, _, keep, slot = moe.dispatch(idx, C, cfg.moe.num_experts)
    np.testing.assert_array_equal(keep.numpy(), keep_ref)
    np.testing.assert_array_equal(slot.numpy(), slot_ref)
    assert float(occ) == float(occ_ref)  # slot_sparsity, exactly
    if regime == "dropping":
        assert not keep_ref.all()
    else:
        assert keep_ref.all()
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=ATOL,
                               atol=ATOL)
    np.testing.assert_allclose(float(aux), float(aux_ref), rtol=1e-6)


def test_moe_combine_is_deterministic_and_tie_stable():
    """All-zero rows route to experts 0..K-1 whatever the sort's
    implementation, and two runs give the same bits."""
    _, cfg = _cfgs()
    rng = np.random.default_rng(5)
    p = moe.moe_init(rng, cfg, torch.float32, "cpu")
    x = torch.zeros((2, 6, cfg.d_model))
    x[0, 1] = 1.0
    y1, _, _ = moe.moe_forward(p, x, cfg)
    y2, _, _ = moe.moe_forward(p, x, cfg)
    assert torch.equal(y1, y2)
    _, _, idx = moe.route(x.reshape(-1, cfg.d_model), p["router"],
                          cfg.moe.top_k)
    zero_rows = [i for i in range(12) if i != 1]
    assert (idx[zero_rows] == torch.arange(cfg.moe.top_k)).all()


# ------------------------------------------------------------------ model
def test_forward_matches_reference_and_rejects_bucketed_prefill():
    ref_cfg, cfg, ref_params, params = _model()
    rng = np.random.default_rng(6)
    toks = rng.integers(0, cfg.vocab_size, (2, 9)).astype(np.int32)
    logits, _, aux = model_lib.forward(params, cfg,
                                       {"tokens": torch.from_numpy(toks)})
    want, _, aux_ref = ref_model.forward(ref_params, ref_cfg,
                                         {"tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), rtol=ATOL,
                               atol=ATOL)
    np.testing.assert_allclose(float(aux["loss"]), float(aux_ref["loss"]),
                               rtol=1e-6)
    np.testing.assert_array_equal(aux["skip"].numpy(),
                                  np.asarray(aux_ref["skip"]))
    caches = model_lib.init_caches(cfg, 1, 16, device="cpu")
    with pytest.raises(ValueError, match="bucketed prefill"):
        model_lib.forward(params, cfg, {
            "tokens": torch.zeros((1, 16), dtype=torch.long),
            "advance": torch.tensor([9], dtype=torch.int32)}, caches)


def test_decode_matches_full_forward_dropless():
    """Prefill then token-by-token absorbed decode (contiguous latent
    cache) reproduces the full-sequence logits in the drop-free regime,
    and the reference's decode logits."""
    ref_cfg, cfg, ref_params, params = _model(1, capacity_factor=16.0)
    rng = np.random.default_rng(7)
    S, pre = 12, 8
    toks = rng.integers(0, cfg.vocab_size, (1, S)).astype(np.int32)
    full, _, _ = model_lib.forward(params, cfg,
                                   {"tokens": torch.from_numpy(toks)})
    caches = model_lib.init_caches(cfg, 1, S, device="cpu")
    logits, caches, _ = model_lib.forward(
        params, cfg, {"tokens": torch.from_numpy(toks[:, :pre])}, caches)
    ref_logits, ref_caches = ref_model.prefill(
        ref_params, ref_cfg, {"tokens": jnp.asarray(toks[:, :pre])}, S)
    np.testing.assert_allclose(logits.numpy(), full.numpy()[:, :pre],
                               rtol=ATOL, atol=ATOL)
    for t in range(pre, S):
        step, caches, _ = model_lib.forward(
            params, cfg, {"tokens": torch.from_numpy(toks[:, t:t + 1])},
            caches)
        ref_step, ref_caches = ref_model.decode_step(
            ref_params, ref_cfg, jnp.asarray(toks[:, t:t + 1]), ref_caches)
        np.testing.assert_allclose(step.numpy()[:, 0], full.numpy()[:, t],
                                   rtol=ATOL, atol=ATOL)
        np.testing.assert_allclose(step.numpy(), np.asarray(ref_step),
                                   rtol=ATOL, atol=ATOL)
    assert caches["stack"].length.tolist() == [[S]]
    assert caches["dense_stack"].length.tolist() == [[S]]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridged_moe_tree_exact(dtype):
    """Both stacks, the MoE router, (E, d, de) experts and the shared
    expert cross the bridge bit for bit, in the port's own tree."""
    ref_cfg, cfg = _cfgs()
    ref_cfg = dataclasses.replace(ref_cfg, dtype=dtype)
    cfg = dataclasses.replace(cfg, dtype=dtype)
    ref_params = jax.tree_util.tree_map(
        np.asarray, ref_model.init_params(ref_cfg, jax.random.PRNGKey(0)))
    port = bridge.params_from_reference(ref_params, device="cpu")
    own = model_lib.init_params(cfg, seed=0, device="cpu")
    assert len(port["dense_stack"]) == cfg.first_k_dense
    assert len(port["stack"]) == cfg.num_layers - cfg.first_k_dense
    for key in ("dense_stack", "stack"):
        flat = jax.tree_util.tree_flatten_with_path(ref_params[key])[0]
        for path, leaf in flat:
            names = [p.key for p in path]
            for i in range(len(port[key])):
                b, o = port[key][i], own[key][i]
                for k in names:
                    b, o = b[k], o[k]
                assert tuple(b.shape) == tuple(o.shape) == leaf.shape[1:]
                assert b.dtype == o.dtype
                bits = (b.view(torch.int16) if b.dtype == torch.bfloat16
                        else b).numpy()
                want = (leaf[i].view(np.int16)
                        if leaf.dtype.name == "bfloat16" else leaf[i])
                np.testing.assert_array_equal(bits, want)
    assert sorted(port["stack"][0]["moe"]) == ["router", "shared", "w_gate",
                                               "w_in", "w_out"]
    n_ref = sum(a.size for a in jax.tree_util.tree_leaves(ref_params))
    assert modules.param_count(port) == modules.param_count(own) == n_ref


# ----------------------------------------------------------------- engine
EXACT_FIELDS = (
    "prefill_tokens", "decode_tokens", "ticks", "admitted", "completed",
    "replans", "skipped_tile_dots", "total_tile_dots", "mlp_skip_fraction",
    "prefill_skipped_tile_dots", "prefill_total_tile_dots",
    "modeled_hbm_bytes_saved", "kv_paged", "kv_block_size",
    "kv_pool_blocks", "kv_blocks_peak_in_use", "kv_pool_peak_occupancy",
    "kv_internal_frag", "kv_bytes_reserved", "kv_bytes_reserved_contiguous",
    "kv_bytes_saved_frac", "kv_reserved_bytes_per_token",
    "kv_pool_mean_occupancy", "prefill_traces", "attn_kernel_paged",
    "attn_blocks_fetched", "attn_blocks_total", "attn_block_skip_fraction",
    "attn_bytes_gather", "attn_bytes_paged", "attn_bytes_saved_frac",
    "modeled_attn_bytes_saved", "queue_depth", "queue_depth_peak",
    "ttft_ticks_p50", "ttft_ticks_p95", "ttft_ticks_p99", "itl_ticks_p50",
    "itl_ticks_p95", "itl_ticks_p99", "sched_admitted", "sched_deferred",
    "sched_forced", "prefill_tick_share", "decode_tick_share",
    "slo_ttft_violations",
)


@pytest.mark.parametrize("attn_kernel,eos", [
    ("paged", False), ("gather", False), ("paged", True), ("gather", True),
], ids=["paged", "gather", "paged-eos", "gather-eos"])
def test_generate_matches_reference_engine(attn_kernel, eos):
    """Tokens, completion and admission order and every integer, skip and
    modeled ServeMetrics field equal the reference engine's; the pool
    drains. MoE serving prefills at exact length (one shape per prompt
    length), with SparCE on in the dense layers. With ``eos`` the EOS id
    is a token the engine emits mid-stream (read off a run without it),
    so slots release early and neighbours keep decoding."""
    from repro.core.sparse_ops import SparsityConfig as RefSparsity
    from repro_torch.core.sparse_ops import SparsityConfig
    ref_cfg, cfg, ref_params, params = _model(2)
    reqs = make_traffic(ref_cfg, Traffic(n_requests=5, prompt_lens=(2, 12),
                                         max_new=(2, 7), seed=0))
    port_reqs = lambda: [  # noqa: E731
        port_server.Request(uid=r.uid, prompt=np.asarray(r.prompt),
                            max_new=r.max_new) for r in reqs]
    sp = dict(enabled=True, mode="fused", block_m=1, gate_threshold=0.0,
              expected_sparsity=0.5)
    common = dict(batch_slots=3, max_len=32, kv_block_size=8,
                  attn_kernel=attn_kernel)

    def port_engine(eos_id):
        return port_server.Server(cfg, params, port_server.ServeConfig(
            sparsity=SparsityConfig(**sp), eos_id=eos_id, **common),
            device="cpu")

    eos_id = None
    if eos:
        first = port_engine(None).generate(port_reqs())
        eos_id = int(first[0].out[1])
    ref_srv = ref_server.Server(ref_cfg, ref_params, ref_server.ServeConfig(
        sparsity=RefSparsity(**sp), eos_id=eos_id, **common))
    ref_done = ref_srv.generate(
        [dataclasses.replace(r, out=None, stats={}) for r in reqs])
    srv = port_engine(eos_id)
    done = srv.generate(port_reqs())
    assert srv._buckets == () and ref_srv._buckets == ()
    ref_out = {r.uid: np.asarray(r.out) for r in ref_done}
    for r in done:
        np.testing.assert_array_equal(r.out, ref_out[r.uid],
                                      err_msg=f"uid={r.uid}")
    assert [r.uid for r in done] == [r.uid for r in ref_done]
    assert list(srv.admitted_uids) == list(ref_srv.admitted_uids)
    for name in EXACT_FIELDS:
        assert getattr(srv.metrics, name) == getattr(ref_srv.metrics,
                                                     name), name
    m = srv.metrics
    assert m.prefill_traces == len({len(r.prompt) for r in reqs})
    assert m.skipped_tile_dots > 0  # dead slots' dense-layer tiles
    assert m.modeled_hbm_bytes_saved == 0.0  # moe: no modeled MLP bytes
    assert 0 < m.attn_block_skip_fraction < 1
    if eos:
        assert any(len(r.out) < r.max_new for r in done)
    alloc = srv._st.alloc
    assert alloc.in_use == 0 and alloc.reserved == 0


def test_launcher_matches_reference_launcher(capsys, monkeypatch):
    """``--arch deepseek-v3-671b --reduced``: the port's launcher (on the
    CPU, with the reference's weights through the bridge) prints the
    tokens, skip and attention-fetch counters the reference's prints."""
    from repro.launch import serve as ref_serve
    from repro_torch.launch import serve as port_serve

    def bridged_init(cfg, seed=0, device="cuda"):
        ref_cfg = ref_get_config(cfg.name).reduced()
        assert dataclasses.asdict(ref_cfg) == dataclasses.asdict(cfg)
        ref_params = ref_model.init_params(ref_cfg, jax.random.PRNGKey(seed))
        return bridge.params_from_reference(
            jax.tree_util.tree_map(np.asarray, ref_params), device=device)

    monkeypatch.setattr(model_lib, "init_params", bridged_init)
    argv = ["--arch", ARCH, "--reduced", "--requests", "3", "--prompt-len",
            "8", "--max-new", "5", "--batch-slots", "2", "--max-len", "32",
            "--mixed", "--attn-kernel", "paged", "--eos-id", "7"]

    def picked(main, extra):
        main(argv + extra)
        lines = capsys.readouterr().out.splitlines()
        outs = [re.search(r"tokens=.*", ln).group(0) for ln in lines
                if "out=" in ln]
        attn = [re.sub(r";.*", "", ln) for ln in lines
                if "decode attn" in ln]
        served = [re.sub(r" ticks.*", "", ln) for ln in lines
                  if ln.startswith("served")]
        return outs, attn, served

    ref = picked(ref_serve.main, [])
    port = picked(port_serve.main, ["--device", "cpu"])
    assert len(ref[0]) == 3 and len(ref[1]) == 1 and len(ref[2]) == 1
    assert port == ref
