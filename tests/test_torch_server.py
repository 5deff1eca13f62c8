"""The port's serving engine against the reference engine.

Same config, same weights (carried over by the bridge), same seeded
harness traffic: the port's drain-mode ``Server.generate`` over the
paged pool, with the paged decode kernel and the SparCE MLP kernels
(their plain versions on the CPU) -- the fused gated-GLU kernel, the
fused relu MLP kernel, the relu-bitmap and gated GEMM kernels -- must
reproduce the reference's token streams exactly and its integer and
skip metrics exactly; the pool must drain. The reference runs its Pallas
kernels in interpret mode, as its own tests do. The port's launcher is
held against the reference launcher on the same flags.
"""
import dataclasses
import re

import jax
import numpy as np
import pytest

from repro.configs import get_config as ref_get_config
from repro.core.sparse_ops import SparsityConfig as RefSparsityConfig
from repro.models import model as ref_model
from repro.runtime import server as ref_server
from repro_torch.bridge import params_from_reference
from repro_torch.configs import get_config
from repro_torch.core.sparse_ops import SparsityConfig
from repro_torch.runtime import server as port_server
from serving_harness import Traffic, make_traffic

# ServeMetrics fields that must match exactly: counts, skip counters,
# pool telemetry and every modeled quantity (wall-clock fields differ).
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
)


def _serve_both(sp_kwargs, traffic, *, slots=3, max_len=32,
                attn_kernel="paged", mode="fused", act=None):
    ref_cfg = ref_get_config("smollm-135m").reduced()
    cfg = get_config("smollm-135m").reduced()
    if act is not None:
        ref_cfg = dataclasses.replace(ref_cfg, mlp_act=act)
        cfg = dataclasses.replace(cfg, mlp_act=act)
    params = ref_model.init_params(ref_cfg, jax.random.PRNGKey(0))
    np_params = jax.tree_util.tree_map(np.asarray, params)
    reqs = make_traffic(ref_cfg, traffic)

    ref_sc = ref_server.ServeConfig(
        batch_slots=slots, max_len=max_len, kv_block_size=16,
        attn_kernel=attn_kernel,
        sparsity=RefSparsityConfig(enabled=True, mode=mode, **sp_kwargs))
    ref_srv = ref_server.Server(ref_cfg, params, ref_sc)
    ref_done = ref_srv.generate(
        [dataclasses.replace(r, out=None, stats={}) for r in reqs])

    port_sc = port_server.ServeConfig(
        batch_slots=slots, max_len=max_len, kv_block_size=16,
        attn_kernel=attn_kernel,
        sparsity=SparsityConfig(enabled=True, mode=mode, **sp_kwargs))
    port_srv = port_server.Server(
        cfg, params_from_reference(np_params, device="cpu"), port_sc,
        device="cpu")
    port_done = port_srv.generate([
        port_server.Request(uid=r.uid, prompt=np.asarray(r.prompt),
                            max_new=r.max_new, eos_id=r.eos_id)
        for r in reqs])
    return ref_srv, ref_done, port_srv, port_done


def _assert_engines_equal(ref_srv, ref_done, port_srv, port_done):
    """Tokens, completion and admission order, every exact metric; the
    pool drains and every request finished its budget (or its EOS)."""
    ref_out = {r.uid: np.asarray(r.out) for r in ref_done}
    port_out = {r.uid: np.asarray(r.out) for r in port_done}
    assert sorted(port_out) == sorted(ref_out)
    for uid, want in ref_out.items():
        np.testing.assert_array_equal(port_out[uid], want,
                                      err_msg=f"uid={uid}")
    assert [r.uid for r in port_done] == [r.uid for r in ref_done]
    assert list(port_srv.admitted_uids) == list(ref_srv.admitted_uids)
    for name in EXACT_FIELDS:
        assert getattr(port_srv.metrics, name) == getattr(
            ref_srv.metrics, name), name
    alloc = port_srv._st.alloc
    assert alloc.in_use == 0 and alloc.reserved == 0
    alloc.check(expect_reserved=0)
    for r in port_done:
        assert r.stats["tokens"] == len(r.out) >= 1


@pytest.mark.parametrize("case", [
    # The slice's config: block_m=64 rows per gate tile.
    dict(sp=dict(gate_threshold=0.0, autotune=False),
         traffic=Traffic(n_requests=6, prompt_lens=(2, 12), max_new=(1, 8),
                         seed=0)),
    # Per-slot gate tiles with a sparsity hint: dead slots really skip.
    dict(sp=dict(gate_threshold=0.0, autotune=False, block_m=1,
                 expected_sparsity=0.5),
         traffic=Traffic(n_requests=5, prompt_lens=(2, 12), max_new=(1, 8),
                         seed=3, eos_prob=0.5)),
], ids=["slice-config", "per-slot-tiles-eos"])
def test_generate_matches_reference_engine(case):
    ref_srv, ref_done, port_srv, port_done = _serve_both(
        case["sp"], case["traffic"])
    _assert_engines_equal(ref_srv, ref_done, port_srv, port_done)
    if case["sp"].get("block_m") == 1:
        assert port_srv.metrics.skipped_tile_dots > 0  # dead slots skip
    assert port_srv.metrics.attn_block_skip_fraction > 0


@pytest.mark.parametrize("case", [
    # The paper's relu MLP through the fused kernel, replanned from the
    # measured sparsity as the engine serves.
    dict(act="relu", mode="fused",
         sp=dict(block_m=1, block_k=32, autotune=True)),
    # The relu-bitmap kernel, then the gated GEMM kernel.
    dict(act="relu", mode="kernel", sp=dict(block_m=1, block_k=32)),
    # The gated GLU's bitmap, then the gated GEMM kernel.
    dict(act=None, mode="kernel", sp=dict(block_m=1)),
], ids=["relu-fused-autotune", "relu-kernel", "glu-kernel-bm1"])
def test_sparce_modes_match_reference_engine(case):
    traffic = Traffic(n_requests=5, prompt_lens=(2, 12), max_new=(2, 8),
                      seed=5)
    ref_srv, ref_done, port_srv, port_done = _serve_both(
        case["sp"], traffic, mode=case["mode"], act=case["act"])
    _assert_engines_equal(ref_srv, ref_done, port_srv, port_done)
    m = port_srv.metrics
    assert 0 < m.skipped_tile_dots < m.total_tile_dots  # dead slots skip
    if case["sp"].get("autotune"):
        assert m.replans >= 1  # the EMA crossed a bucket and replanned
    if case["act"] == "relu":
        assert m.modeled_hbm_bytes_saved > 0


def _launch_lines(main, argv, capsys):
    main(argv)
    return capsys.readouterr().out.splitlines()


def test_launcher_sparce_flags_match_reference_launcher(capsys,
                                                        monkeypatch):
    """``--sparce --sparce-mode fused`` on the reduced config: the port's
    launcher (on the CPU, with the reference's weights through the
    bridge) prints the same tokens and skip counters as the reference
    launcher, and serves the relu MLP the flag swaps in."""
    from repro.launch import serve as ref_serve
    from repro_torch.launch import serve as port_serve
    from repro_torch.models import model as port_model
    built = []

    def bridged_init(cfg, seed=0, device="cuda"):
        ref_cfg = dataclasses.replace(
            ref_get_config(cfg.name).reduced(), mlp_act=cfg.mlp_act)
        assert dataclasses.asdict(ref_cfg) == dataclasses.asdict(cfg)
        built.append(cfg.mlp_act)
        ref_params = ref_model.init_params(ref_cfg, jax.random.PRNGKey(seed))
        return params_from_reference(
            jax.tree_util.tree_map(np.asarray, ref_params), device=device)

    monkeypatch.setattr(port_model, "init_params", bridged_init)
    argv = ["--arch", "smollm-135m", "--reduced", "--requests", "3",
            "--prompt-len", "8", "--max-new", "4", "--batch-slots", "2",
            "--max-len", "32", "--attn-kernel", "gather", "--sparce",
            "--sparce-mode", "fused"]
    ref_lines = _launch_lines(ref_serve.main, argv, capsys)
    port_lines = _launch_lines(port_serve.main, argv + ["--device", "cpu"],
                               capsys)
    assert built == ["relu"]

    def picked(lines):
        skip = [ln for ln in lines if "mlp_skip_fraction" in ln]
        outs = [re.search(r"tokens=.*", ln).group(0) for ln in lines
                if "out=" in ln]
        return skip, outs

    ref_skip, ref_outs = picked(ref_lines)
    port_skip, port_outs = picked(port_lines)
    assert len(ref_skip) == 1 and len(ref_outs) == 3
    assert port_skip == ref_skip
    assert port_outs == ref_outs


def test_gather_and_paged_attention_serve_identically():
    traffic = Traffic(n_requests=4, prompt_lens=(3, 20), max_new=(2, 6),
                      seed=7)
    sp = dict(gate_threshold=0.0, autotune=False)
    cfg = get_config("smollm-135m").reduced()
    ref_cfg = ref_get_config("smollm-135m").reduced()
    params = params_from_reference(jax.tree_util.tree_map(
        np.asarray, ref_model.init_params(ref_cfg, jax.random.PRNGKey(1))),
        device="cpu")
    outs, metrics = {}, {}
    for kernel in ("gather", "paged"):
        srv = port_server.Server(cfg, params, port_server.ServeConfig(
            batch_slots=2, max_len=32, attn_kernel=kernel,
            sparsity=SparsityConfig(enabled=True, mode="fused", **sp)),
            device="cpu")
        done = srv.generate([
            port_server.Request(uid=r.uid, prompt=np.asarray(r.prompt),
                                max_new=r.max_new)
            for r in make_traffic(ref_cfg, traffic)])
        outs[kernel] = {r.uid: r.out.tolist() for r in done}
        metrics[kernel] = srv.metrics
    assert outs["gather"] == outs["paged"]
    for name in ("skipped_tile_dots", "total_tile_dots", "decode_tokens",
                 "attn_blocks_fetched", "attn_blocks_total"):
        assert getattr(metrics["gather"], name) == getattr(
            metrics["paged"], name)
    assert metrics["paged"].modeled_attn_bytes_saved > 0
    assert metrics["gather"].modeled_attn_bytes_saved == 0


@pytest.mark.parametrize("kwargs", [
    dict(kv_block_size=0), dict(prefix_cache=True), dict(mesh=(1, 2)),
    dict(slo=object()), dict(max_queue_depth=4), dict(preempt=True),
    dict(faults=object()),
])
def test_serve_config_rejects_unported_paths(kwargs):
    with pytest.raises(NotImplementedError, match="not ported yet"):
        port_server.ServeConfig(**kwargs)


def test_serve_config_validates_values():
    with pytest.raises(ValueError, match="batch_slots"):
        port_server.ServeConfig(batch_slots=0)
    with pytest.raises(ValueError, match="attn_kernel"):
        port_server.ServeConfig(attn_kernel="flash")


def test_validate_rejects_requests_that_never_fit():
    cfg = get_config("smollm-135m").reduced()
    from repro_torch.models import model as port_model
    params = port_model.init_params(cfg, seed=0, device="cpu")
    srv = port_server.Server(cfg, params, port_server.ServeConfig(
        batch_slots=2, max_len=16), device="cpu")
    with pytest.raises(ValueError, match="max_len"):
        srv.generate([port_server.Request(uid=0, prompt=np.arange(12),
                                          max_new=8)])
