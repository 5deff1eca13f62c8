"""The port's serving engine against the reference engine.

Same config, same weights (carried over by the bridge), same seeded
harness traffic: the port's drain-mode ``Server.generate`` over the
paged pool, with the paged decode kernel and the fused gated-GLU kernel
(their plain versions on the CPU), must reproduce the reference's token
streams exactly and its integer and skip metrics exactly; the pool must
drain. The reference runs its Pallas kernels in interpret mode, as its
own tests do.
"""
import dataclasses

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
                attn_kernel="paged"):
    ref_cfg = ref_get_config("smollm-135m").reduced()
    params = ref_model.init_params(ref_cfg, jax.random.PRNGKey(0))
    np_params = jax.tree_util.tree_map(np.asarray, params)
    reqs = make_traffic(ref_cfg, traffic)

    ref_sc = ref_server.ServeConfig(
        batch_slots=slots, max_len=max_len, kv_block_size=16,
        attn_kernel=attn_kernel,
        sparsity=RefSparsityConfig(enabled=True, mode="fused", **sp_kwargs))
    ref_srv = ref_server.Server(ref_cfg, params, ref_sc)
    ref_done = ref_srv.generate(
        [dataclasses.replace(r, out=None, stats={}) for r in reqs])

    port_sc = port_server.ServeConfig(
        batch_slots=slots, max_len=max_len, kv_block_size=16,
        attn_kernel=attn_kernel,
        sparsity=SparsityConfig(enabled=True, mode="fused", **sp_kwargs))
    port_srv = port_server.Server(
        get_config("smollm-135m").reduced(),
        params_from_reference(np_params, device="cpu"), port_sc,
        device="cpu")
    port_done = port_srv.generate([
        port_server.Request(uid=r.uid, prompt=np.asarray(r.prompt),
                            max_new=r.max_new, eos_id=r.eos_id)
        for r in reqs])
    return ref_srv, ref_done, port_srv, port_done


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
    if case["sp"].get("block_m") == 1:
        assert port_srv.metrics.skipped_tile_dots > 0  # dead slots skip
    assert port_srv.metrics.attn_block_skip_fraction > 0
    # Every request finished its budget (or its EOS) and the pool drained.
    alloc = port_srv._st.alloc
    assert alloc.in_use == 0 and alloc.reserved == 0
    alloc.check(expect_reserved=0)
    for r in port_done:
        assert r.stats["tokens"] == len(r.out) >= 1


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
