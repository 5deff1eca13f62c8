"""Serving on a (data, model) mesh over ``torch.distributed`` (gloo, CPU)
against the single-host port.

The reference's sharded-serving tests cannot be the oracle here (they
fail in this sandbox's jax), so the sharded port is held against the
single-host port, which the other port tests hold against the
reference. Sharding is an execution detail: on every mesh the token
streams and every exact-parity counter (the reference's ``PARITY_KEYS``)
must equal the single-host run's, with the skip counters summed over the
shards. Reduced ``smollm-135m`` in f32; the ranks are spawned processes
(``launch/mesh.py:spawn_mesh``) running several scenarios per spawn,
every process group with a 20 s timeout and every spawn with a deadline.
The refusals are held to the reference's exception types in process,
and the per-shard skip contract (blocks each shard's GQA reads, NaN in a
shard's dead blocks and stripes) is checked on the plain kernels at the
shapes a shard gives them.
"""
import dataclasses
import time

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.core.sparse_ops import SparsityConfig as RefSparsityConfig
from repro.models import model as ref_model
from repro.runtime import server as ref_server
from repro_torch.configs import get_config
from repro_torch.core.sparse_ops import SparsityConfig
from repro_torch.kernels import ops as kops
from repro_torch.kernels import paged_decode_attn as pda
from repro_torch.kernels import ref as kref
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import model as model_lib
from repro_torch.runtime import server as port_server
from serving_harness import (
    OpenLoopTraffic, Traffic, make_open_loop_trace, make_traffic,
)
import torch_mesh_scenarios as scen

MESHES = [(2, 1), (1, 2), (2, 2)]  # data x model
TIMEOUT_S = 20.0  # every process group's timeout
DEADLINE_S = 240.0  # every spawn's

# Exact-parity fields (the reference's tests/test_spmd_serving.py).
PARITY_KEYS = (
    "prefill_tokens", "decode_tokens", "ticks", "admitted", "completed",
    "skipped_tile_dots", "total_tile_dots", "mlp_skip_fraction",
    "attn_blocks_fetched", "attn_blocks_total", "attn_block_skip_fraction",
    "kv_blocks_peak_in_use", "modeled_hbm_bytes_saved",
    "modeled_attn_bytes_saved",
)
# Every metric read off the virtual clock or counted (no wall clock).
LIVE_KEYS = PARITY_KEYS + (
    "ttft_ticks_p50", "ttft_ticks_p95", "ttft_ticks_p99", "itl_ticks_p50",
    "itl_ticks_p99", "slo_ttft_violations", "slo_itl_violations",
    "sched_admitted", "sched_deferred", "sched_forced", "preemptions",
    "requeues", "preempt_restore_ticks", "prefill_tick_share",
    "kv_pool_mean_occupancy", "kv_internal_frag",
)
PREFIX_KEYS = (
    "prefix_lookups", "prefix_hits", "prefix_matched_tokens",
    "prefix_blocks_shared", "prefix_cow_forks", "prefill_ticks_saved",
    "prefill_tokens", "decode_tokens", "skipped_tile_dots",
    "total_tile_dots",
)

RELU_SP = dict(enabled=True, mode="reference", block_m=1, block_k=32)
# expected_sparsity 0.5: the planner's pick at these widths is then the
# fused GLU (at 0 it is dense, which skips and counts nothing).
GLU_SP = dict(enabled=True, mode="fused", block_m=1, block_k=32,
              gate_threshold=0.0, autotune=False, expected_sparsity=0.5)
BASE_SC = dict(batch_slots=4, max_len=64, kv_block_size=8,
               attn_kernel="paged")


def _port_reqs(reqs):
    return [port_server.Request(uid=r.uid, prompt=np.asarray(r.prompt),
                                max_new=r.max_new, eos_id=r.eos_id)
            for r in reqs]


def _prefix_reqs(cfg, n=6, shared_len=16, seed=3):
    """Prompts behind one seeded 16-token prefix (2 full 8-row blocks),
    the reference's prefix-cache workload."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, cfg.vocab_size, shared_len)
    reqs = make_traffic(cfg, Traffic(
        n_requests=n, prompt_lens=(1, 8), max_new=(1, 6), seed=seed))
    return [port_server.Request(
        uid=r.uid, prompt=np.concatenate([shared, np.asarray(r.prompt)]),
        max_new=r.max_new) for r in reqs]


def _specs():
    cfg = ref_get_config("smollm-135m").reduced()
    relu_reqs = _port_reqs(make_traffic(cfg, Traffic(
        n_requests=6, prompt_lens=(2, 12), max_new=(1, 8), seed=0,
        eos_prob=0.3)))
    glu_reqs = _port_reqs(make_traffic(cfg, Traffic(
        n_requests=5, prompt_lens=(2, 10), max_new=(1, 6), seed=2,
        eos_prob=0.2)))
    prefix = _prefix_reqs(cfg)
    rng = np.random.default_rng(0)
    # Two long low-priority requests fill both slots (one per data
    # shard on a (2, x) mesh); an urgent arrival with a tight deadline
    # has to evict one.
    victims = [port_server.Request(uid=u, prompt=rng.integers(0, 256, 6),
                                   max_new=24) for u in (0, 1)]
    urgent = port_server.Request(uid=2, prompt=rng.integers(0, 256, 4),
                                 max_new=4)
    slo = OpenLoopTraffic(n_requests=8, prompt_lens=(2, 10), max_new=(2, 8),
                          seed=5, rate_per_tick=0.5)
    slo_trace = [(a, _port_reqs([r])[0])
                 for a, r in make_open_loop_trace(cfg, slo)]
    relu_sc = dict(BASE_SC, sparsity=RELU_SP)
    return {
        "relu": dict(name="relu", act="relu", sc=relu_sc,
                     requests=relu_reqs),
        # The head dim left to d_model // num_heads, as the full
        # smollm-135m leaves it.
        "relu-hd": dict(name="relu-hd", act="relu", cfg=dict(head_dim=0),
                        sc=relu_sc, requests=relu_reqs),
        "glu": dict(name="glu", seed=1, sc=dict(BASE_SC, sparsity=GLU_SP),
                    requests=glu_reqs),
        "prefix": dict(name="prefix", act="relu",
                       sc=dict(relu_sc, prefix_cache=True), requests=prefix),
        "prefix-off": dict(name="prefix-off", act="relu", sc=relu_sc,
                           requests=prefix),
        "preempt": dict(
            name="preempt", act="relu", driver="serve_trace",
            sc=dict(relu_sc, batch_slots=2, preempt=True, prefix_cache=True,
                    slo=dict(target_ttft_ticks=64.0, target_itl_ticks=2.0)),
            trace=[(0.0, victims[0]), (0.0, victims[1]), (3.0, urgent)],
            priorities={2: 5.0}, deadlines={2: 6.0}),
        "slo": dict(
            name="slo", act="relu", driver="serve_trace",
            sc=dict(relu_sc, slo=dict(target_ttft_ticks=32.0,
                                      target_itl_ticks=3.0)),
            trace=slo_trace),
        "async": dict(name="async", driver="async",
                      sc=dict(BASE_SC, sparsity=GLU_SP), seed=1,
                      requests=glu_reqs),
    }


# Scenarios per mesh: several per spawn.
PLAN = {
    (2, 1): ("relu", "prefix", "preempt"),
    (1, 2): ("relu", "prefix", "relu-hd"),
    (2, 2): ("relu", "glu", "prefix", "slo", "async"),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def specs():
    return _specs()


@pytest.fixture(scope="module")
def single(specs):
    """The single-host port's run of every scenario: the oracle."""
    return {name: scen.run_scenario(spec) for name, spec in specs.items()}


@pytest.fixture(scope="module")
def runs(specs):
    """{mesh: [each rank's (coords, logits digests, result)]}."""
    out = {}
    for mesh, names in PLAN.items():
        out[mesh] = mesh_lib.spawn_mesh(
            scen.rank_main, mesh, ([specs[n] for n in names],),
            device="cpu", backend="gloo", timeout_s=TIMEOUT_S,
            deadline_s=DEADLINE_S)
    return out


def _result(runs, mesh, name):
    (res,) = [r for r in runs[mesh][0]["out"] if r["name"] == name]
    return res


def _assert_keys(got, want, keys, what):
    for k in keys:
        assert got["metrics"][k] == want["metrics"][k], (
            f"{what}: {k}={got['metrics'][k]} != single-host "
            f"{want['metrics'][k]}")


# ------------------------------------------------------- engine parity
@pytest.mark.parametrize("mesh", MESHES)
def test_relu_tokens_and_parity_keys_equal_single_host(runs, single, mesh):
    """relu ``mode="reference"`` (block_m 1, block_k 32), paged attention
    and EOS mid-stream: tokens and every summed counter as on one host;
    the workload skips tiles and blocks."""
    got, want = _result(runs, mesh, "relu"), single["relu"]
    assert got["tokens"] == want["tokens"]
    _assert_keys(got, want, PARITY_KEYS, f"relu {mesh}")
    m = got["metrics"]
    assert (m["mesh_data"], m["mesh_model"]) == tuple(map(float, mesh))
    assert want["metrics"]["mesh_data"] == want["metrics"]["mesh_model"] == 0
    assert want["metrics"]["skipped_tile_dots"] > 0
    assert want["metrics"]["attn_blocks_total"] > 0
    assert want["metrics"]["completed"] == 6
    assert got["shards"] == mesh[0] and got["pool_clean"]


def test_unset_head_dim_parity_on_model_mesh(runs, single):
    """A config whose head dim is d_model // num_heads serves on (1, 2)
    with the whole model's head dim on each shard."""
    got, want = _result(runs, (1, 2), "relu-hd"), single["relu-hd"]
    assert got["tokens"] == want["tokens"] == single["relu"]["tokens"]
    _assert_keys(got, want, PARITY_KEYS, "relu-hd (1, 2)")


def test_glu_fused_parity_on_2x2(runs, single):
    """The gated GLU through the fused GLU kernel's plain version on the
    full (2, 2) mesh: each model shard's gate bitmap covers its own d_ff/tp
    columns, and the summed ledger equals the single host's."""
    got, want = _result(runs, (2, 2), "glu"), single["glu"]
    assert got["tokens"] == want["tokens"]
    _assert_keys(got, want, PARITY_KEYS, "glu (2, 2)")
    assert want["metrics"]["skipped_tile_dots"] > 0


def test_prefix_cache_exact_on_model_mesh(runs, single):
    """On (1, 2) there is one data shard, so the prefix index is the
    single host's: hits, shared blocks, CoW forks and savings equal."""
    got, want = _result(runs, (1, 2), "prefix"), single["prefix"]
    assert got["tokens"] == want["tokens"]
    assert want["metrics"]["prefix_hits"] > 0
    assert want["metrics"]["prefix_blocks_shared"] > 0
    _assert_keys(got, want, PREFIX_KEYS, "prefix (1, 2)")
    assert got["pool_clean"]


@pytest.mark.parametrize("mesh", [(2, 1), (2, 2)])
def test_prefix_cache_tokens_on_data_mesh(runs, single, mesh):
    """With dp > 1 every data shard keeps its own prefix index, so hits
    differ from one host's; the tokens equal the cache-off single-host
    run's, and so does the decode part of the skip ledger."""
    got, want = _result(runs, mesh, "prefix"), single["prefix-off"]
    assert got["tokens"] == want["tokens"]
    m, w = got["metrics"], want["metrics"]
    assert m["prefix_hits"] > 0
    assert (m["skipped_tile_dots"] - m["prefill_skipped_tile_dots"]
            == w["skipped_tile_dots"] - w["prefill_skipped_tile_dots"])
    assert got["pool_clean"] and got["shards"] == mesh[0]


def test_preemption_on_data_mesh(runs, single):
    """On (2, 1) each of the two slots is its own data shard: the urgent
    head evicts a victim on the other shard's slot, which restores from
    its registered blocks (its shard's prefix index). Schedule, tokens
    and counters equal one host's."""
    got, want = _result(runs, (2, 1), "preempt"), single["preempt"]
    assert got["metrics"]["preemptions"] >= 1
    assert got["tokens"] == want["tokens"]
    assert got["admitted"] == want["admitted"]
    assert got["failed"] == want["failed"]
    _assert_keys(got, want, LIVE_KEYS, "preempt (2, 1)")
    assert got["pool_clean"]


def test_serve_trace_under_slo_on_2x2(runs, single):
    got, want = _result(runs, (2, 2), "slo"), single["slo"]
    assert got["tokens"] == want["tokens"]
    assert got["admitted"] == want["admitted"]
    _assert_keys(got, want, LIVE_KEYS, "slo (2, 2)")
    assert got["metrics"]["ttft_ticks_p99"] > 0


def test_async_server_on_2x2(runs, single):
    """``AsyncServer``: its engine thread on rank 0 drives the mesh;
    submitted before start, the FIFO schedule equals one host's."""
    got, want = _result(runs, (2, 2), "async"), single["async"]
    assert got["tokens"] == want["tokens"] == single["glu"]["tokens"]
    assert got["admitted"] == want["admitted"]
    assert got["streamed"] == sorted(want["tokens"])
    _assert_keys(got, want, PARITY_KEYS, "async (2, 2)")


@pytest.mark.parametrize("mesh", MESHES)
def test_model_ranks_logits_bitwise_equal(runs, mesh):
    """After every decode tick each model rank of a data group holds the
    same logits bits (its residual stream never drifts), and every rank
    ran every tick."""
    outs = runs[mesh]
    ticks = sum(r["metrics"]["ticks"] for r in outs[0]["out"])
    by_group = {}
    for o in outs:
        assert len(o["digests"]) == ticks
        by_group.setdefault(o["coords"]["data"], []).append(o["digests"])
    for group in by_group.values():
        for d in group[1:]:
            assert d == group[0]
    if mesh[0] > 1:  # different slots on the two data groups
        assert by_group[0] != by_group[1]


@pytest.mark.parametrize("mesh", MESHES)
def test_worker_collectives_count_the_psums(runs, mesh):
    """A worker's collectives, counted: per decode tick one psum per
    attention block and per MLP on a model group, plus the skip
    counters' sum; per prefill of its data group the same over 'model'."""
    outs = runs[mesh]
    L = get_config("smollm-135m").reduced().num_layers
    dp, tp = mesh
    results = outs[0]["out"]
    per_tick = (2 * L if tp > 1 else 0) + 1
    per_prefill = (2 * L + 1) if tp > 1 else 0
    for o in outs[1:]:
        engines = o["out"]
        assert len(engines) == len(results)  # one per Server opened
        for r, e in zip(results, engines):
            c = e["collectives"]
            ticks = r["metrics"]["ticks"]
            if dp == 1:  # every prefill runs on this rank's data group
                assert c["counts"]["all-reduce"] == (
                    ticks * per_tick + len(r["admitted"]) * per_prefill)
            else:
                assert c["counts"]["all-reduce"] >= ticks * per_tick
            assert c["all-reduce"] > 0 and c["total"] >= c["all-reduce"]
            if dp > 1 and o["coords"]["model"] == 0:
                assert c["counts"]["all-gather"] == ticks


# ------------------------------------------------------------ refusals
def _ref_params(cfg):
    return ref_model.init_params(cfg, jax.random.PRNGKey(0))


REFUSALS = {
    "axes": dict(sc=dict(mesh=(0, 1))),
    "contiguous": dict(sc=dict(mesh=(1, 2), kv_block_size=0)),
    "slots": dict(sc=dict(mesh=(3, 1), batch_slots=4)),
    "moe": dict(arch="deepseek-v3-671b", sc=dict(mesh=(1, 2))),
    "ssm": dict(arch="mamba2-2.7b", sc=dict(mesh=(1, 2))),
    "heads": dict(sc=dict(mesh=(1, 3))),
    "pool": dict(sc=dict(mesh=(2, 1), kv_pool_blocks=7)),
    "block_k": dict(act="relu", sc=dict(mesh=(1, 2)),
                    sp=dict(enabled=True, mode="reference", block_m=1,
                            block_k=128)),
    "block_m": dict(act="relu", sc=dict(mesh=(2, 1)),
                    sp=dict(enabled=True, mode="reference", block_m=4,
                            block_k=32)),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_mesh_refusals_match_reference(case):
    """Each refusal raises the reference's exception type and message,
    before any rank is needed."""
    c = REFUSALS[case]
    arch = c.get("arch", "smollm-135m")
    ref_cfg, cfg = ref_get_config(arch).reduced(), get_config(arch).reduced()
    if c.get("act"):
        ref_cfg = dataclasses.replace(ref_cfg, mlp_act=c["act"])
        cfg = dataclasses.replace(cfg, mlp_act=c["act"])
    kw = dict(dict(batch_slots=4, max_len=32, kv_block_size=8), **c["sc"])
    sp = c.get("sp")
    with pytest.raises(Exception) as want:
        ref_sc = ref_server.ServeConfig(
            sparsity=None if sp is None else RefSparsityConfig(**sp), **kw)
        ref_server.Server(ref_cfg, _ref_params(ref_cfg), ref_sc)
    with pytest.raises(Exception) as got:
        sc = port_server.ServeConfig(
            sparsity=None if sp is None else SparsityConfig(**sp), **kw)
        port_server.Server(cfg, model_lib.init_params(cfg, device="cpu"),
                           sc, device="cpu")
    assert type(got.value) is type(want.value) is ValueError
    assert str(got.value) == str(want.value)


def test_mesh_without_ranks_raises_runtime_error():
    """A valid mesh config in a process that is not rank 0 of such a mesh
    is a RuntimeError, as the reference's is with too few devices."""
    cfg = get_config("smollm-135m").reduced()
    sc = port_server.ServeConfig(batch_slots=4, max_len=32, mesh=(2, 2))
    with pytest.raises(RuntimeError, match="spawn_mesh"):
        port_server.Server(cfg, model_lib.init_params(cfg, device="cpu"),
                           sc, device="cpu")
    with pytest.raises(RuntimeError, match="initialized world"):
        mesh_lib.make_mesh((2, 2), ("data", "model"))
    with pytest.raises(RuntimeError, match="initialized world"):
        mesh_lib.make_production_mesh()


def test_idle_engine_keeps_its_workers(specs):
    """An AsyncServer idling for longer than the groups' timeout between
    two batches: rank 0's keepalive keeps the workers waiting, and the
    second batch serves the first's tokens."""
    spec = dict(specs["async"], idle_s=6.0)
    (out,) = mesh_lib.spawn_mesh(
        scen.rank_main, (1, 2), ([spec],), device="cpu", backend="gloo",
        timeout_s=4.0, deadline_s=120.0)[0]["out"]
    assert out["tokens"] == out["again"]
    assert len(out["tokens"]) == len(spec["requests"])


def test_failing_worker_fails_the_run_within_the_timeout(specs):
    """A worker raising in the middle of a decode tick ends the run with
    an error naming it, within the groups' timeout, and no rank is left
    running."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="injected failure on rank 1"):
        mesh_lib.spawn_mesh(scen.rank_main, (1, 2), ([specs["relu"]], 1),
                            device="cpu", backend="gloo", timeout_s=10.0,
                            deadline_s=60.0)
    assert time.monotonic() - t0 < 10.0 + 30.0


# ------------------------------------------- the skip contract per shard
BS = 4  # pool rows per block


def _sharded_gqa_case(rng, dp, lengths_per_shard, max_blocks=4, KV=4,
                      g=2, D=16):
    """dp sub-pools (each with its own null block 0), shard-local
    tables, per-shard live lengths: the engine's layout."""
    shard_nb = max(sum(-(-int(n) // BS) for n in lens) + 1
                   for lens in lengths_per_shard) + 1
    B = sum(len(lens) for lens in lengths_per_shard)
    q = torch.from_numpy(rng.standard_normal((B, KV, g, D)).astype(np.float32))
    kp = torch.from_numpy(rng.standard_normal(
        (dp, shard_nb, BS, KV, D)).astype(np.float32))
    vp = torch.from_numpy(rng.standard_normal(
        (dp, shard_nb, BS, KV, D)).astype(np.float32))
    tables = np.zeros((B, max_blocks), np.int32)
    lengths = np.zeros((B,), np.int32)
    row = 0
    for lens in lengths_per_shard:
        nxt = 1  # local id 0 is this shard's null block
        for n in lens:
            live = -(-int(n) // BS)
            tables[row, :live] = np.arange(nxt, nxt + live)
            lengths[row] = n
            nxt += live
            row += 1
    return q, kp, vp, tables, lengths


def test_sharded_gqa_reads_only_its_shards_live_blocks():
    """Per data shard (own sub-pool, local tables) and model shard (its
    KV heads): the blocks each shard's GQA walks are its live prefix, the
    outputs equal the gather oracle over global ids, and NaN in every
    block no shard addresses leaves the output bit for bit."""
    dp, tp, KV = 2, 2, 4
    rng = np.random.default_rng(5)
    q, kp, vp, tables, lengths = _sharded_gqa_case(
        rng, dp, [[1, 9, 0, 13], [4, 0, 16, 3]], KV=KV)
    B, b = tables.shape[0], tables.shape[0] // dp

    def run(kp, vp):
        out = torch.empty_like(q)
        for d in range(dp):
            rows = slice(d * b, (d + 1) * b)
            for j in range(tp):
                heads = slice(j * KV // tp, (j + 1) * KV // tp)
                out[rows, heads] = pda.paged_gqa_decode_attn(
                    q[rows, heads].contiguous(),
                    kp[d][:, :, heads].contiguous(),
                    vp[d][:, :, heads].contiguous(),
                    torch.from_numpy(tables[rows]),
                    torch.from_numpy(lengths[rows]))
        return out

    base = run(kp, vp)
    nb = kp.shape[1]
    g_tables = tables + (np.arange(B)[:, None] // b) * nb
    want = kref.paged_gqa_decode_attn_ref(
        q, kp.reshape(dp * nb, BS, KV, -1), vp.reshape(dp * nb, BS, KV, -1),
        torch.from_numpy(g_tables), torch.from_numpy(lengths))
    live = lengths > 0
    torch.testing.assert_close(base[live], want[live], rtol=2e-5, atol=2e-5)
    kp2, vp2 = kp.clone(), vp.clone()
    for d in range(dp):
        rows = slice(d * b, (d + 1) * b)
        walked = {int(i) for slot in pda.gqa_chunk_walk(
            tables[rows], lengths[rows], BS, KV // tp) for c in slot
            for i in c}
        want_ids = {int(i) for ids in pda.live_block_ids(
            tables[rows], lengths[rows], BS) for i in ids}
        assert walked == want_ids and 0 not in walked
        dead = [i for i in range(nb) if i not in walked]
        assert dead
        kp2[d, dead] = float("nan")
        vp2[d, dead] = float("nan")
    poisoned = run(kp2, vp2)
    assert torch.isfinite(poisoned).all()
    assert torch.equal(poisoned, base)


def test_sharded_glu_dead_stripes_skip_both_fetches():
    """The fused GLU per model shard (w_gate/w_in column- and w_out
    row-sharded, partial sums added as the psum does): a dead gate stripe
    on each shard skips that shard's w_in and w_out stripes (two-sided
    NaN poison leaves the sum bit for bit) and the shards' bits are the
    whole MLP's columns."""
    tp = 2
    M, K, F, N, bm, bf = 8, 64, 512, 64, 1, 128
    g = torch.Generator().manual_seed(6)
    x = torch.randn(M, K, generator=g)
    wg = torch.randn(K, F, generator=g) / K ** 0.5
    wi = torch.randn(K, F, generator=g) / K ** 0.5
    wo = torch.randn(F, N, generator=g) / F ** 0.5
    dead = np.r_[128:256, 384:512]  # local stripe 1 of both shards
    wg[:, dead] *= 1e-4
    tau = 0.05

    def run(wi, wo):
        y, bits = 0, []
        for j in range(tp):
            cols = slice(j * F // tp, (j + 1) * F // tp)
            yj, bmp = kops.sparce_glu_mlp_fused(
                x, wg[:, cols].contiguous(), wi[:, cols].contiguous(),
                wo[cols].contiguous(), block_m=bm, block_f=bf, act="silu",
                tau=tau)
            y = y + yj
            bits.append(bmp.bits)
        return y, torch.cat(bits, dim=1)

    y0, bits0 = run(wi, wo)
    _, whole = kops.sparce_glu_mlp_fused(x, wg, wi, wo, block_m=bm,
                                         block_f=bf, act="silu", tau=tau)
    assert torch.equal(bits0, whole.bits)
    assert bool(bits0[:, 1].all()) and bool(bits0[:, 3].all())
    wi2, wo2 = wi.clone(), wo.clone()
    wi2[:, dead] = float("nan")
    wo2[dead] = float("nan")
    y1, bits1 = run(wi2, wo2)
    assert torch.equal(bits1, bits0)
    assert torch.isfinite(y1).all() and torch.equal(y1, y0)


def test_sharded_relu_rows_dead_tiles_never_reach_y():
    """The relu path per data shard (4 of 8 decode rows each, tiles
    (1, 32)): each shard's fused relu MLP gives the whole MLP's rows and
    bits for its slots, and NaN in a shard's dead stripes (negative w_in
    columns, dead in every row) stays out of y."""
    dp, M, K, F, N, bk = 2, 8, 64, 128, 64, 32
    g = torch.Generator().manual_seed(7)
    x = torch.randn(M, K, generator=g).abs()
    x[M // 2 + 1] = 0.0  # a dead slot on shard 1
    wi = torch.randn(K, F, generator=g) / K ** 0.5
    wi[:, bk:2 * bk] = -wi[:, bk:2 * bk].abs()
    wo = torch.randn(F, N, generator=g) / F ** 0.5
    y_all, bmp_all = kops.sparce_mlp_fused(x, wi, wo, block_m=1, block_f=bk)
    wo2 = wo.clone()
    wo2[bk:2 * bk] = float("nan")
    for d in range(dp):
        rows = slice(d * M // dp, (d + 1) * M // dp)
        y, bmp = kops.sparce_mlp_fused(x[rows].contiguous(), wi, wo,
                                       block_m=1, block_f=bk)
        assert torch.equal(bmp.bits, bmp_all.bits[rows])
        torch.testing.assert_close(y, y_all[rows], rtol=0, atol=0)
        y2, _ = kops.sparce_mlp_fused(x[rows].contiguous(), wi, wo2,
                                      block_m=1, block_f=bk)
        assert torch.isfinite(y2).all() and torch.equal(y2, y)
    assert bool(bmp_all.bits[M // 2 + 1].all())


def test_launcher_mesh_serves_the_single_host_tokens(capfd):
    """``launch.serve --mesh 2,1`` (gloo, CPU ranks) with ``--sparce``
    serves the tokens of the same flags without a mesh and prints the
    mesh; under ``--mesh 1,2`` the f-tile shrinks until it divides the
    per-shard d_ff (128 // 2 = 64)."""
    from repro_torch.launch import serve as port_serve
    argv = ["--arch", "smollm-135m", "--reduced", "--requests", "5",
            "--mixed", "--batch-slots", "4", "--max-len", "64",
            "--max-new", "6", "--prompt-len", "10", "--sparce",
            "--device", "cpu"]
    want = {r.uid: r.out.tolist() for r in port_serve.main(argv)}
    for mesh in ("2,1", "1,2"):
        done = port_serve.main(argv + ["--mesh", mesh, "--backend", "gloo",
                                       "--mesh-timeout", "20"])
        assert {r.uid: r.out.tolist() for r in done} == want
    out = capfd.readouterr().out
    assert "SPMD mesh: data=2 x model=1" in out
    assert "SPMD mesh: data=1 x model=2" in out
    args = port_serve._parse(argv + ["--mesh", "1,2"])
    assert args.backend == "gloo" and args.mesh_timeout == 60.0
