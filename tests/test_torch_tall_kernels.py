"""The tall paths of the gated GEMM and the fused relu MLP, on the CPU.

The kernels themselves run only on the card (``tests/test_torch_gpu.py``
holds them against their plain versions there). What the CPU can hold:

* the path-selection rules (``sparce_gemm.tall_path`` / ``tall_plan``
  and ``sparce_mlp.tall_path``) -- functions of the shapes, blocks and
  dtype only; decode and f32 never tall; the training shapes of
  PERF.md's rows 3b, 3d and 5b-5f tall;
* the tall GEMM's chunks and scratch as functions of the shapes only;
* a model of each tall walk -- which x boxes, w boxes and w_out stripes a
  CTA requests for given bits, stage by stage as the CUDA code walks --
  checked against the bits (no gated box, no all-dead stripe requested;
  every live one requested) and, summed over the requested boxes only,
  against the plain version;
* the wrappers on CPU tensors at tall shapes: the plain version, no
  launch counted, and equal to the reference's Pallas kernel (interpret
  mode) on the same numpy inputs.
"""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import sparce_gemm as ref_sg
from repro.kernels import sparce_mlp as ref_sm
from repro_torch.kernels import sparce_gemm as sg
from repro_torch.kernels import sparce_mlp as sm

BF16, F32 = torch.bfloat16, torch.float32

# (row, M, K, N, block_m, block_k): the down-projection GEMMs of a
# training step (FP a @ w_out, BP g @ w_out^T, WG a^T @ g) at PERF.md's
# rows 5b-5f and the FP row added beside them.
TRAIN_GEMMS = [
    ("5b BP", 4096, 576, 1536, 64, 128),
    ("5c WG", 1536, 4096, 576, 128, 64),
    ("FP", 4096, 1536, 576, 64, 128),
    ("5d FP", 4096, 512, 576, 64, 128),
    ("5d BP", 4096, 576, 512, 64, 128),
    ("5d WG", 512, 4096, 576, 128, 64),
    ("5e FP", 1024, 1536, 576, 64, 128),
    ("5e BP", 1024, 576, 1536, 64, 128),
    ("5e WG", 1536, 1024, 576, 128, 64),
    ("5f FP", 4608, 512, 576, 64, 128),
    ("5f BP", 4608, 576, 512, 64, 128),
    ("5f WG", 512, 4608, 576, 128, 64),
]
# (M, K, N, block_m, block_k, dtype, gate): the calls that keep the core:
# the decode tick, the 256-row prefill at per-slot and 64-row tiles, f32
# training shapes, the rhs gate, AlexNet's tiles, ragged blocks.
NOT_TALL_GEMMS = [
    (8, 576, 1536, 1, 128, BF16, "lhs"),
    (8, 1536, 576, 1, 128, BF16, "lhs"),
    (256, 1536, 576, 1, 128, BF16, "lhs"),
    (256, 1536, 576, 64, 128, BF16, "lhs"),
    (4096, 576, 1536, 64, 128, F32, "lhs"),
    (1536, 4096, 576, 128, 64, F32, "lhs"),
    (4096, 576, 1536, 64, 128, BF16, "rhs"),
    (729, 2400, 256, 8, 128, BF16, "lhs"),
    (4096, 576, 1536, 64, 32, BF16, "lhs"),
    (4096, 576, 1536, 96, 128, BF16, "lhs"),
    (4096, 570, 1536, 64, 128, BF16, "lhs"),
]


@pytest.mark.parametrize("row,M,K,N,bm,bk", TRAIN_GEMMS)
def test_training_gemms_take_the_tall_path(row, M, K, N, bm, bk):
    assert sg.tall_path(M, K, N, block_m=bm, block_k=bk, dtype=BF16)
    bn, s = sg.tall_plan(M, K, N, block_m=bm, block_k=bk, dtype=BF16)
    assert bn in sg.TALL_BN and s >= 1
    # The same shapes in f32 keep the core.
    assert sg.tall_plan(M, K, N, block_m=bm, block_k=bk, dtype=F32) is None


@pytest.mark.parametrize("M,K,N,bm,bk,dtype,gate", NOT_TALL_GEMMS)
def test_decode_f32_and_other_gates_keep_the_core(M, K, N, bm, bk, dtype,
                                                 gate):
    assert not sg.tall_path(M, K, N, block_m=bm, block_k=bk, dtype=dtype,
                            gate=gate)
    assert sg.tall_plan(M, K, N, block_m=bm, block_k=bk, dtype=dtype,
                        gate=gate) is None


@pytest.mark.parametrize("fn", [sg.tall_path, sg.tall_plan, sm.tall_path])
def test_path_rules_read_shapes_blocks_and_dtype_only(fn):
    """No tensor and no bit reaches the rule: every argument is a shape,
    a block, the dtype or the gate."""
    params = set(inspect.signature(fn).parameters)
    assert params <= {"m", "k", "n", "fdim", "block_m", "block_k",
                      "block_f", "dtype", "gate"}


@pytest.mark.parametrize("row,M,K,N,bm,bk", TRAIN_GEMMS)
def test_tall_chunks_cover_every_k_tile_once(row, M, K, N, bm, bk):
    bn, s = sg.tall_plan(M, K, N, block_m=bm, block_k=bk, dtype=BF16)
    gk = -(-K // bk)
    shape = sg.tall_partial_shape(M, K, N, block_k=bk, chunk=s)
    chunks = shape[0] if len(shape) == 3 else 1
    assert (chunks - 1) * s < gk <= chunks * s
    assert chunks <= sg.TALL_MAX_CHUNKS
    assert shape == ((chunks, M, N) if chunks > 1 else (0,))
    # A second call plans the same; the plan is the shapes'.
    assert sg.tall_plan(M, K, N, block_m=bm, block_k=bk,
                        dtype=BF16) == (bn, s)


def test_tall_plans_at_the_recorded_rows():
    """The column tiles and chunks PERF.md records (no split K at BP and
    FP; the WG's reduction over 4096 tokens in 4 chunks)."""
    plan = lambda M, K, N, bm, bk: sg.tall_plan(  # noqa: E731
        M, K, N, block_m=bm, block_k=bk, dtype=BF16)
    assert plan(4096, 576, 1536, 64, 128) == (192, 5)      # 5b: one chunk
    assert plan(4096, 1536, 576, 64, 128) == (192, 12)     # FP: one chunk
    assert plan(1536, 4096, 576, 128, 64) == (192, 16)     # 5c: 4 chunks
    assert plan(4096, 576, 512, 64, 128) == (128, 5)       # N 512: 128
    assert sg.tall_partial_shape(1536, 4096, 576, block_k=64,
                                 chunk=16) == (4, 1536, 576)
    assert sg.tall_partial_shape(4096, 576, 1536, block_k=128,
                                 chunk=5) == (0,)


@pytest.mark.parametrize("row,M,K,N,bm,bk", TRAIN_GEMMS)
def test_tall_plan_is_the_same_for_every_row_count(row, M, K, N, bm, bk):
    """A row's sum runs in one order whatever the call's row count: a
    pipeline micro-batch's FP and BP rows equal the whole batch's."""
    plans = {sg.tall_plan(m, K, N, block_m=bm, block_k=bk, dtype=BF16)
             for m in (512, 1024, 1100, M, 4096, 4608)}
    assert len(plans) == 1


@pytest.mark.parametrize("row,M,K,N,bm,bk", TRAIN_GEMMS)
def test_one_chunk_wherever_the_tiles_fill_the_card(row, M, K, N, bm, bk):
    bn, s = sg.tall_plan(M, K, N, block_m=bm, block_k=bk, dtype=BF16)
    tiles = -(-M // sg.TALL_BM) * -(-N // 128)
    if tiles >= 132:  # the card's SMs
        assert s >= -(-K // bk)


# ----------------------------------------------------- the GEMM's walk
def gemm_walk(bits, M, K, N, bm, bk, bn, s):
    """What the tall GEMM's producer requests, CTA by CTA (csrc/
    tall_gemm.cuh: Walk and the producer loop): per stage (k0, the row
    offsets of the x boxes requested, the column offsets of the w boxes
    requested). A CTA is (row block of 128, column tile of bn, chunk of
    s k tiles); a warpgroup's row tile past the bit grid counts dead."""
    gm, gk = bits.shape
    out = {}
    for rb in range(-(-M // 128)):
        row0 = 128 * rb
        tiles = [r // bm if r < M else -1 for r in (row0, row0 + 64)]
        for cb in range(-(-N // bn)):
            for z in range(-(-gk // s)):
                stages = []
                for kt in range(z * s, min(gk, (z + 1) * s)):
                    live = [t >= 0 and bits[t, kt] == 0 for t in tiles]
                    if not any(live):
                        continue
                    for k0 in range(kt * bk, min(K, (kt + 1) * bk), 64):
                        a = [row0 + 64 * w for w in (0, 1) if live[w]]
                        b = [cb * bn + 64 * j for j in range(bn // 64)]
                        stages.append((k0, a, b))
                out[(rb, cb, z)] = stages
    return out


@pytest.mark.parametrize("M,K,N,bm,bk,p", [
    (1100, 600, 1000, 64, 128, 0.3),   # ragged M, K (4.7 k tiles), N
    (512, 1024, 576, 128, 64, 0.5),    # a WG: one row tile a CTA
    (1030, 576, 256, 64, 128, 0.0),    # a row tile past the grid
    (640, 512, 384, 64, 128, 0.95),
])
def test_gemm_walk_requests_only_live_boxes_and_sums_like_plain(
        M, K, N, bm, bk, p):
    rng = np.random.default_rng(M + K)
    gm, gk = -(-M // bm), -(-K // bk)
    bits = (rng.random((gm, gk)) < p).astype(np.int32)
    bn, s = sg.tall_plan(M, K, N, block_m=bm, block_k=bk, dtype=BF16)
    walk = gemm_walk(bits, M, K, N, bm, bk, bn, s)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = rng.standard_normal((K, N)).astype(np.float32) / np.sqrt(K)
    y = np.zeros((M, N), np.float32)
    requested = set()
    for (rb, cb, z), stages in walk.items():
        for k0, a_rows, b_cols in stages:
            assert k0 < K and k0 % 64 == 0
            kt = k0 // bk
            assert z * s <= kt < (z + 1) * s
            assert b_cols, "a stage requests w"
            for r0 in a_rows:  # never a gated x box
                assert r0 < M and bits[r0 // bm, kt] == 0
                requested.add((r0 // 64, k0 // 64, cb))
            # w of a k tile is requested only when a row tile is live.
            assert a_rows
            for r0 in a_rows:
                ks = slice(k0, min(k0 + 64, K))
                cs = slice(cb * bn, min(cb * bn + bn, N))
                y[r0:r0 + 64, cs] += x[r0:r0 + 64, ks] @ w[ks, cs]
    # Every live 64 x 64 x box is requested once per column tile.
    for r in range(-(-M // 64)):
        for kk in range(-(-K // 64)):
            live = bits[(64 * r) // bm, (64 * kk) // bk] == 0
            for cb in range(-(-N // bn)):
                assert ((r, kk, cb) in requested) == bool(live)
    want = sg.sparce_gemm_gated_plain(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(bits),
        block_m=bm, block_k=bk, block_n=bn)
    np.testing.assert_allclose(y, want.numpy(), rtol=1e-4, atol=1e-4)


# ------------------------------------------------------ the MLP's walk
# (row, M, K, F, N): the fused relu MLP at (64, 128) tiles, bf16.
TRAIN_MLPS = [
    ("3b", 4096, 576, 1536, 576),
    ("3d", 2048, 576, 1536, 576),
    ("tp-3 SP", 4608, 576, 512, 576),
    ("smallest shard", 1024, 576, 1536, 576),
]


@pytest.mark.parametrize("row,M,K,F,N", TRAIN_MLPS)
def test_training_mlps_take_the_tall_path(row, M, K, F, N):
    assert sm.tall_path(M, K, F, N, block_m=64, block_f=128, dtype=BF16)
    assert not sm.tall_path(M, K, F, N, block_m=64, block_f=128, dtype=F32)


@pytest.mark.parametrize("M,K,F,N,bm,bf", [
    (8, 576, 1536, 576, 1, 128),     # the decode tick
    (8, 576, 1536, 576, 64, 128),    # 8 rows under a 64-row tile
    (256, 576, 1536, 576, 64, 128),  # the 256-row prefill
    (256, 576, 1536, 576, 256, 512),  # plan_mlp's prefill tiles
    (4096, 576, 1536, 576, 256, 512),  # plan_mlp's training tiles
    (4096, 576, 1536, 576, 64, 256),
    (4096, 3584, 14336, 3584, 64, 128),  # K past the resident x
    (4096, 648, 1536, 576, 64, 128),
    (4096, 576, 1530, 576, 64, 128),     # F rows not 16-byte units
])
def test_decode_prefill_and_other_tiles_keep_the_cluster_design(
        M, K, F, N, bm, bf):
    assert not sm.tall_path(M, K, F, N, block_m=bm, block_f=bf, dtype=BF16)


def mlp_walk(x, w_in, w_out, act):
    """What the tall MLP kernel does, CTA by CTA (csrc/sparce_mlp.cu:
    mlp_tall_kernel): per (column slice q of 288, 64-row tile) and stripe
    f, the w_in boxes it requests (always: both 64-column halves of the
    stripe, a warpgroup each), the tile's bit from a
    rounded through the operands' dtype (bf16 on the card; NaN live),
    and the w_out boxes it requests
    (only when live); y summed over the live stripes only. Returns
    (y, bits, requests: {(q, tile): [(f, w_in boxes, w_out boxes)]})."""
    M, K = x.shape
    F, N = w_out.shape
    nf = -(-F // 128)
    bits = np.ones((-(-M // 64), nf), np.int32)
    y = np.zeros((M, N), np.float32)
    requests = {}
    for q in range(-(-N // sm.TALL_COLS)):
        for t in range(-(-M // 64)):
            rows = slice(64 * t, min(64 * t + 64, M))
            log = []
            for f in range(nf):
                fs = slice(128 * f, min(128 * f + 128, F))
                win = [(128 * f + 64 * wg, k0) for k0 in range(0, K, 64)
                       for wg in (0, 1)]
                h = x[rows] @ w_in[:, fs]
                a = np.maximum(h, 0.0, where=~np.isnan(h), out=h.copy())
                if act == "relu2":
                    a = a * a
                a = torch.from_numpy(a).to(torch.from_numpy(x).dtype) \
                    .float().numpy()
                live = bool(np.any(a != 0))
                bits[t, f] = 0 if live else 1
                wout = []
                if live:
                    wout = [(q * sm.TALL_COLS + 144 * wg + 16 * b, f0)
                            for f0 in range(128 * f, min(128 * f + 128, F),
                                            64)
                            for wg in (0, 1) for b in range(9)]
                    cs = slice(q * sm.TALL_COLS,
                               min(q * sm.TALL_COLS + sm.TALL_COLS, N))
                    y[rows, cs] += a @ w_out[fs, cs]
                log.append((f, win, wout))
            requests[(q, t)] = log
    return y, bits, requests


@pytest.mark.parametrize("M,K,F,N,act", [
    (1100, 600, 1000, 600, "relu"),    # ragged M, F (7.8 stripes), N
    (1024, 576, 512, 576, "relu2"),
    (1088, 256, 640, 320, "relu"),
])
def test_mlp_walk_never_requests_a_dead_stripe_and_sums_like_plain(
        M, K, F, N, act):
    rng = np.random.default_rng(M + F)
    x = np.abs(rng.standard_normal((M, K))).astype(np.float32)
    x[64 * 3:64 * 4] = 0.0                      # a dead row tile
    w_in = (rng.standard_normal((K, F)) / np.sqrt(K)).astype(np.float32)
    w_in[:, 256:384] = -np.abs(w_in[:, 256:384])  # stripe 2 dead everywhere
    w_out = (rng.standard_normal((F, N)) / np.sqrt(F)).astype(np.float32)
    y, bits, requests = mlp_walk(x, w_in, w_out, act)
    y0, bits0 = sm.sparce_mlp_fused_plain(
        *(torch.from_numpy(a) for a in (x, w_in, w_out)), block_m=64,
        block_f=128, act=act)
    np.testing.assert_array_equal(bits, bits0.numpy())
    np.testing.assert_allclose(y, y0.numpy(), rtol=1e-4, atol=1e-4)
    assert bits[:, 2].all() and bits[3].all()
    for (q, t), log in requests.items():
        for f, win, wout in log:
            assert len(win) == 2 * -(-K // 64)  # w_in: always, it votes
            # No w_out address of a stripe dead in this tile.
            assert (len(wout) > 0) == (bits[t, f] == 0)
            assert all(f0 < F and 128 * f <= f0 < 128 * f + 128
                       for _, f0 in wout)
    dead_everywhere = bits.all(axis=0).nonzero()[0]
    for log in requests.values():
        for f, _, wout in log:
            assert not (f in dead_everywhere and wout)


# -------------------------------------- the wrappers on CPU tensors
def test_cpu_tensors_take_the_plain_versions_at_tall_shapes():
    rng = np.random.default_rng(7)
    M, K, N, bm, bk = 512, 256, 192, 64, 64
    x = torch.from_numpy(rng.standard_normal((M, K), dtype=np.float32)).to(
        BF16)
    w = torch.from_numpy(rng.standard_normal((K, N), dtype=np.float32)).to(
        BF16)
    bits = torch.from_numpy((rng.random((M // bm, K // bk)) < 0.4).astype(
        np.int32))
    assert sg.tall_path(M, K, N, block_m=bm, block_k=bk, dtype=BF16)
    counts = (sg.sparce_gemm_gated.launches,
              sg.sparce_gemm_gated.tall_launches,
              sg.sparce_gemm_compacted.tall_launches)
    kw = dict(block_m=bm, block_k=bk, block_n=128)
    y = sg.sparce_gemm_gated(x, w, bits, **kw)
    yc = sg.sparce_gemm_compacted(x, w, bits, **kw)
    assert counts == (sg.sparce_gemm_gated.launches,
                      sg.sparce_gemm_gated.tall_launches,
                      sg.sparce_gemm_compacted.tall_launches)
    assert torch.equal(y, sg.sparce_gemm_gated_plain(x, w, bits, **kw))
    assert torch.equal(yc, y)
    xm = torch.from_numpy(np.abs(rng.standard_normal((1024, 128),
                                                     dtype=np.float32)))
    wi = torch.from_numpy(rng.standard_normal((128, 256), dtype=np.float32))
    wo = torch.from_numpy(rng.standard_normal((256, 64), dtype=np.float32))
    xm, wi, wo = xm.to(BF16), wi.to(BF16), wo.to(BF16)
    n = (sm.sparce_mlp_fused.launches, sm.sparce_mlp_fused.tall_launches)
    y, b = sm.sparce_mlp_fused(xm, wi, wo, block_m=64, block_f=128)
    y0, b0 = sm.sparce_mlp_fused_plain(xm, wi, wo, block_m=64, block_f=128)
    assert n == (sm.sparce_mlp_fused.launches,
                 sm.sparce_mlp_fused.tall_launches)
    assert torch.equal(y, y0) and torch.equal(b, b0)


def test_gated_gemm_at_a_tall_shape_matches_reference_kernel():
    """512 rows under the lhs gate at (64, 64) tiles, bf16: the port's
    wrapper (CPU: the plain version) against the reference's Pallas
    kernel in interpret mode on the same numpy inputs."""
    rng = np.random.default_rng(11)
    M, K, N, bm, bk, bn = 512, 256, 128, 64, 64, 128
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32)
    bits = (rng.random((M // bm, K // bk)) < 0.3).astype(np.int32)
    kw = dict(block_m=bm, block_k=bk, block_n=bn)
    assert sg.tall_path(M, K, N, block_m=bm, block_k=bk, dtype=BF16)
    want = ref_sg.sparce_gemm_gated(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
        jnp.asarray(bits), interpret=True, **kw)
    got = sg.sparce_gemm_gated(torch.from_numpy(x).to(BF16),
                               torch.from_numpy(w).to(BF16),
                               torch.from_numpy(bits), **kw)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=3e-2,
                               atol=3e-2)


@pytest.mark.parametrize("act", ["relu", "relu2"])
def test_fused_mlp_at_a_tall_shape_matches_reference_kernel(act):
    """1024 rows at (64, 128) tiles, bf16, with a dead row tile and a
    stripe dead in every tile: bits exactly, y within bf16 rounding."""
    rng = np.random.default_rng(12)
    M, K, F, N = 1024, 128, 384, 128
    x = np.abs(rng.standard_normal((M, K))).astype(np.float32)
    x[128:192] = 0.0
    w_in = (rng.standard_normal((K, F)) / np.sqrt(K)).astype(np.float32)
    w_in[:, 128:256] = -np.abs(w_in[:, 128:256])
    w_out = (rng.standard_normal((F, N)) / np.sqrt(F)).astype(np.float32)
    assert sm.tall_path(M, K, F, N, block_m=64, block_f=128, dtype=BF16)
    y_ref, bits_ref = ref_sm.sparce_mlp_fused(
        *(jnp.asarray(a, jnp.bfloat16) for a in (x, w_in, w_out)),
        block_m=64, block_f=128, act=act, interpret=True)
    y, bits = sm.sparce_mlp_fused(
        *(torch.from_numpy(a).to(BF16) for a in (x, w_in, w_out)),
        block_m=64, block_f=128, act=act)
    np.testing.assert_array_equal(bits.numpy(), np.asarray(bits_ref))
    assert bits.numpy()[2].all() and bits.numpy()[:, 1].all()
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(y_ref, np.float32), rtol=3e-2,
                               atol=3e-2)
