"""The port's CUDA kernels on a GPU: each kernel against its plain
version on the card, the skip contracts (NaN-poisoned dead blocks and
stripes), the launch counters, and the reduced engine on the GPU against
the same engine on the CPU.

Every test here needs a CUDA device and carries the ``gpu`` marker; on
a host without one they skip. This file imports torch and the port
only, so it runs where the reference's framework is not installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.paper_alexnet import (
    ALEXNET_GEMMS, BENCH_SPARSITY, DEEPCOMP_WEIGHT_SPARSITY,
)
from repro_torch.core import sasa, sparse_ops, sprf
from repro_torch.core.sparse_ops import SparsityConfig
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.kernels import paged_decode_attn as pda
from repro_torch.kernels import relu_bitmap as rb
from repro_torch.kernels import sparce_gemm as sg
from repro_torch.kernels import sparce_glu_mlp as sgm
from repro_torch.kernels import sparce_mlp as sm
from repro_torch.models import model as model_lib
from repro_torch.runtime.server import Request, ServeConfig, Server

# The chip script's operands and limits for the training GEMMs.
sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import (  # noqa: E402
    AUTOTUNE_TOLS, TRAIN_GEMM_REL, autotune_decode_inputs,
    train_gemm_operands,
)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _attn_case(dev, dtype, seed=0, lengths=(0, 1, 4, 5, 17, 24), BS=4,
               max_blocks=6, KV=3, g=3, D=64):
    rng = np.random.default_rng(seed)
    B = len(lengths)
    nb = B * max_blocks + 1
    tables = np.zeros((B, max_blocks), np.int32)
    ids = rng.permutation(np.arange(1, nb))
    nxt = 0
    for b, n in enumerate(lengths):
        live = -(-n // BS)
        tables[b, :live] = ids[nxt:nxt + live]
        nxt += live
    spare = ids[nxt:]
    for b, n in enumerate(lengths):  # dead entries name spare blocks
        if -(-n // BS) < max_blocks:
            tables[b, -(-n // BS):] = spare[b % len(spare)]
    t = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32)).to(dev, dtype)
    return (t(B, KV, g, D), t(nb, BS, KV, D), t(nb, BS, KV, D),
            torch.from_numpy(tables).to(dev),
            torch.tensor(lengths, dtype=torch.int32, device=dev),
            set(ids[:nxt].tolist()))


@pytest.mark.parametrize("dtype,tol", [
    (torch.float32, 1e-5),   # f32 sums in another order
    (torch.bfloat16, 2e-2),  # p rounded vs a running max; bf16 output
])
def test_paged_attn_kernel_matches_plain(cuda, dtype, tol):
    q, kp, vp, tables, lengths, live_ids = _attn_case(cuda, dtype)
    before = pda.paged_gqa_decode_attn.launches
    got = pda.paged_gqa_decode_attn(q, kp, vp, tables, lengths)
    assert pda.paged_gqa_decode_attn.launches == before + 1
    want = pda.paged_gqa_decode_attn_plain(q, kp, vp, tables, lengths)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    assert bool((got[0] == 0).all())  # the length-0 slot
    dead = [i for i in range(kp.shape[0]) if i not in live_ids]
    kp2, vp2 = kp.clone(), vp.clone()
    kp2[dead] = float("nan")
    vp2[dead] = float("nan")
    poisoned = pda.paged_gqa_decode_attn(q, kp2, vp2, tables, lengths)
    assert bool(torch.isfinite(poisoned).all())
    assert torch.equal(poisoned, got)


def _replayed(fn):
    """fn's result from a CUDA graph of one call, captured after a warm-up
    call on a side stream and replayed once."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    graph.replay()
    torch.cuda.synchronize()
    return out


# time_attention's lengths (chip_smoke.py: 8 slots from the seeded trace).
_TRACE_LENGTHS = tuple(int(n) for n in np.random.default_rng(5).integers(
    16, 256 + 32, 8))
GQA_CASES = [
    # (lengths, BS, max_blocks, KV, g, D)
    pytest.param(_TRACE_LENGTHS, 16, 32, 3, 3, 64, id="time_attention"),
    pytest.param((512,) * 8, 16, 32, 3, 3, 64, id="full_table"),
    pytest.param((601, 0, 1, 3, 300, 598, 599, 2), 1, 601, 3, 3, 64,
                 id="width_not_a_multiple_of_E"),
    pytest.param((16, 1, 5, 0, 16, 9, 3, 2), 16, 32, 3, 3, 64,
                 id="single_live_chunk"),
    pytest.param((0, 1, 23, 24, 25, 120, 240, 239), 24, 10, 5, 8, 40,
                 id="rows_across_blocks"),
    pytest.param((0, 70, 33, 128), 16, 8, 8, 8, 128, id="wide_heads"),
    pytest.param((0, 70, 33, 128), 16, 8, 2, 5, 20, id="unaligned_rows"),
    # The new configs' head groups: smollm-360m (KV 5, group 3, D 64),
    # mistral-nemo (group 4, D 128), qwen1.5-110b (group 8, D 128: the
    # kernel's limit on both), qwen2-moe (16 KV heads of group 1).
    pytest.param(_TRACE_LENGTHS, 16, 32, 5, 3, 64, id="smollm_360m"),
    pytest.param(_TRACE_LENGTHS, 16, 32, 8, 4, 128, id="mistral_nemo"),
    pytest.param(_TRACE_LENGTHS, 16, 32, 8, 8, 128, id="qwen1p5_110b"),
    pytest.param(_TRACE_LENGTHS, 16, 32, 16, 1, 128, id="qwen2_moe"),
    # A serving mesh's shards of smollm-135m: tp 3 (1 KV head of group
    # 3, all 8 slots) and dp 2 (3 KV heads, 4 slots).
    pytest.param(_TRACE_LENGTHS, 16, 32, 1, 3, 64, id="smollm_tp3_shard"),
    pytest.param(_TRACE_LENGTHS[:4], 16, 32, 3, 3, 64,
                 id="smollm_dp2_shard"),
]


@pytest.mark.parametrize("lengths,BS,max_blocks,KV,g,D", GQA_CASES)
@pytest.mark.parametrize("dtype,tol", [
    (torch.float32, 1e-5),   # f32 (split-TF32) sums, chunks merged
    (torch.bfloat16, 2e-2),  # p rounded vs a chunk's running max
])
def test_gqa_kernel_on_chunked_shapes(cuda, lengths, BS, max_blocks, KV, g,
                                      D, dtype, tol):
    """The chunked GQA kernel at the engine's shape, a full table, a
    table width that is not a multiple of E, a single live chunk, rows
    crossing blocks (bs 24), two head groups at D 128 and rows that are
    not 16-byte multiples: it equals its plain version, NaN in every dead
    block leaves the output equal and finite, a second call is equal bit
    for bit, and a replayed CUDA graph of the call equals the eager
    call. The launch covers more than the old one-CTA-per-(slot, KV
    head) grid wherever a slot has more than one chunk."""
    grid = pda.gqa_grid(len(lengths), KV, max_blocks, BS)
    if max_blocks == 601:
        assert max_blocks % grid["entries"] != 0
    if lengths == _TRACE_LENGTHS:
        assert grid["ctas"] > len(lengths) * KV
    q, kp, vp, tables, lens, live_ids = _attn_case(
        cuda, dtype, lengths=lengths, BS=BS, max_blocks=max_blocks, KV=KV,
        g=g, D=D)
    run = lambda: pda.paged_gqa_decode_attn(  # noqa: E731
        q, kp, vp, tables, lens)
    got = run()
    want = pda.paged_gqa_decode_attn_plain(q, kp, vp, tables, lens)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    for b, n in enumerate(lengths):
        if n == 0:
            assert bool((got[b] == 0).all())
    assert torch.equal(_bits_view(run()), _bits_view(got))
    assert torch.equal(_bits_view(_replayed(run)), _bits_view(got))
    dead = [i for i in range(kp.shape[0]) if i not in live_ids]
    kp2, vp2 = kp.clone(), vp.clone()
    kp2[dead] = float("nan")
    vp2[dead] = float("nan")
    poisoned = pda.paged_gqa_decode_attn(q, kp2, vp2, tables, lens)
    assert bool(torch.isfinite(poisoned).all())
    assert torch.equal(_bits_view(poisoned), _bits_view(got))


def test_gqa_kernel_checks_its_limits(cuda):
    q, kp, vp, tables, lengths, _ = _attn_case(cuda, torch.bfloat16, g=9)
    with pytest.raises(ValueError, match="past the kernel's limits"):
        pda.paged_gqa_decode_attn(q, kp, vp, tables, lengths)


def test_gqa_arrival_counters_per_stream_and_graph(cuda):
    """The last-arriving merge's arrival counters: eager calls on two
    streams use two sets, a captured call one of its own, so replays of
    the graph on a side stream, unsynchronised with eager calls on the
    main stream, stay equal to the eager call; every call leaves its
    counters at zero."""
    q, kp, vp, tables, lens, _ = _attn_case(
        cuda, torch.bfloat16, lengths=_TRACE_LENGTHS, BS=16, max_blocks=32)
    run = lambda: pda.paged_gqa_decode_attn(  # noqa: E731
        q, kp, vp, tables, lens)
    assert pda.gqa_grid(8, 3, 32, 16)["chunks"] > 1
    want = run()
    main = torch.cuda.current_stream()
    side = torch.cuda.Stream()
    side.wait_stream(main)
    with torch.cuda.stream(side):
        got_side = run()
    torch.cuda.synchronize()
    assert torch.equal(got_side, want)
    sets = {k[1]: v for k, v in pda._GQA_COUNTS.items()
            if k[0] == q.device and k[2] == (8, 1)}
    assert {main.cuda_stream, side.cuda_stream} <= set(sets)
    assert sets[main.cuda_stream].data_ptr() \
        != sets[side.cuda_stream].data_ptr()
    cached = len(pda._GQA_COUNTS)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = run()
    assert len(pda._GQA_COUNTS) == cached
    replay_stream = torch.cuda.Stream()
    eager = []
    for _ in range(8):
        replay_stream.wait_stream(main)
        with torch.cuda.stream(replay_stream):
            graph.replay()
        eager.append(run())
        main.wait_stream(replay_stream)
    torch.cuda.synchronize()
    assert torch.equal(captured, want)
    for out in eager:
        assert torch.equal(out, want)
    for counts in pda._GQA_COUNTS.values():
        assert int(counts.abs().sum()) == 0


@pytest.mark.parametrize("dtype,tol", [
    (torch.float32, 1e-4),   # f32 sums over K and F in another order
    (torch.bfloat16, 2e-2),  # bf16 roundings of g, h, a and y
])
def test_glu_kernel_matches_plain(cuda, dtype, tol):
    rng = np.random.default_rng(1)
    M, K, F, N, bm, bf = 128, 192, 512, 96, 64, 128
    x = rng.standard_normal((M, K)).astype(np.float32)
    x[64:] = 0.0  # row tile 1 is dead across F
    wg, wi = (rng.standard_normal((K, F)) * 0.1 for _ in range(2))
    wo = rng.standard_normal((F, N)) * 0.1
    wg = wg.astype(np.float32)
    wg[:, bf:2 * bf] = 0.0  # stripe 1 dead in every row tile
    args = [torch.from_numpy(np.asarray(a, np.float32)).to(cuda, dtype)
            for a in (x, wg, wi, wo)]
    for tau in (0.0, 0.05):
        before = sgm.sparce_glu_mlp_fused.launches
        y, bits = sgm.sparce_glu_mlp_fused(*args, block_m=bm, block_f=bf,
                                           tau=tau)
        assert sgm.sparce_glu_mlp_fused.launches == before + 1
        y0, bits0 = sgm.sparce_glu_mlp_fused_plain(*args, block_m=bm,
                                                   block_f=bf, tau=tau)
        assert torch.equal(bits, bits0)
        assert bool(bits[1].all()) and bool(bits[:, 1].all())
        torch.testing.assert_close(y.float(), y0.float(), rtol=tol, atol=tol)
        wi2, wo2 = args[2].clone(), args[3].clone()
        wi2[:, bf:2 * bf] = float("nan")
        wo2[bf:2 * bf] = float("nan")
        y2, _ = sgm.sparce_glu_mlp_fused(args[0], args[1], wi2, wo2,
                                         block_m=bm, block_f=bf, tau=tau)
        assert bool(torch.isfinite(y2).all()) and torch.equal(y2, y)


def test_glu_kernel_at_block_m_1_matches_plain(cuda):
    """Per-slot gate tiles (the launcher's block_m=1): dead rows' tiles
    are dead in every stripe."""
    rng = np.random.default_rng(3)
    M, K, F, N, bf = 8, 576, 1536, 576, 128
    x = rng.standard_normal((M, K)).astype(np.float32)
    x[[1, 5]] = 0.0
    ws = [rng.standard_normal(s).astype(np.float32) * s[0] ** -0.5
          for s in ((K, F), (K, F), (F, N))]
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        args = [torch.from_numpy(a).to(cuda, dtype) for a in [x] + ws]
        y, bits = sgm.sparce_glu_mlp_fused(*args, block_m=1, block_f=bf)
        y0, bits0 = sgm.sparce_glu_mlp_fused_plain(*args, block_m=1,
                                                   block_f=bf)
        assert torch.equal(bits, bits0)
        assert bool(bits[[1, 5]].all()) and not bool(bits.all())
        torch.testing.assert_close(y.float(), y0.float(), rtol=tol, atol=tol)


def _nan_tail(a, dev, dtype, pad=4096):
    """``a`` on the card as a contiguous view into a flat buffer that
    holds NaN right past its end: a read past the last row or column
    brings NaN in."""
    buf = torch.full((a.size + pad,), float("nan"), device=dev, dtype=dtype)
    view = buf[:a.size].view(a.shape)
    view.copy_(torch.from_numpy(np.ascontiguousarray(a)))
    return view


# (M, K, F, N, block_m, block_f): the decode tick (8 rows under 64-row
# tiles, and per-row tiles), a 256-row prefill bucket, ragged M, K, F, N,
# and row tiles of 128 and 256 rows (walked in chunks of 64).
GLU_CASES = [(8, 576, 1536, 576, 64, 128), (8, 576, 1536, 576, 1, 128),
             (256, 576, 1536, 576, 64, 128), (40, 200, 320, 70, 16, 128),
             (300, 192, 320, 96, 256, 128), (130, 64, 256, 48, 128, 64),
             # smollm-360m's MLP and zamba2-7b's shared block, at a
             # decode tick and a 256-row prefill.
             (8, 960, 2560, 960, 64, 128), (256, 960, 2560, 960, 64, 128),
             (8, 3584, 14336, 3584, 64, 128),
             (256, 3584, 14336, 3584, 64, 128),
             # smollm-135m's MLP on a tp 3 shard (512 of 1536 columns)
             # at a decode tick.
             (8, 576, 512, 576, 64, 128),
             # The planner's own tiles at a training step's 4096 rows,
             # where the cluster widens to fit shared memory.
             (4096, 576, 1536, 576, 256, 512)]


@pytest.mark.parametrize("M,K,F,N,bm,bf", GLU_CASES)
@pytest.mark.parametrize("dtype,tol", [
    (torch.float32, 1e-4),   # f32 (split-TF32) sums in another order
    (torch.bfloat16, 2e-2),  # bf16 roundings of g, h, a and y
])
def test_glu_cluster_kernel_at_unpadded_shapes(cuda, M, K, F, N, bm, bf,
                                               dtype, tol):
    """The kernel takes M and F unpadded, with NaN right past every
    operand's end: bits equal the plain version's, y within tolerance;
    a second call gives the same bits; NaN in the w_in columns and w_out
    rows of the stripes dead in every row tile never reaches y. At the
    decode shape the launch spreads over more CTAs than stripes."""
    rng = np.random.default_rng(40)
    x = rng.standard_normal((M, K)).astype(np.float32)
    x[[1, 5]] = 0.0
    wg, wi = (rng.standard_normal((K, F)).astype(np.float32) * K ** -0.5
              for _ in range(2))
    wo = rng.standard_normal((F, N)).astype(np.float32) * F ** -0.5
    wg[:, bf:2 * bf] = 0.0           # stripe 1 dead at any tau
    wg[:, -(F % bf or bf):] *= 1e-3  # the last stripe dead at tau 0.05
    args = [_nan_tail(a, cuda, dtype) for a in (x, wg, wi, wo)]
    grid = sgm.kernel_grid(M, K, F, N, block_m=bm, block_f=bf, dtype=dtype)
    assert grid["ctas"] > -(-M // max(bm, 64)) * -(-F // bf)
    for tau in (0.0, 0.05):
        before = sgm.sparce_glu_mlp_fused.launches
        y, bits = sgm.sparce_glu_mlp_fused(*args, block_m=bm, block_f=bf,
                                           tau=tau)
        assert sgm.sparce_glu_mlp_fused.launches == before + 1
        y0, bits0 = sgm.sparce_glu_mlp_fused_plain(*args, block_m=bm,
                                                   block_f=bf, tau=tau)
        assert torch.equal(bits, bits0)
        assert bool(bits[:, 1].all()) and not bool(bits.all())
        assert bool(torch.isfinite(y).all())
        torch.testing.assert_close(y.float(), y0.float(), rtol=tol, atol=tol)
        y1, bits1 = sgm.sparce_glu_mlp_fused(*args, block_m=bm, block_f=bf,
                                             tau=tau)
        assert torch.equal(bits1, bits)
        assert torch.equal(_bits_view(y1), _bits_view(y))
        dead = bits.bool().all(dim=0).nonzero().flatten().tolist()
        wi2, wo2 = args[2].clone(), args[3].clone()
        for f in dead:
            wi2[:, f * bf:(f + 1) * bf] = float("nan")
            wo2[f * bf:(f + 1) * bf] = float("nan")
        y2, bits2 = sgm.sparce_glu_mlp_fused(args[0], args[1], wi2, wo2,
                                             block_m=bm, block_f=bf, tau=tau)
        assert torch.equal(bits2, bits)
        assert bool(torch.isfinite(y2).all()) and torch.equal(y2, y)


@pytest.mark.parametrize("shape,block", [
    ((8, 1536), (1, 128)), ((256, 1536), (1, 128)), ((128, 256), (64, 128)),
    ((4, 1536), (1, 128)),  # a dp 2 shard's decode rows
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_relu_bitmap_kernel_matches_plain(cuda, shape, block, dtype):
    rng = np.random.default_rng(4)
    x = rng.standard_normal(shape).astype(np.float32)
    x[: block[0], : block[1]] = -1.0  # a tile with no element > 0
    x[-block[0]:] = 0.0
    xt = torch.from_numpy(x).to(cuda, dtype)
    before = rb.relu_bitmap.launches
    y, bits = rb.relu_bitmap(xt, block_r=block[0], block_c=block[1])
    assert rb.relu_bitmap.launches == before + 1
    y0, bits0 = rb.relu_bitmap_plain(xt, block_r=block[0], block_c=block[1])
    assert torch.equal(y, y0) and torch.equal(bits, bits0)
    assert bool(bits[0, 0]) and bool(bits[-1].all()) and not bool(bits.all())


RELU_BITMAP_CASES = [
    ((8, 1536), (1, 128)),    # decode
    ((256, 1536), (1, 128)),  # prefill
    ((256, 1536), (64, 128)),
    ((7, 300), (1, 128)),     # ragged, rows not 16-byte multiples
    ((130, 200), (64, 128)),  # ragged, tiles taller than a row
    ((1, 128), (1, 128)),     # a single tile
    ((3, 1000), (2, 700)),    # a segment wider than a warp's vectors
]


@pytest.mark.parametrize("shape,block", RELU_BITMAP_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "unaligned"])
def test_relu_bitmap_kernel_changes_no_bit(cuda, shape, block, dtype,
                                           offset):
    """The unpadded relu_bitmap kernel at the decode, prefill, ragged and
    single-tile shapes, with NaN, -0.0 and whole tiles <= 0 in x, from an
    aligned base and from one element past it (no 16-byte vectors): y
    equals the plain version's bit for bit (NaN and -0.0 pass through),
    and so do the bits over ceil(R/br) x ceil(C/bc) tiles."""
    rng = np.random.default_rng(5)
    R, C = shape
    br, bc = block
    x = rng.standard_normal(shape).astype(np.float32)
    x[:br, :bc] = -1.0  # a tile with no element > 0
    x[-1, -1] = np.nan
    x[0, -1] = -0.0
    x[R // 2, : min(C, 3)] = np.nan
    buf = torch.empty(R * C + offset, dtype=dtype, device=cuda)
    xt = buf[offset:].view(R, C)
    xt.copy_(torch.from_numpy(x))
    before = rb.relu_bitmap.launches
    y, bits = rb.relu_bitmap(xt, block_r=br, block_c=bc)
    assert rb.relu_bitmap.launches == before + 1
    y0, bits0 = rb.relu_bitmap_plain(xt, block_r=br, block_c=bc)
    assert tuple(bits.shape) == (-(-R // br), -(-C // bc))
    assert torch.equal(_bits_view(y), _bits_view(y0))
    assert torch.equal(bits, bits0)
    assert bool(bits[0, 0])
    yb, _ = rb.relu_bitmap(xt.cpu(), block_r=br, block_c=bc)
    assert torch.equal(_bits_view(y.cpu()), _bits_view(yb))


@pytest.mark.parametrize("gate", ["lhs", "rhs"])
@pytest.mark.parametrize("M,bm", [(8, 1), (256, 1), (128, 64), (256, 64),
                                  (4, 1)])
@pytest.mark.parametrize("dtype,tol", [
    (torch.float32, 1e-4),   # f32 sums over K in another order
    (torch.bfloat16, 2e-2),  # bf16 output rounding
])
def test_gated_gemm_kernel_matches_plain(cuda, gate, M, bm, dtype, tol):
    """The decode and prefill shapes of the down-projection: ragged N
    (576 over 128-wide tiles), gated tiles NaN-poisoned."""
    rng = np.random.default_rng(5)
    K, N, bk, bn = 1536, 576, 128, 128
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) * K ** -0.5).astype(np.float32)
    shape = sg.bit_grid(M, K, N, block_m=bm, block_k=bk, block_n=bn,
                        gate=gate)
    bits = (rng.random(shape) < 0.4).astype(np.int32)
    bits[:, 3] = 1  # gated for every row tile / k-stripe 3 of every column
    xt, wt = (torch.from_numpy(a).to(cuda, dtype) for a in (x, w))
    bt = torch.from_numpy(bits).to(cuda)
    kw = dict(block_m=bm, block_k=bk, block_n=bn, gate=gate)
    before = sg.sparce_gemm_gated.launches
    y = sg.sparce_gemm_gated(xt, wt, bt, **kw)
    assert sg.sparce_gemm_gated.launches == before + 1
    y0 = sg.sparce_gemm_gated_plain(xt, wt, bt, **kw)
    torch.testing.assert_close(y.float(), y0.float(), rtol=tol, atol=tol)
    x2, w2 = xt.clone(), wt.clone()
    if gate == "lhs":
        for i, j in zip(*np.nonzero(bits)):
            x2[i * bm:(i + 1) * bm, j * bk:(j + 1) * bk] = float("nan")
        w2[3 * bk:4 * bk] = float("nan")  # gated in every row tile
    else:
        for i, j in zip(*np.nonzero(bits)):
            w2[i * bk:(i + 1) * bk, j * bn:(j + 1) * bn] = float("nan")
    y2 = sg.sparce_gemm_gated(x2, w2, bt, **kw)
    assert bool(torch.isfinite(y2).all()) and torch.equal(y2, y)


@pytest.mark.parametrize("act", ["relu", "relu2"])
@pytest.mark.parametrize("M,bm", [(8, 1), (256, 1), (128, 64), (4, 1)])
@pytest.mark.parametrize("dtype,tol", [
    (torch.float32, 1e-4),   # f32 sums over K and F in another order
    (torch.bfloat16, 2e-2),  # bf16 roundings of a and y
])
def test_fused_mlp_kernel_matches_plain(cuda, act, M, bm, dtype, tol):
    rng = np.random.default_rng(6)
    K, F, N, bf = 576, 1536, 576, 128
    x = rng.standard_normal((M, K)).astype(np.float32)
    x[M // 2: M // 2 + bm] = 0.0  # a dead row tile
    w_in = (rng.standard_normal((K, F)) * K ** -0.5).astype(np.float32)
    w_in[:, 2 * bf:3 * bf] = -np.abs(w_in[:, 2 * bf:3 * bf])
    x = np.abs(x)  # with the negative stripe: stripe 2 dead everywhere
    w_out = (rng.standard_normal((F, N)) * F ** -0.5).astype(np.float32)
    args = [torch.from_numpy(a).to(cuda, dtype) for a in (x, w_in, w_out)]
    before = sm.sparce_mlp_fused.launches
    y, bits = sm.sparce_mlp_fused(*args, block_m=bm, block_f=bf, act=act)
    assert sm.sparce_mlp_fused.launches == before + 1
    y0, bits0 = sm.sparce_mlp_fused_plain(*args, block_m=bm, block_f=bf,
                                          act=act)
    assert torch.equal(bits, bits0)
    assert bool(bits[:, 2].all()) and bool(bits[M // 2 // bm].all())
    torch.testing.assert_close(y.float(), y0.float(), rtol=tol, atol=tol)
    wo2 = args[2].clone()
    wo2[2 * bf:3 * bf] = float("nan")
    y2, bits2 = sm.sparce_mlp_fused(args[0], args[1], wo2, block_m=bm,
                                    block_f=bf, act=act)
    assert bool(torch.isfinite(y2).all())
    assert torch.equal(y2, y) and torch.equal(bits2, bits)


# (M, K, F, N, block_m, block_f): the relu decode tick and a 256-row
# prefill bucket at per-row tiles, ragged M and F unpadded under per-row
# and 64-row tiles, ragged K and N, and 256-row tiles (chunks of 64).
MLP_CASES = [(8, 576, 1536, 576, 1, 128), (256, 576, 1536, 576, 1, 128),
             (4, 576, 1536, 576, 1, 128),  # a dp 2 shard's decode rows
             (37, 576, 1000, 576, 1, 128), (37, 576, 1000, 576, 64, 128),
             (100, 200, 1000, 70, 64, 128), (300, 192, 320, 96, 256, 128),
             # The planner's own tiles at a 256-row prefill and at a
             # training step's 4096 rows (there the cluster widens to fit
             # shared memory).
             (256, 576, 1536, 576, 256, 512),
             (4096, 576, 1536, 576, 256, 512)]


@pytest.mark.parametrize("M,K,F,N,bm,bf", MLP_CASES)
@pytest.mark.parametrize("act", ["relu", "relu2"])
@pytest.mark.parametrize("dtype,tol", [
    (torch.float32, 1e-4),   # f32 (split-TF32) sums over K and F
    (torch.bfloat16, 2e-2),  # bf16 roundings of a and y
])
def test_mlp_cluster_kernel_at_unpadded_shapes(cuda, M, K, F, N, bm, bf,
                                               act, dtype, tol):
    """The cluster kernel takes M and F unpadded, with NaN right past
    every operand's end: bits equal the plain version's, y within
    tolerance, a second call equal bit for bit; NaN in the w_out rows of
    the stripes dead in every row tile never reaches y, and NaN in a
    stripe live in one row tile and dead in another never reaches the
    dead tile's rows. The launch spreads over more CTAs than stripes."""
    rng = np.random.default_rng(41)
    x = np.abs(rng.standard_normal((M, K))).astype(np.float32)
    t = (M // 2) // bm
    if M > bm:
        x[t * bm:(t + 1) * bm] = 0.0  # a dead row tile
    w_in = (rng.standard_normal((K, F)) * K ** -0.5).astype(np.float32)
    w_in[:, bf:2 * bf] = -np.abs(w_in[:, bf:2 * bf])  # stripe 1 dead
    w_out = (rng.standard_normal((F, N)) * F ** -0.5).astype(np.float32)
    args = [_nan_tail(a, cuda, dtype) for a in (x, w_in, w_out)]
    kw = dict(block_m=bm, block_f=bf, act=act)
    grid = sm.kernel_grid(M, K, F, N, block_m=bm, block_f=bf, dtype=dtype)
    assert grid["ctas"] > -(-M // max(bm, 64)) * -(-F // bf)
    before = sm.sparce_mlp_fused.launches
    y, bits = sm.sparce_mlp_fused(*args, **kw)
    assert sm.sparce_mlp_fused.launches == before + 1
    y0, bits0 = sm.sparce_mlp_fused_plain(*args, **kw)
    assert torch.equal(bits, bits0)
    assert bool(bits[:, 1].all()) and not bool(bits.all())
    assert M <= bm or bool(bits[t].all())
    assert bool(torch.isfinite(y).all())
    torch.testing.assert_close(y.float(), y0.float(), rtol=tol, atol=tol)
    y1, bits1 = sm.sparce_mlp_fused(*args, **kw)
    assert torch.equal(bits1, bits)
    assert torch.equal(_bits_view(y1), _bits_view(y))
    dead = bits.bool().all(dim=0).nonzero().flatten().tolist()
    wo2 = args[2].clone()
    for f in dead:
        wo2[f * bf:(f + 1) * bf] = float("nan")
    y2, bits2 = sm.sparce_mlp_fused(args[0], args[1], wo2, **kw)
    assert torch.equal(bits2, bits)
    assert bool(torch.isfinite(y2).all()) and torch.equal(y2, y)
    if M > bm:  # per-row poison: stripe 0 is live but dead in tile t
        assert not bool(bits[:, 0].all()) and bool(bits[t, 0])
        wo3 = args[2].clone()
        wo3[:bf] = float("nan")
        y3, _ = sm.sparce_mlp_fused(args[0], args[1], wo3, **kw)
        rows = torch.arange(M, device=cuda) // bm
        dead_rows = bits[rows, 0].bool()
        assert bool(torch.isfinite(y3[dead_rows]).all())
        assert torch.equal(y3[dead_rows], y[dead_rows])
        assert bool(torch.isnan(y3[~dead_rows]).any())


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_autotuner_times_both_candidates_on_the_card(cuda, dtype):
    """SASA's measuring autotuner at the relu decode tick: each
    candidate's kernels launched once to warm up and ``iters`` times,
    the winner the faster, memoised per device type; both candidates
    give the plain version's bits and y."""
    shape, s, iters = (8, 576, 1536, 576), 0.5, 3
    sasa.plan_cache_clear()
    model = sasa.plan_mlp(*shape, measured_block_sparsity=s, dtype=dtype)
    x, wi, wo = autotune_decode_inputs(torch, cuda, dtype, shape,
                                       model.block_f, s)
    kernels = (sm.sparce_mlp_fused, rb.relu_bitmap, sg.sparce_gemm_gated)
    before = [k.launches for k in kernels]
    kw = dict(measured_block_sparsity=s, dtype=dtype, iters=iters,
              sample_inputs=(x, wi, wo), device=cuda)
    tuned = sasa.autotune_mlp_plan(*shape, **kw)
    assert [k.launches - b for k, b in zip(kernels, before)] == [
        iters + 1] * 3
    plan, timings = tuned
    assert plan.variant == min(timings, key=timings.get)
    assert dataclasses.replace(plan, variant=model.variant) == model
    assert sasa.autotune_mlp_plan(*shape, **kw) is tuned
    key = ("mlp-tuned", *shape, dtype, s, "cuda")
    assert sasa._PLAN_CACHE[key] is tuned
    blocks = dict(block_m=plan.block_m, block_f=plan.block_f)
    y_f, bmp = kops.sparce_mlp_fused(x, wi, wo, **blocks)
    y_t, bits_t = sparse_ops.two_kernel_mlp(x, wi, wo, plan)
    y0, bits0 = sm.sparce_mlp_fused_plain(x, wi, wo, **blocks)
    assert torch.equal(bmp.bits, bits0) and torch.equal(bits_t, bits0)
    assert 0 < int(bits0.sum()) < bits0.numel()
    tol = AUTOTUNE_TOLS[dtype]
    atol = tol * y0.float().abs().max().item()
    for y in (y_f, y_t):
        torch.testing.assert_close(y.float(), y0.float(), rtol=tol,
                                   atol=atol)
    sasa.plan_cache_clear()


def test_wrappers_check_their_inputs(cuda):
    q, kp, vp, tables, lengths, _ = _attn_case(cuda, torch.float32)
    with pytest.raises(TypeError, match="int32"):
        pda.paged_gqa_decode_attn(q, kp, vp, tables.long(), lengths)
    with pytest.raises(TypeError, match="share"):
        pda.paged_gqa_decode_attn(q, kp.double(), vp, tables, lengths)
    x = torch.zeros((64, 32), device=cuda)
    w = torch.zeros((32, 128), device=cuda)
    with pytest.raises(ValueError, match="w_gate on cpu"):
        sgm.sparce_glu_mlp_fused(x, w.cpu(), w, w.T.contiguous(),
                                 block_m=64, block_f=128)
    with pytest.raises(ValueError, match="w_in on cpu"):
        sm.sparce_mlp_fused(x, w.cpu(), w.T.contiguous(), block_m=64,
                            block_f=128)
    with pytest.raises(TypeError, match="w is"):
        sg.sparce_gemm_gated(x, w.double(),
                             torch.zeros((1, 1), dtype=torch.int32,
                                         device=cuda),
                             block_m=64, block_k=32, block_n=128)
    with pytest.raises(ValueError, match="contiguous"):
        rb.relu_bitmap(w.T, block_r=1, block_c=32)


def test_reduced_engine_on_gpu_matches_cpu(cuda):
    cfg = get_config("smollm-135m").reduced()
    rng = np.random.default_rng(2)
    reqs = [(i, rng.integers(0, cfg.vocab_size, int(rng.integers(3, 20))),
             int(rng.integers(2, 9))) for i in range(6)]
    outs, metrics = {}, {}
    for dev in ("cpu", cuda):
        params = model_lib.init_params(cfg, seed=0, device=dev)
        srv = Server(cfg, params, ServeConfig(
            batch_slots=3, max_len=32, attn_kernel="paged",
            sparsity=SparsityConfig(enabled=True, mode="fused", block_m=1,
                                    expected_sparsity=0.5)), device=dev)
        done = srv.generate([Request(uid=u, prompt=p, max_new=n)
                             for u, p, n in reqs])
        key = torch.device(dev).type
        outs[key] = {r.uid: r.out.tolist() for r in done}
        metrics[key] = srv.metrics
    assert outs["cuda"] == outs["cpu"]
    for name in ("skipped_tile_dots", "total_tile_dots", "decode_tokens",
                 "ticks", "attn_blocks_fetched", "kv_blocks_peak_in_use"):
        assert getattr(metrics["cuda"], name) == getattr(metrics["cpu"], name)
    assert metrics["cuda"].skipped_tile_dots > 0


@pytest.mark.parametrize("arch", ["smollm-135m", "mamba2-2.7b",
                                  "zamba2-7b"])
def test_reduced_contiguous_engine_on_gpu_matches_cpu(cuda, arch):
    """The contiguous layout (``kv_block_size=0``; the ssm and hybrid
    families always) on the card gives the CPU's tokens and counters;
    smollm's GLU runs through the fused GLU kernel there. Prompts stay
    within one scan chunk (16 in the reduced configs)."""
    cfg = get_config(arch).reduced()
    rng = np.random.default_rng(3)
    reqs = [(i, rng.integers(0, cfg.vocab_size, int(rng.integers(2, 17))),
             int(rng.integers(2, 9))) for i in range(6)]
    sp = SparsityConfig(enabled=True, mode="fused", gate_threshold=0.0)
    outs, metrics = {}, {}
    for dev in ("cpu", cuda):
        params = model_lib.init_params(cfg, seed=0, device=dev)
        srv = Server(cfg, params, ServeConfig(
            batch_slots=3, max_len=32, kv_block_size=0, sparsity=sp),
            device=dev)
        before = sgm.sparce_glu_mlp_fused.launches
        done = srv.generate([Request(uid=u, prompt=p, max_new=n)
                             for u, p, n in reqs])
        key = torch.device(dev).type
        if key == "cuda" and arch == "smollm-135m":
            assert sgm.sparce_glu_mlp_fused.launches > before
        outs[key] = {r.uid: r.out.tolist() for r in done}
        metrics[key] = srv.metrics
    assert outs["cuda"] == outs["cpu"]
    for name in ("skipped_tile_dots", "total_tile_dots", "decode_tokens",
                 "ticks", "prefill_tokens"):
        assert getattr(metrics["cuda"], name) == getattr(metrics["cpu"], name)
    assert metrics["cuda"].kv_paged == 0


def test_reduced_prefix_cache_engine_on_gpu_matches_cpu(cuda):
    """The prefix cache on the card: shared-prefix prompts and a
    byte-identical re-prompt (a copy-on-write fork) give the CPU's tokens
    and counters, through the paged GQA kernel over tables whose slots
    share blocks; only the index holds blocks afterwards."""
    cfg = get_config("smollm-135m").reduced()
    rng = np.random.default_rng(9)
    prefix = rng.integers(0, cfg.vocab_size, 16)
    prompts = [np.concatenate([prefix, rng.integers(0, cfg.vocab_size, n)])
               for n in (8, 3, 5, 12, 1)]
    prompts.append(prompts[0].copy())  # 24 rows: 3 whole blocks
    outs, metrics = {}, {}
    for dev in ("cpu", cuda):
        params = model_lib.init_params(cfg, seed=0, device=dev)
        srv = Server(cfg, params, ServeConfig(
            batch_slots=3, max_len=48, kv_block_size=8, attn_kernel="paged",
            prefix_cache=True, sparsity=SparsityConfig(
                enabled=True, mode="fused", gate_threshold=0.0)), device=dev)
        before = pda.paged_gqa_decode_attn.launches
        done = srv.generate([Request(uid=i, prompt=p, max_new=6)
                             for i, p in enumerate(prompts)])
        key = torch.device(dev).type
        if key == "cuda":
            assert pda.paged_gqa_decode_attn.launches > before
        outs[key] = {r.uid: r.out.tolist() for r in done}
        metrics[key] = srv.metrics
        alloc = srv._st.alloc
        assert alloc.in_use == len(srv._prefix) and alloc.reserved == 0
        alloc.check(expect_reserved=0)
    assert outs["cuda"] == outs["cpu"]
    for name in ("prefix_hits", "prefix_matched_tokens",
                 "prefix_blocks_shared", "prefix_cow_forks", "ticks",
                 "decode_tokens", "prefill_tokens", "attn_blocks_fetched"):
        assert getattr(metrics["cuda"], name) == getattr(metrics["cpu"], name)
    assert metrics["cuda"].prefix_hits == 5
    assert metrics["cuda"].prefix_cow_forks == 1


@pytest.mark.parametrize("mode", ["fused", "kernel"])
def test_reduced_relu_engine_on_gpu_matches_cpu(cuda, mode):
    """The relu MLP (``--sparce``) in both kernel modes: the same tokens
    and skip counters on the GPU as on the CPU, and the mode's kernels
    really launched."""
    import dataclasses
    cfg = dataclasses.replace(get_config("smollm-135m").reduced(),
                              mlp_act="relu")
    rng = np.random.default_rng(7)
    reqs = [(i, rng.integers(0, cfg.vocab_size, int(rng.integers(3, 20))),
             int(rng.integers(2, 9))) for i in range(6)]
    counters = {"fused": [sm.sparce_mlp_fused],
                "kernel": [rb.relu_bitmap, sg.sparce_gemm_gated]}[mode]
    outs, metrics = {}, {}
    for dev in ("cpu", cuda):
        params = model_lib.init_params(cfg, seed=0, device=dev)
        srv = Server(cfg, params, ServeConfig(
            batch_slots=3, max_len=32, attn_kernel="paged",
            sparsity=SparsityConfig(enabled=True, mode=mode, block_m=1,
                                    block_k=32)), device=dev)
        before = [f.launches for f in counters]
        done = srv.generate([Request(uid=u, prompt=p, max_new=n)
                             for u, p, n in reqs])
        launched = [f.launches - b for f, b in zip(counters, before)]
        key = torch.device(dev).type
        assert all(n > 0 for n in launched) == (key == "cuda"), launched
        outs[key] = {r.uid: r.out.tolist() for r in done}
        metrics[key] = srv.metrics
    assert outs["cuda"] == outs["cpu"]
    for name in ("skipped_tile_dots", "total_tile_dots", "decode_tokens",
                 "prefill_skipped_tile_dots", "ticks"):
        assert getattr(metrics["cuda"], name) == getattr(metrics["cpu"], name)
    assert metrics["cuda"].skipped_tile_dots > 0


def test_ops_wrappers_on_gpu_equal_cpu(cuda):
    """The padded wrappers the model calls, ragged dims included: bits
    equal the CPU plain versions' exactly."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((10, 200)).astype(np.float32)
    x[3] = 0.0
    w_in = (rng.standard_normal((200, 300)) * 0.1).astype(np.float32)
    w_out = (rng.standard_normal((300, 70)) * 0.1).astype(np.float32)
    xt, wi, wo = (torch.from_numpy(a) for a in (x, w_in, w_out))
    y, bmp = kops.sparce_mlp_fused(xt.to(cuda), wi.to(cuda), wo.to(cuda),
                                   block_m=1, block_f=128)
    y0, bmp0 = kops.sparce_mlp_fused(xt, wi, wo, block_m=1, block_f=128)
    assert torch.equal(bmp.bits.cpu(), bmp0.bits)
    torch.testing.assert_close(y.cpu(), y0, rtol=1e-4, atol=1e-4)
    a, abmp = kops.relu_with_bitmap(xt.to(cuda), (1, 128))
    a0, abmp0 = kops.relu_with_bitmap(xt, (1, 128))
    assert torch.equal(a.cpu(), a0) and torch.equal(abmp.bits.cpu(),
                                                    abmp0.bits)
    from repro_torch.core.sasa import SkipPlan
    plan = SkipPlan(gate="lhs", variant="gated", block_m=1, block_k=128,
                    block_n=128)
    g = kops.sparce_gemm(a, wi.to(cuda), plan, lhs_bitmap=abmp)
    g0 = kops.sparce_gemm(a0, wi, plan, lhs_bitmap=abmp0)
    torch.testing.assert_close(g.cpu(), g0, rtol=1e-4, atol=1e-4)


def _mla_case(dev, dtype, seed=0, lengths=(0, 1, 4, 5, 17, 24, 40), BS=4,
              max_blocks=6, h=12, r=512, rope=64):
    """Latent pools with dead table entries naming spare blocks; one
    length on a block edge, one past the table's reach (24)."""
    rng = np.random.default_rng(seed)
    B = len(lengths)
    live = [min(-(-n // BS), max_blocks) for n in lengths]
    nb = sum(live) + 1 + 4
    ids = rng.permutation(np.arange(1, nb))
    tables = np.zeros((B, max_blocks), np.int32)
    nxt = 0
    for b in range(B):
        tables[b, :live[b]] = ids[nxt:nxt + live[b]]
        nxt += live[b]
    spare = ids[nxt:]
    for b in range(B):
        tables[b, live[b]:] = spare[b % len(spare)]
    t = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32)).to(dev, dtype)
    return (t(B, h, r), t(B, h, rope), t(nb, BS, r), t(nb, BS, rope),
            torch.from_numpy(tables).to(dev),
            torch.tensor(lengths, dtype=torch.int32, device=dev),
            set(ids[:nxt].tolist()))


@pytest.mark.parametrize("dtype,tol", [
    (torch.float32, 1e-4),   # f32 sums over 576-term dots in another order
    (torch.bfloat16, 2e-2),  # p rounded vs a running max; bf16 output
])
@pytest.mark.parametrize("r,rope", [(512, 64), (16, 8)])
def test_mla_kernel_matches_plain(cuda, dtype, tol, r, rope):
    """The paged MLA kernel against its plain version; a length-0 slot
    gives exact zeros; NaN in the null block and in every block past the
    live counts never reaches the output; one launch is counted."""
    from repro_torch.kernels import ops as kops
    ql, qr, ckv, kr, tables, lengths, live_ids = _mla_case(
        cuda, dtype, r=r, rope=rope)
    scale = 192 ** -0.5
    before = pda.paged_mla_decode_attn.launches
    got = pda.paged_mla_decode_attn(ql, qr, ckv, kr, tables, lengths,
                                    scale=scale)
    assert pda.paged_mla_decode_attn.launches == before + 1
    want = pda.paged_mla_decode_attn_plain(ql, qr, ckv, kr, tables, lengths,
                                           scale=scale)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    assert bool((got[0] == 0).all())  # the length-0 slot
    wrapped = kops.paged_mla_decode_attn(ql, qr, ckv, kr, tables, lengths,
                                         scale=scale)
    assert torch.equal(wrapped, got)  # lengths past the reach clamp
    dead = [i for i in range(ckv.shape[0]) if i not in live_ids]
    assert 0 in dead
    ckv2, kr2 = ckv.clone(), kr.clone()
    ckv2[dead] = float("nan")
    kr2[dead] = float("nan")
    poisoned = pda.paged_mla_decode_attn(ql, qr, ckv2, kr2, tables, lengths,
                                         scale=scale)
    assert bool(torch.isfinite(poisoned).all())
    assert torch.equal(poisoned, got)


@pytest.mark.parametrize("dtype,tol", [
    (torch.float32, 1e-4),   # f32 (split-TF32) sums, chunks merged
    (torch.bfloat16, 2e-2),  # p rounded vs a chunk's running max
])
@pytest.mark.parametrize("shape", [
    dict(h=128, r=512, rope=64, BS=16, max_blocks=32),  # DeepSeek decode
    dict(h=40, r=100, rope=20, BS=24, max_blocks=5),    # ragged widths
])
def test_mla_kernel_at_chunk_edges(cuda, dtype, tol, shape):
    """Lengths on the kernel's chunk edges (E * bs, E * bs + 1, one row
    short, two chunks), the table's reach and past it, 0 and 1, so some
    slots' trailing chunks are all empty: the kernel equals its plain
    version, a second call is equal bit for bit, a length-0 slot gives
    zeros, and NaN in the null block and every block past the live
    counts never reaches the output. At the DeepSeek shape the launch
    has at least 132 CTAs."""
    bs, max_blocks = shape["BS"], shape["max_blocks"]
    grid = pda.mla_grid(8, shape["h"], max_blocks, bs)
    edge, reach = grid["entries"] * bs, max_blocks * bs
    if shape["h"] == 128:
        assert grid["ctas"] >= 132 and grid["chunks"] > 1
    lengths = (edge, edge + 1, edge - 1, 2 * edge, reach, reach + 1, 0, 1)
    ql, qr, ckv, kr, tables, lens, live_ids = _mla_case(
        cuda, dtype, lengths=lengths, **shape)
    scale = 192 ** -0.5
    got = pda.paged_mla_decode_attn(ql, qr, ckv, kr, tables, lens,
                                    scale=scale)
    want = pda.paged_mla_decode_attn_plain(ql, qr, ckv, kr, tables, lens,
                                           scale=scale)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    assert bool((got[6] == 0).all())
    again = pda.paged_mla_decode_attn(ql, qr, ckv, kr, tables, lens,
                                      scale=scale)
    assert torch.equal(_bits_view(again), _bits_view(got))
    dead = [i for i in range(ckv.shape[0]) if i not in live_ids]
    ckv2, kr2 = ckv.clone(), kr.clone()
    ckv2[dead] = float("nan")
    kr2[dead] = float("nan")
    poisoned = pda.paged_mla_decode_attn(ql, qr, ckv2, kr2, tables, lens,
                                         scale=scale)
    assert bool(torch.isfinite(poisoned).all())
    assert torch.equal(poisoned, got)


def test_mla_kernel_checks_its_inputs(cuda):
    ql, qr, ckv, kr, tables, lengths, _ = _mla_case(cuda, torch.bfloat16)
    with pytest.raises(TypeError, match="q_rope"):
        pda.paged_mla_decode_attn(ql, qr.float(), ckv, kr, tables, lengths,
                                  scale=0.1)
    with pytest.raises(ValueError, match="shape mismatch"):
        pda.paged_mla_decode_attn(ql, qr[:, :, :8].contiguous(), ckv, kr,
                                  tables, lengths, scale=0.1)
    with pytest.raises(TypeError, match="int32"):
        pda.paged_mla_decode_attn(ql, qr, ckv, kr, tables.long(), lengths,
                                  scale=0.1)


def test_reduced_deepseek_engine_is_deterministic_in_bf16(cuda):
    """The bf16 reduced DeepSeek-V3 engine (paged MLA kernel, MoE with a
    fixed-order combine) gives the same token streams and counters twice
    in a row, with the MLA kernel launched on every decode tick's
    layers."""
    import dataclasses
    cfg = dataclasses.replace(get_config("deepseek-v3-671b").reduced(),
                              dtype="bfloat16")
    params = model_lib.init_params(cfg, seed=0, device=cuda)
    rng = np.random.default_rng(9)
    reqs = [(i, rng.integers(0, cfg.vocab_size, int(rng.integers(3, 20))),
             int(rng.integers(2, 9))) for i in range(6)]
    outs, metrics = [], []
    for _ in range(2):
        srv = Server(cfg, params, ServeConfig(
            batch_slots=3, max_len=32, attn_kernel="paged"), device=cuda)
        before = pda.paged_mla_decode_attn.launches
        done = srv.generate([Request(uid=u, prompt=p, max_new=n)
                             for u, p, n in reqs])
        launched = pda.paged_mla_decode_attn.launches - before
        assert launched == srv.metrics.ticks * cfg.num_layers
        outs.append({r.uid: r.out.tolist() for r in done})
        metrics.append(srv.metrics)
    assert outs[0] == outs[1]
    for name in ("decode_tokens", "ticks", "attn_blocks_fetched",
                 "kv_blocks_peak_in_use"):
        assert getattr(metrics[0], name) == getattr(metrics[1], name)
    assert metrics[0].attn_block_skip_fraction > 0


# ------------------------------------ the paper's evaluation path (GEMMs)
def _bits_view(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else \
        t.view(torch.int16)


@pytest.mark.parametrize("M,K,N,bm,bk,bn", [
    (169, 3456, 384, 8, 128, 256),    # conv4, alexnet's compacted plan
    (1, 9216, 4096, 8, 128, 256),     # fc6
    (169, 2304, 384, 168, 128, 128),  # 168-row tiles, ragged M
    (300, 1000, 250, 256, 128, 128),  # 256-row tiles, ragged M, K and N
    (37, 640, 200, 1, 128, 128),
    (2048, 1536, 576, 64, 128, 128),  # bf16: both on the tall path
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_compacted_kernel_equals_gated_kernel_bit_for_bit(
        cuda, M, K, N, bm, bk, bn, dtype):
    """The same tile products in the same ascending order with the same
    per-patch FMA order: the compacted kernel's output equals the gated
    kernel's bit for bit; both equal the plain version within f32
    rounding; a row tile with nnz == 0 writes exact zeros; NaN in every
    dead x tile and in every w k-stripe no live row tile lists never
    reaches y."""
    rng = np.random.default_rng(20)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) * K ** -0.5).astype(np.float32)
    grid = sg.bit_grid(M, K, N, block_m=bm, block_k=bk, block_n=bn,
                       gate="lhs")
    bits = (rng.random(grid) < 0.6).astype(np.int32)
    bits[:, 1] = 1  # k-stripe 1 listed by no row tile
    if grid[0] > 1:
        bits[-1] = 1  # the last row tile: nnz == 0
        bits[0, 0] = 0
    xt, wt = (torch.from_numpy(a).to(cuda, dtype) for a in (x, w))
    bt = torch.from_numpy(bits).to(cuda)
    kw = dict(block_m=bm, block_k=bk, block_n=bn)
    before = sg.sparce_gemm_compacted.launches
    y = sg.sparce_gemm_compacted(xt, wt, bt, **kw)
    assert sg.sparce_gemm_compacted.launches == before + 1
    yg = sg.sparce_gemm_gated(xt, wt, bt, **kw)
    torch.cuda.synchronize()
    assert torch.equal(_bits_view(y), _bits_view(yg))
    tol = 1e-4 if dtype == torch.float32 else 2e-2  # sums in another order
    y0 = sg.sparce_gemm_compacted_plain(xt, wt, bt, **kw)
    torch.testing.assert_close(y.float(), y0.float(), rtol=tol, atol=tol)
    if grid[0] > 1:
        assert bool((y[(grid[0] - 1) * bm:] == 0).all())
    x2, w2 = xt.clone(), wt.clone()
    for i, j in zip(*np.nonzero(bits)):
        x2[i * bm:(i + 1) * bm, j * bk:(j + 1) * bk] = float("nan")
    w2[bk:2 * bk] = float("nan")
    y2 = sg.sparce_gemm_compacted(x2, w2, bt, **kw)
    assert bool(torch.isfinite(y2).all()) and torch.equal(y2, y)


def test_compacted_kernel_takes_a_list_past_the_old_cap(cuda):
    """1024 and 1025 k tiles (the first design's cap on the live list,
    which the chunked walk no longer has) at block_k 1, a k tile below
    the MMA's k step: both launch and equal the plain version."""
    kw = dict(block_m=1, block_k=1, block_n=128)
    for K in (1024, 1025):
        x = torch.randn((2, K), device=cuda)
        w = torch.randn((K, 8), device=cuda)
        bits = torch.zeros((2, K), dtype=torch.int32, device=cuda)
        bits[1, ::3] = 1
        before = sg.sparce_gemm_compacted.launches
        y = sg.sparce_gemm_compacted(x, w, bits, **kw)
        assert sg.sparce_gemm_compacted.launches == before + 1
        torch.testing.assert_close(  # f32 sums over K in another order
            y, sg.sparce_gemm_compacted_plain(x, w, bits, **kw),
            rtol=1e-4, atol=1e-4)


GEMM_TOLS = [
    (torch.float32, 1e-4),   # f32 sums over K in another order
    (torch.bfloat16, 2e-2),  # bf16 output rounding
]


def _gemm_operands(dev, dtype, M, K, N, bm, bk, bn, seed, live=0.5):
    """x, init-scale w, and random lhs and rhs bit grids at ``live``."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) * K ** -0.5).astype(np.float32)
    kw = dict(block_m=bm, block_k=bk, block_n=bn)
    lbits = (rng.random(sg.bit_grid(M, K, N, gate="lhs", **kw)) >= live
             ).astype(np.int32)
    rbits = (rng.random(sg.bit_grid(M, K, N, gate="rhs", **kw)) >= live
             ).astype(np.int32)
    xt, wt = (torch.from_numpy(a).to(dev, dtype) for a in (x, w))
    return xt, wt, lbits, rbits, kw


def _all_three(xt, wt, lbits, rbits, kw, dev):
    """The compacted kernel, the gated kernel (lhs) on the same bits,
    and the gated kernel (rhs), each beside its plain version."""
    lb, rbt = (torch.from_numpy(b).to(dev) for b in (lbits, rbits))
    return [
        (sg.sparce_gemm_compacted(xt, wt, lb, **kw),
         sg.sparce_gemm_compacted_plain(xt, wt, lb, **kw)),
        (sg.sparce_gemm_gated(xt, wt, lb, gate="lhs", **kw),
         sg.sparce_gemm_gated_plain(xt, wt, lb, gate="lhs", **kw)),
        (sg.sparce_gemm_gated(xt, wt, rbt, gate="rhs", **kw),
         sg.sparce_gemm_gated_plain(xt, wt, rbt, gate="rhs", **kw)),
    ]


@pytest.mark.parametrize("M,K,N,bm,bk,bn", [
    (8, 1536, 576, 1, 128, 128),     # relu decode: 6 k chunks
    (169, 3456, 384, 8, 128, 256),   # AlexNet conv4: 7 k chunks
    (4, 96, 64, 1, 128, 128),        # one chunk: y written directly
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gemm_kernels_are_deterministic(cuda, M, K, N, bm, bk, bn, dtype):
    """Two calls on the same inputs give the same bits, for both kernels
    and both gates: the chunks' partials are added in a fixed order,
    with no atomics."""
    xt, wt, lbits, rbits, kw = _gemm_operands(cuda, dtype, M, K, N, bm, bk,
                                              bn, seed=30)
    first = _all_three(xt, wt, lbits, rbits, kw, cuda)
    second = _all_three(xt, wt, lbits, rbits, kw, cuda)
    for (a, _), (b, _) in zip(first, second):
        assert torch.equal(_bits_view(a), _bits_view(b))


@pytest.mark.parametrize("case", ["one_chunk", "empty_chunks", "ragged_k"])
@pytest.mark.parametrize("dtype,tol", GEMM_TOLS)
def test_gemm_kernels_on_chunk_edges(cuda, case, dtype, tol):
    """K = 1536 at block_k 128 runs 6 chunks of 2 k tiles: live tiles in
    exactly one chunk; live tiles only in the first and last chunks (the
    four between them empty); and K = 1500, not a multiple of S * bk,
    its last k tile ragged. Each kernel equals its plain version, the
    compacted kernel equals the gated one bit for bit."""
    K = 1500 if case == "ragged_k" else 1536
    xt, wt, lbits, rbits, kw = _gemm_operands(cuda, dtype, 40, K, 200, 8,
                                              128, 128, seed=31)
    assert sg.chunk_tiles(1536, 128) == 2 and sg.num_chunks(1536, 128) == 6
    if case != "ragged_k":
        keep = [4, 5] if case == "one_chunk" else [0, 11]
        for b in (lbits, rbits.T):
            dead = np.ones(b.shape[1], bool)
            dead[keep] = False
            b[:, dead] = 1
    outs = _all_three(xt, wt, lbits, rbits, kw, cuda)
    for y, y0 in outs:
        torch.testing.assert_close(y.float(), y0.float(), rtol=tol, atol=tol)
    assert torch.equal(_bits_view(outs[0][0]), _bits_view(outs[1][0]))


@pytest.mark.parametrize("bk", [1, 32])
@pytest.mark.parametrize("dtype,tol", GEMM_TOLS)
def test_gemm_kernels_at_small_block_k(cuda, bk, dtype, tol):
    """k tiles of 1 and 32: below the MMA's k step (zero-padded) and one
    stage each; ragged M, K and N. Both kernels and both gates equal
    their plain versions; compacted equals gated bit for bit."""
    xt, wt, lbits, rbits, kw = _gemm_operands(cuda, dtype, 24, 300, 100, 8,
                                              bk, 64, seed=32)
    outs = _all_three(xt, wt, lbits, rbits, kw, cuda)
    for y, y0 in outs:
        torch.testing.assert_close(y.float(), y0.float(), rtol=tol, atol=tol)
    assert torch.equal(_bits_view(outs[0][0]), _bits_view(outs[1][0]))


@pytest.mark.parametrize("M,K,N,bm,bk,bn", [
    (169, 3456, 256, 8, 128, 256),   # deepcomp conv5's plan
    (1, 9216, 4096, 8, 128, 128),    # deepcomp fc6's
    (40, 700, 300, 16, 128, 64),     # narrow column tiles, ragged dims
])
@pytest.mark.parametrize("dtype,tol", [
    (torch.float32, 1e-4),   # f32 sums over K in another order
    (torch.bfloat16, 2e-2),  # bf16 output rounding
])
def test_both_kernel_matches_ref_and_plain(cuda, M, K, N, bm, bk, bn, dtype,
                                           tol):
    """The two-sided gate against the masked oracle with both masks and
    the plain version; NaN in every x tile with lbits 1, every w tile
    with rbits 1 and every w k-stripe dropped for all row tiles."""
    rng = np.random.default_rng(21)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) * K ** -0.5).astype(np.float32)
    lg = sg.bit_grid(M, K, N, block_m=bm, block_k=bk, block_n=bn, gate="lhs")
    rg = sg.bit_grid(M, K, N, block_m=bm, block_k=bk, block_n=bn, gate="rhs")
    lbits = (rng.random(lg) < 0.5).astype(np.int32)
    rbits = (rng.random(rg) < 0.5).astype(np.int32)
    lbits[:, 2] = 1
    xt, wt = (torch.from_numpy(a).to(cuda, dtype) for a in (x, w))
    lb, rbt = (torch.from_numpy(a).to(cuda) for a in (lbits, rbits))
    kw = dict(block_m=bm, block_k=bk, block_n=bn)
    before = sg.sparce_gemm_gated_both.launches
    y = sg.sparce_gemm_gated_both(xt, wt, lb, rbt, **kw)
    assert sg.sparce_gemm_gated_both.launches == before + 1
    want = kref.sparce_gemm_ref(xt, wt, bits_lhs=lb, bits_rhs=rbt, **kw)
    torch.testing.assert_close(y.float(), want.float(), rtol=tol, atol=tol)
    y0 = sg.sparce_gemm_gated_both_plain(xt, wt, lb, rbt, **kw)
    torch.testing.assert_close(y.float(), y0.float(), rtol=tol, atol=tol)
    x2, w2 = xt.clone(), wt.clone()
    for i, j in zip(*np.nonzero(lbits)):
        x2[i * bm:(i + 1) * bm, j * bk:(j + 1) * bk] = float("nan")
    for i, j in zip(*np.nonzero(rbits)):
        w2[i * bk:(i + 1) * bk, j * bn:(j + 1) * bn] = float("nan")
    w2[2 * bk:3 * bk] = float("nan")
    y2 = sg.sparce_gemm_gated_both(x2, w2, lb, rbt, **kw)
    assert bool(torch.isfinite(y2).all()) and torch.equal(y2, y)


@pytest.mark.parametrize("M,K,N,bm,bk,bn", [
    (1, 9216, 4096, 8, 128, 128),   # deepcomp fc6: 8 k chunks of 9 tiles
    (40, 1500, 300, 16, 128, 64),   # ragged dims: 6 chunks of 2
])
@pytest.mark.parametrize("dtype,tol", GEMM_TOLS)
def test_both_kernel_is_deterministic_over_k_chunks(cuda, M, K, N, bm, bk,
                                                    bn, dtype, tol):
    """More than one k chunk: the chunks' partials are added in a fixed
    order, so two calls give the same bits, within tolerance of the
    plain version."""
    assert sg.num_chunks(K, bk) > 1
    xt, wt, lbits, rbits, kw = _gemm_operands(cuda, dtype, M, K, N, bm, bk,
                                              bn, seed=33)
    lb, rbt = (torch.from_numpy(b).to(cuda) for b in (lbits, rbits))
    y = sg.sparce_gemm_gated_both(xt, wt, lb, rbt, **kw)
    y1 = sg.sparce_gemm_gated_both(xt, wt, lb, rbt, **kw)
    assert torch.equal(_bits_view(y), _bits_view(y1))
    y0 = sg.sparce_gemm_gated_both_plain(xt, wt, lb, rbt, **kw)
    torch.testing.assert_close(y.float(), y0.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_both_kernel_with_one_gate_open_equals_the_gated_kernel(cuda, dtype):
    """With every rhs bit 0 the two-sided kernel walks and stages what
    the lhs-gated kernel does, and with every lhs bit 0 what the
    rhs-gated one does: the same MMAs in the same order, so the outputs
    are equal bit for bit."""
    xt, wt, lbits, rbits, kw = _gemm_operands(cuda, dtype, 24, 1536, 200, 8,
                                              128, 64, seed=34)
    lb, rbt = (torch.from_numpy(b).to(cuda) for b in (lbits, rbits))
    y = sg.sparce_gemm_gated_both(xt, wt, lb, torch.zeros_like(rbt), **kw)
    assert torch.equal(_bits_view(y), _bits_view(
        sg.sparce_gemm_gated(xt, wt, lb, gate="lhs", **kw)))
    y = sg.sparce_gemm_gated_both(xt, wt, torch.zeros_like(lb), rbt, **kw)
    assert torch.equal(_bits_view(y), _bits_view(
        sg.sparce_gemm_gated(xt, wt, rbt, gate="rhs", **kw)))


@pytest.mark.parametrize("shape,block", [
    ((8, 1536), (1, 128)), ((128, 256), (8, 128)), ((64, 384), (64, 128)),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_relu_bwd_kernel_matches_plain(cuda, shape, block, dtype):
    """gx and bits equal the plain version's exactly: NaN in g where
    x <= 0 never reaches gx, NaN where x > 0 passes (bit 0), -0.0 counts
    as zero."""
    rng = np.random.default_rng(22)
    br, bc = block
    x = rng.standard_normal(shape).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    x[:br, :bc] = -1.0
    g[:br, :bc] = np.nan  # poison where x <= 0: dropped
    g[:br, bc:2 * bc] = -0.0
    x[-br:, -bc:], g[-br:, -bc:] = 1.0, 0.0
    g[-1, -1] = np.nan
    xt, gt = (torch.from_numpy(a).to(cuda, dtype) for a in (x, g))
    before = rb.relu_bwd_bitmap.launches
    gx, bits = rb.relu_bwd_bitmap(xt, gt, block_r=br, block_c=bc)
    assert rb.relu_bwd_bitmap.launches == before + 1
    gx0, bits0 = rb.relu_bwd_bitmap_plain(xt, gt, block_r=br, block_c=bc)
    assert torch.equal(bits, bits0)
    assert torch.equal(torch.nan_to_num(gx, 7.0), torch.nan_to_num(gx0, 7.0))
    assert bits[0, 0] == 1 and bits[0, 1] == 1 and bits[-1, -1] == 0
    assert bool(torch.isnan(gx).sum() == 1)


def test_relu_bwd_with_bitmap_unpadded_on_gpu(cuda):
    """Ragged rows and columns through ops, nothing padded: edge tiles
    get the padded reference's bits, gx comes back dense; equal to the
    CPU plain version."""
    rng = np.random.default_rng(23)
    x = rng.standard_normal((10, 300)).astype(np.float32)
    g = rng.standard_normal((10, 300)).astype(np.float32)
    x[8:] = -1.0
    xt, gt = torch.from_numpy(x), torch.from_numpy(g)
    gx, bmp = kops.relu_bwd_with_bitmap(xt.to(cuda), gt.to(cuda), (8, 128))
    gx0, bmp0 = kops.relu_bwd_with_bitmap(xt, gt, (8, 128))
    assert tuple(gx.shape) == (10, 300) and gx.is_contiguous()
    assert torch.equal(gx.cpu(), gx0) and torch.equal(bmp.bits.cpu(),
                                                      bmp0.bits)
    assert bool(bmp.bits[1].all()) and bmp.bits.shape == (2, 3)


def relu_bwd_ragged_operands(shape, block, seed):
    """x and g (f32 numpy) for a relu backward at a ragged shape: tile
    (0, 0) has x <= 0 under a NaN g (dropped: dead), a second tile (the
    next one of row tile 0, else of column tile 0) has g = -0.0 (dead),
    and the last tile's only nonzero gx is a NaN (live)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    (br, bc), (r, c) = block, shape
    x[:br, :bc], g[:br, :bc] = -1.0, np.nan
    second = (0, 1) if c > bc else (1, 0)
    g[second[0] * br:(second[0] + 1) * br,
      second[1] * bc:(second[1] + 1) * bc] = -0.0
    lr, lc = (r - 1) // br * br, (c - 1) // bc * bc
    x[lr:, lc:], g[lr:, lc:] = 1.0, 0.0
    g[-1, -1] = np.nan
    return x, g, second


RELU_BWD_RAGGED = [((7, 300), (1, 128)), ((10, 300), (8, 128)),
                   ((3025, 96), (8, 128)), ((3025, 96), (256, 128))]


@pytest.mark.parametrize("shape,block", RELU_BWD_RAGGED)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_relu_bwd_kernel_takes_ragged_shapes(cuda, shape, block, dtype):
    """Unpadded ragged operands: gx equal to the plain version's bit for
    bit (NaN in the same place), bits exactly equal, the NaN and -0.0
    tiles flagged; and one launch."""
    x, g, second = relu_bwd_ragged_operands(shape, block, seed=53)
    xt, gt = (torch.from_numpy(a).to(cuda, dtype) for a in (x, g))
    br, bc = block
    before = rb.relu_bwd_bitmap.launches
    gx, bits = rb.relu_bwd_bitmap(xt, gt, block_r=br, block_c=bc)
    assert rb.relu_bwd_bitmap.launches == before + 1
    gx0, bits0 = rb.relu_bwd_bitmap_plain(xt, gt, block_r=br, block_c=bc)
    assert torch.equal(bits, bits0)
    assert torch.equal(torch.nan_to_num(gx, 7.0), torch.nan_to_num(gx0, 7.0))
    assert bits[0, 0] == 1 and bits[second] == 1 and bits[-1, -1] == 0
    assert int(torch.isnan(gx).sum()) == 1


@pytest.mark.parametrize("bench,layer_name", [
    ("alexnet", "conv4"), ("deepcomp-alexnet", "fc6"),
    ("deepcomp-alexnet", "conv2"), ("alexnet", "conv2"),
    ("deepcomp-alexnet", "conv4"),
])
def test_ops_sparce_gemm_on_alexnet_layers_at_full_shape(cuda, bench,
                                                         layer_name):
    """One AlexNet layer at its published shape (batch 1, f32): features
    with 8 x 128 zero clusters at the scaled sparsity, weights
    block-pruned at the deep-compression sparsity, the fig14 plan; the
    kernel the plan names launches and equals the masked oracle and the
    dense product (honest bits)."""
    layer = next(g for g in ALEXNET_GEMMS if g.name == layer_name)
    act = min(0.9, layer.act_sparsity * BENCH_SPARSITY[bench] / 0.36)
    ws = DEEPCOMP_WEIGHT_SPARSITY[layer.name] if bench.startswith("deep") \
        else 0.0
    plan = sasa.plan_matmul(layer.m, layer.k, layer.n, lhs_sparsity=act,
                            rhs_sparsity=ws, lhs_cluster=8 * 128,
                            rhs_cluster=64 * 128)
    gen = torch.Generator(device=cuda).manual_seed(1)
    x = sprf.random_sparse(gen, (layer.m, layer.k), act, cluster=(8, 128))
    w = torch.randn((layer.k, layer.n), generator=gen, device=cuda) \
        * layer.k ** -0.5
    if ws:
        w = sprf.prune_weights(w, ws, block=plan.block_rhs)
    lb = sprf.compute_bitmap(x, plan.block_lhs)
    rbm = sprf.compute_bitmap(w, plan.block_rhs)
    fn = {"lhs": sg.sparce_gemm_compacted, "rhs": sg.sparce_gemm_gated,
          "both": sg.sparce_gemm_gated_both}[plan.gate]
    if plan.gate == "lhs" and plan.variant == "gated":
        fn = sg.sparce_gemm_gated
    before = fn.launches
    y = kops.sparce_gemm(x, w, plan, lhs_bitmap=lb, rhs_bitmap=rbm)
    assert fn.launches == before + 1
    want = kref.sparce_gemm_ref(
        x, w, bits_lhs=lb.bits if plan.gate in ("lhs", "both") else None,
        bits_rhs=rbm.bits if plan.gate in ("rhs", "both") else None,
        block_m=plan.block_m, block_k=plan.block_k, block_n=plan.block_n)
    torch.testing.assert_close(y, want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(y, x @ w, rtol=1e-4, atol=1e-4)


# ------------------------------------------------------ the live engine
def _live_trace(vocab, seed=0, n=12):
    """A small open-loop trace made with numpy: Poisson arrivals, a burst,
    every other prompt behind one 16-token prefix, one max_ticks
    deadline; priority 1.0 and a 2-tick TTFT deadline for every third."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, 16)
    arrivals = np.cumsum(rng.exponential(1.0, n)).tolist()
    arrivals[-4:] = [arrivals[4]] * 4  # a burst
    trace = []
    for uid in range(n):
        prompt = rng.integers(0, vocab, int(rng.integers(4, 20)))
        if uid % 2 == 0:
            prompt = np.concatenate([prefix, prompt])
        trace.append((arrivals[uid], Request(
            uid=uid, prompt=prompt, max_new=int(rng.integers(3, 10)),
            max_ticks=2 if uid == 5 else None)))
    urgent = range(0, n, 3)
    return trace, dict(priorities={u: 1.0 for u in urgent},
                       deadlines={u: 2.0 for u in urgent})


def _live_run(cfg, sc, dev, trace, kw):
    import dataclasses
    params = model_lib.init_params(cfg, seed=0, device=dev)
    srv = Server(cfg, params, sc, device=dev)
    fresh = [(a, dataclasses.replace(r, out=None, error=None, stats={}))
             for a, r in trace]
    srv.serve_trace(fresh, **kw)
    m = srv.metrics
    return srv, dict(
        admitted=list(srv.admitted_uids),
        outcome={r.uid: (type(r.error).__name__ if r.error else None,
                         r.out.tolist()) for _, r in fresh},
        metrics={k: v for k, v in vars(m).items()
                 if k not in ("prefill_s", "decode_s", "ttft_s_p50",
                              "ttft_s_p99")})


def test_reduced_live_engine_on_gpu_matches_cpu(cuda):
    """Phase 9 (b) at a small size: ``serve_trace`` under the SLO with
    preemption, a bounded queue, the prefix cache and every fault kind,
    on the relu engine in ``mode="kernel"``: the card's tokens,
    admission order, outcomes and every non-wall metric equal the
    CPU's; a preempted request was restored; the kernels launched."""
    import dataclasses
    from repro_torch.runtime.faults import FaultPlan
    from repro_torch.runtime.scheduler import SLOConfig
    cfg = dataclasses.replace(get_config("smollm-135m").reduced(),
                              mlp_act="relu")
    sc = ServeConfig(
        batch_slots=3, max_len=64, kv_block_size=8, kv_pool_blocks=14,
        attn_kernel="paged", prefix_cache=True, preempt=True,
        max_queue_depth=5,
        slo=SLOConfig(target_ttft_ticks=12.0, target_itl_ticks=2.0),
        sparsity=SparsityConfig(enabled=True, mode="kernel", block_m=1,
                                block_k=32),
        faults=FaultPlan(seed=0, step_fault_rate=0.02,
                         alloc_exhaust_rate=0.05, transient_alloc_rate=0.2,
                         poison_uids={7}))
    trace, kw = _live_trace(cfg.vocab_size)
    counted = [pda.paged_gqa_decode_attn, rb.relu_bitmap,
               sg.sparce_gemm_gated]
    before = [f.launches for f in counted]
    gpu_srv, got = _live_run(cfg, sc, cuda, trace, kw)
    assert all(f.launches > b for f, b in zip(counted, before))
    _, want = _live_run(cfg, sc, "cpu", trace, kw)
    assert got == want
    m = gpu_srv.metrics
    assert m.preemptions > 0 and m.shed_requests > 0
    assert m.faults_injected > 0
    assert any(r.stats.get("preemptions", 0) >= 1
               for r in gpu_srv._st.completed)
    alloc = gpu_srv._st.alloc
    assert alloc.in_use == len(gpu_srv._prefix) and alloc.reserved == 0
    alloc.check(expect_reserved=0)


def test_two_async_servers_at_once_on_one_card(cuda):
    """Two AsyncServers serve at the same time on one card, each engine
    thread launching the GQA kernel on its own default stream: each
    gives the tokens the CPU engine gives, and every GQA arrival counter
    is back at zero afterwards (no call saw another's counters)."""
    import threading
    from repro_torch.runtime.server import AsyncServer
    cfg = get_config("smollm-135m").reduced()
    sc = ServeConfig(batch_slots=3, max_len=64, kv_block_size=8,
                     attn_kernel="paged", sparsity=SparsityConfig(
                         enabled=True, mode="fused", gate_threshold=0.0))
    rng = np.random.default_rng(5)
    reqs = [(u, rng.integers(0, cfg.vocab_size, int(rng.integers(3, 30))),
             int(rng.integers(4, 16))) for u in range(10)]
    cpu = Server(cfg, model_lib.init_params(cfg, seed=0, device="cpu"), sc,
                 device="cpu")
    want = {r.uid: r.out.tolist() for r in cpu.generate(
        [Request(uid=u, prompt=p, max_new=n) for u, p, n in reqs])}
    params = model_lib.init_params(cfg, seed=0, device=cuda)
    servers = [AsyncServer(cfg, params, sc, device=cuda) for _ in range(2)]
    before = pda.paged_gqa_decode_attn.launches
    results, errors = [{}, {}], []

    def client(k):
        try:
            hs = [servers[k].submit(p, max_new=n, uid=u)
                  for u, p, n in reqs]
            for h in hs:
                results[k][h.uid] = [int(t) for t in h.stream(timeout=120)]
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(k,), daemon=True)
               for k in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    for s in servers:
        s.shutdown(timeout=120)
    assert not errors, errors
    assert results == [want, want]
    assert pda.paged_gqa_decode_attn.launches > before
    torch.cuda.synchronize()
    for key, counts in pda._GQA_COUNTS.items():
        assert int(counts.abs().sum()) == 0, key


# ------------------------------------------- the frontends and training
@pytest.mark.parametrize("KV,g,D", [(32, 1, 64), (8, 4, 128)],
                         ids=["musicgen-large", "pixtral-12b"])
@pytest.mark.parametrize("dtype,tol", [
    (torch.float32, 1e-5),   # f32 sums in another order
    (torch.bfloat16, 2e-2),  # p rounded vs a running max; bf16 output
])
def test_gqa_kernel_at_frontend_heads(cuda, KV, g, D, dtype, tol):
    """musicgen's multi-head attention (group 1) and pixtral's GQA."""
    q, kp, vp, tables, lengths, live_ids = _attn_case(
        cuda, dtype, KV=KV, g=g, D=D)
    got = pda.paged_gqa_decode_attn(q, kp, vp, tables, lengths)
    want = pda.paged_gqa_decode_attn_plain(q, kp, vp, tables, lengths)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    dead = [i for i in range(kp.shape[0]) if i not in live_ids]
    kp2, vp2 = kp.clone(), vp.clone()
    kp2[dead] = float("nan")
    vp2[dead] = float("nan")
    assert torch.equal(pda.paged_gqa_decode_attn(q, kp2, vp2, tables,
                                                 lengths), got)


@pytest.mark.parametrize("M", [8, 256])
@pytest.mark.parametrize("dtype,tol", [
    (torch.float32, 1e-4),   # f32 sums over K and F in another order
    (torch.bfloat16, 2e-2),  # g rounded to bf16; bf16 output rounding
])
def test_glu_kernel_gelu_at_musicgen_widths(cuda, M, dtype, tol):
    """The gelu GLU (musicgen-large: K = N = 2048, F = 8192) with zero
    rows and zero gate stripes: bits exact, y close, the dead stripes'
    w_in / w_out NaN-poisoned never read."""
    rng = np.random.default_rng(11)
    K, F, N, bm, bf = 2048, 8192, 2048, 64, 128
    x = rng.standard_normal((M, K)).astype(np.float32)
    x[M // 2:] = 0.0
    wg = (rng.standard_normal((K, F)) / np.sqrt(K)).astype(np.float32)
    wg[:, 3 * bf:5 * bf] = 0.0
    wi = (rng.standard_normal((K, F)) / np.sqrt(K)).astype(np.float32)
    wo = (rng.standard_normal((F, N)) / np.sqrt(F)).astype(np.float32)
    x, wg, wi, wo = (torch.from_numpy(a).to(cuda, dtype)
                     for a in (x, wg, wi, wo))
    kw = dict(block_m=bm, block_f=bf, act="gelu")
    y, bits = sgm.sparce_glu_mlp_fused(x, wg, wi, wo, **kw)
    y0, bits0 = sgm.sparce_glu_mlp_fused_plain(x, wg, wi, wo, **kw)
    assert torch.equal(bits, bits0) and bool(bits[:, 3:5].all())
    torch.testing.assert_close(y.float(), y0.float(), rtol=tol, atol=tol)
    wi2, wo2 = wi.clone(), wo.clone()
    wi2[:, 3 * bf:5 * bf] = float("nan")
    wo2[3 * bf:5 * bf] = float("nan")
    y2, _ = sgm.sparce_glu_mlp_fused(x, wg, wi2, wo2, **kw)
    assert torch.equal(y2, y)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gated_gemm_at_training_shapes(cuda, dtype):
    """FP, BP and WG of the GLU's down-projection under mode="kernel",
    through ``ops.sparce_gemm`` on the transposed views the autograd
    rule passes, against the same calls on the CPU, within the chip
    script's share of the output's largest value (an absolute limit
    is loose on BP's small outputs and tight on WG's large ones)."""
    rel, _ = TRAIN_GEMM_REL[str(dtype)[6:]]
    a, w, g, _ = train_gemm_operands(torch, dtype, seed=3)
    abits = sprf.compute_bitmap(a, (64, 128)).bits
    gbits = sprf.compute_bitmap(g, (64, 128)).bits
    for x, rhs, bits, (bm, bk, bn) in (
            (a, w, abits, (64, 128, 128)), (g, w.T, gbits, (64, 128, 128)),
            (a.T, g, abits.T.contiguous(), (128, 64, 128))):
        plan = sasa.SkipPlan(gate="lhs", variant="gated", block_m=bm,
                             block_k=bk, block_n=bn)

        def run(dev):
            return kops.sparce_gemm(
                x.to(dev), rhs.to(dev), plan, lhs_bitmap=sprf.TileBitmap(
                    bits.to(dev), (bm, bk), tuple(x.shape)))
        before = sg.sparce_gemm_gated.launches
        got = run(cuda)
        assert sg.sparce_gemm_gated.launches == before + 1
        want = run("cpu").float()
        torch.testing.assert_close(got.cpu().float(), want, rtol=0.0,
                                   atol=rel * want.abs().max().item())


@pytest.mark.parametrize("act", ["relu", "relu2"])
def test_fused_mlp_kernel_at_training_rows(cuda, act):
    """The relu MLP's training forward: 8 x 512 rows, 64-row tiles."""
    rng = np.random.default_rng(4)
    M, K, F, N = 4096, 576, 1536, 576
    x = np.abs(rng.standard_normal((M, K))).astype(np.float32)
    x[1024:1088] = 0.0  # one dead row tile
    wi = (rng.standard_normal((K, F)) / np.sqrt(K)).astype(np.float32)
    wo = (rng.standard_normal((F, N)) / np.sqrt(F)).astype(np.float32)
    x, wi, wo = (torch.from_numpy(v).to(cuda, torch.bfloat16)
                 for v in (x, wi, wo))
    kw = dict(block_m=64, block_f=128, act=act)
    y, bits = sm.sparce_mlp_fused(x, wi, wo, **kw)
    y0, bits0 = sm.sparce_mlp_fused_plain(x, wi, wo, **kw)
    assert torch.equal(bits, bits0) and bool(bits[16].all())
    torch.testing.assert_close(y.float(), y0.float(), rtol=2e-2, atol=2e-2)


def _grads_on(dev, fn, *tensors):
    ts = [t.detach().to(dev).requires_grad_(t.is_floating_point())
          for t in tensors]
    y = fn(*ts)
    y = y[0] if isinstance(y, tuple) else y
    gy = torch.from_numpy(np.random.default_rng(7).standard_normal(
        tuple(y.shape)).astype(np.float32)).to(dev, y.dtype)
    gy[: gy.shape[0] // 2] = 0.0  # zero error rows: gated BP tiles
    y.backward(gy)
    return [y.detach().cpu()] + [t.grad.cpu() for t in ts
                                 if t.is_floating_point()]


def test_autograd_functions_on_gpu_match_cpu(cuda):
    """The three backward rules (the gated BP and WG GEMMs of
    ``sparce_matmul`` under mode="kernel", the relu MLP's and the GLU's
    dense recompute) on the card against the CPU, f32; the relu-bitmap
    kernel refuses a backward on the card too."""
    from repro_torch.core import sparse_ops
    rng = np.random.default_rng(8)
    M, K, F, N = 256, 576, 1536, 576
    t = lambda *s: torch.from_numpy(  # noqa: E731
        (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32))
    x, wg, wi, wo = t(M, K), t(K, F), t(K, F), t(F, N)
    a = torch.relu(t(M, F))
    a[:64, :128] = 0.0
    cfg = SparsityConfig(enabled=True, mode="kernel", block_m=64,
                         block_k=128, block_n=128)

    def matmul(a, w):
        bmp = sprf.compute_bitmap(a.detach(), (64, 128))
        return sparse_ops.sparce_matmul(a, w, cfg, lhs_bitmap=bmp)
    fused = SparsityConfig(enabled=True, mode="fused", block_m=64,
                           block_k=128, block_n=128)
    cases = [
        (matmul, (a, wo)),
        (lambda x, wi, wo: sparse_ops.sparce_mlp(x, wi, wo, "relu", fused),
         (x, wi, wo)),
        (lambda x, wi, wo: sparse_ops.sparce_mlp(x, wi, wo, "relu2", fused),
         (x, wi, wo)),
        (lambda x, wg, wi, wo: sparse_ops.sparce_glu_mlp(
            x, wg, wi, wo, "gelu", fused), (x, wg, wi, wo)),
    ]
    for fn, args in cases:
        for got, want in zip(_grads_on(cuda, fn, *args),
                             _grads_on("cpu", fn, *args)):
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    h = t(8, F).to(cuda).requires_grad_()
    y, _ = sparse_ops.relu_with_bitmap(h, cfg)
    with pytest.raises(ValueError, match="not differentiable"):
        y.sum().backward()


@pytest.mark.parametrize("arch", ["pixtral-12b", "musicgen-large"])
def test_reduced_frontend_engine_on_gpu_matches_cpu(cuda, arch):
    """The vlm (patch rows in every slot) and audio (codebook streams)
    engines, reduced, f32, paged, the GLU fused: the card's tokens and
    counters equal the CPU's."""
    cfg = get_config(arch).reduced()
    rng = np.random.default_rng(3)
    lead = (cfg.num_codebooks,) if cfg.frontend == "codes" else ()
    reqs = [(i, rng.integers(0, cfg.vocab_size,
                             lead + (int(rng.integers(3, 14)),)),
             int(rng.integers(2, 9))) for i in range(5)]
    outs, metrics = {}, {}
    for dev in ("cpu", cuda):
        params = model_lib.init_params(cfg, seed=0, device=dev)
        srv = Server(cfg, params, ServeConfig(
            batch_slots=3, max_len=32, attn_kernel="paged",
            sparsity=SparsityConfig(enabled=True, mode="fused")), device=dev)
        done = srv.generate([Request(uid=u, prompt=p, max_new=n)
                             for u, p, n in reqs])
        key = torch.device(dev).type
        outs[key] = {r.uid: np.asarray(r.out).tolist() for r in done}
        metrics[key] = srv.metrics
    assert outs["cuda"] == outs["cpu"]
    for name in ("decode_tokens", "ticks", "attn_blocks_fetched",
                 "kv_blocks_peak_in_use", "total_tile_dots"):
        assert getattr(metrics["cuda"], name) == getattr(metrics["cpu"], name)


def test_reduced_training_on_gpu_matches_cpu(cuda):
    """Five Trainer steps of the reduced smollm (f32, the GLU's gated
    GEMM in FP, BP and WG) on the card and on the CPU: the same losses
    within f32 tolerance, 3 gated launches a layer a step on the card."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, make_batch_iterator
    from repro_torch.optim.adamw import AdamW
    from repro_torch.runtime.trainer import TrainConfig, Trainer
    import dataclasses
    cfg = dataclasses.replace(get_config("smollm-135m").reduced(),
                              sparsity=SparsityConfig(
                                  enabled=True, mode="kernel", block_m=8,
                                  block_k=32, block_n=32))
    shape = ShapeConfig("t", 32, 4, "train")
    losses = {}
    for dev in ("cpu", cuda):
        before = sg.sparce_gemm_gated.launches
        out = Trainer(cfg, shape, AdamW(lr=3e-3), TrainConfig(
            steps=5, log_every=1), device=dev).run(
                make_batch_iterator(cfg, shape, DataConfig()))
        losses[torch.device(dev).type] = [h["loss"] for h in out["history"]]
        if torch.device(dev).type == "cuda":
            assert sg.sparce_gemm_gated.launches - before == \
                3 * cfg.num_layers * 5
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)


@pytest.mark.parametrize("mesh", [(2, 1), (1, 2)])
def test_reduced_mesh_engine_on_gpu_matches_single_rank(cuda, mesh):
    """The reduced relu engine (the kernels' path: relu bitmap and gated
    GEMM, paged GQA) served on a gloo mesh with every rank on card 0:
    tokens and every exact-parity counter equal the single-rank engine's
    on the card (f32), and every rank launched the path's kernels."""
    from repro_torch.launch import mesh as mesh_lib
    import torch_mesh_scenarios as scen
    rng = np.random.default_rng(3)
    reqs = [Request(uid=i, prompt=rng.integers(0, 256, int(n)), max_new=6)
            for i, n in enumerate(rng.integers(2, 12, 6))]
    spec = dict(name="relu", act="relu", device="cuda:0", requests=reqs,
                sc=dict(batch_slots=4, max_len=64, kv_block_size=8,
                        attn_kernel="paged",
                        sparsity=dict(enabled=True, mode="kernel",
                                      block_m=1, block_k=32)))
    want = scen.run_scenario(spec)
    outs = mesh_lib.spawn_mesh(scen.rank_main, mesh, ([spec],),
                               device="cuda:0", backend="gloo",
                               timeout_s=30.0, deadline_s=240.0)
    (got,) = outs[0]["out"]
    assert got["tokens"] == want["tokens"]
    for k in ("prefill_tokens", "decode_tokens", "ticks", "admitted",
              "skipped_tile_dots", "total_tile_dots", "attn_blocks_fetched",
              "attn_blocks_total", "kv_blocks_peak_in_use"):
        assert got["metrics"][k] == want["metrics"][k], k
    for o in outs[1:]:
        (served,) = o["out"]
        for name in ("paged_gqa_decode_attn", "relu_bitmap",
                     "sparce_gemm_gated"):
            assert served["launches"][name] > 0, name


# ------------------------------------------------ training on a mesh
@pytest.mark.parametrize("rows", [4096, 4608])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gated_gemm_at_a_tp3_training_shard(cuda, dtype, rows):
    """The gated GEMM at the tp-3 shard's FP, BP and WG of smollm-135m's
    down-projection (F 1536 / 3 = 512), over 8 x 512 rows and over a
    sequence-parallel step's gathered 8 x 576 (576 divides over 3
    ranks, 512 does not), WG reducing over them: against the CPU within
    the chip script's share of the output's largest value, and gated
    tiles NaN-poisoned on the card never read."""
    from chip_smoke import TP3_F
    rel, _ = TRAIN_GEMM_REL[str(dtype)[6:]]
    a, w, g, _ = train_gemm_operands(torch, dtype, seed=5, F_=TP3_F,
                                     M=rows)
    abits = sprf.compute_bitmap(a, (64, 128)).bits
    gbits = sprf.compute_bitmap(g, (64, 128)).bits
    for x, rhs, bits, (bm, bk, bn) in (
            (a, w, abits, (64, 128, 128)), (g, w.T, gbits, (64, 128, 128)),
            (a.T, g, abits.T.contiguous(), (128, 64, 128))):
        plan = sasa.SkipPlan(gate="lhs", variant="gated", block_m=bm,
                             block_k=bk, block_n=bn)

        def run(lhs, dev):
            return kops.sparce_gemm(
                lhs.to(dev), rhs.to(dev), plan, lhs_bitmap=sprf.TileBitmap(
                    bits.to(dev), (bm, bk), tuple(lhs.shape)))
        got = run(x, cuda)
        want = run(x, "cpu").float()
        torch.testing.assert_close(got.cpu().float(), want, rtol=0.0,
                                   atol=rel * want.abs().max().item())
        x2 = x.to(cuda).contiguous().clone()
        for i, j in zip(*np.nonzero(bits.numpy())):
            x2[i * bm:(i + 1) * bm, j * bk:(j + 1) * bk] = float("nan")
        assert torch.equal(run(x2, cuda), got)


@pytest.mark.parametrize("M,F", [(2048, 1536), (4608, 512)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_mlp_kernel_at_a_dp2_training_shard(cuda, dtype, M, F):
    """The fused relu MLP at a dp-2 shard's 2048 rows (8 x 512 tokens
    over 2 data ranks) and at a sequence-parallel step's tp-3 shard (8 x
    576 gathered rows, F 512), 64-row tiles: bits equal the plain
    version's, y within tolerance, NaN in the dead stripes' w_out rows
    never read."""
    rng = np.random.default_rng(6)
    K, N = 576, 576
    x = np.abs(rng.standard_normal((M, K))).astype(np.float32)
    x[512:576] = 0.0  # one dead row tile
    wi = (rng.standard_normal((K, F)) / np.sqrt(K)).astype(np.float32)
    wi[:, 256:384] = -np.abs(wi[:, 256:384])  # a stripe dead in every tile
    wo = (rng.standard_normal((F, N)) / np.sqrt(F)).astype(np.float32)
    x, wi, wo = (torch.from_numpy(v).to(cuda, dtype) for v in (x, wi, wo))
    kw = dict(block_m=64, block_f=128, act="relu")
    y, bits = sm.sparce_mlp_fused(x, wi, wo, **kw)
    y0, bits0 = sm.sparce_mlp_fused_plain(x, wi, wo, **kw)
    assert torch.equal(bits, bits0) and bool(bits[8].all())
    assert bool(bits[:, 2].all())
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(y.float(), y0.float(), rtol=tol, atol=tol)
    wo2 = wo.clone()
    wo2[256:384] = float("nan")
    y2, _ = sm.sparce_mlp_fused(x, wi, wo2, **kw)
    assert torch.equal(y2, y)


@pytest.mark.parametrize("mesh", [(2, 1), (1, 2)])
def test_sharded_train_step_on_gpu_matches_single_rank(cuda, mesh):
    """The reduced smollm's f32 training step (the GLU's gated GEMM in
    FP, BP and WG) on a gloo mesh with every rank on card 0 against one
    rank on the card: the loss, the grad norm and every gathered
    gradient; each rank launched the gated GEMM 3 times a layer."""
    from repro_torch.launch import mesh as mesh_lib
    import torch_train_scenarios as ts
    spec = dict(name="glu", arch="smollm-135m", device="cuda:0", mask_tail=8,
                fields=dict(sparsity=dict(enabled=True, mode="kernel",
                                          block_m=8, block_k=32,
                                          block_n=32)))
    want = ts.run_single(spec)
    outs = mesh_lib.spawn_mesh(ts.train_rank, mesh, ([spec],),
                               device="cuda:0", backend="gloo",
                               timeout_s=30.0, deadline_s=240.0)
    got = outs[0][0]
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
    assert got["grad_norm"] == pytest.approx(want["grad_norm"], rel=1e-5)
    for a, b in zip(got["grads"], want["grads"]):
        np.testing.assert_allclose(a, b, rtol=1e-3,
                                   atol=1e-5 * float(np.abs(b).max()))
    layers = get_config("smollm-135m").reduced().num_layers
    for rank in outs:
        assert rank[0]["gated_launches"] == 3 * layers


def test_checkpoint_gather_to_root_of_cuda_slices(cuda):
    """``gather_to_root`` of CUDA slices on (2, 1, 2) gloo ranks on card
    0 (sends and receives staged through the host): rank 0 holds every
    leaf whole, bit for bit."""
    from repro_torch.launch import mesh as mesh_lib
    import torch_train_scenarios as ts
    outs = mesh_lib.spawn_mesh(ts.gather_rank, (2, 1, 2),
                               ([dict(device="cuda:0")],),
                               axes=("pod", "data", "model"),
                               device="cuda:0", backend="gloo",
                               timeout_s=30.0, deadline_s=120.0)
    whole = ts.gather_leaves(None)
    for a, b in zip(outs[0][0]["leaves"], ts._np(whole)):
        np.testing.assert_array_equal(a, b)
    assert all(o[0]["leaves"] is None for o in outs[1:])


def test_compressed_psum_on_cuda_tensors(cuda):
    """compressed_psum of CUDA tensors on 2 gloo ranks on card 0 equals
    the same call on CPU tensors (int8 and 1-bit, two rounds)."""
    from repro_torch.launch import mesh as mesh_lib
    import torch_train_scenarios as ts
    rng = np.random.default_rng(7)
    grads = [rng.standard_normal((2, 40, 24)).astype(np.float32)
             for _ in range(2)]
    for method in ("int8", "1bit"):
        res = {}
        for dev in ("cpu", "cuda:0"):
            outs = mesh_lib.spawn_mesh(
                ts.compress_rank, (2,), ([dict(shape=(40, 24), grads=grads,
                                               method=method, device=dev)],),
                axes=("data",), device=dev, backend="gloo",
                timeout_s=30.0, deadline_s=120.0)
            res[dev] = outs
        for a, b in zip(res["cuda:0"], res["cpu"]):
            for (x, r), (y, q) in zip(a[0]["rounds"], b[0]["rounds"]):
                # The card sums the n dequantized parts in another order.
                np.testing.assert_allclose(x, y, rtol=1e-6, atol=1e-6)
                np.testing.assert_allclose(r, q, rtol=1e-6, atol=1e-6)
            assert a[0]["stats"]["all-gather"] == 2 * (40 * 24 + 4)


def test_sequence_parallel_primitives_of_cuda_tensors_under_gloo(cuda):
    """seq_split, seq_gather, sp_open and sp_close over 'model' on (1, 2)
    gloo ranks on card 0 (the all-gathers and reduce-scatters staged
    through the host): each output and the gradient of sum(out * cot)
    equal the same calls on CPU tensors, and count the same
    collectives."""
    from repro_torch.launch import mesh as mesh_lib
    import torch_sp_scenarios as sps
    res = {}
    for dev in ("cpu", "cuda:0"):
        res[dev] = mesh_lib.spawn_mesh(
            sps.prims_rank, (1, 2), ([dict(device=dev)],),
            axes=("data", "model"), device=dev, backend="gloo",
            timeout_s=30.0, deadline_s=120.0)
    for a, b in zip(res["cuda:0"], res["cpu"]):
        for name in ("seq_split", "seq_gather", "sp_open", "sp_close"):
            (y, g, where), (y0, g0, _) = a[0][name], b[0][name]
            assert where == "cuda", name
            np.testing.assert_allclose(y, y0, rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(g, g0, rtol=1e-6, atol=1e-6)
        assert a[0]["stats"]["counts"] == b[0]["stats"]["counts"]
        assert a[0]["stats"]["counts"]["reduce-scatter"] == 2


@pytest.mark.parametrize("mesh", [(2, 2), (1, 4)])
def test_sharded_train_step_over_nccl_matches_single_rank(cuda, mesh):
    """The same step over NCCL with one card per rank (a machine with at
    least 4 cards): the loss, the grad norm and every gathered gradient
    equal one rank's on card 0; each rank launched the gated GEMM 3
    times a layer."""
    from repro_torch.launch import mesh as mesh_lib
    import torch_train_scenarios as ts
    n = mesh[0] * mesh[1]
    if torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} cards (NCCL, one rank a card)")
    spec = dict(name="glu", arch="smollm-135m", device="cuda", mask_tail=8,
                zero1=True, steps=2,
                fields=dict(sparsity=dict(enabled=True, mode="kernel",
                                          block_m=8, block_k=32,
                                          block_n=32)))
    want = ts.run_single(dict(spec, device="cuda:0"))
    outs = mesh_lib.spawn_mesh(ts.train_rank, mesh, ([spec],),
                               device=[f"cuda:{r}" for r in range(n)],
                               backend="nccl", timeout_s=60.0,
                               deadline_s=300.0)
    got = outs[0][0]
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
    assert got["grad_norm"] == pytest.approx(want["grad_norm"], rel=1e-5)
    for a, b in zip(got["grads"], want["grads"]):
        np.testing.assert_allclose(a, b, rtol=1e-3,
                                   atol=1e-5 * float(np.abs(b).max()))
    layers = get_config("smollm-135m").reduced().num_layers
    for r, rank in enumerate(outs):
        assert rank[0]["gated_launches"] == 3 * layers * 2, r
        assert rank[0]["digest"] == outs[r % mesh[1]][0]["digest"], r


@pytest.mark.parametrize("n_micro", [2, 4])
def test_pipeline_forward_of_cuda_tensors_under_gloo(cuda, n_micro):
    """``pipeline_forward`` on a ("pod",) gloo mesh of 2 ranks on card 0
    (each hand-off staged through the host): y and the gradients of
    sum(y * cot) with respect to x (stage 0) and each stage's weights
    against the sequential composition on the card (f32, rtol 1e-5,
    atol 1e-6)."""
    from repro_torch.launch import mesh as mesh_lib
    import torch_pipeline_scenarios as ps
    W, x, cot = ps.numpy_case(2)
    spec = dict(W=W, x=x, cot=cot, n_micro=n_micro, device="cuda:0")
    outs = mesh_lib.spawn_mesh(ps.pipeline_rank, (2,), ([spec],),
                               axes=("pod",), device="cuda:0",
                               backend="gloo", timeout_s=30.0,
                               deadline_s=120.0)
    Wg = torch.from_numpy(W).to(cuda).requires_grad_(True)
    xg = torch.from_numpy(x).to(cuda).requires_grad_(True)
    h = xg
    for s in range(2):
        h = torch.tanh(h @ Wg[s])
    torch.sum(h * torch.from_numpy(cot).to(cuda)).backward()
    for rank in outs:
        got = rank[0]
        assert got["device"].startswith("cuda")
        np.testing.assert_allclose(got["y"], h.detach().cpu().numpy(),
                                   rtol=1e-5, atol=1e-6)
        s = got["stage"]
        np.testing.assert_allclose(got["w_grad"], Wg.grad[s].cpu().numpy(),
                                   rtol=1e-5, atol=1e-6)
        if s == 0:
            np.testing.assert_allclose(got["x_grad"], xg.grad.cpu().numpy(),
                                       rtol=1e-5, atol=1e-6)
        assert got["stats"]["counts"]["collective-permute"] == n_micro + 1


# ------------------------------------------- the tall paths (training rows)
# (row, M, K, N, block_m, block_k): the gated GEMM at PERF.md's row 5b
# (BP), 5c (WG), the FP row beside them, and a ragged shape (M, K and N
# past whole tiles and stages).
TALL_GEMMS = [("5b", 4096, 576, 1536, 64, 128),
              ("5c", 1536, 4096, 576, 128, 64),
              ("FP", 4096, 1536, 576, 64, 128),
              ("ragged", 1100, 600, 1000, 64, 128)]


def _tall_gemm_case(dev, M, K, N, bm, bk, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32)
    bits = (rng.random((-(-M // bm), -(-K // bk))) < 0.3).astype(np.int32)
    bits[:, 1] = 1  # a k tile dead in every row tile: w never requested
    xt, wt = (torch.from_numpy(a).to(dev, torch.bfloat16) for a in (x, w))
    return xt, wt, bits, torch.from_numpy(bits).to(dev)


@pytest.mark.parametrize("row,M,K,N,bm,bk", TALL_GEMMS)
def test_tall_gemm_matches_plain_and_skips_what_the_bits_gate(
        cuda, row, M, K, N, bm, bk):
    """The tall path (bf16, lhs gate): within the training GEMMs' share
    of max|y| of the plain version; a second call equal bit for bit; NaN
    in every gated x tile and in w's rows of the k tile dead in every
    row tile never reaching y; one launch counted, on the tall path."""
    assert sg.tall_path(M, K, N, block_m=bm, block_k=bk,
                        dtype=torch.bfloat16)
    xt, wt, bits, bt = _tall_gemm_case(cuda, M, K, N, bm, bk, seed=M + N)
    kw = dict(block_m=bm, block_k=bk, block_n=128)
    before = (sg.sparce_gemm_gated.launches,
              sg.sparce_gemm_gated.tall_launches)
    y = sg.sparce_gemm_gated(xt, wt, bt, **kw)
    assert (sg.sparce_gemm_gated.launches,
            sg.sparce_gemm_gated.tall_launches) == (before[0] + 1,
                                                     before[1] + 1)
    y0 = sg.sparce_gemm_gated_plain(xt, wt, bt, **kw)
    rel, _ = TRAIN_GEMM_REL["bfloat16"]
    torch.testing.assert_close(y.float(), y0.float(), rtol=0.0,
                               atol=rel * y0.float().abs().max().item())
    assert torch.equal(_bits_view(sg.sparce_gemm_gated(xt, wt, bt, **kw)),
                       _bits_view(y))
    x2, w2 = xt.clone(), wt.clone()
    for i, j in zip(*np.nonzero(bits)):
        x2[i * bm:(i + 1) * bm, j * bk:(j + 1) * bk] = float("nan")
    w2[bk:2 * bk] = float("nan")
    y2 = sg.sparce_gemm_gated(x2, w2, bt, **kw)
    assert bool(torch.isfinite(y2).all()) and torch.equal(y2, y)


def test_tall_gemm_rows_do_not_depend_on_the_row_count(cuda):
    """A pipeline micro-batch's 1024 rows of the FP and the BP equal the
    same rows of the whole 4096-row call bit for bit (the plan reads no
    M), as the pipeline's check against one rank relies on."""
    for M, K, N, bm, bk in ((4096, 1536, 576, 64, 128),
                            (4096, 576, 1536, 64, 128)):
        xt, wt, _, bt = _tall_gemm_case(cuda, M, K, N, bm, bk, seed=K)
        kw = dict(block_m=bm, block_k=bk, block_n=128)
        whole = sg.sparce_gemm_gated(xt, wt, bt, **kw)
        part = sg.sparce_gemm_gated(xt[1024:2048].contiguous(), wt,
                                    bt[16:32].contiguous(), **kw)
        assert torch.equal(_bits_view(part), _bits_view(whole[1024:2048]))


# (row, M, K, F, N): the fused relu MLP at row 3b (a training step's
# forward) and at a ragged shape, (64, 128) tiles.
TALL_MLPS = [("3b", 4096, 576, 1536, 576), ("ragged", 1100, 568, 1000, 600)]


@pytest.mark.parametrize("row,M,K,F,N", TALL_MLPS)
@pytest.mark.parametrize("act", ["relu", "relu2"])
def test_tall_mlp_matches_plain_and_never_reads_a_dead_stripe(
        cuda, row, M, K, F, N, act):
    """The tall path: bits equal the plain version's, y within bf16
    rounding, a second call equal bit for bit; NaN in the w_out rows of
    the stripe dead in every row tile never reaches y, and NaN in a
    stripe live in one row tile and dead in another never reaches the
    dead tile's rows."""
    assert sm.tall_path(M, K, F, N, block_m=64, block_f=128,
                        dtype=torch.bfloat16)
    rng = np.random.default_rng(M + F)
    x = np.abs(rng.standard_normal((M, K))).astype(np.float32)
    x[512:576] = 0.0  # row tile 8 dead
    wi = (rng.standard_normal((K, F)) / np.sqrt(K)).astype(np.float32)
    wi[:, 256:384] = -np.abs(wi[:, 256:384])  # stripe 2 dead everywhere
    wo = (rng.standard_normal((F, N)) / np.sqrt(F)).astype(np.float32)
    x, wi, wo = (torch.from_numpy(v).to(cuda, torch.bfloat16)
                 for v in (x, wi, wo))
    kw = dict(block_m=64, block_f=128, act=act)
    before = sm.sparce_mlp_fused.tall_launches
    y, bits = sm.sparce_mlp_fused(x, wi, wo, **kw)
    assert sm.sparce_mlp_fused.tall_launches == before + 1
    y0, bits0 = sm.sparce_mlp_fused_plain(x, wi, wo, **kw)
    assert torch.equal(bits, bits0)
    assert bool(bits[:, 2].all()) and bool(bits[8].all())
    torch.testing.assert_close(y.float(), y0.float(), rtol=2e-2, atol=2e-2)
    y1, bits1 = sm.sparce_mlp_fused(x, wi, wo, **kw)
    assert torch.equal(_bits_view(y1), _bits_view(y))
    assert torch.equal(bits1, bits)
    wo2 = wo.clone()
    wo2[256:384] = float("nan")
    y2, bits2 = sm.sparce_mlp_fused(x, wi, wo2, **kw)
    assert bool(torch.isfinite(y2).all()) and torch.equal(y2, y)
    # A stripe live in some row tiles: row tile 8 is dead in all.
    f = next(f for f in range(bits.shape[1])
             if not bool(bits[:, f].all()))
    wo3 = wo.clone()
    wo3[f * 128:(f + 1) * 128] = float("nan")
    y3, _ = sm.sparce_mlp_fused(x, wi, wo3, **kw)
    dead = bits[torch.arange(M, device=cuda) // 64, f].bool()
    assert torch.equal(y3[dead], y[dead])
    assert bool(torch.isnan(y3[~dead]).any())


def _kernel_names(run):
    from torch.profiler import ProfilerActivity, profile
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return {e.key for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


def test_decode_shapes_launch_the_old_kernels_and_training_the_tall(cuda):
    """By kernel name on the card: the decode tick (8 rows) and the
    256-row prefill launch the core and cluster kernels, never a tall
    one; a training step's 4096 rows launch the tall kernels and not the
    core or the cluster kernel."""
    def names(M, bm):
        rng = np.random.default_rng(M)
        K, F, N = 576, 1536, 576
        t = lambda *s: torch.from_numpy(  # noqa: E731
            rng.standard_normal(s).astype(np.float32)).to(
                cuda, torch.bfloat16)
        x, wi, wo, a = t(M, K), t(K, F), t(F, N), t(M, F)
        bits = torch.zeros((-(-M // bm), F // 128), dtype=torch.int32,
                           device=cuda)
        gemm = _kernel_names(lambda: sg.sparce_gemm_gated(
            a, wo, bits, block_m=bm, block_k=128, block_n=128))
        mlp = _kernel_names(lambda: sm.sparce_mlp_fused(
            x, wi, wo, block_m=bm, block_f=128))
        return " ".join(gemm), " ".join(mlp)
    for M, bm in ((8, 1), (256, 1), (256, 64)):
        gemm, mlp = names(M, bm)
        assert "gated_gemm_kernel" in gemm and "tall_gemm_kernel" not in gemm
        assert "mlp_cluster_kernel" in mlp and "mlp_tall_kernel" not in mlp
    gemm, mlp = names(4096, 64)
    assert "tall_gemm_kernel" in gemm and "gated_gemm_kernel" not in gemm
    assert "mlp_tall_kernel" in mlp and "mlp_cluster_kernel" not in mlp
    assert "stripe_reduce_kernel" not in mlp


@pytest.mark.parametrize("M", [8, 256, 511, 512, 1023, 1024, 4096])
@pytest.mark.parametrize("K,N,bm,bk", [(576, 1536, 64, 128),
                                       (4096, 576, 128, 64),
                                       (600, 1000, 64, 128),
                                       (570, 576, 64, 128),
                                       (576, 576, 1, 128),
                                       (576, 576, 64, 32)])
def test_tall_rules_in_c_equal_the_wrappers(cuda, M, K, N, bm, bk):
    """``csrc``'s mirrors of the path rules (tall::gemm_ok, tall_mlp::ok)
    say what the wrappers' ``tall_path`` say, bf16."""
    bf16 = torch.bfloat16
    assert sg.tall_ok_c(M, K, N, block_m=bm, block_k=bk) == sg.tall_path(
        M, K, N, block_m=bm, block_k=bk, dtype=bf16)
    assert sm.tall_ok_c(M, K, bk * 12, N, block_m=bm, block_f=bk) == \
        sm.tall_path(M, K, bk * 12, N, block_m=bm, block_f=bk, dtype=bf16)
