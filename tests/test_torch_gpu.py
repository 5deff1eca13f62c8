"""The port's CUDA kernels on a GPU: each kernel against its plain
version on the card, the skip contracts (NaN-poisoned dead blocks and
stripes), the launch counters, and the reduced engine on the GPU against
the same engine on the CPU.

Every test here needs a CUDA device and carries the ``gpu`` marker; on
a host without one they skip. This file imports torch and the port
only, so it runs where the reference's framework is not installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.paper_alexnet import (
    ALEXNET_GEMMS, BENCH_SPARSITY, DEEPCOMP_WEIGHT_SPARSITY,
)
from repro_torch.core import sasa, sprf
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
             (300, 192, 320, 96, 256, 128), (130, 64, 256, 48, 128, 64)]


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
@pytest.mark.parametrize("M,bm", [(8, 1), (256, 1), (128, 64), (256, 64)])
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
@pytest.mark.parametrize("M,bm", [(8, 1), (256, 1), (128, 64)])
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
             (37, 576, 1000, 576, 1, 128), (37, 576, 1000, 576, 64, 128),
             (100, 200, 1000, 70, 64, 128), (300, 192, 320, 96, 256, 128)]


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


def test_relu_bwd_with_bitmap_pads_on_gpu(cuda):
    """Ragged rows and columns through ops: padding tiles get bit 1;
    equal to the CPU plain version."""
    rng = np.random.default_rng(23)
    x = rng.standard_normal((10, 300)).astype(np.float32)
    g = rng.standard_normal((10, 300)).astype(np.float32)
    x[8:] = -1.0
    xt, gt = torch.from_numpy(x), torch.from_numpy(g)
    gx, bmp = kops.relu_bwd_with_bitmap(xt.to(cuda), gt.to(cuda), (8, 128))
    gx0, bmp0 = kops.relu_bwd_with_bitmap(xt, gt, (8, 128))
    assert tuple(gx.shape) == (10, 300)
    assert torch.equal(gx.cpu(), gx0) and torch.equal(bmp.bits.cpu(),
                                                      bmp0.bits)
    assert bool(bmp.bits[1].all()) and bmp.bits.shape == (2, 3)


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
