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
from repro_torch.core.sparse_ops import SparsityConfig
from repro_torch.kernels import ops as kops
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


@pytest.mark.parametrize("gate", ["lhs", "rhs"])
@pytest.mark.parametrize("M,bm", [(8, 1), (256, 1), (128, 64)])
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
