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
from repro_torch.kernels import paged_decode_attn as pda
from repro_torch.kernels import sparce_glu_mlp as sgm
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
