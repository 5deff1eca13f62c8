"""SparCE kernel anatomy demo on the PyTorch/CUDA port: gated vs
compacted vs dense, with the skip accounting the paper reports
(instructions skipped -> tiles skipped; D-cache accesses -> tile
fetches).

Run: PYTHONPATH=src python examples/torch_sparse_gemm_demo.py \
         [sparsity] [--device cpu]

On a CUDA device both skipping kernels launch and their times are
printed beside ``x @ w``'s (CUDA events); on the CPU they run their
plain PyTorch versions.
"""
import argparse
import sys

import torch

from repro_torch.core import sprf
from repro_torch.device import resolve_device
from repro_torch.kernels import sparce_gemm as sgk


def cuda_ms(fn, iters: int = 50) -> float:
    """Mean ms per call from CUDA events around ``iters`` calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("sparsity", type=float, nargs="?", default=0.7)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain "
                         "versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    s = args.sparsity
    M, K, N = 256, 3456, 384  # paper Fig. 17 inner dims (padded M)
    bm, bk, bn = 8, 128, 128

    x = sprf.random_sparse(torch.Generator(device=dev).manual_seed(0),
                           (M, K), s, cluster=(bm, bk))
    # The kernels mask ragged edges, so w is not padded to the tile.
    w = torch.randn((K, N), generator=torch.Generator(
        device=dev).manual_seed(1), device=dev)
    bmp = sprf.compute_bitmap(x, (bm, bk))
    nm, nk = bmp.grid
    total_tiles = nm * nk
    skipped = int(bmp.num_skipped())

    print(f"word sparsity {s:.0%} -> {skipped}/{total_tiles} tiles "
          f"skippable ({skipped / total_tiles:.1%})")

    kw = dict(block_m=bm, block_k=bk, block_n=bn)
    y_g = sgk.sparce_gemm_gated(x, w, bmp.bits, **kw)
    y_c = sgk.sparce_gemm_compacted(x, w, bmp.bits, **kw)
    y_d = x @ w
    print(f"gated     max err vs dense: {float((y_g - y_d).abs().max()):.2e}")
    print(f"compacted max err vs dense: {float((y_c - y_d).abs().max()):.2e}")

    # Savings accounting (the paper's Fig. 16 metrics, in tiles and in
    # the modeled bytes of x, w and y once each).
    frac = skipped / total_tiles
    bytes_frac = K * N * frac / (M * K + K * N + M * N)
    print(f"tile products skipped: {frac:.1%}  (instructions, in paper "
          "terms)")
    print(f"modeled bytes skipped: {bytes_frac:.1%}  (D-cache, in paper "
          "terms)")
    if dev.type == "cuda":
        name = torch.cuda.get_device_name(dev)
        ms_g = cuda_ms(lambda: sgk.sparce_gemm_gated(x, w, bmp.bits, **kw))
        ms_c = cuda_ms(
            lambda: sgk.sparce_gemm_compacted(x, w, bmp.bits, **kw))
        ms_d = cuda_ms(lambda: x @ w)
        print(f"on {name}: gated {ms_g:.4f} ms, compacted {ms_c:.4f} ms, "
              f"x @ w {ms_d:.4f} ms (CUDA events)")
    print("sparse_gemm_demo OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
