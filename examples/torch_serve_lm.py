"""Serving example on the PyTorch/CUDA port: mixed-length requests
through the continuous-batching prefill + decode engine, including the
SparCE-gated MLP path and the audio (musicgen codebook) path.

    PYTHONPATH=src python examples/torch_serve_lm.py [--device cpu]
"""
import argparse
import sys

from repro_torch.device import resolve_device
from repro_torch.launch import serve as serve_launch

SECTIONS = (
    ("== text LM serving (smollm-135m reduced, mixed lengths) ==", [
        "--arch", "smollm-135m", "--reduced",
        "--requests", "6", "--prompt-len", "8", "--max-new", "8",
        "--batch-slots", "4", "--mixed",
    ]),
    ("\n== SparCE-gated serving (skip metrics on) ==", [
        "--arch", "smollm-135m", "--reduced",
        "--requests", "6", "--prompt-len", "8", "--max-new", "8",
        "--batch-slots", "4", "--mixed", "--sparce",
    ]),
    ("\n== paged KV: oversubscribed block pool (shares device memory "
     "across slots) ==", [
        "--arch", "smollm-135m", "--reduced",
        "--requests", "6", "--prompt-len", "8", "--max-new", "8",
        "--batch-slots", "4", "--mixed", "--max-len", "64",
        "--kv-block-size", "8", "--kv-pool-blocks", "12",
    ]),
    # Every request carries the same 32-token system-prompt prefix: the
    # first admission prefills and registers it, the rest map the cached
    # blocks read-only and prefill only their divergent tail (watch the
    # "prefix cache" hit-rate and "prefix savings" lines).
    ("\n== prefix cache: shared-prefix requests reuse pool blocks ==", [
        "--arch", "smollm-135m", "--reduced",
        "--requests", "6", "--prompt-len", "8", "--max-new", "4",
        "--batch-slots", "4", "--mixed", "--max-len", "64",
        "--kv-block-size", "16", "--prefix-cache",
        "--shared-prefix-len", "32",
    ]),
    ("\n== open loop: live queue + SLO-aware prefill scheduling ==", [
        "--arch", "smollm-135m", "--reduced",
        "--requests", "8", "--prompt-len", "8", "--max-new", "8",
        "--batch-slots", "4", "--mixed", "--max-len", "64",
        "--open-loop", "--arrival-rate", "20",
        "--slo-ttft-ticks", "32", "--slo-itl-ticks", "4",
    ]),
    ("\n== audio (EnCodec codebooks, musicgen reduced) ==", [
        "--arch", "musicgen-large", "--reduced",
        "--requests", "2", "--prompt-len", "4", "--max-new", "4",
        "--batch-slots", "2", "--max-len", "64",
    ]),
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain "
                         "versions)")
    dev = str(resolve_device(ap.parse_args(argv).device))
    for title, flags in SECTIONS:
        print(title)
        serve_launch.main(flags + ["--device", dev])
    print("serve_lm OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
