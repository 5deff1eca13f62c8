#!/usr/bin/env python3
"""Where ``chip_smoke.py``'s time goes: seconds spent in its helpers.

    python3 tools/smoke_helper_times.py --phases 1,4,5,6

Runs ``chip_smoke.main`` with the given arguments, each helper named in
HELPERS wrapped to count its calls and their seconds (nested helpers
count in each), and times four windows of ``torch.profiler`` (host and
device activity, 50 small matmuls) before and after the run: entry,
the calls, exit and ``key_averages``. Prints the card's name and power
limit, then one ``helpers`` JSON line {name: [calls, seconds]}. Exits
with the script's code. Needs the card.
"""
from __future__ import annotations

import collections
import functools
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

HELPERS = ("full_width_params", "run_engine", "profile_engine",
           "check_decode_step", "log_device_times", "device_time_ms",
           "graph_time_ms", "cuda_time_ms", "time_attention", "time_glu",
           "time_mlp", "time_relu_bitmap", "time_gemm", "time_mla",
           "time_rows", "check_attention", "check_glu", "check_train_gemm",
           "check_mlp", "check_mla", "run_mesh_engines", "mesh_driver",
           "run_ssm_tp", "ssm_tp_train", "run_dryrun_cells")


def wrap(acc, name):
    fn = getattr(cs, name)

    @functools.wraps(fn)
    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            acc[name][0] += 1
            acc[name][1] += time.perf_counter() - t0

    setattr(cs, name, timed)  # chip_smoke calls its helpers by global name


def profiler_windows(tag):
    import torch
    from torch.profiler import ProfilerActivity, profile
    x = torch.randn(64, 64, device="cuda")
    for i in range(4):
        t0 = time.perf_counter()
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.__enter__()
        t1 = time.perf_counter()
        for _ in range(50):
            x @ x
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        prof.__exit__(None, None, None)
        t3 = time.perf_counter()
        prof.key_averages()
        t4 = time.perf_counter()
        print(f"profiler window {tag} {i}: enter {t1 - t0:.3f} s, calls "
              f"{t2 - t1:.3f} s, exit {t3 - t2:.3f} s, key_averages "
              f"{t4 - t3:.3f} s", flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("smoke_helper_times: no CUDA device", file=sys.stderr)
        return 1
    acc = collections.defaultdict(lambda: [0, 0.0])
    for name in HELPERS:
        wrap(acc, name)
    profiler_windows("before")
    rc = cs.main(sys.argv[1:])
    profiler_windows("after")
    print(cs.gpu_name_and_power())
    print("helpers " + json.dumps(
        {k: [n, round(s, 2)] for k, (n, s) in sorted(acc.items())}))
    return rc


if __name__ == "__main__":
    sys.exit(main())
