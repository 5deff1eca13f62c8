"""A cell run on the CPU at the port's ``reduced()`` sizes: the whole
path of a run (set-up, load generator, window, check, result line) with
the kernels' plain versions, the card's calls stubbed and no device
metric written. Used by the tests; not a measurement."""
from __future__ import annotations

import contextlib
import copy
import sys
import time
from pathlib import Path
from typing import Any, Dict, Optional

ROOT = Path(__file__).resolve().parents[2]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import torch  # noqa: E402

from perfbench import harness  # noqa: E402

# The port's reduced() sizes, as published keys.
REDUCED_MODEL = {"hidden_size": 64, "intermediate_size": 128,
                 "num_attention_heads": 4, "num_key_value_heads": 2,
                 "head_dim": 16, "num_hidden_layers": 2, "vocab_size": 256}
SMALL_TRAFFIC = {"clients": 8, "prompt_min": 8, "prompt_max": 40,
                 "new_min": 2, "new_max": 10, "block": 4, "fine": 4,
                 "warm_completions": 2, "slice_s": 0.5,
                 "batch": 2, "seq": 24, "first_steps": 3,
                 "rate": 10.0, "gap_block": 8, "lead_s": 0.3,
                 "tail_wait_s": 10.0}


def small_cell(name: str) -> harness.Cell:
    cell = harness.load_cell(name)
    cfg = copy.deepcopy(cell.config)
    cfg["model"].update(REDUCED_MODEL)
    cfg["dtype"] = "float32"
    if "engine" in cfg:
        cfg["engine"].update(batch_slots=4, max_len=64)
    wl = copy.deepcopy(cell.workload)
    wl["params"].update({k: v for k, v in SMALL_TRAFFIC.items()
                         if k in wl["params"]})
    return harness.Cell(cell.name, wl, cfg, cell.bench)


@contextlib.contextmanager
def no_card():
    """The CUDA calls the harness makes around a window, as no-ops."""
    saved = {}
    stubs = {"synchronize": lambda *a, **k: None,
             "reset_peak_memory_stats": lambda *a, **k: None,
             "max_memory_allocated": lambda *a, **k: 0,
             "empty_cache": lambda *a, **k: None,
             "get_device_name": lambda *a, **k: "cpu"}
    for k, v in stubs.items():
        saved[k] = getattr(torch.cuda, k)
        setattr(torch.cuda, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(torch.cuda, k, v)


def rehearse(name: str, seed: int = 1, seconds: float = 2.0,
             cell: Optional[harness.Cell] = None) -> Dict[str, Any]:
    """Run the cell small on the CPU; returns the result line's fields
    (metrics empty: nothing a CPU run measures is a device number) and
    the run's context."""
    from perfbench import run
    cell = cell or small_cell(name)
    args = run.parse(["--workload", name, "--seed", str(seed),
                      "--seconds", str(seconds), "--trace", "0"])
    with no_card():
        ctx, result = run.execute(args, torch.device("cpu"),
                                  time.perf_counter(), cell)
    result["metrics"] = {}
    result["device"] = {"platform": "cpu", "kind": "cpu", "count": 1,
                        "memory_peak_bytes": 0}
    return {"result": result, "ctx": ctx, "checks": ctx["checks"]}
