#!/usr/bin/env python3
"""Why the relu MLP's tensor-parallel training step sits further from one
rank's than the GLU's: ``chip_smoke.py`` phase 16 (b)'s step on gloo CPU
ranks, in f32 and in f64.

    python3 tools/relu_tp_witness.py [--mesh 1,3] [--runs NAME ...]

Each run is smollm-135m at full width cut to ``SP_F32_LAYERS`` layers,
8 x 576 tokens of phase 12's first batch, one step on the mesh with
``seq_shard`` ("sp") and without ("tp"), each against one rank's step on
the whole model (``chip_smoke.sp_step_f32``). Runs:

    relu-fused-f32   the relu MLP under ``mode="fused"`` (its plain
                     version on the CPU), f32: the errors, where each
                     layer's relu mask differs from one rank's (count,
                     and the largest |h| there over the layer's largest
                     |h|), and the errors against one rank's step whose
                     backward takes the mesh run's masks
    relu-dense-f32   the relu MLP with sparsity off (autograd's relu)
    relu-dense-f64   the same in f64, where the shards' sums and one
                     rank's round 2^29 times finer
    glu-kernel-f32   the silu GLU under ``mode="kernel"``

One JSON line per run. CPU only; every rank one thread, so a run takes
a minute or two.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

RUNS = {
    "relu-fused-f32": ("relu fused", "float32"),
    "relu-dense-f32": ("relu dense", "float32"),
    "relu-dense-f64": ("relu dense", "float64"),
    "glu-kernel-f32": ("glu kernel", "float32"),
}
RELU_DENSE = ("relu dense", "relu", dict(enabled=False), None, 0)


def witness_rank(mesh, names):
    import torch
    import chip_smoke as cs
    from repro_torch.models import modules
    # The port's configs name bf16 and f32 only; the f64 witness runs
    # the same code on f64 tensors.
    modules.DTYPES.setdefault("float64", torch.float64)
    out = []
    for name in names:
        label, dtype = RUNS[name]
        run = RELU_DENSE if label == "relu dense" else None
        r = cs.sp_step_f32(torch, torch.device("cpu"), mesh, label,
                           dtype=dtype, run=run)
        out.append(dict(r, run=name))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="1,3")
    ap.add_argument("--runs", nargs="+", default=list(RUNS),
                    choices=list(RUNS))
    args = ap.parse_args(argv)
    from repro_torch.launch.mesh import spawn_mesh
    shape = tuple(int(s) for s in args.mesh.split(","))
    outs = spawn_mesh(witness_rank, shape, (args.runs,),
                      axes=("data", "model"), timeout_s=600.0)
    for r in outs[0]:
        print(json.dumps({k: v for k, v in r.items()
                          if k not in ("expect", "kernel", "launches")}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
