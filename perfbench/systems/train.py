"""A trained model: the port's ``Trainer`` step with its AdamW.

Set-up builds one trainer with its weights (made on the card from the
seed) and optimizer state, and drives it through its first steps with
the window's own call and feed; that same state goes on into the
window. The check follows those first steps with the plain f32
reference on the same weights and rows: each step's loss, the norm of
the first gradient as the optimizer got it (from its first moment after
one step), and the norm of each weight's change after the first steps.
"""
from __future__ import annotations

import dataclasses
import gc
import statistics
import time
from typing import Any, Dict, List, Optional

import torch

from perfbench import harness, weights, work
from perfbench.reference import adamw as ref_adamw
from perfbench.reference import llama
from perfbench.systems import serve as serve_sys


@dataclasses.dataclass
class Train:
    cfg: Any
    model: Dict[str, Any]
    hp: Dict[str, float]
    trainer: Any
    corpus: Any
    batch: int
    seq: int
    params0: Dict[str, Any]  # the weights as made, kept for the check
    params: Any = None
    state: Any = None
    steps_done: int = 0
    losses: List[float] = dataclasses.field(default_factory=list)
    spans: Optional[harness.KernelSpans] = None

    def step(self) -> Dict[str, float]:
        """One step through the trainer's own call and feed."""
        t0 = time.perf_counter()
        rows = self.corpus.batch(self.steps_done, self.batch, self.seq)
        b = self.trainer.to_device({"tokens": rows})
        self.params, self.state, m = self.trainer.step_fn(
            self.params, self.state, b)
        loss = float(m["loss"])
        t1 = time.perf_counter()
        self.steps_done += 1
        self.losses.append(loss)
        return {"t0": t0, "t1": t1, "tokens": rows.size, "loss": loss}


def build(cell: harness.Cell, seed: int, device, trace: bool,
          traffic) -> tuple:
    """The trainer and its state, driven through ``first_steps`` steps.
    Returns (Train, program readings for the check)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.optim.adamw import AdamW
    from repro_torch.runtime.trainer import TrainConfig, Trainer
    config, p = cell.config, cell.workload["params"]
    cfg = serve_sys.arch_config(config)
    hp = config["optimizer"]
    opt = AdamW(lr=hp["lr"], b1=hp["b1"], b2=hp["b2"], eps=hp["eps"],
                weight_decay=hp["weight_decay"], clip_norm=hp["clip_norm"])
    shape = ShapeConfig("bench", p["seq"], p["batch"], "train")
    trainer = Trainer(cfg, shape, opt, TrainConfig(seed=int(seed)),
                      device=device)
    params0 = serve_sys.make_weights(config, seed, device)
    tr = Train(cfg, config["model"], hp, trainer,
               traffic.Corpus(config["model"]["vocab_size"], seed,
                              p["noise"]),
               p["batch"], p["seq"], params0)
    tr.params, tr.state = params0, opt.init(params0)
    if trace:
        tr.spans = instrument(tr)
    readings: Dict[str, Any] = {}
    for i in range(int(p["first_steps"])):
        tr.step()
        if i == 0:
            # Held on the host, so the window's peak is the program's.
            readings["grad1_vec"] = {
                k: (m.float() / (1 - hp["b1"])).cpu()
                for k, m in weights.iter_named(tr.state.mu)}
    n0 = dict(weights.iter_named(params0))
    readings["change"] = {
        k: float(torch.linalg.vector_norm(v.float() - n0[k].float()))
        for k, v in weights.iter_named(tr.params)}
    readings["losses"] = list(tr.losses)
    torch.cuda.synchronize()
    harness.log(f"first steps: losses {tr.losses}")
    return tr, readings


def instrument(tr: Train) -> harness.KernelSpans:
    """The traced run's spans: the gated GEMM's entry point with its
    work, and the step's phases for the idle breakdown."""
    from repro_torch.kernels import sparce_gemm as sg
    spans = harness.KernelSpans()

    def gemm(args, kwargs, out):
        x, w, bits = args[:3]
        m, k = x.shape
        n = w.shape[1]
        gate = kwargs.get("gate", "lhs")
        ey = torch.empty((), dtype=kwargs.get("out_dtype") or x.dtype
                         ).element_size()
        ex, ew = x.element_size(), w.element_size()
        bm, bk, bn = kwargs["block_m"], kwargs["block_k"], kwargs["block_n"]
        return lambda: work.gated_gemm(m, k, n, bm, bk, bn, gate,
                                       bits.cpu().numpy(), ex, ew, ey)

    spans.wrap(sg, "sparce_gemm_gated", "gated_gemm", gemm)
    spans.span(tr.trainer, "step_fn", "step")
    spans.span(tr.trainer, "to_device", "feed")
    spans.span(tr.corpus, "batch", "data")
    return spans


def stop(tr: Train) -> None:
    if tr.spans is not None:
        tr.spans.restore()
    tr.params = tr.state = tr.trainer = None
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


# ------------------------------------------------------------- the check
def reference_steps(params0, model: Dict[str, Any], hp: Dict[str, float],
                    batches: List[torch.Tensor], fp8: bool = False
                    ) -> Dict[str, Any]:
    """The plain f32 reference over ``batches`` from ``params0``: each
    step's loss, the first step's clipped gradient, and the change of
    every weight after the last step. One row at a time goes through a
    forward and its backward. ``fp8``: the control (see
    ``llama.loss_sum``)."""
    names = [k for k, _ in weights.iter_named(params0)]
    p = {k: v.detach().float().clone().requires_grad_(True)
         for k, v in weights.iter_named(params0)}
    tree = _tree_like(params0, p)
    opt = ref_adamw.AdamW([p[k] for k in names], hp)
    losses, grad1_vec = [], None
    with llama.no_tf32():
        for i, toks in enumerate(batches):
            positions = toks.shape[0] * (toks.shape[1] - 1)
            total = 0.0
            for row in toks:
                lo = llama.loss_sum(tree, model, row[None], fp8) / positions
                lo.backward()
                total += float(lo.detach())
            grads = [p[k].grad if p[k].grad is not None
                     else torch.zeros_like(p[k]) for k in names]
            clipped = opt.step(grads)
            for k in names:
                p[k].grad = None
            losses.append(total)
            if i == 0:
                grad1_vec = {k: g.detach().clone()
                             for k, g in zip(names, clipped)}
    n0 = dict(weights.iter_named(params0))
    change = {k: float(torch.linalg.vector_norm(p[k].detach()
                                                - n0[k].float()))
              for k in names}
    return {"losses": losses, "grad1_vec": grad1_vec, "change": change}


def _tree_like(tree, flat: Dict[str, torch.Tensor], prefix=""):
    if isinstance(tree, dict):
        return {k: _tree_like(v, flat, f"{prefix}{k}.")
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_like(v, flat, f"{prefix}{i}.")
                for i, v in enumerate(tree)]
    return flat[prefix[:-1]]


def compare(prog: Dict[str, Any], ref: Dict[str, Any],
            worst_leaf: Optional[Dict[str, str]] = None) -> Dict[str, float]:
    """The compared numbers, each by the worst leaf, against the larger
    of the reference's norm of that leaf and of the median leaf:
    ``grad1_norm_gap``, the gap between the two norms of the first
    clipped gradient; ``grad1_diff``, the norm of the two first
    gradients' difference (zero-mean rounding noise moves a norm only at
    second order, so only this one tells a lower precision's gradient
    from the program's); ``change_norm_gap``, the gap between the norms
    of each weight's change after the first steps, leaving out leaves
    whose reference gradient is under a thousandth of the median leaf's
    (they move by round-off alone). ``loss_rel_gap``, the largest
    relative gap of the steps' losses, is read for the log. With
    ``worst_leaf`` each number's worst leaf is put there by name."""
    def norms(vec):
        return {k: float(torch.linalg.vector_norm(v)) for k, v in vec.items()}

    def worst(gap: Dict[str, float], base: Dict[str, float], keep) -> tuple:
        med = statistics.median(base[k] for k in keep)
        return max((gap[k] / max(base[k], med, 1e-30), k) for k in keep)

    pg, rg = norms(prog["grad1_vec"]), norms(ref["grad1_vec"])
    every = list(rg)
    gmed = statistics.median(rg.values())
    moved = [k for k in every if rg[k] >= 1e-3 * gmed]
    diff = {k: float(torch.linalg.vector_norm(
        prog["grad1_vec"][k].to(v.device) - v))
        for k, v in ref["grad1_vec"].items()}
    out = {
        "grad1_norm_gap": worst({k: abs(pg[k] - rg[k]) for k in every},
                                rg, every),
        "grad1_diff": worst(diff, rg, every),
        "change_norm_gap": worst(
            {k: abs(prog["change"][k] - ref["change"][k]) for k in moved},
            ref["change"], moved)}
    if worst_leaf is not None:
        worst_leaf.update({n: v[1] for n, v in out.items()})
    got = {n: v[0] for n, v in out.items()}
    got["loss_rel_gap"] = max(abs(a - b) / abs(b) for a, b in
                              zip(prog["losses"], ref["losses"]))
    return got


def check(tr: Train, readings: Dict[str, Any], config: Dict[str, Any],
          device) -> Dict[str, Dict[str, float]]:
    lim = config["limits"]
    batches = [torch.as_tensor(tr.corpus.batch(i, tr.batch, tr.seq),
                               device=device)
               for i in range(len(readings["losses"]))]
    ref = reference_steps(tr.params0, tr.model, tr.hp, batches)
    leaves: Dict[str, str] = {}
    got = compare(readings, ref, leaves)
    harness.log(f"worst leaves: {leaves}; loss_rel_gap (not compared) "
                f"{got['loss_rel_gap']!r}")
    return {k: {"value": v, "limit": float(lim[k])} for k, v in got.items()
            if k in lim}


def run_cell(cell: harness.Cell, seed: int, seconds: float, trace: bool,
             device, traffic, t_start: float) -> Dict[str, Any]:
    tr, readings = build(cell, seed, device, trace, traffic)
    out = traffic.run(tr, cell, seed, seconds, trace, harness)
    setup_s = out["t_open"] - t_start
    harness.log("window steps (s): " + " ".join(
        f"{s['t1'] - s['t0']:.3f}" for s in out["steps"]))
    spans = tr.spans
    stop(tr)
    peak = max(out["peak_setup_bytes"], out["peak_window_bytes"])
    ctx: Dict[str, Any] = dict(out, setup_s=setup_s, model=tr.model,
                               config=cell.config,
                               workload_params=cell.workload["params"],
                               spans=spans,
                               memory_peak_bytes=peak,
                               attempted=len(out["steps"]), failed=0)
    if trace:
        ctx["trace"] = harness.read_trace(ctx.pop("profiled"))
    t0 = time.perf_counter()
    ctx["checks"] = check(tr, readings, cell.config, device)
    harness.log(f"reference: {time.perf_counter() - t0:.1f} s")
    return ctx
