"""Vocab-parallel scenarios for the port's mesh tests, run on every rank
of a spawned (data, model) mesh.

Spawned ranks import this module by its name in a fresh interpreter, so
it imports neither jax nor the reference package. :func:`vocab_rank`
runs a list of scenarios, each a dict with ``kind``:

    train    ``torch_train_scenarios``' training scenario (its fields),
             optionally under one of :data:`MUTANTS`, or with
             ``gathered`` (the plan told the vocab does not divide, so
             the embedding and head are gathered whole as before they
             ran vocab-parallel)
    prefill  ``torch_ssm_tp_scenarios.run_cached``'s prefill
    decode   and its decode steps

Every scenario also returns ``vocab_gathers``: the shapes of the
all-gathers, made while a plan was ambient, whose operand was a stored
slice of ``embed``, ``head`` or ``heads`` (:class:`VocabGatherSpy`),
and ``vocab_cut``: whether the plan ran the vocab cut.
"""
from __future__ import annotations

import torch

from repro_torch.models import model as model_lib
from repro_torch.parallel import collectives
from repro_torch.parallel import sharding as shd
import torch_ssm_tp_scenarios as tps
import torch_train_scenarios as ts

VOCAB_LEAVES = ("embed", "head", "heads")


# ------------------------------------------------------------- mutants
def _rows_unsummed(x, sp, mesh):
    return x


def _sum_exp_local(lg, m, mesh):
    return torch.exp(lg - m[..., None]).sum(-1)


def _target_unsummed(lg, targets, lo, mesh):
    local = targets - lo
    mine = (local >= 0) & (local < lg.shape[-1])
    t = torch.gather(lg, -1, torch.where(mine, local, 0)[..., None])[..., 0]
    return torch.where(mine, t, t.new_zeros(()))


def _logits_open_without_bwd(logits):
    """``_logits`` with ``collectives.tp_open`` an identity while it
    runs."""
    def run(params, cfg, x, mesh=None):
        tp_open = collectives.tp_open
        collectives.tp_open = lambda x, axes, mesh=None: x
        try:
            return logits(params, cfg, x, mesh)
        finally:
            collectives.tp_open = tp_open
    return run


# name -> (attribute of models/model.py, replacement of its value): each
# breaks one rule of the vocab-parallel embedding, head or loss, and the
# sharded step must then fail the parity checks.
MUTANTS = {
    # The lookup's partial rows left unsummed over 'model'.
    "rows_unsummed": ("_close_rows", lambda _: _rows_unsummed),
    # The softmax's sum of exps over this rank's columns only.
    "sum_exp_local": ("_sum_exp", lambda _: _sum_exp_local),
    # The target's logit left on the rank that holds it, not summed.
    "target_unsummed": ("_target_logit", lambda _: _target_unsummed),
    # The head's input without its gradient summed over 'model'.
    "head_open_no_bwd": ("_logits", _logits_open_without_bwd),
}


class VocabGatherSpy:
    """Records each all-gather, made while a plan is ambient, whose
    operand is a stored vocab leaf (``embed``, ``head``, ``heads``) as
    the plan's ``top`` was handed it."""

    def __init__(self):
        self.leaves = set()
        self.shapes = []
        self.cut = []

    def __enter__(self):
        self._top, self._gather = shd.TrainPlan.top, collectives.all_gather
        spy, top, gather = self, self._top, self._gather

        def spy_top(plan, params, cfg):
            spy.cut.append(plan.vocab_tp(cfg))
            for k in VOCAB_LEAVES:
                if k in params:
                    spy.leaves.add(params[k].data_ptr())
            return top(plan, params, cfg)

        def spy_gather(x, axis, mesh=None, dim=0):
            if shd.current_plan() is not None and x.data_ptr() in spy.leaves:
                spy.shapes.append(tuple(x.shape))
            return gather(x, axis, mesh, dim)

        shd.TrainPlan.top = spy_top
        collectives.all_gather = spy_gather
        return self

    def __exit__(self, *exc):
        shd.TrainPlan.top = self._top
        collectives.all_gather = self._gather
        return False


def _apply(spec):
    """Break what ``spec`` asks for in this process; returns the undo."""
    saved = []
    if spec.get("mutant"):
        attr, make = MUTANTS[spec["mutant"]]
        saved.append((model_lib, attr, getattr(model_lib, attr)))
        setattr(model_lib, attr, make(getattr(model_lib, attr)))
    if spec.get("gathered"):
        saved.append((shd.TrainPlan, "vocab_tp", shd.TrainPlan.vocab_tp))
        shd.TrainPlan.vocab_tp = lambda plan, cfg: False

    def undo():
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)
    return undo


def vocab_rank(mesh, specs) -> list:
    """Every scenario on this rank of ``mesh``."""
    out = []
    for spec in specs:
        undo = _apply(spec)
        try:
            with VocabGatherSpy() as spy:
                if spec["kind"] == "train":
                    res = ts._train_one(mesh, spec)
                else:
                    res = tps.run_cached(spec, mesh)
        finally:
            undo()
        res.update(vocab_gathers=spy.shapes, vocab_cut=sorted(set(spy.cut)))
        out.append(res)
    return out
