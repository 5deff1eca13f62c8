"""Multi-pod dry run: trace one rank's step of every (arch x shape) cell
on the production mesh, on the meta device, and extract the roofline
inputs.

Port of ``repro/launch/dryrun.py``. The reference lowers and compiles
the step for 512 stub devices; the port has no compiler, so each cell
traces ONE rank's program (rank 0's: every rank runs the same SPMD
program on blocks of the same shapes) on PyTorch's ``meta`` device,
where tensors have shapes and dtypes and no data:

    mesh   = launch/mesh.py:trace_mesh(shape, axes)   # no world, no groups
    params = model.init_params(cfg, device="meta"), cut to rank 0's
             blocks by sharding.param_specs / shard_shape
    train  : runtime/trainer.py:make_train_step(cfg, AdamW, mesh, ...)
    prefill: model.forward(..., last_only=True) into contiguous caches
    decode : model.decode_step over init_caches(..., device="meta")
             (both under sharding.use_plan(TrainPlan(...)), no autograd;
             where cache_spec cuts the attention caches' rows, the
             long-context batch of 1, the plan's ``cache_rows`` name the
             axes the decode step merges its attention over)

read off under nested dispatch modes:

    flops            FlopCounterMode's count (torch.utils.flop_counter's
                     registry: matmul-class ops, mm, bmm, addmm,
                     convolution, attention)
    bytes accessed   input + output bytes of every aten op, views
                     excluded: an unfused upper bound (XLA's count is
                     post-fusion)
    memory           argument bytes (the rank's params, opt state, batch,
                     caches), output bytes, the outputs' bytes that reuse
                     an argument's storage (alias), and temp: the peak of
                     live non-argument bytes over the trace, storage by
                     storage (polled: see _Tracer)
    collectives      the trace mesh's per-kind operand bytes and calls
                     (``parallel/collectives.py``), as a real mesh counts

The trace counts every layer, so there is no extrapolation from
unrolled compiles (``--no-extrapolate`` is accepted and changes
nothing). ``lower_s`` is the seconds spent building the rank's
inputs, ``compile_s`` the trace's. The dry run never touches a card:
it runs the same on any host.

Usage:
    python -m repro_torch.launch.dryrun --arch smollm-135m --shape train_4k
    python -m repro_torch.launch.dryrun --all --both-meshes [--out DIR]
    python -m repro_torch.launch.dryrun --arch X --shape Y --devices 8 \
        --mesh 2,4
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
import traceback

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import (
    ALL_SHAPES, ARCH_NAMES, get_config, shape_by_name,
)
from repro_torch.data.pipeline import input_specs
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import model as model_lib
from repro_torch.optim.adamw import (
    AdamState, AdamW, host_step, opt_state_shardings,
)
from repro_torch.parallel import collectives
from repro_torch.parallel import sharding as shd
from repro_torch.runtime.trainer import make_train_step

ROOF_SOURCE = ("traced (every layer; matmul-class FLOPs; unfused bytes; "
               "meta device)")
# Characters of the traced aten op log kept for --print-hlo.
LOG_CHARS = 20000
# The temp peak's resolution: 1/PEAK_SLACK of it (see _Tracer).
PEAK_SLACK = 64


def _parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true", dest="multi_pod")
    ap.add_argument("--both-meshes", action="store_true", dest="both")
    ap.add_argument("--devices", type=int, default=512)
    ap.add_argument("--mesh", default=None,
                    help="override mesh shape, e.g. '2,4' or '2,2,2'")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--remat", default=None, choices=["none", "full", "dots"])
    ap.add_argument("--no-extrapolate", action="store_true",
                    help="accepted for the reference's command lines; the "
                         "trace counts every layer")
    ap.add_argument("--zero1", action="store_true")
    ap.add_argument("--profile", default="tp", choices=["tp", "dp"])
    ap.add_argument("--seq-shard", action="store_true", dest="seq_shard")
    ap.add_argument("--print-hlo", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--tag", default="")
    return ap.parse_args(argv)


# ------------------------------------------------------------ the tracer
def _tensors(tree, out=None):
    """The tensors of an op's arguments or results (nested lists, tuples
    and dicts), in order."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _tensors(v, out)
    elif isinstance(tree, dict):
        for v in tree.values():
            _tensors(v, out)
    return out


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _cdata(t) -> int:
    """The identity of ``t``'s storage (its StorageImpl's address)."""
    return t.untyped_storage()._cdata


_expired = torch.UntypedStorage._expired


class _Tracer(TorchDispatchMode):
    """Counts every aten op's FLOPs (by ``torch.utils.flop_counter``'s
    registry, the table ``FlopCounterMode`` reads) and bytes, the live
    storages that are not arguments (``args_cdata``), and a log of the
    ops.

    Liveness is polled: each storage an op returns is held by a weak
    reference, and a sweep drops those whose storage is gone. The
    running sum (exact at the last sweep, plus every storage since)
    bounds the live bytes from above; a sweep runs when it passes the
    peak and the storages since the last sweep hold at least
    1/PEAK_SLACK of the peak. So between sweeps the live bytes never
    exceed the reported peak by more than that share: the peak is exact
    to within 1/PEAK_SLACK, from below.

    A functional op on meta tensors whose signature (:func:`_key`) it
    has seen returns fresh tensors of the shapes, strides and dtypes it
    gave then, without running its meta kernel again: the chunked
    attention repeats a few signatures thousands of times a layer."""

    def __init__(self, args_cdata, log: bool):
        super().__init__()
        self.args = args_cdata
        self.info = {}  # op -> (view-like, mutates, flop function)
        self.memo = {}  # _key -> ([(shape, stride, dtype)], flops, single)
        self.flops = 0
        self.bytes = 0
        self.live = {}  # cdata -> (weak ref, bytes)
        self.est = 0  # live bytes, some perhaps already freed
        self.peak = 0
        self.since = 0  # bytes tracked since the last sweep
        self.ops = 0
        self.log = [] if log else None
        self.log_len = 0

    def sweep(self):
        self.live = {k: v for k, v in self.live.items() if not _expired(k)}
        self.est = sum(b for _, b in self.live.values())
        self.peak = max(self.peak, self.est)
        self.since = 0

    def _track(self, t):
        st = t.untyped_storage()
        cd = st._cdata
        if cd in self.args:
            return
        if cd in self.live and not _expired(cd):
            return
        nb = st.nbytes()
        self.live[cd] = (StorageWeakRef(st), nb)
        self.est += nb
        self.since += nb
        if self.est > self.peak and self.since * PEAK_SLACK >= self.peak:
            self.sweep()

    def _op_info(self, func):
        got = self.info.get(func)
        if got is None:
            got = self.info[func] = (func.is_view, func._schema.is_mutable,
                                     flop_registry.get(func._overloadpacket))
        return got

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        is_view, mutates, flop = self._op_info(func)
        ins = _tensors(args)
        if kwargs:
            _tensors(kwargs, ins)
        key = None
        if not is_view and not mutates and all(
                t.device.type == "meta" for t in ins):
            key = _key(func, args, kwargs)
        hit = self.memo.get(key) if key is not None else None
        if hit is not None:
            metas, flops, single = hit
            outs = [torch.empty_strided(shp, std, dtype=dt, device="meta")
                    for shp, std, dt in metas]
            out = outs[0] if single else tuple(outs)
        else:
            out = func(*args, **kwargs)
            outs = _tensors(out)
            flops = (flop(*args, **kwargs, out_val=out)
                     if flop is not None else 0)
            if not is_view and not mutates and outs:
                # A result sharing an input's storage is a view too
                # (_unsafe_view, _reshape_alias, ...).
                in_st = {_cdata(t) for t in ins}
                is_view = any(_cdata(t) in in_st for t in outs)
                single = isinstance(out, torch.Tensor)
                if key is not None and not is_view and (
                        single or (type(out) is tuple
                                   and len(outs) == len(out))):
                    self.memo[key] = ([(t.shape, t.stride(), t.dtype)
                                       for t in outs], flops, single)
        self.ops += 1
        self.flops += flops
        if not is_view:
            self.bytes += (sum(_nbytes(t) for t in ins)
                           + sum(_nbytes(t) for t in outs))
        for t in outs:
            self._track(t)
        if self.log is not None and self.log_len < LOG_CHARS:
            line = (f"{func}({', '.join(_sig(t) for t in ins)})"
                    f" -> {', '.join(_sig(t) for t in outs)}\n")
            self.log.append(line)
            self.log_len += len(line)
        return out


def _key(func, args, kwargs):
    """A hashable signature of a call on meta tensors: the op, each
    tensor's shape, strides and dtype, every other argument; None when
    an argument has no hashable form."""
    def one(a):
        if isinstance(a, torch.Tensor):
            return (tuple(a.shape), a.stride(), a.dtype)
        if isinstance(a, (list, tuple)):
            return tuple(one(v) for v in a)
        if a is None or isinstance(a, (bool, int, float, str,
                                       torch.dtype, torch.device,
                                       torch.memory_format, torch.layout)):
            return a
        raise TypeError
    try:
        return (func, one(args), tuple((k, one(v)) for k, v in
                                       sorted(kwargs.items())))
    except TypeError:
        return None


def _sig(t) -> str:
    return f"{str(t.dtype).replace('torch.', '')}{list(t.shape)}"


def trace(fn, args, *, log: bool = False):
    """Run ``fn(*args)`` under the counters. Returns (outputs, cost,
    memory, op log): cost {"flops", "bytes accessed", "aten ops"},
    memory the four sizes the dry run reports."""
    arg_leaves = _tensors(args)
    args_cdata = {_cdata(t) for t in arg_leaves}
    tracer = _Tracer(args_cdata, log)
    with tracer:
        out = fn(*args)
    tracer.sweep()
    outs, seen = [], set()
    for t in _tensors(out):
        cd = _cdata(t)
        if cd not in seen:
            seen.add(cd)
            outs.append((cd, _nbytes(t)))
    memory = dict(
        argument_size_in_bytes=sum(_nbytes(t) for t in arg_leaves),
        output_size_in_bytes=sum(b for _, b in outs),
        alias_size_in_bytes=sum(b for cd, b in outs if cd in args_cdata),
        temp_size_in_bytes=tracer.peak,
    )
    cost = {"flops": float(tracer.flops),
            "bytes accessed": float(tracer.bytes),
            "aten ops": float(tracer.ops)}
    return out, cost, memory, "".join(tracer.log or ())


# ----------------------------------------------------------- the program
def _zip_map(fn, tree, specs, path=()):
    """``fn(path, leaf, spec)`` over a tree of dicts, lists and (named)
    tuples of tensors and its spec tree (a spec is a tuple: a leaf)."""
    if isinstance(tree, dict):
        return {k: _zip_map(fn, tree[k], specs[k], path + (str(k),))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        names = getattr(tree, "_fields", None) or [str(i) for i in
                                                   range(len(tree))]
        out = [_zip_map(fn, v, w, path + (n,))
               for v, w, n in zip(tree, specs, names)]
        if isinstance(tree, list):
            return out
        return type(tree)(*out) if hasattr(tree, "_fields") else tuple(out)
    return fn(path, tree, specs)


def _blocks(tree, specs, mesh, dtype=None):
    """Meta tensors of rank 0's blocks of ``tree``'s leaves under
    ``specs`` (a spec tree of the same structure), optionally in
    ``dtype``."""
    return _zip_map(lambda _, leaf, spec: torch.empty(
        shd.shard_shape(leaf.shape, spec, mesh), dtype=dtype or leaf.dtype,
        device="meta"), tree, specs)


def _plan_cache_specs(plan, cfg, caches, specs):
    """``cache_spec``'s specs with the 'model' cut kept where the plan
    runs the block's heads tensor-parallel: on the GQA k/v caches when
    attention is, and on the ssm states ``h`` when the Mamba2 mixer is.
    Gathered attention computes every head, and MLA reads the whole
    latent on every model rank, so those caches stay whole over 'model'
    (the conv windows are never cut over it)."""
    keep = {"k": plan.attn_tp(cfg) and cfg.mla is None,
            "v": plan.attn_tp(cfg) and cfg.mla is None,
            "h": plan.mixer_tp(cfg)}

    def one(path, leaf, spec):
        if keep.get(path[-1], False):
            return spec
        return tuple(None if a == "model" else a for a in spec)
    return _zip_map(one, caches, specs)


def _row_axes(caches, specs):
    """The axes the attention caches' rows (dim 2 of the stacked
    k/v) are cut over under ``specs``."""
    axes = set()

    def one(path, leaf, spec):
        if path[-1] in ("k", "v") and leaf.dim() >= 3 and spec[2]:
            axes.update((spec[2],) if isinstance(spec[2], str) else spec[2])
    _zip_map(one, caches, specs)
    return tuple(sorted(axes))


def cache_plan(cfg, shape, mesh, pspecs, params, batch_axes, caches):
    """(plan, cache specs) of a prefill or decode step of ``shape``:
    ``cache_spec``'s layout of ``caches`` (the whole trees) with the
    'model' cut kept where the plan runs GQA or the Mamba2 mixer
    tensor-parallel, and a plan
    whose ``cache_rows`` are the axes that layout cuts the attention
    caches' rows over."""
    plan = shd.TrainPlan(mesh, cfg, pspecs, params, batch_axes)
    cspecs = _plan_cache_specs(plan, cfg, caches,
                               shd.cache_spec(cfg, shape, mesh, caches))
    return shd.TrainPlan(mesh, cfg, pspecs, params, batch_axes,
                         cache_rows=_row_axes(caches, cspecs)), cspecs


def build_program(cfg, shape, mesh, *, zero1: bool = False,
                  profile: str = "tp"):
    """(fn, args) of rank 0's step of ``cfg`` at ``shape`` on ``mesh``
    (a trace mesh), every argument a meta tensor of that rank's block
    (the optimizer's step counter a host tensor)."""
    full = model_lib.init_params(cfg, device="meta")
    pspecs = shd.param_specs(full, mesh, profile=profile)
    params = _blocks(full, pspecs, mesh)
    whole = {k: torch.empty(s, dtype=d, device="meta")
             for k, (s, d) in input_specs(cfg, shape).items()}
    B = shape.global_batch
    batch_axes = shd.batch_axes(mesh, B, profile)
    if shape.kind == "train":
        batch = _blocks(whole, shd.batch_spec(cfg, shape, mesh, whole,
                                              profile=profile), mesh)
        opt = AdamW(lr=3e-4)
        mspecs = opt_state_shardings(AdamState((), full, full), pspecs, mesh,
                                     zero1=zero1)
        state = AdamState(host_step(),
                          _blocks(full, mspecs.mu, mesh, torch.float32),
                          _blocks(full, mspecs.nu, mesh, torch.float32))
        step = make_train_step(
            cfg, opt, mesh, pspecs, list(shd.iter_leaves_specs(mspecs.mu)),
            batch_axes=batch_axes)
        return step, (params, state, batch)

    caches = model_lib.init_caches(cfg, B, shape.seq_len, device="meta")
    plan, cspecs = cache_plan(cfg, shape, mesh, pspecs, params, batch_axes,
                              caches)
    caches = _blocks(caches, cspecs, mesh)
    if shape.kind == "prefill":
        # model.prefill's forward, into caches laid out as the
        # reference's out_shardings lay its prefill's (cache_spec).
        batch = _blocks(whole, shd.batch_spec(cfg, shape, mesh, whole),
                        mesh)

        def prefill_step(params, batch, caches):
            with torch.no_grad(), shd.use_plan(plan):
                logits, new_caches, _ = model_lib.forward(
                    params, cfg, batch, caches, last_only=True)
            return logits, new_caches
        return prefill_step, (params, batch, caches)

    # decode: one new token against a seq_len cache
    lead = (cfg.num_codebooks,) if cfg.frontend == "codes" else ()
    toks = {"tokens": torch.empty((B,) + lead + (1,), dtype=torch.int32,
                                  device="meta")}
    toks = _blocks(toks, shd.batch_spec(cfg, shape, mesh, toks), mesh)

    def serve_step(params, last_tokens, caches):
        with torch.no_grad(), shd.use_plan(plan):
            return model_lib.decode_step(params, cfg, last_tokens, caches)
    return serve_step, (params, toks["tokens"], caches)


def _cell(arch: str, shape_name: str, *, multi_pod: bool, mesh_override,
          remat, zero1: bool, print_hlo: bool, profile: str,
          devices: int, seq_shard: bool = False):
    """Trace one cell. Returns a result dict."""
    cfg = get_config(arch)
    if remat is not None:
        cfg = dataclasses.replace(cfg, remat=remat)
    if seq_shard:
        cfg = dataclasses.replace(cfg, seq_shard=True)
    shape = shape_by_name(shape_name)

    if shape.name == "long_500k" and not cfg.supports_long_context():
        return dict(
            arch=arch, shape=shape_name, status="skipped",
            reason="pure full-attention arch: 524k dense decode is not "
                   "sub-quadratic-servable (DESIGN.md §Arch-applicability)",
        )

    if mesh_override:
        dims = tuple(int(x) for x in mesh_override.split(","))
        axes = ("pod", "data", "model")[-len(dims):]
    else:
        dims, axes = mesh_lib.production_mesh_shape(multi_pod=multi_pod)
    chips = math.prod(dims)
    if devices < chips:
        raise RuntimeError(f"mesh {dims} needs {chips} devices, "
                           f"--devices gives {devices}")
    mesh = mesh_lib.trace_mesh(dims, axes)

    t0 = time.time()
    fn, args = build_program(cfg, shape, mesh, zero1=zero1, profile=profile)
    t_lower = time.time() - t0
    before = collectives.get_mesh()
    collectives.set_mesh(mesh)
    try:
        _, cost, mem, log = trace(fn, args, log=print_hlo)
    finally:
        collectives.set_mesh(before)
    t_compile = time.time() - t0 - t_lower
    coll = collectives.stats(mesh)
    del coll["seconds"]
    if print_hlo:
        sys.stderr.write(log[:LOG_CHARS])

    flops = cost["flops"]
    hbm_bytes = cost["bytes accessed"]
    coll_total = coll["total"]
    terms = collectives.roofline_terms(
        flops=flops, hbm_bytes=hbm_bytes, collective_bytes=coll_total,
        chips=chips,
    )
    n_act = cfg.n_params_active()
    # train/prefill process B*S tokens; decode processes B*1 per step.
    tokens = shape.global_batch * (
        1 if shape.kind == "decode" else shape.seq_len
    )
    mf = (6.0 if shape.kind == "train" else 2.0) * n_act * tokens
    mf_per_device = mf / chips
    return dict(
        arch=arch, shape=shape_name, status="ok",
        mesh=list(dims), chips=chips, multi_pod=multi_pod,
        lower_s=round(t_lower, 2), compile_s=round(t_compile, 2),
        memory=mem, cost_scanned=cost, collectives_scanned=coll,
        roofline=terms, roofline_source=ROOF_SOURCE,
        roofline_inputs=dict(flops=flops, hbm_bytes=hbm_bytes,
                             collective_bytes=coll_total),
        extrapolation=None,
        model_flops=mf, model_flops_per_device=mf_per_device,
        useful_flop_ratio=(mf_per_device / flops) if flops else None,
        params_active=n_act, params_total=cfg.n_params(),
    )


def main(argv=None):
    args = _parse_args(argv)

    cells = []
    archs = [args.arch] if args.arch else list(ARCH_NAMES)
    shapes = [args.shape] if args.shape else [s.name for s in ALL_SHAPES]
    meshes = [False, True] if args.both else [args.multi_pod]
    for a in archs:
        for s in shapes:
            for mp in meshes:
                cells.append((a, s, mp))

    os.makedirs(args.out, exist_ok=True)
    failures = 0
    for arch, shape, mp in cells:
        tag = f"{arch}_{shape}_{'pod2' if mp else 'pod1'}{args.tag}"
        path = os.path.join(args.out, tag + ".json")
        if args.skip_existing and os.path.exists(path):
            print(f"[skip-existing] {tag}", flush=True)
            continue
        try:
            res = _cell(
                arch, shape, multi_pod=mp, mesh_override=args.mesh,
                remat=args.remat, zero1=args.zero1,
                print_hlo=args.print_hlo, profile=args.profile,
                devices=args.devices, seq_shard=args.seq_shard,
            )
        except Exception as e:  # noqa: BLE001 - one cell's failure
            res = dict(arch=arch, shape=shape, status="error",
                       error=f"{type(e).__name__}: {e}",
                       traceback=traceback.format_exc()[-4000:])
            failures += 1
        with open(path, "w") as f:
            json.dump(res, f, indent=1)
        status = res["status"]
        extra = ""
        if status == "ok":
            r = res["roofline"]
            extra = (
                f" compile={res['compile_s']:.1f}s dominant={r['dominant']}"
                f" t=({r['t_compute']:.2e},{r['t_memory']:.2e},"
                f"{r['t_collective']:.2e})s [{res['roofline_source']}]"
            )
        elif status == "error":
            extra = " " + res["error"][:160]
        print(f"[{status}] {tag}{extra}", flush=True)
    if failures:
        sys.exit(1)


if __name__ == "__main__":
    main()
