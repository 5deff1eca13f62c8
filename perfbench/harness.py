"""What every cell's run shares: the specs, the device, the profiled
slice and its reading, the result line.

A cell is found by name: ``workloads/<cell>.json`` names its
configuration (``configs/<config>.json``), its traffic kind (a
generator in ``traffic/<kind>.py``) and its parameters; the
configuration names the system that runs it (``systems/<system>.py``);
``BENCHMARK.json`` lists the metrics, each read by
``metrics/<name>.py`` or by the shared reader of ``readers.py`` that
``metrics/<name>.json`` names. Nothing here names a cell, a
configuration or a metric.
"""
from __future__ import annotations

import bisect
import dataclasses
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

ROOT = Path(__file__).resolve().parent.parent
PKG = Path(__file__).resolve().parent
# Top-level module names that may not be loaded in a run's process: the
# JAX stack and the package the port was made from.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class NoDevice(SystemExit):
    """The run cannot measure here: it prints no result."""


@dataclasses.dataclass
class Cell:
    name: str
    workload: Dict[str, Any]
    config: Dict[str, Any]
    bench: Dict[str, Any]

    @property
    def chips(self) -> int:
        return int(self.workload["chips"])

    def metrics(self, section: str) -> List[Dict[str, Any]]:
        """The metrics of ``BENCHMARK.json``'s ``section`` this cell
        reports: those listing it, or listing no cells."""
        return [m for m in self.bench[section]
                if "workloads" not in m or self.name in m["workloads"]]


def load_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: Path = ROOT) -> Cell:
    wl = load_json(PKG / "workloads" / f"{name}.json")
    cfg = load_json(PKG / "configs" / f"{wl['config']}.json")
    bench = load_json(root / "BENCHMARK.json")
    return Cell(name, wl, cfg, bench)


def load_module(kind: str, name: str):
    """``perfbench/<kind>/<name>.py`` as a module (a name may hold dots,
    so a file is loaded by its path)."""
    if name.isidentifier():
        return importlib.import_module(f"perfbench.{kind}.{name}")
    modname = f"perfbench.{kind}._{name.replace('.', '_').replace('-', '_')}"
    if modname in sys.modules:
        return sys.modules[modname]
    spec = importlib.util.spec_from_file_location(
        modname, PKG / kind / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[modname] = mod
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str) -> Callable[[Dict[str, Any]], Any]:
    """The reader of metric ``name``: ``read(ctx)`` of
    ``metrics/<name>.py``, or the function of ``readers.py`` that
    ``metrics/<name>.json`` names ({"reader": ..., "args": {...}})."""
    spec = PKG / "metrics" / f"{name}.json"
    if not spec.exists():
        return load_module("metrics", name).read
    from perfbench import readers
    d = load_json(spec)
    fn, args = getattr(readers, d["reader"]), d.get("args", {})
    return lambda ctx: fn(ctx, **args)


def cache_env(root: Path = ROOT) -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    base = root / "build"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(base / "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(base / "triton"))
    os.environ["USE_FLAX"] = "0"
    os.environ.setdefault("OMP_NUM_THREADS", "4")


def require_devices(n: int):
    """The CUDA device the run uses; exits (no result) without ``n``."""
    import torch
    if not torch.cuda.is_available():
        raise NoDevice("no CUDA device: the benchmark measures the card and "
                       "never falls back to the CPU")
    if torch.cuda.device_count() < n:
        raise NoDevice(f"the cell needs {n} cards, "
                       f"{torch.cuda.device_count()} are visible")
    return torch.device("cuda", 0)


def log(msg: str) -> None:
    """A line on stderr, stamped with the seconds since the process
    started (the result line is the last line of stdout)."""
    print(f"[{time.perf_counter():9.2f}] {msg}", file=sys.stderr, flush=True)


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card_note() -> str:
    """The card's name, power limit and clocks, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.max.sm,temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def quantiles(xs: List[float], q: float) -> Optional[float]:
    """The q-quantile (0..1) by linear interpolation, None when empty."""
    if not xs:
        return None
    s = sorted(xs)
    pos = q * (len(s) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)


# ------------------------------------------------------------ profiling
class KernelSpans:
    """In a traced run, wraps named kernel entry points of the program:
    each call inside the profiled slice is stamped on the host clock
    (``time.time_ns``, the clock of the profiler's records) around the
    call and records the work ``work_fn`` counts from its inputs and
    outputs. A call's device time is read from the device records whose
    launch (the runtime or driver call with the same correlation id)
    lies inside its stamps, whatever the kernels are called. Host spans
    around the system's own phases name the device's idle gaps."""

    def __init__(self):
        self.active = False
        self.calls: Dict[str, List[Callable[[], Dict[str, float]]]] = {}
        self.stamps: Dict[str, List[tuple]] = {}
        self.host: List[tuple] = []  # (start ns, end ns, label)
        self._undo: List[Callable[[], None]] = []

    def wrap(self, module, attr: str, name: str, work_fn) -> None:
        """Replace ``module.attr``; ``work_fn(args, kwargs, out)`` returns
        a callable that gives the call's {"flops", "bytes"} once the
        slice has closed (it may hold the call's tensors, so nothing
        waits on the device inside the slice)."""
        orig = getattr(module, attr)
        calls = self.calls.setdefault(name, [])
        stamps = self.stamps.setdefault(name, [])

        def wrapped(*args, **kwargs):
            if not self.active:
                return orig(*args, **kwargs)
            t0 = time.time_ns()
            out = orig(*args, **kwargs)
            stamps.append((t0, time.time_ns()))
            calls.append(work_fn(args, kwargs, out))
            return out

        # The entry point counts its launches on the module's attribute,
        # which is now the wrapper.
        for k, v in vars(orig).items():
            setattr(wrapped, k, v)
        setattr(module, attr, wrapped)
        self._undo.append(lambda: setattr(module, attr, orig))

    def work(self, name: str) -> List[Dict[str, float]]:
        """The recorded calls' work, worked out now."""
        return [w() for w in self.calls.get(name, [])]

    def span(self, obj, attr: str, label: str) -> None:
        """Wrap a method of the running system in a host span."""
        orig = getattr(obj, attr)

        def wrapped(*args, **kwargs):
            if not self.active:
                return orig(*args, **kwargs)
            t0 = time.time_ns()
            try:
                return orig(*args, **kwargs)
            finally:
                self.host.append((t0, time.time_ns(), label))

        setattr(obj, attr, wrapped)
        self._undo.append(lambda: setattr(obj, attr, orig))

    def restore(self) -> None:
        for undo in reversed(self._undo):
            undo()
        self._undo.clear()


class Profiled:
    """A profiled slice of the card's activity: its device records and
    the runtime and driver calls that launched them (the profiler
    records no host ops, whose cost would slow the host it measures).
    ``start`` and ``stop`` run on the thread that launches the system's
    kernels: a profiler started on another thread was seen to record no
    device activity of a serving engine's thread. ``events`` (times in
    ns) is read after the slice, off the measured path; ``offset`` is
    the profiler's clock minus ``time.time_ns``, from the synchronize
    that follows the start mark."""

    def __init__(self, spans: KernelSpans):
        self.spans = spans
        self.t0 = self.t1 = self.stop_s = 0.0
        self.offset = 0
        self._prof = None
        self._events: Optional[List[Dict[str, Any]]] = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        torch.cuda.synchronize()
        self._prof.__enter__()
        # Some versions parse every record into Python objects when the
        # profiler stops: many seconds on the engine's thread, for
        # objects the reading never uses (it reads the raw records).
        inner = getattr(self._prof, "profiler", None)
        if hasattr(inner, "_parse_kineto_results"):
            inner._parse_kineto_results = lambda result: []
        self._mark = time.time_ns()
        torch.cuda.synchronize()
        self.spans.active = True
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        import torch
        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.spans.active = False
        self._prof.__exit__(None, None, None)
        self.stop_s = time.perf_counter() - self.t1

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False

    @property
    def events(self) -> List[Dict[str, Any]]:
        if self._events is None:
            self._events = _raw_events(
                self._prof.profiler.kineto_results.events())
            self._prof = None
            syncs = [e["start"] for e in self._events
                     if e["name"] == "cudaDeviceSynchronize"
                     and e["start"] >= self._mark - 10_000_000]
            if syncs:
                self.offset = min(syncs) - self._mark
        return self._events

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


def _raw_events(kevents) -> List[Dict[str, Any]]:
    import torch
    out = []
    for e in kevents:
        dev = e.device_type() == torch.autograd.DeviceType.CUDA
        start = int(e.start_ns())
        out.append({"name": e.name(), "start": start,
                    "end": start + int(e.duration_ns()), "device": dev,
                    "corr": int(e.correlation_id())})
    return out


def _union_ns(intervals) -> int:
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


@dataclasses.dataclass
class TraceReading:
    window_s: float
    busy_s: float
    kernels: int
    by_span: Dict[str, Dict[int, float]]  # entry point -> call -> seconds
    device_ops: List[List[Any]]
    idle_gaps: List[List[Any]]


def _containing(sorted_spans, t: int):
    """Index of the span (start, end) in a start-sorted list holding t."""
    i = bisect.bisect_right(sorted_spans, (t, float("inf"))) - 1
    if i >= 0 and sorted_spans[i][0] <= t <= sorted_spans[i][1]:
        return i
    return None


def read_trace(slices: List[Profiled]) -> TraceReading:
    """Busy time, each wrapped call's device time, the device ops that
    took most time and the idle gaps by what the host was doing, summed
    over the profiled slices. Raises when a slice holds no device
    record: a 100% idle card is never reported from an empty trace."""
    window = busy = 0.0
    kernels = 0
    by_span: Dict[str, Dict[int, float]] = {}
    totals: Dict[str, float] = {}
    gaps: Dict[str, float] = {}
    for p in slices:
        ev = p.events
        gpu = [e for e in ev if e["device"] and e["end"] > e["start"]]
        if not gpu:
            raise RuntimeError(f"a profiled slice holds no device records "
                               f"({len(ev)} host records)")
        window += p.seconds
        busy += _union_ns((e["start"], e["end"]) for e in gpu) / 1e9
        kernels += len(gpu)
        launches = {e["corr"]: e["start"] - p.offset for e in ev
                    if not e["device"] and e["corr"]}
        for name, stamps in p.spans.stamps.items():
            order = sorted((a, b, i) for i, (a, b) in enumerate(stamps))
            keys = [(a, b) for a, b, _ in order]
            calls = by_span.setdefault(name, {})
            for k in gpu:
                t = launches.get(k["corr"])
                j = None if t is None else _containing(keys, t)
                if j is not None:
                    i = order[j][2]
                    calls[i] = calls.get(i, 0.0) + (
                        k["end"] - k["start"]) / 1e9
        for k in gpu:
            totals[k["name"]] = totals.get(k["name"], 0.0) + (
                k["end"] - k["start"]) / 1e9
        for label, v in _idle_gaps(gpu, p.spans.host, p.offset).items():
            gaps[label] = gaps.get(label, 0.0) + v
    return TraceReading(
        window_s=window, busy_s=busy, kernels=kernels, by_span=by_span,
        device_ops=_top([(n[:120], v) for n, v in totals.items()]),
        idle_gaps=_top(list(gaps.items())))


def _top(pairs, n: int = 10) -> List[List[Any]]:
    return [[k, v] for k, v in sorted(pairs, key=lambda kv: -kv[1])[:n]]


def _idle_gaps(gpu, host, offset: int) -> Dict[str, float]:
    """Idle time between device records, summed by what the host was
    doing at each gap's middle: the innermost host span holding it."""
    ivs = sorted((e["start"], e["end"]) for e in gpu)
    spans = sorted(host)
    gaps: Dict[str, float] = {}
    cur_end = ivs[0][1]
    for s, e in ivs[1:]:
        if s > cur_end + 1000:  # gaps under a microsecond are not idle
            mid = (cur_end + s) // 2 - offset
            label, width = "outside the system's spans", None
            for a, b, name in spans:
                if a > mid:
                    break
                if b >= mid and (width is None or b - a < width):
                    label, width = name, b - a
            gaps[label] = gaps.get(label, 0.0) + (s - cur_end) / 1e9
        cur_end = max(cur_end, e)
    return gaps


def roofline_share(calls: List[Dict[str, float]],
                   device_s: Dict[int, float], peak_flops: float,
                   peak_bw: float) -> Optional[float]:
    """100 x (least time of the calls' work) / (their device time), over
    the calls whose device records were found; None without any."""
    least = took = 0.0
    for i, c in enumerate(calls):
        t = device_s.get(i)
        if not t:
            continue
        least += max(c["flops"] / peak_flops, c["bytes"] / peak_bw)
        took += t
    if took <= 0:
        return None
    return 100.0 * least / took


# --------------------------------------------------------------- result
def emit(result: Dict[str, Any], checks: Dict[str, Dict[str, float]]) -> None:
    """The compared numbers beside their limits as the last lines on
    stderr, then the result line (with them last) on stdout."""
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    line = dict(result)
    line["checks"] = checks
    print(json.dumps(line), flush=True)
