"""Shared pieces of the benchmark: the clock, percentiles, weights from the
seed, the import guard, the profiler window and its reduction, the metric
readers found by name, and the result line.

Nothing here imports the program: the runners (``serve.py``, ``train.py``)
and the family adapters under ``families/`` do.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import sys
import tempfile
import time
from pathlib import Path

import torch

PEAK_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate (data sheet)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bandwidth (data sheet)

# Top-level module names that may not be loaded in a run: the JAX package
# and JAX itself. Compared whole: ``flash_attn_tpu_torch`` is the port.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "flash_attn_tpu")

BENCH_DIR = Path(__file__).resolve().parent.parent  # portbench/


def clock() -> float:
    return time.perf_counter()


def percentile(values, q: float) -> float:
    """The q-th percentile (0..100) of all values, linearly interpolated
    between order statistics (numpy's default rule)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    FORBIDDEN_MODULES, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names
                  if n.split(".", 1)[0] in FORBIDDEN_MODULES)


def load_file_module(path: Path):
    """Import one file by path (metric readers, families, references)."""
    spec = importlib.util.spec_from_file_location(
        "portbench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# --------------------------------------------------------------- weights


def make_weights(spec, seed: int, dtype, device) -> dict:
    """Weights from the seed in two large calls on ``device``: every
    matrix from one normal(0, 0.02) buffer, every norm weight from one
    uniform [0.5, 1.5) buffer, in ``dtype``. ``spec``: [(name, shape,
    kind)] with kind "normal" or "norm", in a fixed order. Returns {name:
    view}; the same seed gives the same weights."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    sizes = {"normal": 0, "norm": 0}
    for _, shape, kind in spec:
        sizes[kind] += math.prod(shape)
    flat = {
        "normal": torch.randn(sizes["normal"], generator=gen, dtype=dtype,
                              device=device).mul_(0.02),
        "norm": torch.rand(sizes["norm"], generator=gen, dtype=dtype,
                           device=device).add_(0.5),
    }
    out, off = {}, {"normal": 0, "norm": 0}
    for name, shape, kind in spec:
        n = math.prod(shape)
        out[name] = flat[kind][off[kind]:off[kind] + n].view(shape)
        off[kind] += n
    return out


def weight_seed(seed: int) -> int:
    """The weights' generator seed, apart from the traffic's."""
    return (seed * 2654435761 + 97) % (2 ** 63)


# ---------------------------------------------------------------- device


@dataclasses.dataclass
class Device:
    """The run's device. ``cuda`` False only in the CPU tests."""
    torch_device: torch.device

    @property
    def cuda(self) -> bool:
        return self.torch_device.type == "cuda"

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def peak_bytes(self) -> int:
        return torch.cuda.max_memory_allocated() if self.cuda else 0

    def info(self) -> dict:
        if not self.cuda:
            return {"platform": "cpu", "kind": "cpu", "count": 1,
                    "memory_peak_bytes": 0}
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": 1, "memory_peak_bytes": self.peak_bytes()}


# ------------------------------------------------------ spans and trace


class Spans:
    """Host spans recorded around the calls into the program: (name, t0,
    t1, info). With ``annotate`` each span is also a profiler range of the
    same name, so the trace can tell what the host was doing."""

    def __init__(self, annotate: bool):
        self.items: list[tuple[str, float, float, dict]] = []
        self.annotate = annotate

    def span(self, name: str, **info):
        return _Span(self, name, info)


class _Span:
    def __init__(self, owner, name, info):
        self.owner, self.name, self.info = owner, name, info
        self.rf = None

    def __enter__(self):
        if self.owner.annotate:
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.t0 = clock()
        return self

    def __exit__(self, *exc):
        t1 = clock()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        self.owner.items.append((self.name, self.t0, t1, self.info))
        return False


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW_MARK = "portbench.profiled_window"
PAD_S = 0.025

# (class, substrings of the kernel name), first match; chip_smoke.py's
# table, which names the port's kernels.
KERNEL_CLASSES = [
    ("blocksparse (K8)", ("bs_fwd", "bs_dkv", "bs_dq", "bs_stats")),
    ("flash_bwd (K2)", ("flash_bwd", "bwd_stats", "bwd_dq")),
    ("flash_fwd (K1)", ("flash_fwd",)),
    ("paged_decode (K5)", ("paged_decode",)),
    ("paged_chunk (K6)", ("paged_chunk",)),
    ("split merge (K5/K6)", ("paged_merge",)),
    ("cache writes (K7)", ("append_token", "append_span", "write_pages")),
    ("GEMM", ("gemm", "cutlass", "nvjet", "xmma", "sm90_")),
    ("optimizer", ("multi_tensor", "adam")),
    ("loss", ("cross_entropy", "softmax", "nll")),
    ("layer_norm", ("layer_norm",)),
    ("copies", ("memcpy", "memset", "copy")),
]


def kernel_class(name: str) -> str:
    low = name.lower()
    return next((c for c, keys in KERNEL_CLASSES
                 if any(k in low for k in keys)), "elementwise/other")


class Profiled:
    """A bounded profiled sub-window: ``start()`` at a step boundary,
    ``stop()`` at a later one. The window is a profiler range
    (WINDOW_MARK) padded by PAD_S seconds of one-element adds on each side
    inside the trace, because the trace drops device events near its ends.
    ``reduce()`` returns the device events inside the window and the host
    annotations."""

    def __init__(self, device: Device):
        """Made in set-up: one short profile here, so that the profiler's
        own start-up cost falls in set-up and not in the window."""
        self.device = device
        self.state = "idle"  # -> "on" -> "done"
        self.start()
        self.stop()
        self.prof.export_chrome_trace(os.devnull)
        self.state = "idle"

    def _pad(self):
        one = torch.zeros(1, device=self.device.torch_device)
        t0 = clock()
        while clock() - t0 < PAD_S:
            one.add_(1)

    def start(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.cuda:
            acts.append(ProfilerActivity.CUDA)
        self.device.sync()
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self._pad()
        self.mark = torch.profiler.record_function(WINDOW_MARK)
        self.mark.__enter__()
        self.t0 = clock()
        self.state = "on"

    def stop(self):
        self.device.sync()
        self.t1 = clock()
        self.mark.__exit__(None, None, None)
        self._pad()
        self.device.sync()
        self.prof.__exit__(None, None, None)
        self.state = "done"

    def reduce(self) -> "Trace":
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self.prof = None
        return Trace.from_events(events)


@dataclasses.dataclass
class Trace:
    """The profiled window: device events (name, start us, duration us)
    clipped to it, host annotations (name, start, duration) inside it, and
    its bounds in trace microseconds."""
    device: list
    host: list
    w0: float
    w1: float

    @classmethod
    def from_events(cls, events):
        mark = next(e for e in events if e.get("name") == WINDOW_MARK
                    and e.get("cat") == "user_annotation")
        w0, w1 = mark["ts"], mark["ts"] + mark["dur"]
        dev = []
        for e in events:
            if e.get("cat") not in DEVICE_CATS:
                continue
            a, b = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
            if b > a:
                dev.append((e["name"], a, b - a))
        host = [(e["name"], e["ts"], e["dur"]) for e in events
                if e.get("cat") == "user_annotation"
                and e.get("name") != WINDOW_MARK
                and w0 <= e["ts"] <= w1]
        dev.sort(key=lambda x: x[1])
        return cls(dev, host, w0, w1)

    @property
    def window_s(self) -> float:
        return (self.w1 - self.w0) / 1e6

    def union_us(self, events=None) -> float:
        busy, end = 0.0, -math.inf
        for _, a, d in sorted(self.device if events is None else events,
                              key=lambda x: x[1]):
            b = a + d
            busy += max(0.0, b - max(a, end))
            end = max(end, b)
        return busy

    @property
    def busy_s(self) -> float:
        return self.union_us() / 1e6

    def idle_gaps(self):
        """[(start us, length us)] of the window with no device event."""
        gaps, end = [], self.w0
        for _, a, d in self.device:
            if a > end:
                gaps.append((end, a - end))
            end = max(end, a + d)
        if self.w1 > end:
            gaps.append((end, self.w1 - end))
        return gaps

    def breakdown(self) -> dict:
        """Device time by kernel class and idle time by the innermost host
        annotation around each gap, each the 10 largest, in seconds."""
        by_class: dict[str, float] = {}
        for name, _, d in self.device:
            c = kernel_class(name)
            by_class[c] = by_class.get(c, 0.0) + d / 1e6
        by_host: dict[str, float] = {}
        host = sorted(self.host, key=lambda h: h[2])  # innermost first
        for a, d in self.idle_gaps():
            mid = a + d / 2
            label = next((n for n, t, dur in host if t <= mid <= t + dur),
                         "harness (outside any program call)")
            by_host[label] = by_host.get(label, 0.0) + d / 1e6
        top = lambda m: [[k, v] for k, v in sorted(  # noqa: E731
            m.items(), key=lambda kv: -kv[1])[:10]]
        return {"device_ops": top(by_class), "idle_gaps": top(by_host)}


# -------------------------------------------------------------- metrics


def metric_reader(name: str, root: Path = BENCH_DIR):
    """``metrics/<name>.py``, else ``metrics/<stem>.py`` for ``<stem>.<cell
    suffix>`` names: each reader's ``read(ctx)`` returns a number or None
    (nothing to read here)."""
    for stem in (name, name.split(".", 1)[0]):
        path = root / "metrics" / f"{stem}.py"
        if path.exists():
            return load_file_module(path)
    raise FileNotFoundError(f"no reader for metric {name!r} under "
                            f"{root / 'metrics'}")


def cell_metrics(bench: dict, cell: str, kind: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` entries that this cell reports:
    those listing it, and those without a ``workloads`` key (per-layer
    ones only where the cell reports the end-to-end metric they move)."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if kind == "end_to_end":
        return e2e
    names = {m["name"] for m in e2e}

    def reported(m):
        if "workloads" in m:
            return cell in m["workloads"]
        return m["moves"] in names

    return [m for m in bench["per_layer"] if reported(m)]


def spans_named(ctx, name: str, profiled: bool = False) -> list:
    """The run's spans called ``name``: all of the window's, or with
    ``profiled`` those inside the profiled sub-window."""
    if profiled:
        if ctx.profiled is None:
            return []
        a, b = ctx.profiled
        return [s for s in ctx.spans if s[0] == name and a <= s[1]
                and s[2] <= b]
    return [s for s in ctx.spans if s[0] == name]


def result_line(correct, attempted, failed, metrics, device, checks,
                breakdown=None) -> str:
    """The run's last stdout line; ``checks`` (each compared number and
    its limit) comes last."""
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return json.dumps(out)


def log(*args):
    print(*args, file=sys.stderr, flush=True)
