"""Profiler traces reduced to what the per-layer readers and the result's
``breakdown`` need: the device's kernels by family, the union of their
intervals over a traced window, and its idle gaps labelled by the harness
span (and the host op inside it) that was open.

Kernel families are files ``kgbench/kernels/<family>.json``: {"role":
"handwritten" | "gemm" | "nccl", "rspmm": whether its kernels do
relational-SpMM work, "match": substrings of kernel names}. A kernel no
family matches is glue. A later kernel adds a file.
"""

from __future__ import annotations

import contextlib
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

KERNEL_DIR = Path(__file__).resolve().parent.parent / "kernels"
SPAN_PREFIX = "kgbench."
WINDOW_SPAN = SPAN_PREFIX + "window"


def kernel_families(directory: Path = KERNEL_DIR) -> Dict[str, dict]:
    return {p.stem: json.loads(p.read_text())
            for p in sorted(directory.glob("*.json"))}


def family_of(name: str, families: Dict[str, dict]) -> str:
    for fam, spec in families.items():
        if any(m in name for m in spec["match"]):
            return fam
    return "glue"


@dataclass
class Interval:
    name: str
    start: float  # us, the profiler's clock
    end: float


@dataclass
class Trace:
    """A traced window: its device kernels and host spans, clipped to it."""
    window: Tuple[float, float]
    kernels: List[Interval]
    spans: List[Interval]  # harness spans (kgbench.*)
    host_ops: List[Interval]  # other host events, for labels
    families: Dict[str, dict] = field(default_factory=kernel_families)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def merged(self) -> List[Tuple[float, float]]:
        """The union of the kernels' intervals inside the window."""
        lo, hi = self.window
        out: List[List[float]] = []
        for k in sorted(self.kernels, key=lambda k: k.start):
            a, b = max(k.start, lo), min(k.end, hi)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [tuple(x) for x in out]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.merged()) * 1e-6

    def seconds_by_family(self) -> Dict[str, float]:
        """Each family's (and glue's) summed kernel seconds."""
        out: Dict[str, float] = {}
        for k in self.kernels:
            fam = family_of(k.name, self.families)
            out[fam] = out.get(fam, 0.0) + (k.end - k.start) * 1e-6
        return out

    def seconds_by_role(self, role: str, rspmm: Optional[bool] = None) -> float:
        """Summed kernel seconds of the families with ``role`` (and, when
        given, that ``rspmm`` flag); role "glue" is what no family holds."""
        total = 0.0
        for fam, s in self.seconds_by_family().items():
            spec = self.families.get(fam, {"role": "glue", "rspmm": False})
            if spec["role"] != role:
                continue
            if rspmm is not None and bool(spec.get("rspmm")) != rspmm:
                continue
            total += s
        return total

    def top_ops(self, n: int = 10) -> List[list]:
        """[kernel name, seconds] of the n kernels that took the most."""
        by: Dict[str, float] = {}
        for k in self.kernels:
            by[k.name] = by.get(k.name, 0.0) + (k.end - k.start) * 1e-6
        return [[name, s] for name, s in
                sorted(by.items(), key=lambda x: -x[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """[label, seconds] of the n longest gaps in the window where no
        kernel ran, each labelled by the innermost harness span and host op
        open at its middle."""
        lo, hi = self.window
        edges = [lo] + [x for iv in self.merged() for x in iv] + [hi]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        return [[self._label((a + b) / 2), (b - a) * 1e-6]
                for a, b in gaps[:n]]

    def _label(self, t: float) -> str:
        def innermost(events):
            best = None
            for e in events:
                if e.start <= t <= e.end and (
                        best is None or e.end - e.start < best.end - best.start):
                    best = e
            return best

        span, op = innermost(self.spans), innermost(self.host_ops)
        label = span.name[len(SPAN_PREFIX):] if span else "outside spans"
        return f"{label} / {op.name}" if op else label


def read_profile(prof) -> Optional[Trace]:
    """The Trace of a ``torch.profiler.profile`` whose window was recorded
    under ``WINDOW_SPAN``; None when it holds no device kernel or no
    window."""
    kernels, spans, host, window = [], [], [], None
    for e in prof.events():
        iv = Interval(e.name, e.time_range.start, e.time_range.end)
        if e.device_type == torch.autograd.DeviceType.CUDA:
            # spans are mirrored on the device's timeline: not kernels
            if not (getattr(e, "is_user_annotation", False)
                    or e.name.startswith(SPAN_PREFIX)):
                kernels.append(iv)
        elif e.name == WINDOW_SPAN:
            window = (iv.start, iv.end)
        elif e.name.startswith(SPAN_PREFIX):
            spans.append(iv)
        else:
            host.append(iv)
    if window is None or not kernels:
        return None
    return Trace(window, kernels, spans, host)


def profiled(fn, lead=None):
    """Run ``fn()`` under torch.profiler (host and device) inside the window
    span, the device synchronised at its end, after ``lead()`` (outside the
    window: the profiler's own start-up lands there); returns (fn's result,
    the Trace or None)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        if lead is not None:
            lead()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        with torch.profiler.record_function(WINDOW_SPAN):
            out = fn()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    return out, read_profile(prof)


@contextlib.contextmanager
def spans(patches):
    """Wrap each (owner, attribute, span name) in a ``record_function`` span
    while the block runs, and restore the originals after it."""
    saved = []
    try:
        for owner, attr, name in patches:
            original = getattr(owner, attr)
            saved.append((owner, attr, original, attr in vars(owner)))

            def wrapped(*a, _f=original, _n=SPAN_PREFIX + name, **k):
                with torch.profiler.record_function(_n):
                    return _f(*a, **k)

            setattr(owner, attr, wrapped)
        yield
    finally:
        for owner, attr, original, own in reversed(saved):
            if own:
                setattr(owner, attr, original)
            else:
                delattr(owner, attr)
