"""What every driver shares: the cell it runs, the run's arguments, the
card's name and power limit, peak memory, and the per-layer readers'
context."""

from __future__ import annotations

import importlib.util
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Dict, Optional

import torch

KGBENCH = Path(__file__).resolve().parent.parent
# top-level names the process may not hold once the window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "ultra_torchdrug_tpu")


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    family: ModuleType
    limits: Dict[str, float]
    chips: int = 1
    per_layer: Dict[str, tuple] = field(default_factory=dict)  # reader, unit
    end_to_end: Dict[str, str] = field(default_factory=dict)  # name -> unit


@dataclass
class Run:
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float  # perf_counter at the process's start
    rank: int = 0
    world: int = 1


@dataclass
class LayerContext:
    """What a per-layer reader reads: the traced window, the requests or
    steps it held, the unprofiled seconds each took, and the work of
    one."""
    trace: object  # lib.trace.Trace
    items: int
    item_s: float
    work: object  # lib.work.Work
    power_limit_w: Optional[float] = None
    notes: list = field(default_factory=list)


class Stages:
    """Seconds of each stage of set-up, for the run's stderr."""

    def __init__(self, t0: float):
        self.t = t0
        self.marks = []

    def mark(self, name: str, device=None) -> None:
        if device is not None:
            sync(device)
        now = time.perf_counter()
        self.marks.append((name, now - self.t))
        self.t = now

    def line(self) -> str:
        return "set-up: " + ", ".join(f"{n} {s:.2f} s" for n, s in self.marks)


def load_module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def since(t0: float) -> float:
    return time.perf_counter() - t0


def power_limit_w() -> Optional[float]:
    """The card's power limit (nvidia-smi), or None where it cannot say."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i",
             str(torch.cuda.current_device())],
            capture_output=True, text=True, timeout=20)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def device_info(device, count: int, peak_bytes: int) -> dict:
    device = torch.device(device)
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": count, "memory_peak_bytes": int(peak_bytes)}
    return {"platform": "cpu", "kind": "cpu", "count": count,
            "memory_peak_bytes": int(peak_bytes)}


def peak_bytes(device) -> int:
    if torch.device(device).type == "cuda":
        return torch.cuda.max_memory_allocated(device)
    return 0


def reset_peak(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def read_layers(cell: Cell, ctx: LayerContext) -> Dict[str, dict]:
    """Each per-layer metric of the cell that its reader finds, with its
    unit; a reader that finds nothing returns None and the metric is left
    out."""
    out = {}
    for name, (reader, unit) in cell.per_layer.items():
        value = reader.read(ctx)
        if value is not None:
            out[name] = {"value": float(value), "unit": unit}
    return out
