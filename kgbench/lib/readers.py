"""The reductions that the per-layer metrics' readers share
(``kgbench/metrics/<metric>.py``); each returns None where its trace holds
nothing to read."""

from __future__ import annotations

from typing import Optional

from .runtime import LayerContext


def idle_pct(ctx: LayerContext) -> Optional[float]:
    """The share of the traced window in which no kernel ran."""
    if ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)


def step_mfu_pct(ctx: LayerContext) -> Optional[float]:
    """The least time of a request's or step's work (the larger of its
    operations over the fp32 peak and its bytes over the memory rate) over
    the time one took in the unprofiled window."""
    bound, _ = ctx.work.bound_s()
    if bound <= 0 or ctx.item_s <= 0:
        return None
    return 100.0 * bound / ctx.item_s


def rspmm_roofline(ctx: LayerContext) -> Optional[float]:
    """The summed bounds of the relational-SpMM ops of the traced requests
    or steps over the device time of the kernels that do that work."""
    seconds = ctx.trace.seconds_by_role("handwritten", rspmm=True)
    bound = ctx.work.rspmm_bound_s() * ctx.items
    if seconds <= 0 or bound <= 0:
        return None
    return 100.0 * bound / seconds


def glue_ms(ctx: LayerContext) -> Optional[float]:
    """Device ms a request or step of every kernel that is none of the
    hand-written kernels, the matrix products or NCCL."""
    seconds = ctx.trace.seconds_by_role("glue")
    return 1e3 * seconds / ctx.items if seconds > 0 else None


def allreduce_ms(ctx: LayerContext) -> Optional[float]:
    """Device ms a step of NCCL's kernels on this chip."""
    seconds = ctx.trace.seconds_by_role("nccl")
    return 1e3 * seconds / ctx.items if seconds > 0 else None
