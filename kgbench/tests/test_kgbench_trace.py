"""The reduction of a trace to per-layer metrics, on a made-up window."""

import pytest

from kgbench.lib import readers, runtime, trace, work

FAMILIES = trace.kernel_families()


def made_up():
    # a 100 us window: rspmm 10-30, a GEMM 25-40, glue 50-60, NCCL 70-75;
    # spans: a request over it, the scores 5-45
    kernels = [trace.Interval("void rspmm::staged_rows<0>()", 10, 30),
               trace.Interval("sm80_xmma_gemm_f32f32", 25, 40),
               trace.Interval("vectorized_layer_norm_kernel", 50, 60),
               trace.Interval("ncclDevKernel_AllReduce_Sum_f32", 70, 75)]
    spans = [trace.Interval("kgbench.eval.request", 0, 100),
             trace.Interval("kgbench.task.scores", 5, 45)]
    host = [trace.Interval("aten::index_add_", 41, 49)]
    return trace.Trace((0.0, 100.0), kernels, spans, host, FAMILIES)


def test_union_families_and_gaps():
    t = made_up()
    assert t.merged() == [(10, 40), (50, 60), (70, 75)]
    assert t.busy_s == pytest.approx(45e-6)
    assert t.seconds_by_role("handwritten", rspmm=True) == pytest.approx(
        20e-6)
    assert t.seconds_by_role("glue") == pytest.approx(10e-6)
    assert t.seconds_by_role("nccl") == pytest.approx(5e-6)
    gaps = t.idle_gaps()
    assert gaps[0] == ["eval.request", pytest.approx(25e-6)]
    assert ["task.scores / aten::index_add_", pytest.approx(10e-6)] in gaps
    assert t.top_ops(1)[0][0] == "void rspmm::staged_rows<0>()"


def test_readers():
    op = work.Op("sum", 0, 3.35e12 * 5e-6, rspmm=True)  # 5 us bound
    ctx = runtime.LayerContext(made_up(), items=2, item_s=50e-6,
                               work=work.Work([op]))
    assert readers.idle_pct(ctx) == pytest.approx(55.0)
    assert readers.rspmm_roofline(ctx) == pytest.approx(50.0)
    assert readers.step_mfu_pct(ctx) == pytest.approx(10.0)
    assert readers.glue_ms(ctx) == pytest.approx(5e-3)
    assert readers.allreduce_ms(ctx) == pytest.approx(2.5e-3)


def test_a_reader_that_finds_nothing_returns_nothing():
    t = made_up()
    t.kernels = [k for k in t.kernels if "nccl" not in k.name]
    ctx = runtime.LayerContext(t, 2, 50e-6, work.Work())
    assert readers.allreduce_ms(ctx) is None
    assert readers.rspmm_roofline(ctx) is None
