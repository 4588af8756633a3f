"""The work counts against hand counts at a tiny shape."""

import json

import pytest

from kgbench.families import classic_nbfnet, ultra
from kgbench.lib import work
from kgbench.run import KGBENCH


def config(name):
    cfg = json.loads((KGBENCH / "configs" / f"{name}.json").read_text())
    return cfg


def test_relational_sum_takes_the_cheaper_grouping():
    # 10 edges of 2 types into 4 rows of 3 features: 3EF = 90 against
    # 2EF + 2TVF = 60 + 48 = 108
    op = work.relational_sum(10, 5, 4, 2, 3, 6)
    assert op.flops == 90
    assert op.nbytes == 16 * 10 + 4 * (3 * (5 + 4) + 6)
    assert op.bwd.flops == 180
    assert op.bwd.nbytes == 16 * 10 + 4 * (3 * (4 + 2 * 5) + 2 * 6)
    # a dense graph: 100 edges of 1 type into 10 rows: 2EF + 2TVF wins
    assert work.relational_sum(100, 10, 10, 1, 2, 2).flops == 400 + 40


def test_bounds_take_the_larger_side():
    w = work.Work([work.Op("a", 67e12, 0), work.Op("b", 0, 6.7e12)])
    assert w.bound_s() == (2.0, "bytes")
    assert work.Op("c", 67e9, 3.35e9, rspmm=True).bound_s() == \
        pytest.approx(1e-3)
    assert w.with_backward().flops == 3 * 67e12
    assert w.scaled(0.5).nbytes == 3.35e12


def test_ultra_request_by_hand():
    cfg = config("ultra_6x64")
    D, L, B, V, E, R2, N, Er = 64, 6, 2, 10, 40, 4, 4, 16
    shapes = dict(entities=V, edges=E, relation_types=R2, rel_nodes=N,
                  rel_edges=Er)
    w = ultra.request_work(cfg, shapes, B)
    F = B * D
    rel_layer = (min(3 * Er * F, 2 * Er * F + 2 * 4 * N * F)
                 + 2 * N * B * 2 * D * D + N * B * D * 10)
    ent_layer = (2 * (2 * B * R2 * D * D) + B * R2 * D
                 + min(3 * E * F, 2 * E * F + 2 * R2 * V * F)
                 + 2 * V * B * 2 * D * D + V * B * D * 10)
    head = 2 * V * B * 128 * 128 + V * B * 128 + 2 * V * B * 128
    want = L * rel_layer + 2 * (L * ent_layer + head + 2 * V * B)
    assert w.flops == want
    rspmm = [op for op in w.ops if op.rspmm]
    assert len(rspmm) == 2 * L  # the entity tower's sums, both directions
    assert rspmm[0].nbytes == 16 * E + 4 * (F * 2 * V + R2 * F)


def test_train_steps_count_forward_and_backward():
    cfg = config("nbfnet_6x32_pna")
    shapes = dict(entities=10, edges=40, relation_types=4, rel_nodes=4,
                  rel_edges=16)
    step = classic_nbfnet.step_work(cfg, shapes, 2)
    fwd = classic_nbfnet.forward_work(cfg, shapes, 2, 2 * 33)
    # the backward twice the forward, PNA's at 16 operations an edge and
    # feature against its forward's 7
    assert step.flops == pytest.approx(3 * (fwd.flops + 2 * 33 * 10)
                                       + 6 * (16 - 2 * 7) * 40 * 64)
    pna = [op for op in step.ops if op.name.startswith("pna_aggregate")]
    assert len(pna) == 12  # 6 layers forward and backward
    assert pna[0].flops == 7 * 40 * 64 and pna[-1].flops == 16 * 40 * 64
