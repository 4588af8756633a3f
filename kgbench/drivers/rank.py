"""Ranking requests in a closed loop with one client: each request is
``queries_per_request`` test triples drawn from the seed, ranked tail and
head, filtered, against every entity, through the task's evaluation path
(``_run_eval`` -> ``eval_fn``) with the results on the host.

The window's requests are timed one by one on the host's clock (each ends
with its rankings copied to the host). A reservoir drawn from the seed
keeps the score matrices of ``checked_requests`` of them; once the window
has closed and the program is freed, the reference scores those requests
again and judges the program's scores, ranks and candidate counts.
"""

from __future__ import annotations

import gc
import math
import sys
import time

import numpy as np
import torch

from ..lib import check, kg, program, runtime, seeds, trace, weights
from ..lib.work import kg_shapes
from ..reference import common


class ScoreKeeper:
    """Keeps the program's (tail, head) score matrices of a seeded uniform
    sample of the requests (reservoir sampling), by wrapping the task's
    scoring hook. Each kept matrix is copied on the device's stream into
    host memory taken in set-up (pinned on a card): the sample adds nothing
    to the device's memory and no wait to a request."""

    def __init__(self, task, size: int, rng: np.random.Generator, shape,
                 device: torch.device):
        self.size, self.rng = size, rng
        pin = device.type == "cuda"
        self.slots = [tuple(torch.empty(shape, pin_memory=pin)
                            for _ in range(2)) for _ in range(size)]
        self.kept = {}  # request index -> its slot
        self.current = None
        inner = task._eval_scores

        def keep(*args, **kwargs):
            scores = inner(*args, **kwargs)
            if self.current is not None:
                for host, s in zip(self.slots[self.kept[self.current]],
                                   scores):
                    host.copy_(s.detach(), non_blocking=True)
            return scores

        task._eval_scores = keep

    def begin(self, i: int) -> None:
        """Request ``i`` is next: decide whether the sample takes it."""
        self.current = None
        if i < self.size:
            self.kept[i] = i
        else:
            j = int(self.rng.integers(0, i + 1))
            if j >= self.size:
                return
            self.kept[i] = self.kept.pop(sorted(self.kept)[j])
        self.current = i

    def scores(self) -> dict:
        """{request index: (tail scores, head scores)}, on the host."""
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        return {i: self.slots[slot] for i, slot in self.kept.items()}


def prepare(cell: runtime.Cell, run: runtime.Run, stages):
    """The graph, the run's weights, the task with its model, and the
    request draw: (graph, weights, task, request(), serve(queries))."""
    cfg, tr, fam, dev = cell.config, cell.traffic, cell.family, run.device
    graph = kg.skewed_kg(tr["graph"], run.seed)
    stages.mark("graph")
    task = fam.build_task(cfg, [program.dataset(graph)], dev)
    stages.mark("task", dev)
    model = task.init_params(0)
    params = weights.draw(fam.param_specs(fam.model_dims(cfg),
                                          graph["relations"]), run.seed, dev)
    model.load_state_dict(params, strict=True)
    stages.mark("weights", dev)
    B = tr["queries_per_request"]
    test = graph["test"]
    draw = seeds.rng(run.seed, "requests")

    def request():
        return test[draw.choice(len(test), B, replace=False)]

    def serve(queries):
        return task._run_eval(task._eval_fn, model, queries, B)

    return graph, params, task, request, serve


def run(cell: runtime.Cell, run: runtime.Run) -> dict:
    tr, dev = cell.traffic, run.device
    B = tr["queries_per_request"]
    stages = runtime.Stages(run.t_start)
    import ultra_torchdrug_tpu_torch  # noqa: F401
    stages.mark("imports")
    graph, params, task, request, serve = prepare(cell, run, stages)
    for _ in range(tr["warm_requests"]):
        serve(request())
    stages.mark("warm requests", dev)
    keeper = ScoreKeeper(task, tr["checked_requests"],
                         seeds.rng(run.seed, "sample"),
                         (B, graph["entities"]), dev)
    stages.mark("sample's host memory", dev)
    setup_s = runtime.since(run.t_start)
    print(stages.line(), file=sys.stderr)

    setup_peak = runtime.peak_bytes(dev)
    runtime.reset_peak(dev)
    served, latency = [], []
    t0 = time.perf_counter()
    while True:
        queries = request()
        keeper.begin(len(served))
        ts = time.perf_counter()
        ranking, cand = serve(queries)
        te = time.perf_counter()
        latency.append(te - ts)
        served.append((queries, ranking, cand))
        if te - t0 >= run.seconds:
            break
    elapsed = te - t0
    keeper.current = None
    window_peak = runtime.peak_bytes(dev)
    out = {
        "attempted": len(served), "failed": 0, "setup_s": setup_s,
        "peak_bytes": max(setup_peak, window_peak),
        "metrics": {
            "eval_triples_per_s": len(served) * B / elapsed,
            # nearest rank: the latency that 95 % of the requests met
            "eval_p95_ms": sorted(latency)[math.ceil(0.95 * len(latency))
                                           - 1] * 1e3,
            "peak_mem_gib": window_peak / 2**30,
        },
    }
    if run.trace:
        out["layers"] = _traced(cell, run, task, request, serve, graph,
                                elapsed / len(served))
    kept = keeper.scores()
    del task, serve, keeper
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    out["numbers"] = judge(cell, graph, params, served, kept, dev)
    out["reference_s"] = time.perf_counter() - t_ref
    return out


def _traced(cell, run, task, request, serve, graph, item_s):
    """The per-layer context of a profiled sub-window of requests."""
    from ultra_torchdrug_tpu_torch.tasks import task as task_mod

    patches = [(task, "_eval_scores", "task.scores"),
               (task_mod, "tail_truth_mask", "task.filter_masks"),
               (task_mod, "head_truth_mask", "task.filter_masks"),
               (task_mod, "filtered_ranking", "task.ranking")]
    patches += cell.family.spans()
    n = cell.traffic["traced_requests"]
    batches = [request() for _ in range(n + 1)]

    def window():
        for q in batches[1:]:
            with torch.profiler.record_function(trace.SPAN_PREFIX
                                                + "eval.request"):
                serve(q)

    with trace.spans(patches):
        _, tr = trace.profiled(window, lambda: serve(batches[0]))
    if tr is None:
        return None
    shapes = kg_shapes(graph, kg.relation_edges(graph, run.device))
    work = cell.family.request_work(cell.config, shapes,
                                    cell.traffic["queries_per_request"])
    return runtime.LayerContext(tr, n, item_s, work, runtime.power_limit_w())


class Reference:
    """The reference's view of a run's graph: its model on the weights, the
    fact edges with their inverses, the relation graph and the sorted keys
    of every split's triples (the filter)."""

    def __init__(self, cell, graph, params, device, prec):
        fam, V, R = cell.family, graph["entities"], graph["relations"]
        self.V, self.R = V, R
        self.model = fam.REFERENCE(params, fam.model_dims(cell.config), R,
                                   prec)
        train = torch.as_tensor(graph["train"], device=device)
        self.edges = common.Edges.undirected(
            train[:, 0], train[:, 1], train[:, 2],
            torch.ones(len(train), device=device), V, R)
        self.adjacency = common.relation_adjacency(
            train[:, 0], train[:, 1], train[:, 2], V, R)
        every = torch.as_tensor(np.concatenate(
            [graph[k] for k in ("train", "valid", "test")]), device=device)
        self.keys = torch.sort(common.triple_keys(
            every[:, 0], every[:, 1], every[:, 2], V, R)).values

    def score(self, batch):
        """((tail scores, head scores), (tail truth, head truth))."""
        return (self.model.eval_scores(self.edges, self.adjacency, batch),
                common.truth_masks(self.keys, batch, self.V, self.R))


@torch.no_grad()
def reference_served(cell, graph, params, requests, device, prec):
    """``requests`` served by the reference computing as ``prec`` says, in
    the program's place: (served, kept) as a run keeps them."""
    ref = Reference(cell, graph, params, device, prec)
    served, kept = [], {}
    for i, queries in enumerate(requests):
        batch = torch.as_tensor(queries, device=device)
        scores, truths = ref.score(batch)
        targets = (batch[:, 1], batch[:, 0])
        ranking = torch.stack([common.filtered_rank(s, t, m) for s, t, m in
                               zip(scores, targets, truths)], 1)
        cand = torch.stack([(~m).sum(-1) for m in truths], 1).float()
        served.append((queries, ranking.cpu().numpy(), cand.cpu().numpy()))
        kept[i] = scores
    return served, kept


@torch.no_grad()
def judge(cell, graph, params, served, kept, device) -> dict:
    """The reference's scores of the kept requests against the program's,
    and every kept request's ranks and candidate counts."""
    ref = Reference(cell, graph, params, device, common.Precision())
    gap, off, cand_off = 0.0, 0, 0
    for i, (t_prog, h_prog) in sorted(kept.items()):
        queries, ranking, cand = served[i]
        batch = torch.as_tensor(queries, device=device)
        (t_ref, h_ref), (t_truth, h_truth) = ref.score(batch)
        ranking = torch.as_tensor(ranking, device=device)
        for col, prog, want, target, truth in (
                (0, t_prog, t_ref, batch[:, 1], t_truth),
                (1, h_prog, h_ref, batch[:, 0], h_truth)):
            prog = prog.to(device)
            gap = max(gap, check.score_gap(prog, want))
            off += check.rank_off(ranking[:, col], prog, target, truth)
            allowed = (~truth).sum(-1).cpu().numpy()
            cand_off += int((cand[:, col] != allowed).sum())
    return {"score_gap": gap, "rank_off": off, "cand_off": cand_off}
