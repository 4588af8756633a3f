"""Device timing, least-time bounds and the check of hub sums for the port's
kernels on one NVIDIA H100, shared by ``chip_smoke.py``, the ladder tools
and ``redesign_times.py``. This module imports only torch:
``redesign_times.py`` loads it by path to time another checkout's kernels
with it.

A bound is the least time the card could take for a function's work: the
larger of its compulsory bytes (each input read once, each output written
once) over the memory rate and its operations over the fp32 peak. Every
time here is a device time from CUDA events, but ``host_us_per_call``'s,
which is the host's clock on what a wrapper does on the host.
"""

from __future__ import annotations

import subprocess
import time

import torch

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, fp32 FLOP/s outside the
# tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
# a sum over a hub row of 10^3 to 10^5 edges rounds differently in another
# order: besides a kernel's own tolerance, its check allows 8 fp32 ulps of
# each entry's absolute mass, the sum of its terms' absolute values (the
# ladder's allowance, ops/rspmm_ladder_cuda.py)
MASS_ULPS = 8 * torch.finfo(torch.float32).eps
# edges a time in the mass sums, to bound their [chunk, F] intermediates
MASS_CHUNK = 1 << 15


def cuda_time_ms(fn, iters: int, warmup: int = 2,
                 queue_ahead: bool = False) -> float:
    """Mean device time of fn() over iters back-to-back calls (CUDA events).
    With ``queue_ahead`` the device first spins (about 30 ms at the H100's
    clocks) while the host queues every call, so that a call whose host
    side takes longer than its kernels is timed by the device, not by the
    host's pace."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if queue_ahead:
        torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cards_time_ms(fn, cards, iters: int, warmup: int = 2,
                  queue_ahead: bool = True) -> float:
    """Mean device time of fn() over iters back-to-back calls whose work
    spans ``cards``: the window runs from each card's start event to its
    end event, and the longest card's window over iters is the time. With
    ``queue_ahead`` every card first spins (about 30 ms) while the host
    queues every call, so that the devices' work is timed; without, the
    calls run at the host's pace."""
    for _ in range(warmup):
        fn()
    for c in cards:
        torch.cuda.synchronize(c)
    starts, ends = [], []
    for c in cards:
        with torch.cuda.device(c):
            if queue_ahead:
                torch.cuda._sleep(50_000_000)
            starts.append(torch.cuda.Event(enable_timing=True))
            starts[-1].record()
    for _ in range(iters):
        fn()
    for c in cards:
        with torch.cuda.device(c):
            ends.append(torch.cuda.Event(enable_timing=True))
            ends[-1].record()
    for c in cards:
        torch.cuda.synchronize(c)
    return max(a.elapsed_time(b) for a, b in zip(starts, ends)) / iters


def times_in_turns(fns: dict, iters: int, queue_ahead: bool = False) -> dict:
    """cuda_time_ms of each named function, read twice in turns (the
    functions in order, then in reverse order), the lesser of its two
    readings: the first reading after an idle or allocation-heavy phase can
    run 15 % slow, whichever function it times (PERF.md)."""
    reads = {name: [] for name in fns}
    for name in list(fns) + list(fns)[::-1]:
        reads[name].append(cuda_time_ms(fns[name], iters,
                                        queue_ahead=queue_ahead))
    return {name: min(r) for name, r in reads.items()}


def host_us_per_call(fn, calls: int, readings: int = 3) -> float:
    """The host's microseconds per fn() call: the least of ``readings``
    readings of ``calls`` calls queued behind a device spin (about 55 ms at
    the H100's clocks), so that the host's clock reads only the call's host
    side (checks, allocations, launches), not its kernels. Keep calls times
    launches a call well below the launch queue's depth (about 1,000)."""
    fn()
    best = float("inf")
    for _ in range(readings):
        torch.cuda.synchronize()
        torch.cuda._sleep(100_000_000)
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        best = min(best, time.perf_counter() - t0)
        torch.cuda.synchronize()
    return best * 1e6 / calls


def roofline_ms(nbytes: int, flops: int) -> tuple:
    """(the larger of nbytes over the memory rate and flops over the fp32
    peak, in ms; which of the two it is)."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def edge_bytes(num_edges: int) -> int:
    """The compulsory bytes of a graph's edges: one int32 edge list (source,
    destination, type) and one fp32 weight per edge, read once. The kernels'
    own layouts (CSRs, eid arrays, chunks) are a design's cost, not the
    function's."""
    return num_edges * (3 * 4 + 4)


def k1_bound_ms(operands) -> tuple:
    """Least time for K1's (or K1h's) work on this card: the edges, rel and
    x read once (4 B a feature, 2 B for bf16 operands) and the fp32 output
    written once over the memory rate, against 3 fp32 operations per edge
    and feature (message, weight, sum) over the fp32 peak. ``operands`` is
    K1's (rowptr, src, etype, eid, w, rel, x)."""
    rowptr, src, etype, eid, w, rel, x = operands
    E = src.numel()
    V, F = rowptr.numel() - 1, x.shape[1]
    nbytes = (edge_bytes(E) + (rel.numel() + x.numel()) * x.element_size()
              + V * F * 4)
    return roofline_ms(nbytes, 3 * E * F)


def _csr_rows(rowptr: torch.Tensor) -> torch.Tensor:
    return torch.repeat_interleave(
        torch.arange(rowptr.numel() - 1, device=rowptr.device),
        (rowptr[1:] - rowptr[:-1]).long())


def _abs_sums(keys, num_rows: int, num_features: int, terms, num_edges: int):
    """Σ over the edges of |terms(a, b)| ([b - a, F], edges [a, b)) into
    their rows keys[a:b], MASS_CHUNK edges at a time."""
    out = torch.zeros((num_rows, num_features), device=keys.device)
    for a in range(0, num_edges, MASS_CHUNK):
        b = min(a + MASS_CHUNK, num_edges)
        out.index_add_(0, keys[a:b], terms(a, b).abs_())
    return out


def k1_mass(operands, mode: str = "mul_rel") -> torch.Tensor:
    """The absolute mass of K1's sums: Σ |w · msg(rel, x)| into each output
    entry. ``operands`` is K1's (rowptr, src, etype, eid, w, rel, x)."""
    rowptr, src, etype, eid, w, rel, x = operands
    w_e = w.index_select(0, eid.long())
    src, etype = src.long(), etype.long()

    def terms(a, b):
        r, xs = rel.index_select(0, etype[a:b]), x.index_select(0, src[a:b])
        return (r * xs if mode == "mul_rel" else r + xs) * w_e[a:b, None]

    return _abs_sums(_csr_rows(rowptr), rowptr.numel() - 1, x.shape[1],
                     terms, src.numel())


def _sums64(keys, num_rows: int, num_features: int, terms,
            num_edges: int) -> tuple:
    """Σ over the edges of each of terms(a, b) (a tuple of float64 [b - a,
    F], edges [a, b)) into their rows keys[a:b], in float64,
    MASS_CHUNK edges at a time: the reference of a sum kernel's checks on
    hub rows, where a plain fp32 version's own rounding on the card (its
    index_add_ adds a row of 10^5 terms in any order) reaches the kernel's
    tolerance. Returns a tuple of float64 [num_rows, F], one a term."""
    out = None
    for a in range(0, num_edges, MASS_CHUNK):
        b = min(a + MASS_CHUNK, num_edges)
        parts = terms(a, b)
        if out is None:
            out = tuple(torch.zeros((num_rows, num_features),
                                    dtype=torch.float64, device=keys.device)
                        for _ in parts)
        for acc, t in zip(out, parts):
            acc.index_add_(0, keys[a:b], t)
    return out


def k1h_sums64(operands, mode: str = "mul_rel") -> torch.Tensor:
    """The plain K1h's sums (ops/rspmm_cuda.py::rspmm_fwd_bf16_plain: each
    message of the bf16 operands rounded to bf16, then weighted) taken in
    float64 (_sums64), as float64. ``operands`` is K1's (rowptr, src,
    etype, eid, w, rel, x)."""
    rowptr, src, etype, eid, w, rel, x = operands
    w_e = w.index_select(0, eid.long()).double()
    src, etype = src.long(), etype.long()

    def terms(a, b):
        r = rel.index_select(0, etype[a:b]).float()
        xs = x.index_select(0, src[a:b]).float()
        m = (r * xs if mode == "mul_rel" else r + xs).to(torch.bfloat16)
        return (m.double() * w_e[a:b, None],)

    return _sums64(_csr_rows(rowptr), rowptr.numel() - 1, x.shape[1], terms,
                   src.numel())[0]


def _k7_terms(csr, w, rel, x, absolute: bool):
    """K7's terms of edges [a, b) of the destination-sorted CSR in float64:
    (m · w, m · m · w), m = rel[r] ⊙ x[s] (their absolute values with
    ``absolute``)."""
    w_e = w.index_select(0, csr.eid.long()).double()
    src, etype = csr.src.long(), csr.etype.long()

    def terms(a, b):
        m = (rel.index_select(0, etype[a:b]).double()
             * x.index_select(0, src[a:b]).double())
        mw = m * w_e[a:b, None]
        out = (mw, m * mw)
        return tuple(t.abs_() for t in out) if absolute else out

    return terms


def k7_sums64(csr, w, rel, x) -> tuple:
    """K7's plain sums (s, sq) = (Σ m · w, Σ m · (m · w)), m = rel ⊙ x, each
    term and sum in float64 (_sums64), as float64."""
    return _sums64(_csr_rows(csr.rowptr), csr.rowptr.numel() - 1,
                   x.shape[1], _k7_terms(csr, w, rel, x, False),
                   csr.src.numel())


def k7_mass(csr, w, rel, x) -> tuple:
    """The absolute masses of K7's sums, (s's, sq's): Σ |m · w| and
    Σ |m · m · w| into each output entry, as float32."""
    return tuple(t.float() for t in _sums64(
        _csr_rows(csr.rowptr), csr.rowptr.numel() - 1, x.shape[1],
        _k7_terms(csr, w, rel, x, True), csr.src.numel()))


def k2_mass(csr, w, rel, x, g) -> tuple:
    """The absolute masses of K2's sums, (dx's, dr's): Σ |w · rel · g| into
    each dx entry and Σ |w · x · g| into each dr entry."""
    src = _csr_rows(csr.src_rowptr)
    dst, etype = csr.src_dst.long(), csr.src_etype.long()
    w_e = w.index_select(0, csr.src_eid.long())
    E, F = dst.numel(), g.shape[1]

    def dx_terms(a, b):
        return (rel.index_select(0, etype[a:b]) * g.index_select(0, dst[a:b])
                * w_e[a:b, None])

    def dr_terms(a, b):
        return (x.index_select(0, src[a:b]) * g.index_select(0, dst[a:b])
                * w_e[a:b, None])

    return (_abs_sums(src, x.shape[0], F, dx_terms, E),
            _abs_sums(etype, rel.shape[0], F, dr_terms, E))


def assert_mass_close(got, want, mass, rtol: float, atol: float,
                      label: str) -> float:
    """|got - want| <= atol + rtol |want| + MASS_ULPS mass, entry by entry
    (a NaN fails); returns the largest difference."""
    diff = (got - want).abs()
    ok = diff <= atol + rtol * want.abs() + MASS_ULPS * mass
    if not bool(torch.all(ok)):
        where = torch.nonzero(~ok)[0].tolist()
        raise AssertionError(
            f"{label}: differs from its plain version at {where}: "
            f"{got[tuple(where)].item()!r} vs {want[tuple(where)].item()!r} "
            f"(mass {mass[tuple(where)].item():.4g})")
    return diff.max().item() if diff.numel() else 0.0


def k2_half_times(k2, operands, iters: int = 20) -> dict:
    """K2's (or K2h's) halves each alone, ``k2(need_dx, need_dr)``, and each
    half's bound: dx reads the edges, g and rel and writes dx, dr reads the
    edges, x and g and writes dr (operands of their own size, 2 B for K2h's
    bf16; fp32 outputs), 3 operations an edge and feature each. Keys ms_dx,
    ms_dr, bound_ms_dx, bound_ms_dr. ``operands`` is K2's (csr, w, rel, x,
    g)."""
    _, w, rel, x, g = operands
    E, F, size = w.numel(), x.shape[1], x.element_size()
    return dict(
        ms_dx=cuda_time_ms(lambda: k2(True, False), iters),
        ms_dr=cuda_time_ms(lambda: k2(False, True), iters),
        bound_ms_dx=roofline_ms(edge_bytes(E) + (g.numel() + rel.numel())
                                * size + g.numel() * 4, 3 * E * F)[0],
        bound_ms_dr=roofline_ms(edge_bytes(E) + (x.numel() + g.numel())
                                * size + rel.numel() * 4, 3 * E * F)[0])


# per gather kernel: (node rows read, relation rows read, node rows
# written, relation rows written, fp32 operations per edge and feature).
# K4: message 2, extremum; K6: message 2, max, min; K7: message, weight,
# two sums, square; K6b: message 2, two gates, the gated sum g_mx + g_mn,
# one weighting, then dx and dr 2 each; K5: message 2, one gate, one
# weighting, dx and dr 2 each; K7b with w factored out and 2·g_sq formed
# once per node, c = w·(g_s + m·(2·g_sq)): message, product, sum,
# weighting, dx and dr 2 each; K3: the weighting g·w, shared by the dx and
# dr sums; K8f: the complex product (3 per real lane), the weight, the sum;
# K8b: the same for dx and for dr (its halves share no coefficient:
# K8B_HALVES)
GATHER_WORK = {"K4": (1, 1, 1, 0, 3), "K6": (1, 1, 2, 0, 4),
               "K7": (1, 1, 2, 0, 5), "K6b": (5, 1, 1, 1, 10),
               "K5": (3, 1, 1, 1, 8), "K7b": (3, 1, 1, 1, 8),
               "K3": (1, 0, 1, 1, 3), "K8f": (1, 1, 1, 0, 5),
               "K8b": (2, 1, 1, 1, 10)}
# K8b's halves alone, as GATHER_WORK's rows: dx reads g and rel, dr x and
# g, each with its own complex product, weight and sum
K8B_HALVES = {"dx": (1, 1, 1, 0, 5), "dr": (2, 0, 0, 1, 5)}


def gather_bound_ms(name: str, w, rel, x, half: str = "") -> tuple:
    """Least time for a gather kernel's work on this card (GATHER_WORK):
    its dense inputs read once and outputs written once, plus the edges,
    over the memory rate, against its fp32 operations over the fp32 peak.
    ``half`` "dx" or "dr" bounds a backward kernel's half alone: the same
    inputs (both halves recompute the coefficient), one output, and the
    other half's product and sum left out; K8b's halves as K8B_HALVES."""
    E, V, F = w.numel(), x.shape[0], x.shape[1]
    R = rel.shape[0]
    node_in, rel_in, node_out, rel_out, ops = GATHER_WORK[name]
    if half and name == "K8b":
        node_in, rel_in, node_out, rel_out, ops = K8B_HALVES[half]
    elif half == "dx":
        rel_out, ops = 0, ops - 2
    elif half == "dr":
        node_out, ops = 0, ops - 2
    rows = (node_in + node_out) * V + (rel_in + rel_out) * R
    return roofline_ms(edge_bytes(E) + rows * F * 4, ops * E * F)


def assert_bwd_close(got, want):
    """A two-pass backward kernel (K3, K5, K6b, K7b, K8b's dr) against its
    plain version: K2's tolerance, with the absolute one widened to 1e-5 of
    the result's largest entry: a dr row sums a thousand or more terms
    (K7b's carry x² and reach ~1e2), whose partial sums grow to that size,
    in another order than the plain version."""
    atol = max(1e-4, 1e-5 * want.abs().max().item())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=atol)


def _pna_coefficients(kind: str, mode: str, rel_e, x_e, w_e, planes_e):
    """K6b's (``argext_pair``), K5's (``argext``) or K7b's (``moments``)
    coefficient c of each edge, [n, F], from the edges' rel, x and weight
    and the planes at their destinations, as ops/rspmm_pna_cuda.py's plain
    version forms it, and the gates (a list of [n, F] bools; none for
    moments)."""
    w = w_e[:, None]
    if kind == "moments":
        m2 = (rel_e * x_e).mul_(2.0)
        return planes_e[0] * w + m2.mul_(planes_e[1] * w), []
    m = (rel_e * x_e if mode == "mul_rel" else rel_e + x_e) * w
    c, gates = torch.zeros_like(m), []
    for g, out in zip(planes_e[::2], planes_e[1::2]):
        gates.append(m == out)
        c += torch.where(gates[-1], g * w, 0.0)
    return c, gates


def _pna_chunks(kind: str, csr, w, rel, x, planes, mode: str):
    """Per MASS_CHUNK edges of the source-sorted CSR: (their source rows,
    types, rel rows, x rows, coefficients c, gates)."""
    src_all = _csr_rows(csr.src_rowptr)
    E = src_all.numel()
    for a in range(0, E, MASS_CHUNK):
        b = min(a + MASS_CHUNK, E)
        src, dst = src_all[a:b], csr.src_dst[a:b].long()
        etype = csr.src_etype[a:b].long()
        rel_e, x_e = rel.index_select(0, etype), x.index_select(0, src)
        c, gates = _pna_coefficients(
            kind, mode, rel_e, x_e, w.index_select(0, csr.src_eid[a:b].long()),
            [p.index_select(0, dst) for p in planes])
        yield src, etype, rel_e, x_e, c, gates


def pna_mass(kind: str, csr, w, rel, x, planes, mode: str) -> tuple:
    """The absolute masses of K6b's, K5's or K7b's sums, (dx's, dr's):
    Σ |rel · c| (|c| for add_rel) into each dx entry and Σ |x · c| (|c|)
    into each dr entry."""
    dx, dr = torch.zeros_like(x), torch.zeros_like(rel)
    for src, etype, rel_e, x_e, c, _ in _pna_chunks(kind, csr, w, rel, x,
                                                    planes, mode):
        mul = mode == "mul_rel"
        dx.index_add_(0, src, (rel_e * c if mul else c).abs_())
        dr.index_add_(0, etype, (x_e * c if mul else c).abs_())
    return dx, dr


def _conj_product_mass(a, b, dim: int) -> torch.Tensor:
    """|conj(a) ⊗ b|'s terms, entry by entry ([n, F] rows of blocks of
    ``dim``): |ar br| + |ai bi| in the real parts, |ar bi| + |ai br| in the
    imaginary parts."""
    a, b = (t.abs().unflatten(-1, (-1, dim)) for t in (a, b))
    h = dim // 2
    ar, ai, br, bi = a[..., :h], a[..., h:], b[..., :h], b[..., h:]
    return torch.cat([ar * br + ai * bi, ar * bi + ai * br], -1).flatten(-2)


def k8f_mass(operands, dim: int) -> torch.Tensor:
    """The absolute mass of K8f's sums: Σ |w| · |rel ⊗ x|'s terms into each
    output entry (_conj_product_mass: the same absolute terms).
    ``operands`` is K1's (rowptr, src, etype, eid, w, rel, x)."""
    rowptr, src, etype, eid, w, rel, x = operands
    w_e = w.index_select(0, eid.long())
    src, etype = src.long(), etype.long()

    def terms(a, b):
        return _conj_product_mass(rel.index_select(0, etype[a:b]),
                                  x.index_select(0, src[a:b]),
                                  dim) * w_e[a:b, None]

    return _abs_sums(_csr_rows(rowptr), rowptr.numel() - 1, x.shape[1],
                     terms, src.numel())


def rotate_mass(csr, w, rel, x, g, dim: int) -> tuple:
    """The absolute masses of K8b's sums, (dx's, dr's): Σ |w| ·
    |conj(rel) ⊗ g|'s terms into each dx entry and Σ |w| · |conj(x) ⊗ g|'s
    into each dr entry (_conj_product_mass)."""
    src = _csr_rows(csr.src_rowptr)
    dst, etype = csr.src_dst.long(), csr.src_etype.long()
    w_e = w.index_select(0, csr.src_eid.long())
    E, F = dst.numel(), g.shape[1]

    def dx_terms(a, b):
        return _conj_product_mass(rel.index_select(0, etype[a:b]),
                                  g.index_select(0, dst[a:b]),
                                  dim) * w_e[a:b, None]

    def dr_terms(a, b):
        return _conj_product_mass(x.index_select(0, src[a:b]),
                                  g.index_select(0, dst[a:b]),
                                  dim) * w_e[a:b, None]

    return (_abs_sums(src, x.shape[0], F, dx_terms, E),
            _abs_sums(etype, rel.shape[0], F, dr_terms, E))


def gate_skip_share(csr, w, rel, x, planes, mode: str, lanes: int = 4):
    """Of K6b's loads of g_mx and of g_mn, one per edge and thread
    (``lanes`` features, one 16-byte load), the share in which no feature
    passes its gate (the message equals the extremum): the loads that a
    design loading the extrema first and the gradients only where a gate
    passes would skip (timed and dropped: csrc/rspmm_pna_bwd.cu)."""
    skipped = total = 0
    F = x.shape[1] - x.shape[1] % lanes
    for *_, gates in _pna_chunks("argext_pair", csr, w, rel, x, planes,
                                 mode):
        for gate in gates:
            groups = gate[:, :F].reshape(gate.shape[0], -1, lanes)
            skipped += int((~groups.any(-1)).sum())
            total += groups.shape[0] * groups.shape[1]
    return skipped / max(total, 1)


def pna_half_times(run, kid: str, w, rel, x, iters: int = 20) -> dict:
    """A two-pass backward kernel's halves each alone (K6b, K7b, K5,
    K8b), ``run(need_dx, need_dr)``, and each half's bound
    (gather_bound_ms). Keys ms_dx, ms_dr, bound_ms_dx, bound_ms_dr."""
    return dict(
        ms_dx=cuda_time_ms(lambda: run(True, False), iters),
        ms_dr=cuda_time_ms(lambda: run(False, True), iters),
        bound_ms_dx=gather_bound_ms(kid, w, rel, x, "dx")[0],
        bound_ms_dr=gather_bound_ms(kid, w, rel, x, "dr")[0])


def sparse_mm_halves(csr, w):
    """K3's function (the transe backward) as two library calls, timed
    beside K3 and never used by the port: dx = Aᵀ g and dr = T g, with
    Aᵀ[s, v] and T[r, v] the summed weights of the edges s → v and of the
    type-r edges into v, as coalesced CSR tensors. Returns (Aᵀ, T)."""
    V, R = csr.src_rowptr.numel() - 1, csr.rel_chunk_ptr.numel() - 1
    counts = (csr.src_rowptr[1:] - csr.src_rowptr[:-1]).long()
    src = torch.repeat_interleave(
        torch.arange(V, device=counts.device), counts)
    dst, etype = csr.src_dst.long(), csr.src_etype.long()
    weight = w.index_select(0, csr.src_eid.long())
    return tuple(
        torch.sparse_coo_tensor(torch.stack([rows, dst]), weight,
                                (n, V)).coalesce().to_sparse_csr()
        for rows, n in ((src, V), (etype, R)))


def k3_half_times(k3, at, t, grad, num_edges: int, iters: int = 20) -> dict:
    """K3's halves each alone, ``k3(need_dx, need_dr)``, beside
    torch.sparse.mm's halves (``at``, ``t`` from sparse_mm_halves) on the
    same g, and each half's bound: g read once, its output written once,
    the edges; a product and a sum per edge and feature. Keys ms_dx,
    ms_dr, library_ms_dx, library_ms_dr, library_ms (their sum),
    bound_ms_dx, bound_ms_dr."""
    out = dict(
        ms_dx=cuda_time_ms(lambda: k3(True, False), iters),
        ms_dr=cuda_time_ms(lambda: k3(False, True), iters),
        library_ms_dx=cuda_time_ms(lambda: torch.sparse.mm(at, grad), iters),
        library_ms_dr=cuda_time_ms(lambda: torch.sparse.mm(t, grad), iters))
    out["library_ms"] = out["library_ms_dx"] + out["library_ms_dr"]
    (V, F), E = grad.shape, num_edges
    for half, rows in (("dx", V), ("dr", t.shape[0])):
        out[f"bound_ms_{half}"] = roofline_ms(
            edge_bytes(E) + (V + rows) * F * 4, 2 * E * F)[0]
    return out


def k9_times(shift, plain, x: torch.Tensor, n: int, iters: int = 50) -> dict:
    """K9 (``shift()``, the ring shift of the n blocks of x) beside its
    plain version (``plain()``), torch.cat of the rotated blocks (its
    library call, the views made once, outside the timing) and torch.roll,
    all queued ahead of the device, and K9 and torch.cat at the host's
    pace; every time the lesser of two readings in turns
    (times_in_turns). The bound: every byte read and written once. Keys
    ms, plain_ms, library_ms, roll_ms, host_paced_ms,
    library_host_paced_ms, bound_ms, bound_by."""
    blocks = list(x.chunk(n))
    rotated = [blocks[(s - 1) % n] for s in range(n)]
    vb = x.shape[0] // n
    queued = times_in_turns(dict(
        ms=shift, plain_ms=plain, library_ms=lambda: torch.cat(rotated),
        roll_ms=lambda: torch.roll(x, vb, dims=0)), iters, queue_ahead=True)
    paced = times_in_turns(dict(
        host_paced_ms=shift,
        library_host_paced_ms=lambda: torch.cat(rotated)), iters)
    bound_ms, bound_by = roofline_ms(2 * x.numel() * x.element_size(), 0)
    return dict(**queued, **paced, bound_ms=bound_ms, bound_by=bound_by)


def gpu_query() -> dict:
    """The card's name, power limit and current SM clock as nvidia-smi
    reports them (``--query-gpu=name,power.limit,clocks.sm``), and the
    SM count from PyTorch."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    name, power, clock = (s.strip() for s in
                          out.stdout.strip().splitlines()[0].split(","))
    return dict(name=name, power_limit=power, sm_clock=clock,
                sm_clock_hz=float(clock.split()[0]) * 1e6,
                sm_count=torch.cuda.get_device_properties(
                    0).multi_processor_count)
