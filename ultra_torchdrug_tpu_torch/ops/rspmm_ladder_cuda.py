"""The K1 strip-down ladder (csrc/rspmm_ladder.cu): variants of the rspmm
forward row kernel that each drop or change one per-edge ingredient, and the
plain PyTorch version of every variant.

The card's counterpart of the TPU probes P1
(script/diagnostics/kernel_floor.py::run_variant, ``pallas_call`` :350) and
P2 (script/diagnostics/blocked_ladder.py::main, :333 and :370). Only the
tools in ``diagnostics/`` call it; no model, task or op routes here.

Over K1's destination-sorted CSR (rowptr / src / etype / eid), x [V_in, F],
relation [R, F] and edge_weight [E] in original edge order, every variant
returns out [V, F] fp32:

    full      Σ w[eid]·rel[r]⊙x[s]      K1's own row kernel
    noweight  Σ rel[r]⊙x[s]             no eid or weight load
    norel     Σ w·x[s]                  no etype or relation load
    statrow   Σ w·rel[r]⊙x[0]           every gather hits row 0
    floor     Σ w·x[0]                  the metadata walk and one FMA
    multiacc  full, 4 accumulator sets per thread
    packed    full from one int32 (src << shift | etype) per edge and the
              weights in CSR order (no eid hop)
    direct    full by one float atomicAdd per edge and feature
    drrmw     full, and dr [R, F] = Σ by edge type of w·rel[r]⊙x[s] by
              atomics; returns (out, dr)
    nowrite   full, whose store is behind a flag: with write=False the
              caller's ``out`` stays as it was
    split     full from row segments of at most SPLIT_EDGES edges, the
              partial sums added in segment order by a second pass
    ftile     full with 64-thread feature tiles

``ladder_cuda`` launches the variant for CUDA tensors and counts each call
in ``launches[variant]``; for CPU tensors it runs ``ladder_plain`` and
counts nothing. ``check_variant`` holds a result against the plain version;
``check_ragged`` holds a variant to all of its checks on
``ragged_operands``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from ..data.graph import DR_CHUNK_EDGES, build_csr
from .cuda_build import load_library
from .rspmm_cuda import _check, check_fwd_operands, csr_rows, rspmm_fwd_cuda

VARIANTS = ("full", "noweight", "norel", "statrow", "floor", "multiacc",
            "packed", "direct", "drrmw", "nowrite", "split", "ftile")
# split's segment length: the rows are cut as K2 cuts its relation chunks
SPLIT_EDGES = DR_CHUNK_EDGES
# what each variant sums per edge: (weighted, with relation, x row 0 only);
# every other variant sums K1's terms
_TERMS = {"noweight": (False, True, False), "norel": (True, False, False),
          "statrow": (True, True, True), "floor": (True, False, True)}
_K1_TERMS = (True, True, False)
# variants whose result equals full's bitwise (the same sums in the same
# order)
BITWISE_FULL = ("packed", "ftile")

# Tolerance against the plain version (K1's, 1e-5), plus a rounding
# allowance of 8 fp32 ulps of the row's absolute mass Σ|term|: both sides
# sum in fp32 in different orders, and on a hub row of 10^5 edges that
# difference reaches about 1e-5 of the row's largest entry (two orders of
# 107,150 N(0, 1)^3 terms differ by up to 1.1e-5 of it, and by up to 2.4
# ulps of the mass in a numpy simulation), where a wrong or missing edge
# moves the row by a whole term
RTOL = ATOL = 1e-5
MASS_ULPS = 8 * torch.finfo(torch.float32).eps
# drrmw's dr: 1e-4 of its largest entry (a dr row sums about E / R terms)
DR_TOL = 1e-4
# plain versions take the edges in chunks of this many, to bound the
# [chunk, F] intermediates at the tools' full sizes
PLAIN_CHUNK = 1 << 16
# ragged_operands' last rows, which have no edges
RAGGED_EMPTY = 5

# calls that launched each variant since import (or since the caller last
# reset them)
launches = dict.fromkeys(VARIANTS, 0)


@dataclasses.dataclass(frozen=True)
class LadderOperands:
    """K1's operands and the per-variant layouts derived from them, on one
    device. ``dst`` is each CSR edge's row (direct), ``weight_csr`` the
    weights in CSR order and ``packed`` the (src << shift | etype) words
    (packed; None where they do not fit 31 bits), ``seg_ptr`` [S + 1] the
    segments of at most SPLIT_EDGES edges of each row and ``row_seg_ptr``
    [V + 1] each row's segments (split)."""

    rowptr: torch.Tensor
    src: torch.Tensor
    etype: torch.Tensor
    eid: torch.Tensor
    weight: torch.Tensor
    relation: torch.Tensor
    x: torch.Tensor
    dst: torch.Tensor
    weight_csr: torch.Tensor
    packed: Optional[torch.Tensor]
    shift: int
    seg_ptr: torch.Tensor
    row_seg_ptr: torch.Tensor

    @property
    def num_rows(self) -> int:
        return self.rowptr.numel() - 1

    @property
    def num_edges(self) -> int:
        return self.src.numel()


def split_segments(rowptr: torch.Tensor, seg_edges: int = SPLIT_EDGES):
    """(seg_ptr [S + 1], row_seg_ptr [V + 1]), int32: each row's edges cut
    into segments of at most ``seg_edges``; rows without edges own none."""
    counts = (rowptr[1:] - rowptr[:-1]).long()
    per_row = (counts + seg_edges - 1) // seg_edges
    row_seg_ptr = torch.zeros(rowptr.numel(), dtype=torch.long,
                              device=rowptr.device)
    torch.cumsum(per_row, 0, out=row_seg_ptr[1:])
    seg_row = torch.repeat_interleave(
        torch.arange(per_row.numel(), device=rowptr.device), per_row)
    local = torch.arange(seg_row.numel(), device=rowptr.device) - (
        row_seg_ptr[seg_row])
    seg_ptr = torch.cat([rowptr.long()[seg_row] + local * seg_edges,
                         rowptr.long()[-1:]])
    return seg_ptr.int(), row_seg_ptr.int()


def ladder_operands(rowptr, src, etype, eid, edge_weight, relation,
                    x) -> LadderOperands:
    """The ladder's operands on the tensors' device, from K1's."""
    num_types = relation.shape[0]
    shift = max(1, (num_types - 1).bit_length())
    fits = x.shape[0] == 0 or ((x.shape[0] - 1) << shift) < 2 ** 31
    packed = (src.long() << shift | etype.long()).int() if fits else None
    seg_ptr, row_seg_ptr = split_segments(rowptr)
    return LadderOperands(
        rowptr=rowptr, src=src, etype=etype, eid=eid, weight=edge_weight,
        relation=relation, x=x, dst=csr_rows(rowptr).int(),
        weight_csr=edge_weight.index_select(0, eid.long()), packed=packed,
        shift=shift, seg_ptr=seg_ptr, row_seg_ptr=row_seg_ptr)


def ragged_operands(F: int, seed: int, device, hub: int = 700
                    ) -> LadderOperands:
    """Ladder operands at a ragged shape: 40 rows, the last RAGGED_EMPTY
    without edges, row 3 with ``hub`` of 1,200 in-edges (three split
    segments at 700), eid the original edge order (not the identity);
    weights, relation [6, F] and x [40, F] N(0, 1), all from numpy's
    generator seeded with ``seed``."""
    rng = np.random.default_rng(seed)
    V, E, R = 40, 1200, 6
    dst = rng.permutation(np.concatenate(
        [np.full(hub, 3), rng.integers(0, V - RAGGED_EMPTY, E - hub)]))
    csr = build_csr(rng.integers(0, V, E), dst, rng.integers(0, R, E), V,
                    R).to(device)
    w, rel, x = (torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(
        device) for s in ((E,), (R, F), (V, F)))
    return ladder_operands(csr.rowptr, csr.src, csr.etype, csr.eid, w, rel,
                           x)


def check_ragged(variant: str, ops: LadderOperands) -> float:
    """``variant`` on ``ops`` (ragged_operands) against its plain version
    (check_variant), with its rows without edges 0; full bitwise equal to
    K1 (ops/rspmm_cuda.py), packed, ftile and nowrite bitwise equal to
    full, and nowrite with write=False leaving its output as filled.
    Returns the max error; raises AssertionError."""
    got = ladder_cuda(variant, ops)
    err = check_variant(variant, got, ladder_plain(variant, ops),
                        rounding_mass(variant, ops))
    out = got[0] if variant == "drrmw" else got
    if not torch.all(out[-RAGGED_EMPTY:] == 0):
        raise AssertionError(f"{variant}: rows without edges are not 0")
    full = ladder_cuda("full", ops)
    if variant in BITWISE_FULL + ("nowrite",) and not torch.equal(out, full):
        raise AssertionError(f"{variant} differs from full bitwise")
    if variant == "full" and not torch.equal(full, rspmm_fwd_cuda(
            ops.rowptr, ops.src, ops.etype, ops.eid, ops.weight,
            ops.relation, ops.x, "mul_rel")):
        raise AssertionError("full differs from K1")
    if variant == "nowrite":
        fill = torch.full_like(full, 3.0)
        if not torch.equal(ladder_cuda(variant, ops, out=fill.clone(),
                                       write=False), fill):
            raise AssertionError("nowrite wrote with write=False")
    return err


def check_variant_name(variant: str):
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got "
                         f"{variant!r}")


def terms_of(variant: str) -> tuple:
    """(weighted, with relation, x row 0 only): the terms a variant sums."""
    check_variant_name(variant)
    return _TERMS.get(variant, _K1_TERMS)


def _edge_sums(ops: LadderOperands, weighted: bool, with_rel: bool,
               static_row: bool, by_type: bool = False,
               absolute: bool = False) -> torch.Tensor:
    """Σ over the CSR's edges of [w ·] [rel[r] ⊙] x[s or 0] (each term's
    absolute value with ``absolute``) into its destination row, or into its
    edge type's row with ``by_type``: index_select, the product and
    index_add_, as K1's plain version (ops/rspmm_cuda.py::rspmm_plain_edges)
    forms it, PLAIN_CHUNK edges at a time."""
    x, rel = ops.x, ops.relation
    keys = ops.etype if by_type else ops.dst
    out = x.new_zeros((rel.shape[0] if by_type else ops.num_rows,
                       x.shape[1]))
    for a in range(0, ops.num_edges, PLAIN_CHUNK):
        b = min(a + PLAIN_CHUNK, ops.num_edges)
        if static_row:
            term = x[:1].expand(b - a, -1)
        else:
            term = x.index_select(0, ops.src[a:b].long())
        if with_rel:
            term = rel.index_select(0, ops.etype[a:b].long()) * term
        if weighted:
            term = term * ops.weight_csr[a:b, None]
        out.index_add_(0, keys[a:b].long(), term.abs() if absolute else term)
    return out


def ladder_plain(variant: str, ops: LadderOperands,
                 out: Optional[torch.Tensor] = None, write: bool = True):
    """The variant's function in plain PyTorch: out [V, F]; for drrmw
    (out, dr); for nowrite with write=False, ``out`` as given."""
    check_variant_name(variant)
    if variant == "nowrite" and not write:
        if out is None:
            raise ValueError("nowrite with write=False needs out")
        return out
    res = _edge_sums(ops, *terms_of(variant))
    if out is not None:
        res = out.copy_(res)
    if variant == "drrmw":
        return res, _edge_sums(ops, *_K1_TERMS, by_type=True)
    return res


def rounding_mass(variant: str, ops: LadderOperands) -> torch.Tensor:
    """Σ of |term| into each output entry: the scale of the fp32 rounding
    of a sum of those terms in any order."""
    return _edge_sums(ops, *terms_of(variant), absolute=True)


def check_variant(variant: str, got, want, mass: torch.Tensor) -> float:
    """Max |got − want| of a variant against its plain version (drrmw: of
    out and of dr relative to dr's largest entry, the larger); raises
    AssertionError beyond the tolerance: RTOL and ATOL plus MASS_ULPS of
    ``mass`` (rounding_mass) per entry for the sums, DR_TOL of the largest
    entry for dr."""
    check_variant_name(variant)
    dr_err = 0.0
    if variant == "drrmw":
        (got, got_dr), (want, want_dr) = got, want
        scale = want_dr.abs().max().item() if want_dr.numel() else 0.0
        dr_err = (got_dr - want_dr).abs().max().item() if want_dr.numel() \
            else 0.0
        if not dr_err <= DR_TOL * max(scale, 1.0):
            raise AssertionError(f"drrmw: dr differs by {dr_err:.3g} from "
                                 f"its plain version (largest entry "
                                 f"{scale:.3g})")
        dr_err /= max(scale, 1.0)
    if got.shape != want.shape:
        raise AssertionError(f"{variant}: shape {tuple(got.shape)}, expected "
                             f"{tuple(want.shape)}")
    diff = (got - want).abs()
    bound = ATOL + RTOL * want.abs() + MASS_ULPS * mass
    if not bool(torch.all(diff <= bound)):  # NaN fails too
        where = torch.nonzero(~(diff <= bound))[0].tolist()
        raise AssertionError(
            f"{variant}: differs from its plain version at {where}: "
            f"{got[tuple(where)].item()!r} vs {want[tuple(where)].item()!r}")
    err = diff.max().item() if diff.numel() else 0.0
    return max(err, dr_err)


def ladder_cuda(variant: str, ops: LadderOperands,
                out: Optional[torch.Tensor] = None, write: bool = True):
    """The variant on CUDA tensors (the plain version on CPU tensors). out
    [V, F] fp32 may be given (nowrite with write=False leaves it as it
    was); direct and drrmw zero their outputs first. Returns out, or (out,
    dr) for drrmw."""
    check_variant_name(variant)
    if ops.x.device.type == "cpu":
        return ladder_plain(variant, ops, out, write)
    num_rows, num_features = check_fwd_operands(
        "the ladder", ops.rowptr, ops.src, ops.etype, ops.eid, ops.weight,
        ops.relation, ops.x)
    device = ops.x.device
    col, weight = ops.src, ops.weight
    if variant == "packed":
        if ops.packed is None:
            raise ValueError("packed: (src << shift | etype) does not fit "
                             "31 bits")
        col, weight = ops.packed, ops.weight_csr
    for name, t in (("dst", ops.dst), ("seg_ptr", ops.seg_ptr),
                    ("row_seg_ptr", ops.row_seg_ptr), ("col", col)):
        _check(name, t, torch.int32, device, 1)
    _check("weight_csr", ops.weight_csr, torch.float32, device, 1)
    if out is None:
        out = torch.empty((num_rows, num_features), dtype=torch.float32,
                          device=device)
    _check("out", out, torch.float32, device, 2)
    if tuple(out.shape) != (num_rows, num_features):
        raise ValueError(f"out must be {(num_rows, num_features)}, got "
                         f"{tuple(out.shape)}")
    scratch = None
    if variant == "direct":
        out.zero_()
    elif variant == "drrmw":
        scratch = torch.zeros_like(ops.relation)
    elif variant == "split":
        scratch = torch.empty((ops.seg_ptr.numel() - 1, num_features),
                              dtype=torch.float32, device=device)
    fn = _kernel()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(VARIANTS.index(variant), ops.rowptr.data_ptr(),
                 col.data_ptr(), ops.etype.data_ptr(), ops.eid.data_ptr(),
                 weight.data_ptr(), ops.relation.data_ptr(),
                 ops.x.data_ptr(), out.data_ptr(),
                 None if scratch is None else scratch.data_ptr(),
                 ops.dst.data_ptr(), ops.seg_ptr.data_ptr(),
                 ops.row_seg_ptr.data_ptr(), num_rows, num_features,
                 ops.num_edges, ops.seg_ptr.numel() - 1, ops.shift,
                 int(write), float("nan"), stream)
    if err != 0:
        raise RuntimeError(f"rspmm_ladder {variant} launch failed with CUDA "
                           f"error {err}")
    launches[variant] += 1
    return (out, scratch) if variant == "drrmw" else out


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = load_library("rspmm_ladder").rspmm_ladder
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 12
                   + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn
