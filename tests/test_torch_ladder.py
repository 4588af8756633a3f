"""The K1 strip-down ladder (the port's P1 and P2) on the CPU: its workloads
against the TPU scripts' draws and bench.py's, the plain versions against
the TPU ladder's kernels in interpret mode, the JAX package's
generalized_rspmm and a float64 numpy formula, and both tools end to end
with ``--device cpu``.

Tolerances, each with its reason:
  * rtol = atol = 1e-5 for every sum: the same fp32 terms summed in another
    order (the TPU kernel's telescoping row sums, segment_sum, the
    port's index_add_), at most a few hundred terms a row here;
  * against numpy in float64: the same 1e-5, the port summing in fp32;
  * drrmw's dr against numpy: 1e-5 of its largest entry (a dr row sums
    about E / R terms);
  * bitwise where the port computes the same sums in the same order
    (nowrite with write=True and full; chunked plain versions and K1's).
"""

import dataclasses
import hashlib
import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from bench import build_workload as bench_build_workload
from ultra_torchdrug_tpu.ops.csr import build_rspmm_layouts
from ultra_torchdrug_tpu.ops.rspmm import generalized_rspmm as j_rspmm
from ultra_torchdrug_tpu_torch.data.graph import build_csr
from ultra_torchdrug_tpu_torch.diagnostics import (
    blocked_ladder,
    kernel_floor,
    workloads,
)
from ultra_torchdrug_tpu_torch.ops import rspmm_cuda
from ultra_torchdrug_tpu_torch.ops import rspmm_ladder_cuda as ladder

REPO = Path(__file__).resolve().parent.parent
TOL = dict(rtol=1e-5, atol=1e-5)
# P1 at a tiny size: 2 chunks of 64 edges, runs of 8 within 8 rows
FLOOR = dict(E=128, runlen=8, F=256, V=64, R=8, te=64, tv=8)
# P2's generator at a small size
SMALL = dict(V=64, E=512, R=6, B=2, D=4)


def _tpu_kernel_floor():
    """script/diagnostics/kernel_floor.py (a script, not a package)."""
    spec = importlib.util.spec_from_file_location(
        "tpu_kernel_floor", REPO / "script/diagnostics/kernel_floor.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _run_tpu_variant(wl, variant, meta):
    """The TPU kernel of ``variant`` on P1's arrays in interpret mode, with
    run_variant's grid spec (kernel_floor.py:334-356), called once."""
    kf = _tpu_kernel_floor()
    C, _, te = wl.meta.shape
    V, ft, lane = wl.data.shape
    R, tv = wl.rel.shape[0], FLOOR["tv"]
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1,
        grid=(C,),
        in_specs=[
            pl.BlockSpec(memory_space=pl.ANY),
            pl.BlockSpec(memory_space=pl.ANY),
            pl.BlockSpec((V, ft, lane), lambda c, cr: (0, 0, 0),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec((R, ft, lane), lambda c, cr: (0, 0, 0),
                         memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((tv, ft, lane), lambda c, cr: (cr[0, c], 0, 0),
                               memory_space=pltpu.VMEM),
        scratch_shapes=[
            pltpu.SMEM((2, 4, te), jnp.int32),
            pltpu.SMEM((2, 1, te), jnp.float32),
            pltpu.SemaphoreType.DMA((2,)),
            pltpu.SemaphoreType.DMA((2,)),
            pltpu.VMEM((ft, lane), jnp.float32),
        ],
    )
    call = pl.pallas_call(
        kf.make_kernel(variant, C), grid_spec=grid_spec,
        out_shape=jax.ShapeDtypeStruct((tv, ft, lane), jnp.float32),
        interpret=True)
    out = call(jnp.asarray(wl.cr), jnp.asarray(meta), jnp.asarray(wl.w),
               jnp.asarray(wl.data), jnp.asarray(wl.rel))
    return np.asarray(out).reshape(tv, ft * lane)


def _floor_ops(wl):
    return kernel_floor.floor_operands(wl, "cpu")


def _plain(variant, ops):
    return ladder.ladder_plain(variant, ops).numpy()


@pytest.fixture(scope="module")
def floor_wl():
    return workloads.kernel_floor_workload(**FLOOR)


# (TPU variant, its meta, the port's variant, whether the TPU writes the sum
# of every row into row 0)
TPU_CASES = [
    ("v0_current", "meta", "full", False),
    ("v3_multiacc4", "meta", "multiacc", False),
    ("v6_packed", "meta6", "packed", False),
    ("v8_direct_packed", "meta8", "packed", False),
    ("v7_direct", "meta", "direct", False),
    ("v2_noscalar", "meta", "noweight", False),
    ("v1_nobranch", "meta", "full", True),
    ("v4_pure_fma", "meta", "floor", True),
]


@pytest.mark.parametrize("tpu,meta,port,row0", TPU_CASES,
                         ids=[c[0] for c in TPU_CASES])
def test_plain_matches_tpu_kernel_floor(floor_wl, tpu, meta, port, row0):
    """P1's TPU kernels in interpret mode against the port's plain
    versions on the same draws: the sums row by row, or, for the variants
    without a row flush, their row 0 against the sum over the rows."""
    got = _plain(port, _floor_ops(floor_wl))
    want = _run_tpu_variant(floor_wl, tpu, getattr(floor_wl, meta))
    if row0:
        np.testing.assert_allclose(want[0], got.sum(0), **TOL)
    else:
        np.testing.assert_allclose(got, want, **TOL)


def test_kernel_floor_workload_matches_run_variant_draws(floor_wl):
    """The same numpy draws, in the same order, as run_variant: the TPU
    arrays, the packed words, and the edges of K1's CSR."""
    wl = floor_wl
    rng = np.random.default_rng(0)
    C, te = FLOOR["E"] // FLOOR["te"], FLOOR["te"]
    for c in range(C):
        np.testing.assert_array_equal(
            wl.meta[c, 0], rng.integers(0, FLOOR["V"], te))
        np.testing.assert_array_equal(
            wl.meta[c, 1], rng.integers(0, FLOOR["R"], te))
    np.testing.assert_array_equal(
        wl.w, rng.normal(size=(C, 1, te)).astype(np.float32))
    np.testing.assert_array_equal(
        wl.data, rng.normal(size=(FLOOR["V"], 2, 128)).astype(np.float32))
    assert wl.cr.tolist() == [[0, 0], [1, 0]]
    assert np.all(np.diff(wl.meta[:, 2], axis=1) >= 0)
    np.testing.assert_array_equal(wl.meta6[:, 0] >> 18, wl.meta[:, 0])
    np.testing.assert_array_equal(wl.meta8[:, 0] & 1023, wl.meta[:, 2])
    # the CSR holds every edge once, by chunk-local row
    rowptr = wl.csr.rowptr.numpy()
    assert rowptr[-1] == FLOOR["E"]
    eid = wl.csr.eid.numpy()
    np.testing.assert_array_equal(np.sort(eid), np.arange(FLOOR["E"]))
    np.testing.assert_array_equal(wl.csr.src.numpy(),
                                  wl.meta[:, 0].reshape(-1)[eid])
    # at the defaults every row takes 2,048 edges; v8's packing does not fit
    assert workloads.kernel_floor_workload(
        E=16384, te=8192).meta8 is None


def test_build_workload_is_bench_copy():
    got = workloads.build_workload(**SMALL)
    want = bench_build_workload(**SMALL)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    tri, rel, x = workloads.build_workload(**SMALL, features=False)
    np.testing.assert_array_equal(tri, want[0])
    assert rel is None and x is None


def _small_case():
    """bench.py's KG at a small size, with N(0, 1) weights, relation and
    x from numpy, flat over F = B * D."""
    tri, _, _ = workloads.build_workload(**SMALL, features=False)
    rng = np.random.default_rng(7)
    F = SMALL["B"] * SMALL["D"]
    w = rng.normal(size=len(tri)).astype(np.float32)
    rel = rng.normal(size=(SMALL["R"], F)).astype(np.float32)
    x = rng.normal(size=(SMALL["V"], F)).astype(np.float32)
    csr = build_csr(tri[:, 0], tri[:, 1], tri[:, 2], SMALL["V"], SMALL["R"])
    ops = ladder.ladder_operands(csr.rowptr, csr.src, csr.etype, csr.eid,
                                 torch.from_numpy(w), torch.from_numpy(rel),
                                 torch.from_numpy(x))
    return tri, w, rel, x, ops


@pytest.fixture(scope="module")
def small_case():
    return _small_case()


# the distinct plain functions: every other variant's plain version is
# full's (the card tests hold those kernels to it, and packed and ftile to
# full's result bitwise)
DISTINCT = ("full", "noweight", "norel", "statrow", "floor", "drrmw")


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_k1_variants_match_jax_rspmm(small_case, impl):
    """full's plain version (through the wrapper on CPU tensors), which
    every K1-sum variant is held to, against the JAX package's
    generalized_rspmm: segment ops, and interpret-mode Pallas on a blocked
    layout."""
    tri, w, rel, x, ops = small_case
    layouts = None
    if impl == "pallas":
        layouts = build_rspmm_layouts(tri[:, :2], tri[:, 2], SMALL["V"],
                                      SMALL["R"], tile_rows=16, tile_edges=32,
                                      blocked=True, block_rows=16)
        assert layouts.fwd_blk is not None
    want = j_rspmm(jnp.asarray(tri[:, :2]), jnp.asarray(tri[:, 2]),
                   jnp.asarray(w), jnp.asarray(rel), jnp.asarray(x),
                   msg="mul", agg="add", num_nodes=SMALL["V"], impl=impl,
                   layouts=layouts)
    before = dict(ladder.launches)
    got = ladder.ladder_cuda("full", ops).numpy()
    assert ladder.launches == before  # CPU tensors launch nothing
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def _numpy_formula(variant, tri, w, rel, x, V):
    """Each variant's function in float64 numpy, from the edge list."""
    src, dst, et = tri[:, 0], tri[:, 1], tri[:, 2]
    w64, rel64, x64 = (a.astype(np.float64) for a in (w, rel, x))
    xs = x64[np.zeros_like(src)] if variant in ("statrow", "floor") \
        else x64[src]
    term = xs if variant in ("norel", "floor") else rel64[et] * xs
    if variant != "noweight":
        term = term * w64[:, None]
    out = np.zeros((V, x.shape[1]))
    np.add.at(out, dst, term)
    return out


@pytest.mark.parametrize("variant", DISTINCT)
def test_plain_versions_match_numpy(small_case, variant):
    """Each distinct plain version against its formula in float64 numpy
    on bench.py's KG at a small size (hub rows, empty rows); drrmw's dr
    against its sum by edge type."""
    tri, w, rel, x, ops = small_case
    want = _numpy_formula(variant, tri, w, rel, x, SMALL["V"])
    got = ladder.ladder_plain(variant, ops)
    if variant == "drrmw":
        got, dr = got
        want_dr = np.zeros(rel.shape)
        np.add.at(want_dr, tri[:, 2], (rel[tri[:, 2]] * x[tri[:, 0]]).astype(
            np.float64) * w[:, None])
        np.testing.assert_allclose(dr.numpy(), want_dr, rtol=0,
                                   atol=1e-5 * np.abs(want_dr).max())
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    mass = ladder.rounding_mass(variant, ops)
    assert ladder.check_variant(variant, (got, dr) if variant == "drrmw"
                                else got,
                                ladder.ladder_plain(variant, ops), mass) == 0


def test_full_plain_is_k1_plain(small_case):
    """full's chunked plain version sums as K1's plain version does: on the
    CPU, bitwise; with chunks smaller than the edge count too."""
    _, _, _, _, ops = small_case
    want = rspmm_cuda.rspmm_fwd_plain(ops.rowptr, ops.src, ops.etype,
                                      ops.eid, ops.weight, ops.relation,
                                      ops.x, "mul_rel")
    assert torch.equal(ladder.ladder_plain("full", ops), want)
    chunk = ladder.PLAIN_CHUNK
    try:
        ladder.PLAIN_CHUNK = 100
        assert torch.equal(ladder.ladder_plain("full", ops), want)
    finally:
        ladder.PLAIN_CHUNK = chunk


def test_operands_pack_and_split(small_case):
    """packed words decode to (src, etype); weight_csr is w through eid;
    split's segments hold at most SPLIT_EDGES edges, never cross a row and
    cover every row's edges in order; dst is each CSR edge's row."""
    _, _, _, _, ops = small_case
    mask = (1 << ops.shift) - 1
    assert torch.equal(ops.packed >> ops.shift, ops.src)
    assert torch.equal(ops.packed & mask, ops.etype)
    assert torch.equal(ops.weight_csr, ops.weight[ops.eid.long()])
    rowptr = torch.tensor([0, 0, 300, 556, 557, 557, 1000])
    seg_ptr, row_seg_ptr = ladder.split_segments(rowptr)
    assert seg_ptr.tolist() == [0, 256, 300, 556, 557, 813, 1000]
    assert row_seg_ptr.tolist() == [0, 0, 2, 3, 4, 4, 6]
    rows = torch.repeat_interleave(torch.arange(6),
                                   rowptr[1:] - rowptr[:-1])
    assert torch.equal(ladder.ladder_operands(
        rowptr.int(), torch.zeros(1000, dtype=torch.int32),
        torch.zeros(1000, dtype=torch.int32),
        torch.arange(1000, dtype=torch.int32), torch.ones(1000),
        torch.ones(2, 4), torch.ones(3, 4)).dst, rows.int())


def test_check_variant_catches_a_missing_edge():
    """On a hub row of 4,000 edges the tolerance admits another summation
    order but not a dropped edge, nor a NaN."""
    rng = np.random.default_rng(3)
    E, F = 4000, 64
    src = rng.integers(0, 50, E)
    csr = build_csr(src, np.zeros(E, np.int64), rng.integers(0, 4, E), 2, 4)
    ops = ladder.ladder_operands(
        csr.rowptr, csr.src, csr.etype, csr.eid,
        torch.from_numpy(rng.normal(size=E).astype(np.float32)),
        torch.from_numpy(rng.normal(size=(4, F)).astype(np.float32)),
        torch.from_numpy(rng.normal(size=(50, F)).astype(np.float32)))
    want = ladder.ladder_plain("full", ops)
    mass = ladder.rounding_mass("full", ops)
    reordered = ladder.ladder_plain("full", _reversed_rows(ops))
    assert not torch.equal(reordered, want)
    ladder.check_variant("split", reordered, want, mass)
    t = (ops.relation[ops.etype[7].long()] * ops.x[ops.src[7].long()]
         * ops.weight_csr[7])
    with pytest.raises(AssertionError, match="differs from its plain"):
        ladder.check_variant("split", want - t, want, mass)
    bad = want.clone()
    bad[1, 3] = float("nan")
    with pytest.raises(AssertionError):
        ladder.check_variant("full", bad, want, mass)


def _reversed_rows(ops):
    """The same edges in the reverse order within each row."""
    order = torch.cat([torch.arange(int(b) - 1, int(a) - 1, -1)
                       for a, b in zip(ops.rowptr[:-1], ops.rowptr[1:])])
    return dataclasses.replace(ops, src=ops.src[order], etype=ops.etype[order],
                               eid=ops.eid[order],
                               weight_csr=ops.weight_csr[order])


def _digest(path: Path) -> str:
    return hashlib.sha256(path.read_bytes()).hexdigest()


def test_tools_run_on_cpu(tmp_path, capsys):
    """Both tools with --device cpu at a tiny size: every variant's line,
    the JSON under --out, and the TPU ladder's KERNEL_LADDER.json
    untouched; --out KERNEL_LADDER.json is refused."""
    tpu_json = REPO / "KERNEL_LADDER.json"
    before = _digest(tpu_json)
    res = kernel_floor.main(["--device", "cpu", "--variants", "all",
                             "--edges", "128", "--te", "64", "--tv", "8",
                             "--vrows", "64", "--feat", "256",
                             "--relations", "8", "--runlen", "8"])
    assert set(res["variants"]) == set(ladder.VARIANTS)
    assert all(r["ms"] is None and r["max_abs_err"] == 0
               for r in res["variants"].values())
    out = tmp_path / "ladder.json"
    blocked_ladder.main(["--device", "cpu", "--nodes", "300", "--edges",
                         "4000", "--relations", "12", "--feat", "64",
                         "--out", str(out)])
    data = json.loads(out.read_text())
    assert list(data["variants"]) == blocked_ladder.DEFAULT_VARIANTS.split(
        ",")
    assert data["workload"]["E"] == 4000 and data["device"] is None
    assert data["workload"]["max_in_degree"] >= 4000 // 300
    lines = capsys.readouterr().out.splitlines()
    assert sum(line.startswith("[ladder] kernel_floor ") for line in lines) \
        == len(ladder.VARIANTS)
    with pytest.raises(ValueError, match="TPU ladder"):
        blocked_ladder.main(["--device", "cpu", "--out",
                             str(tmp_path / "KERNEL_LADDER.json")])
    assert _digest(tpu_json) == before


def test_tools_default_to_the_card():
    """Without --device the tools run on the card; with none they raise
    instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the tools would run on it")
    for tool in (kernel_floor, blocked_ladder):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tool.main([])


def test_unknown_variant_raises(small_case):
    _, _, _, _, ops = small_case
    with pytest.raises(ValueError, match="variant must be one of"):
        ladder.ladder_cuda("v0_current", ops)
    with pytest.raises(ValueError, match="variant must be one of"):
        kernel_floor.parse_variants("full,nobranch")
    assert kernel_floor.parse_variants("all") == list(ladder.VARIANTS)
