"""The port's K14 tile-partials entries and the point-sorted grid vs the JAX
package (float64, CPU).

The tiny blocked problem tiled with `finalize_blocks(rb=8, prb=16, ts=64,
prb2_cap=0)` in both packages (the two-grid configuration, as in
tests/test_torch_two_grid.py) has a rig grid of 10 tiles and a point-sorted
second grid of 9, with pad slots at the end of tiles. On the CPU the port's
K14 wrappers take their plain versions and the JAX entries their XLA
branches (one-hot einsums).

  * the port's own finalize_blocks builds the point-sorted grid
    (`_pt_perm`, `_pt_w`, `_pt_local`, `_pt_inv`, `_pt_rows`, `_pt_base`) and
    the grid geometry equal to the JAX package's, exactly, on both blockings;
  * K14a-e, gather_tiles and scatter_partials against the JAX entries on both
    grids, random payloads that are nonzero on the pad slots too: 1e-12
    relative to the JAX result's max-abs;
  * the run lists of the tile kernels cover every slot once, in slot order;
  * the matvec composed from the tile kernels (profile_matvec.tile_matvec)
    against the JAX package's rcs.matvec on the same state: 1e-10;
  * the data flow of the redesigned K14b (the flat float4 walk: slot f // D,
    column, tile slot // ts, the N D % 4 tail) and of the tile pass K14a,
    K14c and K14e share (the tile's run list loaded once, rows cut into
    pieces summed by warps in the kernel's order, warp partials summed in
    warp order): K14e's J^T u staged a chunk at a time, K14a's column tiles
    read in the piece walk, K14c's wu = w (J x_row) for every slot (0
    outside the window) and J^T wu staged; written as torch ops, against the
    JAX entries seg_gather_from_tiles, seg_mv_scatter, seg_reduce_partials
    and seg_mv_fused on both grids (K14b also on a grid whose ts is not a
    multiple of 4; the pass also with small chunks and pieces): 1e-12;
  * each variant of tile_variants applies to the source.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_fixtures import (TWO_GRID_BLOCKS, jax_active_cfgs, jax_problem,
                                  jax_two_grid_problem, port_blocked_problem,
                                  port_two_grid_problem, rel, t)

from visual_inertial_bundle_adjustment_tpu.ops import segments as jseg
from visual_inertial_bundle_adjustment_tpu.problem import engine as jeng
from visual_inertial_bundle_adjustment_tpu.problem import rcs as jrcs
from visual_inertial_bundle_adjustment_tpu.problem import structure as jst
from visual_inertial_bundle_adjustment_tpu_torch import profile_matvec as pm
from visual_inertial_bundle_adjustment_tpu_torch.ops import _kernels
from visual_inertial_bundle_adjustment_tpu_torch.ops import segments as tseg
from visual_inertial_bundle_adjustment_tpu_torch.problem import structure as tst

TOL = 1e-12
GRID_KEYS = ("_pt_perm", "_pt_w", "_pt_local", "_pt_inv", "_pt_rows", "_pt_base", "_rb_local",
             "_rb_base", "_pad", "rig", "point")
TILE_KERNELS = ("reduce_partials", "gather_from_tiles", "mv_fused", "mv_gather", "mv_scatter")


def _blocked_data(p):
    (vi,) = [i for i, c in enumerate(p.cfgs) if getattr(c, "block_info", None)]
    return p.cfgs[vi].block_info, p.datas[vi]


@pytest.mark.parametrize("blocking", ["two_grid", "single_pass"])
def test_point_grid_equals_jax(blocking):
    pj = jax_two_grid_problem() if blocking == "two_grid" else jax_problem()
    pt = port_blocked_problem(blocks=TWO_GRID_BLOCKS if blocking == "two_grid" else None)
    info_j, dj = _blocked_data(pj)
    info_t, dt = _blocked_data(pt)
    for f in ("rb", "nt", "ts", "prb", "pnt", "pts", "prb2", "nhg", "wb"):
        assert getattr(info_t, f) == getattr(info_j, f), f
    for k in GRID_KEYS:
        np.testing.assert_array_equal(dt[k].numpy(), np.asarray(dj[k]), err_msg=k)
    rows = tseg._rows_from_bases(dt["_rb_base"], info_t.nt, info_t.rb)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(dj["_rb_rows"]))
    assert torch.equal(tseg._rows_from_bases(dt["_pt_base"], info_t.pnt, info_t.prb),
                       dt["_pt_rows"])


@functools.lru_cache(maxsize=None)
def _grids():
    """Both grids of the JAX two-grid batch as (local, bases, nt, ts, rb,
    n_rows), and random payloads (nonzero on pad slots too)."""
    pj = jax_two_grid_problem()
    info, d = _blocked_data(pj)
    R, L = pj.variables.pose_q.shape[0], pj.variables.points.shape[0]
    grids = {"rig": (np.asarray(d["_rb_local"]), np.asarray(d["_rb_base"]), info.nt, info.ts,
                     info.rb, R),
             "point": (np.asarray(d["_pt_local"]), np.asarray(d["_pt_base"]), info.pnt,
                       info.pts, info.prb, L)}
    rng = np.random.default_rng(71)
    pay = {}
    for name, (_, _, nt, ts, rb, n_rows) in grids.items():
        n = nt * ts
        pay[name] = dict(contrib=rng.normal(size=(9, n)), J3=rng.normal(size=(2, 3, n)),
                         J6=rng.normal(size=(2, 6, n)), w=rng.uniform(0.5, 1.5, size=n),
                         u=rng.normal(size=(2, n)), xt3=rng.normal(size=(nt, rb, 3)),
                         xt6=rng.normal(size=(nt, rb, 6)), table=rng.normal(size=(n_rows, 4)),
                         part=rng.normal(size=(nt, rb, 4)))
    return grids, pay


def _entry(name, grid, k, side):
    """(output tuple) of one entry on `side` ('jax' or 'port')."""
    grids, pay = _grids()
    local, bases, nt, ts, rb, n_rows = grids[grid]
    a = pay[grid]
    if side == "jax":
        arr, m = jnp.asarray, jseg
        loc, rows = jnp.asarray(local), jseg._rows_from_bases(jnp.asarray(bases), nt, rb)
    else:
        arr, m = t, tseg
        loc, rows = torch.from_numpy(local), tseg._rows_from_bases(torch.from_numpy(bases), nt,
                                                                   rb)
    J, xt = arr(a.get(f"J{k}", a["J3"])), arr(a.get(f"xt{k}", a["xt3"]))
    if name == "reduce_partials":
        return (m.seg_reduce_partials(arr(a["contrib"][:k]), loc, nt, ts, rb),)
    if name == "gather_from_tiles":
        return (m.seg_gather_from_tiles(xt, loc, nt, ts, rb),)
    if name == "mv_fused":
        return m.seg_mv_fused(J, arr(a["w"]), xt, loc, nt, ts, rb)
    if name == "mv_gather":
        return (m.seg_mv_gather(J, xt, loc, nt, ts, rb),)
    if name == "mv_scatter":
        return (m.seg_mv_scatter(J, arr(a["u"]), loc, nt, ts, rb),)
    if name == "gather_tiles":
        return (m.gather_tiles(arr(a["table"]), rows, nt, rb),)
    return (m.scatter_partials(arr(a["part"]), rows, n_rows, rb),)


@pytest.mark.parametrize("name,k", [
    ("reduce_partials", 9), ("reduce_partials", 3), ("gather_from_tiles", 3),
    ("gather_from_tiles", 6), ("mv_fused", 6), ("mv_fused", 3), ("mv_gather", 3),
    ("mv_gather", 6), ("mv_scatter", 3), ("mv_scatter", 6), ("gather_tiles", 0),
    ("scatter_partials", 0)])
@pytest.mark.parametrize("grid", ["rig", "point"])
def test_tile_entries_match_jax(name, k, grid):
    out_j = _entry(name, grid, k, "jax")
    out_t = _entry(name, grid, k, "port")
    assert len(out_t) == len(out_j)
    for ot, oj in zip(out_t, out_j):
        assert np.abs(np.asarray(oj)).max() > 0
        assert rel(ot.numpy(), oj) < TOL


@pytest.mark.parametrize("grid", ["rig", "point"])
def test_run_lists_cover_every_slot_in_order(grid):
    """The run list of a grid lists each slot whose local index addresses a
    row exactly once, under its (tile, row), runs in slot order; a local
    index outside [0, rb) is in no run."""
    grids, _ = _grids()
    local, _, nt, ts, rb, _ = grids[grid]
    local = local.copy()
    local[5] = rb  # addresses nothing
    plan = tseg.tile_plan(torch.from_numpy(local), nt, ts, rb)
    ptr, start, length = (a.numpy().astype(np.int64) for a in plan)
    assert ptr.shape == (nt * rb + 1,) and ptr[-1] == len(start)
    seen = np.zeros(nt * ts, np.int64)
    for row in range(nt * rb):
        slots = np.concatenate([np.arange(start[q], start[q] + length[q])
                                for q in range(ptr[row], ptr[row + 1])] + [np.zeros(0, int)])
        assert np.all(np.diff(slots) > 0)
        assert np.all(slots // ts == row // rb) and np.all(local[slots] == row % rb)
        seen[slots] += 1
    np.testing.assert_array_equal(seen, (local >= 0) & (local < rb))


def test_cpu_tensors_take_the_plain_versions_and_count_nothing():
    _kernels.reset_launch_counts()
    for name, k in (("reduce_partials", 9), ("gather_from_tiles", 3), ("mv_fused", 6),
                    ("mv_gather", 3), ("mv_scatter", 3)):
        _entry(name, "point", k, "port")
    counts = _kernels.launch_counts()
    assert set(TILE_KERNELS) <= set(counts) and all(n == 0 for n in counts.values())


@functools.lru_cache(maxsize=None)
def _jax_system():
    pj = jax_two_grid_problem()
    cfgs = jax_active_cfgs(pj)
    datas = tuple(pj.datas)
    lg = jax.jit(lambda d, v, m: jeng.linearize(cfgs, d, v, m))(datas, pj.variables, pj.masks)
    asm = jrcs.assemble(cfgs, datas, lg, pj.variables, pj.masks)
    return pj, jrcs.with_damping(asm, pj.variables, pj.masks, 1e-4, precond="identity")


def test_tile_matvec_matches_jax():
    """The two-grid matvec composed from K14c, K14e, K14d and
    scatter_partials (plus the rest graph and damping) equals the JAX
    package's rcs.matvec on the same state, and the profile's own checks
    (K14a landmark blocks, K14b slot steps) hold."""
    pj, rs_j = _jax_system()
    p = port_two_grid_problem()
    ctx = pm.setup(p)
    rng = np.random.default_rng(73)
    zt = tst.zero_tangent(p.variables)
    x = {f: rng.normal(size=tuple(getattr(zt, f).shape)) for f in zt._fields}
    _kernels.reset_launch_counts()
    y_t = pm.tile_matvec(ctx, tst.Tangent(**{f: t(a) for f, a in x.items()}))
    y_j = jrcs.matvec(rs_j, pj.variables, jst.Tangent(**{f: jnp.asarray(a) for f, a in x.items()}))
    for f in y_j._fields:
        assert rel(getattr(y_t, f).numpy(), getattr(y_j, f)) < 1e-10, f
    errs = pm.check(ctx, tst.Tangent(**{f: t(a) for f, a in x.items()}),
                    t(rng.normal(size=tuple(p.variables.points.shape))))
    assert all(e < TOL for e in errs.values()), errs


# ---------------------------------------------------------------------------
# The redesigned K14b and K14e: their data flow as torch ops (f64)
# ---------------------------------------------------------------------------

# csrc/tile_segments.cu: warps of a CTA, slots of a row piece (K14e, K14c;
# K14a's), staged floats of a chunk
WARPS, PIECE, REDUCE_PIECE, STAGE_FLOATS = 8, 512, 128, 12288


def _gather_flow(xt, local, nt, ts, rb):
    """K14b's flat walk (tile_gather_flat): float4 v of the (N, D) output
    holds floats f = 4v .. 4v + 3; at D >= 3 they span slots a = f // D and
    a + 1 (column ca + i of a while below D, else column ca + i - D of
    a + 1), below 3 each float's slot is its own f // D; the last N D % 4
    floats one by one. A float reads row local[slot] of tile slot // ts, 0
    where local is outside [0, rb)."""
    D = xt.shape[-1]
    n, nf = nt * ts, nt * ts * D
    nv = nf // 4
    flat_xt, loc = xt.reshape(-1), local.long()

    def row_val(slot, col):
        lo = loc[slot]
        ok = (lo >= 0) & (lo < rb)
        return torch.where(ok, flat_xt[((slot // ts) * rb + lo.clamp(0, rb - 1)) * D + col], 0.0)

    out = xt.new_full((nf,), float("nan"))
    f = 4 * torch.arange(nv)
    sa = f // D
    ca = f - sa * D
    for i in range(4):
        if D >= 3:
            c = ca + i
            first = c < D
            slot = torch.where(first, sa, (sa + 1).clamp(max=n - 1))
            out[f + i] = row_val(slot, torch.where(first, c, c - D))
        else:
            s = (f + i) // D
            out[f + i] = row_val(s, f + i - s * D)
    tail = torch.arange(4 * nv, nf)
    out[tail] = row_val(tail // D, tail % D)
    return out.reshape(n, D)


def _odd_grid():
    """Three tiles of 67 slots (not a multiple of 4) in a 16-row window,
    unsorted locals in [-1, 16] (-1 and 16 address nothing)."""
    rng = np.random.default_rng(79)
    return rng.integers(-1, 17, size=3 * 67).astype(np.int32), 3, 67, 16


@pytest.mark.parametrize("grid,D", [("rig", 3), ("rig", 6), ("point", 3), ("point", 6),
                                    ("odd", 1), ("odd", 3)])
def test_gather_flow_matches_jax(grid, D):
    """K14b's flat walk equals the JAX seg_gather_from_tiles (XLA branch) on
    the rig and point grids and on a grid whose ts is not a multiple of 4
    (N D with a tail), 1e-12 relative."""
    if grid == "odd":
        local, nt, ts, rb = _odd_grid()
        xt = np.random.default_rng(83).normal(size=(nt, rb, D))
    else:
        grids, pay = _grids()
        local, _, nt, ts, rb, _ = grids[grid]
        xt = pay[grid][f"xt{D}"]
    want = np.asarray(jseg.seg_gather_from_tiles(jnp.asarray(xt), jnp.asarray(local), nt, ts, rb))
    got = _gather_flow(t(xt), torch.from_numpy(np.array(local)), nt, ts, rb)
    assert np.abs(want).max() > 0 and not torch.isnan(got).any()
    assert rel(got.numpy(), want) < TOL


def _butterfly(acc):
    """Lane 0's total of (32, k) lane sums after the xor butterfly
    (tile_reduce.cuh group_sum<32>)."""
    off = 16
    while off:
        acc = acc + acc[torch.arange(32) ^ off]
        off //= 2
    return acc[0]


def _tile_flow(c, local, nt, ts, rb, chunk, piece=PIECE):
    """The pass K14a, K14c and K14e share (tile_pass) over per-slot columns
    c (W, N): per tile, the tile's run list loaded once; per chunk of the
    tile's slots (chunk = ts: one chunk, as K14a's direct reads), each row's
    slots (its runs concatenated in slot order) cut into pieces of `piece`
    at fixed offsets from the row's start, piece i of row r summed by warp
    (r + i) % WARPS: within a run, clipped to the chunk, lane j takes the
    run's slots j, j + 32, ...; the warp's butterfly total added to its
    partial of the row, chunk by chunk; the row's partial the sum of the
    warps' partials in warp order."""
    W = c.shape[0]
    run_ptr, run_start, run_len = (a.long() for a in tseg.tile_plan(local, nt, ts, rb))
    part = c.new_zeros((nt, rb, W))
    for tile in range(nt):
        q0, q1 = int(run_ptr[tile * rb]), int(run_ptr[(tile + 1) * rb])
        runs = list(zip((run_start[q0:q1] - tile * ts).tolist(), run_len[q0:q1].tolist()))
        ptr = (run_ptr[tile * rb:(tile + 1) * rb + 1] - q0).tolist()
        n_row = [sum(ln for _, ln in runs[ptr[r]:ptr[r + 1]]) for r in range(rb)]
        pp = c.new_zeros((WARPS, rb, W))
        for c0 in range(0, ts, chunk):
            cn = min(chunk, ts - c0)
            cs = c[:, tile * ts + c0:tile * ts + c0 + cn]  # the chunk's values
            for r in range(rb):
                for w in range(WARPS):
                    pieces = range((w - r) % WARPS, -(-n_row[r] // piece), WARPS)
                    if not pieces:
                        continue
                    acc = c.new_zeros((32, W))
                    for i in pieces:
                        lo, hi = i * piece, min((i + 1) * piece, n_row[r])
                        a = 0
                        for s0, ln in runs[ptr[r]:ptr[r + 1]]:
                            x_lo = max(lo, a, a + c0 - s0)
                            x_hi = min(hi, a + ln, a + c0 + cn - s0)
                            if x_lo < x_hi:
                                x = torch.arange(x_lo, x_hi)
                                acc.index_add_(0, (x - x_lo) % 32, cs[:, s0 + x - a - c0].T)
                            a += ln
                    pp[w, r] += _butterfly(acc)
        part[tile] = pp[0]
        for w in range(1, WARPS):
            part[tile] = part[tile] + pp[w]
    return part


def _stage_chunk(W, ts):
    """Slots a chunk stages (tile_segments.cu stage_chunk)."""
    return min(ts, STAGE_FLOATS // W // 32 * 32)


def _mv_scatter_flow(J, u, local, nt, ts, rb, chunk=None, piece=PIECE):
    """K14e's flow (tile_scatter_staged): c_s = J_s^T u_s staged a chunk at a
    time, then the shared pass."""
    k = J.shape[1]
    return _tile_flow((J * u[:, None]).sum(0), local, nt, ts, rb,
                      chunk or _stage_chunk(k, ts), piece)


def _reduce_partials_flow(contrib, local, nt, ts, rb, chunk=None, piece=REDUCE_PIECE):
    """K14a's flow (tile_reduce_split): contrib's D columns in column tiles
    of W (3 for D <= 3, else 9; the last tile padded with zero columns), each
    through the shared pass, contrib read in the piece walk (one chunk of
    the whole tile)."""
    D, n = contrib.shape
    W = 3 if D <= 3 else 9
    n_tiles = -(-D // W)
    padded = torch.cat([contrib, contrib.new_zeros((n_tiles * W - D, n))])
    return torch.cat([_tile_flow(padded[y * W:(y + 1) * W], local, nt, ts, rb, chunk or ts,
                                 piece) for y in range(n_tiles)], dim=-1)[..., :D]


def _mv_fused_flow(J, w, xt, local, nt, ts, rb, chunk=None, piece=PIECE):
    """K14c's flow (tile_fused_staged): per slot, x_row = xt[tile, local]
    (0 for a local outside [0, rb)), wu = w (J x_row) for every slot; c_s =
    J_s^T wu_s staged a chunk at a time, then the shared pass."""
    k, n = J.shape[1], J.shape[2]
    loc = local.long()
    ok = (loc >= 0) & (loc < rb)
    row = (torch.arange(n) // ts) * rb + loc.clamp(0, rb - 1)
    x = torch.where(ok[:, None], xt.reshape(-1, k)[row], 0.0)  # (N, k)
    wu = (J * x.T[None]).sum(1) * w[None]
    return wu, _tile_flow((J * wu[:, None]).sum(0), local, nt, ts, rb,
                          chunk or _stage_chunk(k, ts), piece)


@pytest.mark.parametrize("chunk,piece", [(None, PIECE), (24, 8)])
@pytest.mark.parametrize("k", [3, 6])
@pytest.mark.parametrize("grid", ["rig", "point"])
def test_mv_scatter_flow_matches_jax(grid, k, chunk, piece):
    """K14e's flow equals the JAX seg_mv_scatter (XLA branch) on the rig and
    point grids, at the kernel's chunk and piece sizes and at small ones
    (rows cut into many pieces across the warps, runs clipped to chunks),
    1e-12 relative."""
    grids, pay = _grids()
    local, _, nt, ts, rb, _ = grids[grid]
    J, u = pay[grid][f"J{k}"], pay[grid]["u"]
    want = np.asarray(jseg.seg_mv_scatter(jnp.asarray(J), jnp.asarray(u), jnp.asarray(local),
                                          nt, ts, rb))
    got = _mv_scatter_flow(t(J), t(u), torch.from_numpy(np.array(local)), nt, ts, rb, chunk,
                           piece)
    assert np.abs(want).max() > 0
    assert rel(got.numpy(), want) < TOL


@pytest.mark.parametrize("chunk,piece", [(None, REDUCE_PIECE), (24, 8)])
@pytest.mark.parametrize("D", [9, 12])
@pytest.mark.parametrize("grid", ["rig", "point"])
def test_reduce_partials_flow_matches_jax(grid, D, chunk, piece):
    """K14a's flow (pieces across warps in warp order, column tiles of 9:
    one at D 9, two at D 12) equals the JAX seg_reduce_partials (XLA
    branch) on the rig and point grids, at the kernel's sizes (the whole
    tile, pieces of 128) and at small chunks and pieces, 1e-12 relative."""
    grids, _ = _grids()
    local, _, nt, ts, rb, _ = grids[grid]
    contrib = np.random.default_rng(89).normal(size=(D, nt * ts))
    want = np.asarray(jseg.seg_reduce_partials(jnp.asarray(contrib), jnp.asarray(local), nt, ts,
                                               rb))
    got = _reduce_partials_flow(t(contrib), torch.from_numpy(np.array(local)), nt, ts, rb, chunk,
                                piece)
    assert got.shape == want.shape and np.abs(want).max() > 0
    assert rel(got.numpy(), want) < TOL


@pytest.mark.parametrize("chunk,piece", [(None, PIECE), (24, 8)])
@pytest.mark.parametrize("k", [3, 6])
@pytest.mark.parametrize("grid", ["rig", "point"])
def test_mv_fused_flow_matches_jax(grid, k, chunk, piece):
    """K14c's flow equals the JAX seg_mv_fused (XLA branch) on the rig and
    point grids, wu and partials, with a few locals moved outside the
    window (-1 and rb: their wu is 0 and they sum into no row), at the
    kernel's chunk and piece sizes and at small ones, 1e-12 relative."""
    grids, pay = _grids()
    local, _, nt, ts, rb, _ = grids[grid]
    local = local.copy()
    local[[3, ts + 7]] = -1, rb
    a = pay[grid]
    J, xt = a[f"J{k}"], a[f"xt{k}"]
    want = jseg.seg_mv_fused(jnp.asarray(J), jnp.asarray(a["w"]), jnp.asarray(xt),
                             jnp.asarray(local), nt, ts, rb)
    got = _mv_fused_flow(t(J), t(a["w"]), t(xt), torch.from_numpy(local), nt, ts, rb, chunk,
                         piece)
    wu = np.asarray(want[0])
    assert wu[:, [3, ts + 7]].max() == 0 == np.abs(got[0][:, [3, ts + 7]].numpy()).max()
    for g, wnt in zip(got, want):
        assert np.abs(np.asarray(wnt)).max() > 0
        assert rel(g.numpy(), wnt) < TOL


def test_tile_variants_apply_to_the_source():
    """Each variant of tile_variants (one choice of the kept tile pass undone:
    K14e's, K14a's and K14c's) is an edit that applies once to the current
    csrc/tile_segments.cu and concerns kernels the script times; the kept
    design is the source itself; every kernel of the pass has variants."""
    from visual_inertial_bundle_adjustment_tpu_torch import tile_variants as tv

    source = tv.SOURCE.read_text()
    assert set(tv.VARIANTS) > {"kept"}
    for name, (edits, kernels, _) in tv.VARIANTS.items():
        assert (tv.variant_source(edits) == source) == (name == "kept"), name
        assert kernels and set(kernels) <= set(tv.ENTRIES), name
    for kernel in tv.ENTRIES:
        assert sum(kernel in kernels for _, kernels, _ in tv.VARIANTS.values()) >= 3, kernel
