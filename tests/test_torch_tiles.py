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
    against the JAX package's rcs.matvec on the same state: 1e-10.
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
