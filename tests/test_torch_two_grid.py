"""The port's general (two-grid) solver path vs the JAX package (float64, CPU).

The tiny blocked problem is tiled with `finalize_blocks(rb=8, prb=16, ts=64,
prb2_cap=0)` in both packages: no per-tile landmark window fits, so the JAX
package solves it on its two-grid path (a rig grid plus a point-sorted second
grid reached through permutations) and the port on its general path (K12,
K13 over CSR lists of the rig-ordered arrays). On the CPU the port's wrappers
take their plain versions and the JAX entries their XLA branches.

  * seg_mv_fused_table, seg_mv_scatter_table, seg_mv_gather_table and
    seg_reduce_table on the rig grid and on the landmark grid: 1e-9 relative
    to the JAX result's max-abs (same sums, other order);
  * H_ll0, g_r, g_l, diag_r and the damped matvec: 1e-10;
  * the preconditioner: the JAX two-grid path accumulates the visual rig
    blocks and their Schur correction in bfloat16 even on the CPU, the port
    in the problem's type. So the port's lambda-free rig blocks agree with
    the JAX two-grid ones only to bfloat16 rounding, stated here as 2^-7 of
    the blocks' max-abs (one rounding of each per-observation product at
    2^-9 relative, summed over a rig's observations), and the port's inverse
    blocks agree with the JAX *generic* engine's (no bfloat16) to 1e-9;
  * with other preconditioners the 40-iteration PCG iterates differ, so the
    solve is compared at convergence (rel_tol 1e-13; the reduced system of
    this problem needs ~550 iterations, so the cap is 1,000): 1e-6;
  * optimize() run to the same converged cost: 1e-6.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_fixtures import (BLOCKS, TWO_GRID_BLOCKS, jax_active_cfgs,
                                  jax_two_grid_problem, port_blocked_problem,
                                  port_two_grid_problem, rel, t)

from visual_inertial_bundle_adjustment_tpu.ops import segments as jseg
from visual_inertial_bundle_adjustment_tpu.problem import engine as jeng
from visual_inertial_bundle_adjustment_tpu.problem import optimizer as jopt
from visual_inertial_bundle_adjustment_tpu.problem import rcs as jrcs
from visual_inertial_bundle_adjustment_tpu.problem import structure as jst
from visual_inertial_bundle_adjustment_tpu_torch.ops import _kernels
from visual_inertial_bundle_adjustment_tpu_torch.ops import segments as tseg
from visual_inertial_bundle_adjustment_tpu_torch.problem import optimizer as topt
from visual_inertial_bundle_adjustment_tpu_torch.problem import rcs as trcs
from visual_inertial_bundle_adjustment_tpu_torch.problem import structure as tst

TOL = 1e-9
LAM = 1e-4
BF16_BLOCKS = 2.0 ** -7
PCG_CAP = 1000
TABLE_KERNELS = ("mv_fused_table", "mv_scatter_table", "mv_gather_table", "reduce_table")


def _fields(a, b, tol, what):
    for f in b._fields:
        assert rel(getattr(a, f).numpy(), getattr(b, f)) <= tol, (what, f)


def _jax_blocked_data():
    pj = jax_two_grid_problem()
    (vi,) = [i for i, c in enumerate(pj.cfgs) if getattr(c, "block_info", None)]
    return pj.datas[vi]


@functools.lru_cache(maxsize=None)
def _jax_state():
    """(problem, cfgs, lg, VisBatch, Lin, asm) of the JAX two-grid problem."""
    pj = jax_two_grid_problem()
    cfgs = jax_active_cfgs(pj)
    datas = tuple(pj.datas)
    lg = jax.jit(lambda d, v, m: jeng.linearize(cfgs, d, v, m))(datas, pj.variables, pj.masks)
    (b, lin), = jrcs._vis_batches(cfgs, datas, lg)
    assert not jrcs._single_pass(b) and b.groups == ("rig",) and b.J_pt_po is not None
    asm = jrcs.assemble(cfgs, datas, lg, pj.variables, pj.masks)
    return pj, cfgs, lg, b, lin, asm


@functools.lru_cache(maxsize=None)
def _port_state():
    p = port_two_grid_problem()
    ks = p._build()
    datas = tuple(p.datas)
    lg = ks[0](datas, p.variables, p.masks, None)
    return p, lg, ks[6](datas, lg, p.variables, p.masks)


def test_port_blocking_goes_two_grid_too():
    """The port's own finalize_blocks with prb2_cap=0 records no landmark
    window, and its batch takes the general path."""
    p = port_blocked_problem(blocks=TWO_GRID_BLOCKS)
    (info,) = [c.block_info for c in p.cfgs if c.block_info is not None]
    assert info.prb2 == 0 and info.nhg == 0
    ref = port_blocked_problem()
    (info1,) = [c.block_info for c in ref.cfgs if c.block_info is not None]
    assert info1.prb2 > 0 and dataclasses.replace(info, prb2=info1.prb2, nhg=info1.nhg) == info1
    _, _, asm = _port_state()
    (b,) = asm.vis
    assert not trcs._single_pass(b) and b.groups == ("rig",) and b.cplan is None
    assert BLOCKS["ts"] == TWO_GRID_BLOCKS["ts"]


# ---------------------------------------------------------------------------
# K12 / K13 plain versions vs the JAX entries, on both grids
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _table_inputs():
    """numpy inputs shared by both sides: the JAX batch's Jacobians and
    weights, random tables and payloads (contrib zero on the padded slots,
    as every caller's is)."""
    pj, _, _, b, _, _ = _jax_state()
    R, L = pj.variables.pose_q.shape[0], pj.variables.points.shape[0]
    N = b.w.shape[0]
    rng = np.random.default_rng(41)
    pad = np.asarray(_jax_blocked_data()["_pad"])
    return dict(J=np.asarray(b.jac[0]), J_pt=np.asarray(b.J_pt), w=np.asarray(b.w), pad=pad,
                x=rng.normal(size=(R, 6)), z=rng.normal(size=(L, 3)),
                u=rng.normal(size=(2, N)),
                contrib={D: rng.normal(size=(D, N)) * (1.0 - pad)[None] for D in (3, 9, 36)})


def _jax_table(name, grid, a, D=3):
    """The JAX entry on its XLA branch; point-grid results that live on the
    point-sorted grid are brought back to the rig order."""
    _, _, _, b, _, _ = _jax_state()
    i = b.info
    rig = (b.rb_local, b.rb_base, i.nt, i.ts, i.rb)
    pts = (b.pt_local, b.pt_base, i.pnt, i.pts, i.prb)
    R, L = a["x"].shape[0], a["z"].shape[0]
    J, w = jnp.asarray(a["J"]), jnp.asarray(a["w"])
    if name == "mv_fused_table":
        return jseg.seg_mv_fused_table(J, w, jnp.asarray(a["x"]), *rig)
    if name == "mv_scatter_table":
        u = jnp.asarray(a["u"])
        if grid == "rig":
            return jseg.seg_mv_scatter_table(J, u, *rig, R)
        return jseg.seg_mv_scatter_table(b.J_pt_po, jrcs.permute_cols(u, b.pt_perm), *pts, L)
    if name == "mv_gather_table":
        if grid == "rig":
            return jseg.seg_mv_gather_table(J, jnp.asarray(a["x"]), *rig)
        u_po = jseg.seg_mv_gather_table(b.J_pt_po, jnp.asarray(a["z"]), *pts)
        return jrcs.permute_cols(u_po, b.pt_inv) * (1.0 - a["pad"])[None]
    c = jnp.asarray(a["contrib"][D])
    if grid == "rig":
        return jseg.seg_reduce_table(c, *rig, R)
    pw = _jax_blocked_data()["_pt_w"]
    return jseg.seg_reduce_table(jrcs.permute_cols(c, b.pt_perm) * pw[None], *pts, L)


def _port_table(name, grid, a, plan, D=3):
    rows = tseg.rig_rows(plan) if grid == "rig" else tseg.point_rows(plan)
    J = t(a["J"]) if grid == "rig" else t(a["J_pt"])
    if name == "mv_fused_table":
        return tseg.seg_mv_fused_table(J, t(a["w"]), t(a["x"]), rows)
    if name == "mv_scatter_table":
        return tseg.seg_mv_scatter_table(J, t(a["u"]), rows)
    if name == "mv_gather_table":
        return tseg.seg_mv_gather_table(J, t(a["x"] if grid == "rig" else a["z"]), rows)
    return tseg.seg_reduce_table(t(a["contrib"][D]), rows)


@pytest.mark.parametrize("name,grid,D", [
    ("mv_fused_table", "rig", 0), ("mv_scatter_table", "rig", 0),
    ("mv_scatter_table", "point", 0), ("mv_gather_table", "rig", 0),
    ("mv_gather_table", "point", 0), ("reduce_table", "rig", 3), ("reduce_table", "rig", 36),
    ("reduce_table", "point", 3), ("reduce_table", "point", 9)])
def test_table_plain_matches_jax(name, grid, D):
    a = _table_inputs()
    p, _, _ = _port_state()
    (vi,) = [i for i, c in enumerate(p.cfgs) if c.block_info is not None]
    out_j = _jax_table(name, grid, a, D)
    out_t = _port_table(name, grid, a, trcs.plan_of(p.datas[vi]), D)
    out_j = out_j if isinstance(out_j, tuple) else (out_j,)
    out_t = out_t if isinstance(out_t, tuple) else (out_t,)
    assert len(out_t) == len(out_j)
    for ot, oj in zip(out_t, out_j):
        assert np.abs(np.asarray(oj)).max() > 0
        assert rel(ot.numpy(), oj) < TOL


def test_chunked_rows_reduce_like_whole_rows():
    """A family of few long rows reduces through chunk partials; the plain
    version sums by row index, and the chunk lists hold every real slot of
    each row once, in slot order, at most CHUNK per chunk."""
    a = _table_inputs()
    pad = a["pad"]
    rng = np.random.default_rng(43)
    n_rows = 3
    row = rng.integers(0, n_rows, size=pad.shape[0])
    arrays = {k: torch.from_numpy(v) for k, v in
              tseg.cal_plan_arrays(row, pad, n_rows, chunk=16).items()}
    rows = tseg.chunked_rows(torch.from_numpy(row.astype(np.int32)), arrays)
    assert rows.n_rows == n_rows and rows.n_seg == rows.row_chunk[-1]
    ptr, obs, rc = rows.ptr.numpy(), rows.obs.numpy(), rows.row_chunk.numpy()
    assert np.diff(ptr).max() <= 16
    for r in range(n_rows):
        mine = obs[ptr[rc[r]]:ptr[rc[r + 1]]]
        np.testing.assert_array_equal(mine, np.nonzero((row == r) & (pad < 0.5))[0])
    c = a["contrib"][9]
    want = np.stack([c[:, (row == r)].sum(1) for r in range(n_rows)])
    assert rel(tseg.seg_reduce_table(t(c), rows).numpy(), want) < 1e-12


def test_cpu_tensors_take_the_plain_versions_and_count_nothing():
    a = _table_inputs()
    p, _, _ = _port_state()
    (vi,) = [i for i, c in enumerate(p.cfgs) if c.block_info is not None]
    _kernels.reset_launch_counts()
    for name in TABLE_KERNELS:
        _port_table(name, "rig", a, trcs.plan_of(p.datas[vi]))
    counts = _kernels.launch_counts()
    assert set(TABLE_KERNELS) <= set(counts) and all(n == 0 for n in counts.values())


# ---------------------------------------------------------------------------
# The path as a whole
# ---------------------------------------------------------------------------


def test_assembly_matches_jax():
    _, _, lg_j, _, _, asm_j = _jax_state()
    _, lg_t, asm_t = _port_state()
    assert rel(lg_t.cost.numpy(), lg_j.cost) < 1e-10
    assert rel(asm_t.H_ll0.numpy(), asm_j.H_ll0) < 1e-10
    assert rel(asm_t.g_l.numpy(), asm_j.g_l) < 1e-10
    _fields(asm_t.g_r, asm_j.g_r, 1e-10, "g_r")
    _fields(asm_t.diag_r, asm_j.diag_r, 1e-10, "diag_r")


def test_matvec_matches_jax():
    pj, _, _, _, _, asm_j = _jax_state()
    p, _, asm_t = _port_state()
    rs_j = jrcs.with_damping(asm_j, pj.variables, pj.masks, LAM)
    rs_t = trcs.with_damping(asm_t, p.variables, p.masks, LAM)
    rng = np.random.default_rng(44)
    zt = tst.zero_tangent(p.variables)
    x = {f: rng.normal(size=tuple(getattr(zt, f).shape)) for f in zt._fields}
    y_t = trcs.matvec(rs_t, p.variables, tst.Tangent(**{f: t(v) for f, v in x.items()}))
    y_j = jrcs.matvec(rs_j, pj.variables, jst.Tangent(**{f: jnp.asarray(v) for f, v in x.items()}))
    _fields(y_t, y_j, 1e-10, "matvec")
    z = rng.normal(size=tuple(p.variables.points.shape))
    _fields(trcs.w_y(rs_t, p.variables, t(z)), jrcs.w_y(rs_j, pj.variables, jnp.asarray(z)),
            1e-10, "w_y")
    assert rel(trcs.w_transpose_x(rs_t, p.variables, tst.Tangent(**{
        f: t(v) for f, v in x.items()})).numpy(), jrcs.w_transpose_x(
            rs_j, pj.variables, jst.Tangent(**{f: jnp.asarray(v) for f, v in x.items()}))) < 1e-10


def test_preconditioner_blocks():
    """Rig blocks: bfloat16-close to the JAX two-grid path's, 1e-9-close
    (as inverses) to the JAX generic engine's, which keeps the problem's
    type. Every other group's blocks come from the rest graph: 1e-10."""
    pj, _, lg_j, _, _, asm_j = _jax_state()
    p, _, asm_t = _port_state()
    for g, Bj in asm_j.blocks0.items():
        tol = BF16_BLOCKS if g == "rig" else 1e-10
        assert rel(asm_t.blocks0[g].numpy(), Bj) <= tol, g
    assert rel(asm_t.blocks0["rig"].numpy(), asm_j.blocks0["rig"]) > 1e-6  # bf16 is visible
    rs_t = trcs.with_damping(asm_t, p.variables, p.masks, LAM)
    ref = jeng.build_reduced_system(lg_j, pj.variables, pj.masks, jnp.asarray(LAM))
    _fields(rs_t.precond_inv, ref.precond_inv, TOL, "precond_inv vs generic")
    assert rel(rs_t.H_ll_inv.numpy(), ref.H_ll_inv) < 1e-10


def test_converged_solve_matches_jax():
    pj, _, _, _, _, asm_j = _jax_state()
    p, _, asm_t = _port_state()
    x_rj, x_lj, red_j, rel_j, *_ = jrcs.solve_assembled(asm_j, pj.variables, pj.masks, LAM,
                                                        PCG_CAP, 1e-13)
    x_r, x_l, red, pcg_rel, *_ = trcs.solve_assembled(asm_t, p.variables, p.masks, LAM, PCG_CAP,
                                                     1e-13)
    assert float(pcg_rel) < 1e-12 and float(rel_j) < 1e-12
    _fields(x_r, x_rj, 1e-6, "x_r")
    assert rel(x_l.numpy(), x_lj) < 1e-6
    assert rel(red.numpy(), red_j) < 1e-6


def test_converged_optimize_matches_jax():
    pj = jax_two_grid_problem()
    kw = dict(max_iterations=6, direct_mode=False, pcg_max_iterations=PCG_CAP, pcg_tol=1e-13)
    saved = pj.variables
    try:
        sj = jopt.optimize(pj, jopt.LMSettings(**kw))
    finally:
        pj.variables = saved
    st = topt.optimize(port_two_grid_problem(), topt.LMSettings(**kw))
    assert st.num_iterations == sj.num_iterations
    assert abs(st.final_cost - sj.final_cost) <= 1e-6 * abs(sj.final_cost)
    assert abs(st.initial_cost - sj.initial_cost) <= 1e-10 * abs(sj.initial_cost)
    assert st.final_cost < 1e-2 * st.initial_cost
