"""Blocked reduced-camera-system solver.

Port of `visual_inertial_bundle_adjustment_tpu/problem/rcs.py`: every large
visual batch is REORDERED AT BUILD TIME into rig-sorted ragged tiles
(finalize_blocks, host numpy — the analog of BaSpaCho's symbolic analysis,
reference Optimizer.cpp:166-331); its per-observation Jacobians then feed the
segment kernels of ops/segments.py, which reduce straight into rig, landmark
and calibration-window rows. Three routes, chosen as the JAX package chooses
them (`_rig_only_fast` / `_cal_fast` / else):

  single-pass rig-only     K2-K6: bounded per-tile landmark windows, rig the
                           only non-point group;
  single-pass calibration  K8-K10 (+ K3): rig + cam_extr and/or cam_intr
                           sharing the window row, their columns folded into
                           one J_cal (kc = 23, 6 or 17);
  general (two-grid)       K12, K13: everything else — landmarks re-observed
                           over the whole session (windows past the cap), or
                           other groups (detector bias, calibration rows off
                           the shared window). The matvec composes K12 (rig
                           side) -> K13a over landmark rows (W^T x) -> 3x3
                           solve -> K13b (landmark rows) -> K13a (rig rows);
                           assembly and preconditioner blocks reduce through
                           K13c.
                           Groups of few long rows (a camera's row touched by
                           every observation) reduce through chunked plans,
                           so nothing on this route sums with atomics.

The JAX package reaches the landmark side of the general route through a
second, point-sorted copy of the batch and permutations; here it is a CSR
list over the rig-ordered arrays (finalize_blocks builds the point-sorted
grid too, `_pt_perm` ... `_pt_base`, which only the K14 tile kernels read:
see profile_matvec.py). Its bf16 preconditioner blocks are float32 here. Small
batches (inertial chains, priors, random walks) stay on the generic engine
paths and a stacked rest-graph matvec; small point-coupled ones (a visual
batch below the blocking threshold, `rest_pt`) add their Schur cross terms
through the generic engine, as in the JAX package.

Semantics (damping formula, Schur elimination, block-Jacobi + Gauss-Seidel
Schur-corrected preconditioner, packed PCG) are the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..ops import _kernels
from ..ops import segments as seg
from . import engine
from . import factors as fct
from .structure import (Masks, Tangent, column, has_columns, pack_info, pack_t, stack_columns,
                        t_dot, t_sub, unpack_t, zero_tangent)

VISUAL_KINDS = ("visual", "rs_visual")

# Structurally nonzero rig tangent columns per visual kind: plain visual
# factors touch only the pose (rig tangent [pose 0:6, vel 6:9, omega 9:12])
RIG_COLS = {"visual": 6, "rs_visual": 9}

# Store bf16 copies of each single-pass batch's Jacobians (J_mv, J_pt_mv,
# J_cal_mv) for the kernels of the PCG loop: the preconditioner's rig blocks
# (K3), the Schur right-hand side and W y (K5, K10's up pass) and the PCG
# matvec (K4, K9; K6 and K10's down pass on the route with several visual
# batches), which read J every iteration and are bound by its bytes; bf16
# halves them. The back-substitution (w_transpose_x), assembly, gradient
# and cost read float32 J, so the PCG solves the consistently rounded
# operator S~ = J~^T w J~ - W~ H_ll^-1 W~^T, still symmetric positive
# semi-definite: the reference's LowerPrecSolvePrecond trade
# (Preconditioner.h:163) applied to the reduced operator (the JAX package's
# MATVEC_BF16, rcs.py:57-65). Off by default: the JAX package turns it on
# only on its TPU; on the H100 whether it pays is a benchmark cell's
# question (ROADMAP, "Held for the first benchmark PR").
MATVEC_BF16 = False


def _padk(y, k):
    """(n, k) rig-column result (or (n, k, C) with columns) back to the full
    12-column tangent layout."""
    return torch.nn.functional.pad(y, (0, 0) * (y.ndim - 2) + (0, 12 - k)) if k < 12 else y


def _padkk(B, k):
    """(n, k, k) rig blocks back to (n, 12, 12)."""
    return torch.nn.functional.pad(B, (0, 12 - k, 0, 12 - k)) if k < 12 else B


# ---------------------------------------------------------------------------
# Host-side symbolic phase: sort, pad, tile, build the reduction plans
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BlockInfo:
    """Static ragged-tile geometry for one visual batch (same fields as the
    JAX package's, so a JAX-built block layout converts one to one)."""

    rb: int  # rig rows addressable per tile
    nt: int  # number of rig tiles
    ts: int  # observations per tile
    prb: int  # point rows addressable per point tile
    pnt: int  # number of point tiles
    pts: int  # observations per point tile
    prb2: int = 0  # width of the per-rig-tile point window (0 = unbounded)
    nhg: int = 0  # padded point-table height in 128-row units (0 = too large)
    wb: int = 0  # calibration-window rows per tile (0 = no cal plan)


def _tile_plan(key_sorted, rb, ts):
    """Ragged tiling of a SORTED key array: returns (slot (n,), base (nt,), nt).
    Tiles cut at `ts` rows or when key - base would reach rb; bases are
    floored to multiples of 8 (kept for one-to-one layouts with the JAX
    package)."""
    n = len(key_sorted)
    starts, bases = [], []
    i = 0
    while i < n:
        base = int(key_sorted[i]) & ~7
        end = min(i + ts, int(np.searchsorted(key_sorted, base + rb, side="left")))
        starts.append(i)
        bases.append(base)
        i = end
    nt = len(starts)
    starts_a = np.asarray(starts + [n], np.int64)
    slot = np.arange(n, dtype=np.int64)
    tile_of = np.searchsorted(starts_a, slot, side="right") - 1
    slot = slot - starts_a[tile_of] + tile_of * ts
    return slot, np.asarray(bases, np.int64), nt


def segment_plan(rig, point, pad, n_rows, n_pts):
    """CSR reduction lists over the real slots of a blocked batch (numpy):
    rig rows in slot order (rig-sorted tiles make them contiguous runs),
    landmark rows in point-sorted order — the segment kernels' work lists —
    and `_pt_pos`, each slot's position in the point-sorted list (-1 on the
    pads)."""
    real = np.nonzero(pad < 0.5)[0]
    rig_r = rig[real].astype(np.int64)
    if np.any(np.diff(rig_r) < 0):
        raise ValueError("blocked batch is not rig-sorted")
    rig_ptr = np.zeros(n_rows + 1, np.int64)
    np.cumsum(np.bincount(rig_r, minlength=n_rows), out=rig_ptr[1:])
    pt_r = point[real].astype(np.int64)
    porder = np.argsort(pt_r, kind="stable")
    pt_ptr = np.zeros(n_pts + 1, np.int64)
    np.cumsum(np.bincount(pt_r, minlength=n_pts), out=pt_ptr[1:])
    pt_pos = np.full(len(pad), -1, np.int64)
    pt_pos[real[porder]] = np.arange(len(real))
    i32 = np.int32
    return {"_rig_ptr": rig_ptr.astype(i32), "_rig_obs": real.astype(i32),
            "_pt_ptr": pt_ptr.astype(i32), "_pt_obs": real[porder].astype(i32),
            "_pt_pos": pt_pos.astype(i32)}


# index field of each non-rig, non-point group of a visual batch, and the
# variable table whose height is its row count
_GROUP_FIELDS = (("intr", "cam_intr"), ("extr", "cam_extr_q"), ("bias", "det_bias"))


def group_plan_arrays(data, pad, variables, has_cal_plan):
    """Chunked reduction plans (numpy, keys `_gp_<field>_*`) of the camera
    and detector-bias index fields of a blocked batch, for the general path:
    those groups have few rows touched by very many observations. With a
    calibration-window plan intr and extr share its lists."""
    out = {}
    for field, table in _GROUP_FIELDS:
        if field not in data or (has_cal_plan and field != "bias"):
            continue
        arrays = seg.cal_plan_arrays(np.asarray(data[field]).astype(np.int64), pad,
                                     int(getattr(variables, table).shape[0]))
        out.update({k.replace("_cal_", f"_gp_{field}_"): a for k, a in arrays.items()})
    return out


def group_rows(data, field) -> seg.RowPlan:
    """The chunked row plan of a camera or detector-bias index field."""
    pre = f"_gp_{field}_" if f"_gp_{field}_chunk_ptr" in data else "_cal_"
    return seg.chunked_rows(data[field], data, pre)


def finalize_blocks(problem, rb: int = 128, prb: int = 128, ts: int = 4096,
                    prb2_cap: int = 4096, nhg_cap: int = 2048):
    """Reorder visual batches by rig into ragged tiles (host numpy, one-time)
    and attach their reduction plans. Mutates problem.{cfgs,datas}; the slot
    order, the `_pad`/`_rb_*`/`_rg_*`/`_cb_*` arrays and the point-sorted
    second grid (`point_grid`) match the JAX package's finalize_blocks one to
    one (its lane-major `_uvT`/`_sh4` copies are not built). The solver's
    general path walks the CSR lists (`_rig_*`, `_pt_ptr`/`_pt_obs`) and the
    chunked `_gp_*` plans; only the K14 tile kernels read the point grid
    (profile_matvec.py). Calibration-coupled batches tile at rb = 112, as in
    the JAX package, so the slot order stays the same; their window plan gets
    the port's chunked window-row lists and K9's (rig, window row) pairs."""
    R = int(problem.variables.pose_q.shape[0])
    L = int(problem.variables.points.shape[0])
    n_c = int(problem.variables.cam_intr.shape[0])
    cal_rows_eq = n_c == int(problem.variables.cam_extr_q.shape[0])
    cal_est = bool(problem.masks.cam_intr.any() or problem.masks.cam_extr.any())
    for bi, (cfg, data) in enumerate(zip(problem.cfgs, problem.datas)):
        if cfg.kind not in VISUAL_KINDS or cfg.block_info is not None:
            continue
        device = data["rig"].device
        rig = data["rig"].cpu().numpy()
        pt = data["point"].cpu().numpy()
        if len(rig) < 4 * ts:
            continue  # tiny batch: generic path is fine
        cal_shared = ("intr" in data and cal_rows_eq
                      and bool(torch.equal(data["intr"], data["extr"])))
        rb_b = 112 if (cal_est and rb == 128 and cal_shared) else rb
        order = np.argsort(rig, kind="stable")
        slot, base, nt = _tile_plan(rig[order], rb_b, ts)
        npad = nt * ts
        n_obs = len(rig)
        new, payload = {}, {}
        for k, a in data.items():
            if k.startswith("_ell"):
                continue
            if isinstance(a, tuple):
                payload[k] = a  # non-per-factor payload (the RS tables)
                continue
            a = a.cpu().numpy()
            if a.ndim < 1 or a.shape[0] != n_obs:
                new[k] = a
                continue
            out = np.zeros((npad,) + a.shape[1:], a.dtype)
            out[slot] = a[order]
            new[k] = out
        float_dtype = new["obs_uv"].dtype
        pad = np.ones(npad, float_dtype)
        pad[slot] = 0.0
        tile_base = np.repeat(base, ts)
        new["rig"] = np.where(pad > 0.5, tile_base, new["rig"]).astype(np.int32)
        new["_pad"] = pad  # 1.0 on padded rows
        new["_rb_local"] = (new["rig"].astype(np.int64) - tile_base).astype(np.int32)
        new["_rb_base"] = base.astype(np.int32)

        # per-rig-tile point windows (the single-pass criterion): point ids
        # observed within one rig tile span a bounded range on sequential
        # recordings (tracks live seconds, ids are assigned in time order)
        pt_full = np.zeros(npad, np.int64)
        pt_full[slot] = pt[order]
        pt_tiles = pt_full.reshape(nt, ts)
        pad_tiles = pad.reshape(nt, ts) > 0.5
        big = np.where(pad_tiles, np.int64(np.iinfo(np.int64).max), pt_tiles)
        small = np.where(pad_tiles, np.int64(-1), pt_tiles)
        base2 = (big.min(axis=1) & ~1023).astype(np.int64)
        span = int((small.max(axis=1) - base2).max()) + 1
        nhw = ((-(-span // 128) + 7) // 8) * 8
        prb2 = 128 * nhw
        hib = (base2 >> 7).astype(np.int32)
        nhg = max(-(-L // 128), int(hib.max()) + nhw)
        nhg = ((nhg + 7) // 8) * 8
        if prb2 <= prb2_cap and nhg <= nhg_cap:
            loc2 = pt_full - base2.repeat(ts)
            loc2[pad > 0.5] = 0
            new["_rg_pt_local"] = loc2.astype(np.int32)
            new["_rg_hib"] = hib
        else:
            prb2 = nhg = 0

        # calibration-window plan: per-tile 8-aligned window-row base + local
        # indices, when intr/extr share the window-row index; tiles spanning
        # more than 128 window rows fall back to the two-grid path
        wb = 0
        if cal_shared:
            wrow = new["intr"].astype(np.int64).reshape(nt, ts)
            wmin = np.where(pad_tiles, np.int64(np.iinfo(np.int64).max), wrow).min(axis=1)
            wmin = np.where(wmin == np.iinfo(np.int64).max, 0, wmin)
            cbase = (wmin & ~7).astype(np.int64)
            wmax = np.where(pad_tiles, np.int64(-1), wrow).max(axis=1)
            wb = ((int(np.maximum(wmax - cbase, 0).max()) + 1 + 7) // 8) * 8
            if wb <= 128:
                cloc = wrow - cbase[:, None]
                cloc[pad_tiles] = 0
                new["_cb_local"] = cloc.reshape(-1).astype(np.int32)
                new["_cb_base"] = cbase.astype(np.int32)
                win = (cbase[:, None] + cloc).reshape(-1)
                new.update(seg.cal_plan_arrays(win, pad, n_c))
                new.update(seg.pair_plan_arrays(new["rig"], win, pad, R, n_c))
            else:
                wb = 0
        new.update(point_grid(pt_full, pad, prb, ts, float_dtype))
        pnt = len(new["_pt_base"])
        new.update(segment_plan(new["rig"], new["point"], pad, R, L))
        new.update(group_plan_arrays(new, pad, problem.variables, wb > 0))
        problem.datas[bi] = {k: torch.from_numpy(np.ascontiguousarray(a)).to(device)
                             for k, a in new.items()}
        problem.datas[bi].update(payload)
        problem.cfgs[bi] = dataclasses.replace(
            cfg, block_info=BlockInfo(rb_b, nt, ts, prb, pnt, ts, prb2, nhg, wb))
    return problem


def point_grid(pt_full, pad, prb, ts, float_dtype):
    """The point-sorted second grid of a blocked batch (host numpy, the JAX
    package's finalize_blocks one to one): the real slots sorted by landmark
    (stable), tiled like the rig grid (`_tile_plan` at prb rows per tile).
    `_pt_perm` (pnt*ts,) rig-grid slot of each point-grid slot (pads 0),
    `_pt_w` 1 on its real slots, `_pt_local` the landmark within the tile's
    prb-row window, `_pt_inv` (N,) point-grid slot of each rig-grid slot,
    `_pt_rows` (pnt*prb,) the rows each tile addresses, `_pt_base` (pnt,)."""
    real = np.nonzero(pad < 0.5)[0]
    real_idx = real[np.argsort(pt_full[real], kind="stable")]
    pkey = pt_full[real_idx]
    pslot, pbase, pnt = _tile_plan(pkey, prb, ts)
    perm = np.zeros(pnt * ts, np.int64)
    perm[pslot] = real_idx
    pw = np.zeros(pnt * ts, float_dtype)
    pw[pslot] = 1.0
    pt_local = np.zeros(pnt * ts, np.int32)
    pt_local[pslot] = (pkey - pbase[pslot // ts]).astype(np.int32)
    inv = np.zeros(len(pad), np.int64)
    inv[real_idx] = pslot
    return {"_pt_perm": perm.astype(np.int32), "_pt_w": pw, "_pt_local": pt_local,
            "_pt_inv": inv.astype(np.int32),
            "_pt_rows": (pbase[:, None] + np.arange(prb)[None, :]).astype(np.int32).reshape(-1),
            "_pt_base": pbase.astype(np.int32)}


def permute_cols(a, idx):
    """a[..., idx] for a (..., N): the rig <-> point grid permutations."""
    return a.index_select(-1, idx)


def plan_of(data) -> seg.SegPlan:
    return seg.SegPlan(data["rig"], data["point"], data["_rig_ptr"], data["_rig_obs"],
                       data["_pt_ptr"], data["_pt_obs"], data["_pt_pos"])


def cal_plan_of(data, info) -> seg.CalPlan | None:
    """The window-row plan of a batch with a calibration-window plan."""
    if info.wb == 0 or "_cal_chunk_ptr" not in data:
        return None
    base = data["_cb_base"].repeat_interleave(info.ts)
    return seg.CalPlan((base + data["_cb_local"]).to(torch.int32),
                       *(data["_cal_" + f] for f in seg.CalPlan._fields[1:]))


# ---------------------------------------------------------------------------
# Per-linearization batch state
# ---------------------------------------------------------------------------


class VisBatch(NamedTuple):
    """Per-visual-batch solver state for one linearization."""

    info: BlockInfo
    w: torch.Tensor  # (N,) robust weight * valid * (1 - pad)
    rig_k: int  # rig J blocks carry only the first rig_k columns
    J: torch.Tensor  # (d, rig_k, N) contiguous rig Jacobian
    J_pt: torch.Tensor  # (d, 3, N)
    plan: seg.SegPlan
    cal_groups: tuple = ()  # ((group, dim), ...) folded into J_cal, or ()
    J_cal: torch.Tensor | None = None  # (d, kc, N) [extr | intr], or one of them
    cplan: seg.CalPlan | None = None
    # the non-point groups in lin order, for the general path: names, (N,)
    # index tensors, (d, dim, N) Jacobians (the rig entry is J) and row plans
    groups: tuple = ()
    idx: tuple = ()
    jac: tuple = ()
    rows: tuple = ()
    # the point-sorted slot records of the column kernels (single-pass
    # batches on the card, with_column_records), or None
    rec: seg.PtRecords | None = None
    # bf16 copies of J, J_pt and J_cal for the PCG loop (MATVEC_BF16), or None
    J_mv: torch.Tensor | None = None
    J_pt_mv: torch.Tensor | None = None
    J_cal_mv: torch.Tensor | None = None


def _rig_only_fast(b: VisBatch):
    """Single-pass rig-only batch (the JAX package's criterion: rig the only
    non-point group, bounded per-tile point windows, a point table inside
    the accumulator cap)."""
    return b.groups == (fct.RIG,) and b.info.prb2 > 0 and b.info.nhg > 0


def _cal_fast(b: VisBatch):
    """Single-pass calibration-coupled batch (rig + folded window columns)."""
    return (b.J_cal is not None and b.cplan is not None and b.info.prb2 > 0
            and b.info.nhg > 0 and b.groups[0] == fct.RIG
            and len(b.groups) == 1 + len(b.cal_groups))


def _single_pass(b: VisBatch):
    return _rig_only_fast(b) or _cal_fast(b)


def _mv_jacs(b: VisBatch):
    """(J, J_pt, J_cal) for the kernels of the PCG loop: the bf16 copies
    under MATVEC_BF16, else the batch's own."""
    if b.J_mv is not None:
        return b.J_mv, b.J_pt_mv, b.J_cal_mv
    return b.J, b.J_pt, b.J_cal


def _with_mv_copies(b: VisBatch):
    """b with the bf16 copies of its Jacobians (MATVEC_BF16, single-pass
    batches; every device and float type, so that the CPU tests reach it).
    J_cal is not padded to 8 columns as in the JAX package (a Mosaic
    sublane idiom)."""
    if not (MATVEC_BF16 and _single_pass(b)):
        return b
    bf = torch.bfloat16
    return b._replace(J_mv=b.J.to(bf), J_pt_mv=b.J_pt.to(bf),
                      J_cal_mv=None if b.J_cal is None else b.J_cal.to(bf))


def _split(cfgs, lg):
    """(visual (cfg, lin, w) triples, rest graph, point-coupled rest graph).

    A non-blocked batch that references landmarks (a visual batch below the
    blocking threshold) still couples into the Schur cross terms W = H_rl:
    rest_pt carries exactly those lins, so the matvec, W^T x, W y and the
    landmark blocks add their coupling through the generic engine."""
    vis, rest_lins, rest_w, pt_lins, pt_w = [], [], [], [], []
    for cfg, lin, w in zip(cfgs, lg.lins, lg.w):
        if cfg.block_info is not None:
            vis.append((cfg, lin, w))
            continue
        rest_lins.append(lin)
        rest_w.append(w)
        if fct.POINTS in lin.groups:
            pt_lins.append(lin)
            pt_w.append(w)
    rest = engine.LinearizedGraph(
        lins=tuple(rest_lins), w=tuple(rest_w), cost=lg.cost, stored_cost=(), valid0=(),
        num_invalid=lg.num_invalid, num_optional=lg.num_optional)
    rest_pt = engine.LinearizedGraph(
        lins=tuple(pt_lins), w=tuple(pt_w), cost=lg.cost, stored_cost=(), valid0=(),
        num_invalid=lg.num_invalid, num_optional=lg.num_optional)
    return vis, rest, rest_pt


def _vis_batches(cfgs, datas, lg):
    """[(VisBatch, Lin)] for every blocked visual batch. A batch with a
    window plan whose groups besides the rig are cam_extr, cam_intr or both
    (sharing the window row) folds their Jacobians into J_cal in group order
    (kc = 23, 6 or 17 columns), exactly where the JAX package folds them."""
    out = []
    for (cfg, lin, w), data in zip(zip(cfgs, lg.lins, lg.w), datas):
        if cfg.block_info is None:
            continue
        info = cfg.block_info
        rig_k = RIG_COLS[cfg.kind]
        plan = plan_of(data)
        fields = dict(fct.REGISTRY[cfg.kind]["tangents"])
        J_pt = J_rig = None
        groups, idx, jac, rows = [], [], [], []
        for g, ix, J in zip(lin.groups, lin.idx, lin.jac):
            if g == fct.POINTS:
                J_pt = J
                continue
            if g == fct.RIG:
                J = J_rig = J[:, :rig_k, :].contiguous()
                rows.append(seg.rig_rows(plan))
            else:
                rows.append(group_rows(data, fields[g]))
            groups.append(g)
            idx.append(ix)
            jac.append(J)
        if J_pt is None:
            raise ValueError(f"blocked batch ({cfg.kind}) without active landmarks")
        extra = [(g, J) for g, J in zip(groups, jac) if g != fct.RIG]
        cplan = cal_plan_of(data, info)
        fold = (cplan is not None and bool(extra)
                and all(g in (fct.CAM_EXTR, fct.CAM_INTR) for g, _ in extra))
        out.append((_with_mv_copies(VisBatch(
            info=info, w=w * (1.0 - data["_pad"]), rig_k=rig_k, J=J_rig, J_pt=J_pt, plan=plan,
            cal_groups=tuple((g, J.shape[1]) for g, J in extra) if fold else (),
            J_cal=torch.cat([J for _, J in extra], dim=1) if fold else None,
            cplan=cplan if fold else None,
            groups=tuple(groups), idx=tuple(idx), jac=tuple(jac), rows=tuple(rows))), lin))
    return out


def with_column_records(rs):
    """The system with the point-sorted slot records (seg.point_sorted_records)
    of its single-pass visual batch made once, for the column kernels that
    every PCG iteration of a covariance chunk calls (J is constant over the
    system's solves). Only on the card: the CPU path ignores them. Under
    MATVEC_BF16 the records hold the bf16 copies upcast to float32, so the
    column kernels solve the PCG loop's rounded operator."""
    if not (len(rs.vis) == 1 and not rs.rest_pt.lins and _single_pass(rs.vis[0])):
        return rs
    b = rs.vis[0]
    if not _kernels.on_card(b.w) or b.rec is not None:
        return rs
    J, J_pt, J_cal = (None if a is None else a.float() for a in _mv_jacs(b))
    rec = seg.point_sorted_records(J, J_pt, b.w, b.plan, J_cal if _cal_fast(b) else None,
                                   b.cplan if _cal_fast(b) else None)
    return rs._replace(vis=(b._replace(rec=rec),))


def _cal_table(b: VisBatch, x: Tangent):
    """Concatenated (n_c, kc) window table in cal_groups order."""
    return torch.cat([getattr(x, g) for g, _ in b.cal_groups], dim=1).contiguous()


def _cal_scatter_back(b: VisBatch, y: Tangent, y_c) -> Tangent:
    """Add a (n_c, kc) window result into its group tables."""
    off, upd = 0, {}
    for g, dim in b.cal_groups:
        upd[g] = getattr(y, g) + y_c[:, off:off + dim]
        off += dim
    return y._replace(**upd)


# ---------------------------------------------------------------------------
# Rest graph (non-visual batches): stacked Hessian matvec
# ---------------------------------------------------------------------------


class RestStack(NamedTuple):
    """Stacked operand for the rest-graph Hessian matvec: one residual-dim
    bucket of lins, variable slots padded to S, tangent columns to the packed
    width K. rows index the PACKED reduced state (row nb = zero dummy);
    (ell, ell2) is the deterministic two-level transpose plan of rows
    (factors.two_level_plan)."""

    rows: torch.Tensor  # (S, N) int64 packed-row ids
    J: torch.Tensor  # (S, d, K, N)
    w: torch.Tensor  # (N,)
    ell: torch.Tensor  # (n_chunks, ELL_WIDTH) int64 flat (S*N) slots per row chunk
    ell2: torch.Tensor  # (nb + 1, max chunks per row) int64 chunks per row


def _packed_sections(counts):
    offs, off = [], 0
    for c in counts:
        offs.append(off)
        off += c
    return tuple(offs)


def build_rest_stacks(rest, v):
    """Stack the rest lins into one operand per residual-dim bucket (the
    JAX package's build_rest_stacks; its scatter-add becomes a two-level
    gather-sum so the sum order is fixed)."""
    counts, dims, K = pack_info(zero_tangent(v))
    off_by = dict(zip(Tangent._fields, _packed_sections(counts)))
    nb = sum(counts)
    dtype, device = v.points.dtype, v.points.device
    buckets = {}
    for lin, w in zip(rest.lins, rest.w):
        entries = [(g, ix, J) for g, ix, J in zip(lin.groups, lin.idx, lin.jac)
                   if g != fct.POINTS]
        if entries:
            buckets.setdefault(entries[0][2].shape[0], []).append((entries, w))
    stacks = []
    for d, items in sorted(buckets.items()):
        S = max(len(e) for e, _ in items)
        rows_p, J_p, w_p = [], [], []
        for entries, w in items:
            N = w.shape[0]
            slot_rows, slot_J = [], []
            for s in range(S):
                if s < len(entries):
                    g, ix, J = entries[s]
                    r = (torch.full((N,), off_by[g], dtype=torch.int64, device=device)
                         if g == fct.GRAVITY else off_by[g] + ix.to(torch.int64))
                    slot_J.append(torch.nn.functional.pad(J.to(dtype), (0, 0, 0, K - J.shape[1])))
                else:
                    r = torch.full((N,), nb, dtype=torch.int64, device=device)
                    slot_J.append(torch.zeros((d, K, N), dtype=dtype, device=device))
                slot_rows.append(r)
            rows_p.append(torch.stack(slot_rows))
            J_p.append(torch.stack(slot_J))
            w_p.append(w.to(dtype))
        rows = torch.cat(rows_p, dim=-1)
        ell, ell2 = fct.two_level_plan(rows.reshape(-1), nb + 1)
        stacks.append(RestStack(rows, torch.cat(J_p, dim=-1), torch.cat(w_p, dim=-1), ell, ell2))
    return tuple(stacks)


# elements of the batched products of one vmap over columns (1 GB in float32)
_COLUMN_GROUP_ELEMS = 1 << 28


def rest_hmatvec(stacks, v, x: Tangent) -> Tangent:
    """H_rest x via the stacked operands (engine._hmatvec over the rest
    graph's reduced groups, up to summation order); x with or without
    columns."""
    if has_columns(x):
        # a stack's (S, d, K, N) products run once a column: vmap groups of
        # columns whose products stay within _COLUMN_GROUP_ELEMS elements
        size = max([st.J.numel() for st in stacks] + [1])
        return engine.map_columns(lambda xc: rest_hmatvec(stacks, v, xc), x,
                                  group=_COLUMN_GROUP_ELEMS // size)
    counts, dims, K = pack_info(x)
    nb = sum(counts)
    xp = pack_t(x, counts, dims, K)
    xe = torch.cat([xp, xp.new_zeros((1, K))], dim=0)
    yp = xp.new_zeros((nb + 1, K))
    for st in stacks:
        xgT = xe[st.rows].transpose(1, 2)  # (S, K, N)
        u = (st.J * xgT[:, None]).sum((0, 2))  # (d, N)
        wu = u * st.w[None, :]
        contrib = (st.J * wu[None, :, None, :]).sum(1)  # (S, K, N)
        flat = contrib.transpose(1, 2).reshape(-1, K)  # (S*N, K)
        flat = torch.cat([flat, flat.new_zeros((1, K))], dim=0)
        chunks = flat[st.ell].sum(1)
        yp = yp + torch.cat([chunks, chunks.new_zeros((1, K))], dim=0)[st.ell2].sum(1)
    return unpack_t(yp[:nb], counts, dims, K)


# ---------------------------------------------------------------------------
# Assembly (once per linearization) and damping (per lambda)
# ---------------------------------------------------------------------------


class RcsAsm(NamedTuple):
    """Lambda-INDEPENDENT assembly for one linearization: damping retries
    (Optimizer.cpp:826-854) reuse it and pay only the per-lambda work."""

    vis: tuple  # tuple[VisBatch]
    rest: object  # LinearizedGraph of small batches
    H_ll0: torch.Tensor  # (L, 3, 3) UNdamped landmark blocks
    diag_r: Tangent  # undamped reduced diagonal entries
    g_r: Tangent  # gradient (reduced)
    g_l: torch.Tensor  # gradient (landmarks)
    blocks0: dict  # per-group UNdamped block-Jacobi blocks (Schur correction not yet applied)
    rest_stacks: tuple = ()  # tuple[RestStack]
    A_rp: tuple = ()  # per vis batch: (rig_k, 3, N) J_r^T w J_pt of a general-path batch, or None
    rest_pt: object = None  # LinearizedGraph of the point-coupled small batches (W terms)


class RcsSystem(NamedTuple):
    vis: tuple
    rest: object
    H_ll: torch.Tensor  # (L, 3, 3) damped
    H_ll_inv: torch.Tensor
    diag_r: Tangent  # undamped reduced diagonal
    lam: torch.Tensor
    precond_inv: Tangent | None
    rest_stacks: tuple = ()
    rest_pt: object = None  # LinearizedGraph of the point-coupled small batches (W terms)


_PRECOND_GROUPS = (fct.RIG, fct.CAM_INTR, fct.CAM_EXTR, fct.IMU_CALIB, fct.IMU_EXTR,
                   fct.DET_BIAS, fct.GRAVITY)


def reduce_rows(contrib, rows: seg.RowPlan):
    """Segment-sum `contrib` (D, N) into (n_rows, D) (K13c)."""
    return seg.seg_reduce_table(contrib.contiguous(), rows)


def _outer(Jw, J):
    """(a, b, N) = sum_d Jw[d, a] J[d, b] per slot."""
    return (Jw[:, :, None, :] * J[:, None, :, :]).sum(0)


def _reduce_group(group, contrib, rows, lead):
    """contrib (lead..., N) of one non-point group summed into its rows."""
    if group == fct.GRAVITY:
        return contrib.sum(-1)
    return reduce_rows(contrib.reshape(-1, contrib.shape[-1]), rows).reshape((-1,) + lead)


def _point_blocks_blocked(vis, rest, v):
    """UNdamped landmark blocks H_ll0 (L, 3, 3) of the general-path batches
    (single-pass ones come fused from K2/K8) and of the point-coupled small
    batches (through their transpose plans)."""
    L = v.points.shape[0]
    H = v.points.new_zeros((L, 9))
    for b in vis:
        if _single_pass(b):
            continue
        A = _outer(b.J_pt * b.w[None, None, :], b.J_pt)
        H = H + reduce_rows(A.reshape(9, -1), seg.point_rows(b.plan))
    H = H.reshape(L, 3, 3)
    for lin, w in zip(rest.lins, rest.w):
        for group, idx, J, ell in zip(lin.groups, lin.idx, lin.jac, lin.ell):
            if group == fct.POINTS:
                H = H + fct.scatter_rows(ell, idx, _outer(J * w[None, None, :], J), L)
    return H


def _grad(pairs, rest, v):
    """(Tangent, points) gradient J^T w res: the rest graph through the
    generic engine path, general-path visual batches through K13c."""
    g, gp = engine._accumulate_grad(rest, v)
    g = g._asdict()
    for b, lin in pairs:
        if _single_pass(b):
            continue
        wres = lin.res * b.w[None, :]
        for group, J, rows in zip(b.groups, b.jac, b.rows):
            red = _reduce_group(group, (J * wres[:, None, :]).sum(0), rows, (J.shape[1],))
            g[group] = g[group] + (_padk(red, b.rig_k) if group == fct.RIG else red)
        gp = gp + reduce_rows((b.J_pt * wres[:, None, :]).sum(0), seg.point_rows(b.plan))
    return Tangent(**g), gp


def _diag(vis, rest, v):
    d = engine._hess_diag(rest, v)[0]._asdict()
    for b in vis:
        if _single_pass(b):
            continue
        for group, J, rows in zip(b.groups, b.jac, b.rows):
            red = _reduce_group(group, (J * J * b.w[None, None, :]).sum(0), rows, (J.shape[1],))
            d[group] = d[group] + (_padk(red, b.rig_k) if group == fct.RIG else red)
    return Tangent(**d)


def _precond_blocks_static(vis, rest, v, masks):
    """Lambda-free block-Jacobi blocks per group, and per general-path batch
    the product A = J_r^T w J_pt that the per-lambda Schur correction needs.
    (The JAX package accumulates the visual rig blocks in bfloat16, a TPU
    memory trade; here they are float32.)"""
    dims = fct.GROUP_DIMS
    kw = dict(dtype=v.points.dtype, device=v.points.device)
    blocks = {g: torch.zeros((getattr(masks, g).shape[0] if getattr(masks, g).ndim > 1 else 1,
                              dims[g], dims[g]), **kw) for g in _PRECOND_GROUPS}
    for lin, w in zip(rest.lins, rest.w):
        for group, idx, J, ell in zip(lin.groups, lin.idx, lin.jac, lin.ell):
            if group == fct.POINTS:
                continue
            B = _outer(J * w[None, None, :], J)
            if group == fct.GRAVITY:
                blocks[group] = blocks[group] + B.sum(-1)[None]
            else:
                blocks[group] = blocks[group] + fct.scatter_rows(
                    ell, idx, B, blocks[group].shape[0])
    A_rp = []
    for b in vis:
        A_b = None
        if not _single_pass(b):
            for group, J, rows in zip(b.groups, b.jac, b.rows):
                Jw = J * b.w[None, None, :]
                k = J.shape[1]
                red = _reduce_group(group, _outer(Jw, J), rows, (k, k))
                if group == fct.RIG:
                    A_b = _outer(Jw, b.J_pt)  # (rig_k, 3, N)
                    red = _padkk(red, k)
                elif group == fct.GRAVITY:
                    red = red[None]
                blocks[group] = blocks[group] + red
        A_rp.append(A_b)
    return blocks, tuple(A_rp)


def assemble(cfgs, datas, lg, v, masks: Masks) -> RcsAsm:
    """Everything lambda-independent for this linearization: rig-only
    single-pass batches through K2, calibration-coupled ones through K8
    (which also gives the window gradient, diagonal and block-Jacobi self
    blocks), general-path ones through K13c."""
    pairs = _vis_batches(cfgs, datas, lg)
    vis = tuple(b for b, _ in pairs)
    _, rest, rest_pt = _split(cfgs, lg)
    H_ll0 = _point_blocks_blocked(vis, rest, v)
    diag_r = _diag(vis, rest, v)
    g_r, g_l = _grad(pairs, rest, v)
    blocks0, A_rp = _precond_blocks_static(vis, rest, v, masks)
    for b, lin in pairs:
        if _rig_only_fast(b):
            gr_b, dg_b, gl_b, H_b = seg.seg_assemble_rig(b.J, b.J_pt, lin.res, b.w, b.plan)
        elif _cal_fast(b):
            gr_b, dg_b, gc_b, dc_b, blocks_c, gl_b, H_b = seg.seg_assemble_cal(
                b.J, b.J_cal, b.J_pt, lin.res, b.w, b.plan, b.cplan)
            g_r, diag_r = _cal_scatter_back(b, g_r, gc_b), _cal_scatter_back(b, diag_r, dc_b)
            for (g, _), Bc in zip(b.cal_groups, blocks_c):
                blocks0[g] = blocks0[g] + Bc
        else:
            continue
        g_r = g_r._replace(rig=g_r.rig + _padk(gr_b, b.rig_k))
        diag_r = diag_r._replace(rig=diag_r.rig + _padk(dg_b, b.rig_k))
        g_l = g_l + gl_b
        H_ll0 = H_ll0 + H_b
    return RcsAsm(vis, rest, H_ll0, diag_r, g_r, g_l, blocks0, build_rest_stacks(rest, v), A_rp,
                  rest_pt)


def _precond_finish(asm: RcsAsm, v, masks, lam, H_ll_inv, precond="gauss_seidel"):
    """Per-lambda: rig blocks with the Schur self-correction (K3 for
    single-pass batches; A H_ll^-1 A^T through K13c for general-path ones),
    damp, mask, invert. `precond`: "identity" -> None; "jacobi" -> no Schur
    correction; "gauss_seidel"/"lower_prec" -> corrected (reference
    Preconditioner.h)."""
    if precond == "identity":
        return None
    schur_corr = precond in ("gauss_seidel", "lower_prec")
    blocks = dict(asm.blocks0)
    Hinv_used = H_ll_inv if schur_corr else torch.zeros_like(H_ll_inv)
    for b, A in zip(asm.vis, asm.A_rp):
        if _single_pass(b):
            J, J_pt, _ = _mv_jacs(b)
            blocks[fct.RIG] = blocks[fct.RIG] + _padkk(
                seg.seg_precond_rig(J, J_pt, b.w, Hinv_used, b.plan), b.rig_k)
            continue
        if A is None or not schur_corr:
            continue
        HinvN = H_ll_inv.index_select(0, b.plan.point).permute(1, 2, 0)  # (3, 3, N)
        C = (A[:, :, None, :] * HinvN[None]).sum(1)  # (k, 3, N) = A H^-1
        corr = (C[:, None, :, :] * A[None, :, :, :]).sum(2)  # (k, k, N)
        k = corr.shape[0]
        red = reduce_rows(corr.reshape(k * k, -1), seg.rig_rows(b.plan)).reshape(-1, k, k)
        blocks[fct.RIG] = blocks[fct.RIG] - _padkk(red, k)
    inv = {}
    for g, B in blocks.items():
        dim = B.shape[-1]
        eye = torch.eye(dim, dtype=B.dtype, device=B.device)
        diag = torch.diagonal(B, dim1=-2, dim2=-1)
        B = B + eye * (lam * torch.clamp(diag, min=0.0) + lam)[..., None, :] * eye
        m = getattr(masks, g)
        if m.ndim == 1:
            m = m[None, :]
        B = B * m[:, :, None] * m[:, None, :] + eye * (1.0 - m)[..., None, :] * eye
        tr = torch.diagonal(B, dim1=-2, dim2=-1).sum(-1)[..., None, None]
        B = B + eye * tr * 1e-12
        inv[g] = engine._precond_inv(B)
    return Tangent(rig=inv[fct.RIG], cam_intr=inv[fct.CAM_INTR], cam_extr=inv[fct.CAM_EXTR],
                   imu_calib=inv[fct.IMU_CALIB], imu_extr=inv[fct.IMU_EXTR],
                   det_bias=inv[fct.DET_BIAS], gravity=inv[fct.GRAVITY][0])


def with_damping(asm: RcsAsm, v, masks, lam, precond="gauss_seidel") -> RcsSystem:
    """Per-lambda completion: damped landmark inverses + preconditioner."""
    lam = torch.as_tensor(lam, dtype=v.points.dtype, device=v.points.device)
    diag = torch.diagonal(asm.H_ll0, dim1=-2, dim2=-1)
    eye = torch.eye(3, dtype=asm.H_ll0.dtype, device=asm.H_ll0.device)
    H_ll = asm.H_ll0 + eye * (lam * diag + lam)[..., None, :] * eye
    H_ll_inv = engine._inv3(H_ll)
    precond_inv = _precond_finish(asm, v, masks, lam, H_ll_inv, precond)
    return RcsSystem(asm.vis, asm.rest, H_ll, H_ll_inv, asm.diag_r, lam, precond_inv,
                     asm.rest_stacks, asm.rest_pt)


# ---------------------------------------------------------------------------
# Matvec / PCG (per lambda)
# ---------------------------------------------------------------------------


def _vis_u(b: VisBatch, x: Tangent):
    """u = sum_g J_g x_g over the non-point groups (d, N): the rig term
    through K13b, the few-row groups as gathered elementwise products."""
    u = None
    for group, idx, J, rows in zip(b.groups, b.idx, b.jac, b.rows):
        if group == fct.RIG:
            term = seg.seg_mv_gather_table(J, x.rig[:, :b.rig_k].contiguous(), rows)
        else:
            xgT = (x.gravity[:, None].expand(2, J.shape[-1]) if group == fct.GRAVITY
                   else getattr(x, group).index_select(0, idx).T)
            term = (J * xgT[None]).sum(1)
        u = term if u is None else u + term
    return u


def _vis_scatter(b: VisBatch, y: dict, wu):
    """y_g += J_g^T wu for the non-point groups: the rig rows through K13a,
    the few-row groups through K13c on their chunked plans."""
    for group, J, rows in zip(b.groups, b.jac, b.rows):
        if group == fct.RIG:
            y[group] = y[group] + _padk(seg.seg_mv_scatter_table(J, wu, rows), b.rig_k)
        else:
            y[group] = y[group] + _reduce_group(group, (J * wu[:, None, :]).sum(0), rows,
                                                (J.shape[1],))
    return y


def _pt_reduce(b: VisBatch, wu):
    """The W^T-side landmark summand of a general-path batch: wu (d, N) ->
    (L, 3) (K13a over the landmark rows)."""
    return seg.seg_mv_scatter_table(b.J_pt, wu, seg.point_rows(b.plan))


def _pt_expand(b: VisBatch, yl):
    """u2 (d, N) = w J_pt y_l[pt] (K13b over the landmark rows)."""
    return seg.seg_mv_gather_table(b.J_pt, yl, seg.point_rows(b.plan)) * b.w[None, :]


def w_transpose_x(rs: RcsSystem, v, x: Tangent):
    """W^T x (L, 3) (K6; K10's down pass for calibration-coupled batches;
    K13b + K13a on the general path). The back-substitution: float32 J
    under MATVEC_BF16 too, as in the JAX package."""
    t = torch.zeros_like(v.points)
    for b in rs.vis:
        if _rig_only_fast(b):
            _, t_b = seg.seg_schur_down(b.J, b.J_pt, b.w, x.rig[:, :b.rig_k].contiguous(),
                                        b.plan, want_y=False)
        elif _cal_fast(b):
            _, _, t_b = seg.seg_schur_down_cal(b.J, b.J_cal, b.J_pt, b.w,
                                               x.rig[:, :b.rig_k].contiguous(),
                                               _cal_table(b, x), b.plan, b.cplan, want_y=False)
        else:
            t_b = _pt_reduce(b, _vis_u(b, x) * b.w[None, :])
        t = t + t_b
    if rs.rest_pt.lins:  # point-coupled small batches: H_lr x
        t = t + engine._hmatvec(rs.rest_pt, v, x, torch.zeros_like(v.points))[1]
    return t


def w_y(rs: RcsSystem, v, yl):
    """W y_l (Tangent) (K5; K10's up pass; K13b + K13a on the general path;
    the bf16 copies under MATVEC_BF16)."""
    y = zero_tangent(v)
    yl = yl.contiguous()
    for b in rs.vis:
        J, J_pt, J_cal = _mv_jacs(b)
        if _rig_only_fast(b):
            y_r = seg.seg_schur_up(J, J_pt, b.w, yl, b.plan)
        elif _cal_fast(b):
            y_r, y_c = seg.seg_schur_up_cal(J, J_cal, J_pt, b.w, yl, b.plan, b.cplan)
            y = _cal_scatter_back(b, y, y_c)
        else:
            y = Tangent(**_vis_scatter(b, y._asdict(), _pt_expand(b, yl)))
            continue
        y = y._replace(rig=y.rig + _padk(y_r, b.rig_k))
    if rs.rest_pt.lins:  # point-coupled small batches: H_rl y_l
        y = Tangent(*(a + h for a, h in zip(y, engine._hmatvec(rs.rest_pt, v, zero_tangent(v),
                                                                 yl)[0])))
    return y


def _matvec_factor_sums(rs: RcsSystem, v, x: Tangent) -> Tangent:
    """H_rr x - W H_ll^-1 W^T x, no damping. One single-pass visual batch
    (the bench shapes) runs as K4 or K9; otherwise the batches sum their down
    passes before the landmark solve and subtract their up passes after: a
    general-path batch whose only group is the rig goes down through K12
    (J read once), any other through _vis_u / _vis_scatter.

    x with columns (covariance columns, structure.has_columns): the
    single-pass route runs the column-batched K4 or K9 once for all of them
    (and the rest graph batched over them); every other route (the general
    two-grid path, several visual batches, point-coupled small batches)
    runs its kernels column by column. The single-pass kernels read the
    bf16 copies under MATVEC_BF16."""
    single = len(rs.vis) == 1 and not rs.rest_pt.lins and _single_pass(rs.vis[0])
    cols = has_columns(x)
    if cols and not single:
        return stack_columns([_matvec_factor_sums(rs, v, column(x, c))
                              for c in range(x.gravity.shape[-1])])
    hx = rest_hmatvec(rs.rest_stacks, v, x)
    if single:
        b = rs.vis[0]
        J, J_pt, J_cal = _mv_jacs(b)
        x_r = x.rig[:, :b.rig_k].contiguous()
        if _cal_fast(b):
            args = (J, J_cal, J_pt, b.w, x_r, _cal_table(b, x), rs.H_ll_inv, b.plan, b.cplan)
            y_r, y_c = (seg.seg_schur_pcg_cal_cols(*args, rec=b.rec) if cols
                        else seg.seg_schur_pcg_cal(*args))
            hx = _cal_scatter_back(b, hx, y_c)
        else:
            args = (J, J_pt, b.w, x_r, rs.H_ll_inv, b.plan)
            y_r = (seg.seg_schur_pcg_cols(*args, rec=b.rec) if cols
                   else seg.seg_schur_pcg(*args))
        return hx._replace(rig=hx.rig + _padk(y_r, b.rig_k))
    t = torch.zeros_like(v.points)
    for b in rs.vis:
        x_r = x.rig[:, :b.rig_k].contiguous()
        J, J_pt, J_cal = _mv_jacs(b)
        if _rig_only_fast(b):
            y_b, t_b = seg.seg_schur_down(J, J_pt, b.w, x_r, b.plan)
        elif _cal_fast(b):
            y_b, y_c, t_b = seg.seg_schur_down_cal(J, J_cal, J_pt, b.w, x_r, _cal_table(b, x),
                                                   b.plan, b.cplan)
            hx = _cal_scatter_back(b, hx, y_c)
        elif b.groups == (fct.RIG,):
            wu, y_b = seg.seg_mv_fused_table(b.J, b.w, x_r, b.rows[0])
            t_b = _pt_reduce(b, wu)
        else:
            wu = _vis_u(b, x) * b.w[None, :]
            hx = Tangent(**_vis_scatter(b, hx._asdict(), wu))
            t = t + _pt_reduce(b, wu)
            continue
        hx = hx._replace(rig=hx.rig + _padk(y_b, b.rig_k))
        t = t + t_b
    if rs.rest_pt.lins:  # point-coupled small batches: their W^T x summand
        t = t + engine._hmatvec(rs.rest_pt, v, x, torch.zeros_like(v.points))[1]
    return t_sub(hx, w_y(rs, v, engine._chol_solve(rs.H_ll_inv, t)))


def matvec(rs: RcsSystem, v, x: Tangent) -> Tangent:
    """S x = (H_rr + damping) x - W H_ll^-1 W^T x; x with or without
    columns."""
    S = _matvec_factor_sums(rs, v, x)
    return Tangent(*(h + rs.lam * (d.reshape(d.shape + (1,) * (xv.ndim - d.ndim)) * xv)
                     + rs.lam * xv for h, d, xv in zip(S, rs.diag_r, x)))


def pcg(rs: RcsSystem, v, b: Tangent, max_iters: int, rel_tol):
    """Packed-state PCG on the reduced system (engine.packed_pcg: a fixed
    count of iterations, the stop test an on-device mask); b with columns
    solves them together (engine.packed_pcg_columns)."""
    return engine.packed_pcg(lambda x: matvec(rs, v, x), rs.precond_inv, b, max_iters, rel_tol)


def solve_assembled(asm: RcsAsm, v, masks, lam, max_iters=250, rel_tol=1e-10,
                    precond="gauss_seidel"):
    """Per-lambda solve on a prebuilt assembly: Schur RHS (K5), packed PCG
    (K4 matvecs), back-substitution (K6). Returns (x_r, x_l, model_red, rel,
    iters, rs, (g_r, g_l))."""
    rs = with_damping(asm, v, masks, lam, precond)
    g_r, g_l = asm.g_r, asm.g_l
    z = engine._chol_solve(rs.H_ll_inv, g_l)
    b = t_sub(g_r, w_y(rs, v, z))
    x_r, rel, iters = pcg(rs, v, b, max_iters, rel_tol)
    x_l = engine._chol_solve(rs.H_ll_inv, g_l - w_transpose_x(rs, v, x_r))
    model_red = 0.5 * (t_dot(x_r, g_r) + (x_l * g_l).sum())
    return x_r, x_l, model_red, rel, iters, rs, (g_r, g_l)


def solve_step(cfgs, datas, lg, v, masks, lam, max_iters=250, rel_tol=1e-10,
               precond="gauss_seidel"):
    """Single-shot entry (assemble + solve)."""
    asm = assemble(cfgs, datas, lg, v, masks)
    return solve_assembled(asm, v, masks, lam, max_iters, rel_tol, precond)


def solve_with_system(lg, v, rs: RcsSystem, g_r, g_l, max_iters=250, rel_tol=1e-10):
    """Re-solve with an existing damped system (reference sub-step reusing
    the factorization, Optimizer.cpp:958-1000)."""
    z = engine._chol_solve(rs.H_ll_inv, g_l)
    b = t_sub(g_r, w_y(rs, v, z))
    x_r, _, _ = pcg(rs, v, b, max_iters, rel_tol)
    x_l = engine._chol_solve(rs.H_ll_inv, g_l - w_transpose_x(rs, v, x_r))
    return x_r, x_l
