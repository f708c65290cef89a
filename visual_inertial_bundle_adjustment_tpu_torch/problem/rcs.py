"""Blocked reduced-camera-system solver: the single-pass paths.

Port of `visual_inertial_bundle_adjustment_tpu/problem/rcs.py` for the paths
the bias-only and full-sensor configurations take: every large visual batch
is REORDERED AT BUILD TIME into rig-sorted ragged tiles (finalize_blocks,
host numpy — the analog of BaSpaCho's symbolic analysis, reference
Optimizer.cpp:166-331); its per-observation Jacobians then feed the segment
kernels of ops/segments.py, which reduce straight into rig, landmark and
calibration-window rows: K2-K6 for rig-only batches, K8-K10 (+ K3) for
calibration-coupled ones (rig + cam_extr + cam_intr, the extr|intr window
columns folded into one J_cal). Small batches (inertial chains, priors,
random walks) stay on the generic engine paths and a stacked rest-graph
matvec.

Semantics (damping formula, Schur elimination, block-Jacobi + Gauss-Seidel
Schur-corrected preconditioner, packed PCG) are the JAX package's. Stated
limits: a visual batch that is neither single-pass rig-only nor single-pass
calibration-coupled (the two-grid permute path) and point-coupled small
batches raise NotImplementedError.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..ops import segments as seg
from . import engine
from . import factors as fct
from .structure import (Masks, Tangent, pack_blocks, pack_info, pack_t, t_dot, t_sub,
                        unpack_t, zero_tangent)

VISUAL_KINDS = ("visual", "rs_visual")

# Structurally nonzero rig tangent columns per visual kind: plain visual
# factors touch only the pose (rig tangent [pose 0:6, vel 6:9, omega 9:12])
RIG_COLS = {"visual": 6, "rs_visual": 9}


def _padk(y, k):
    """(n, k) rig-column result back to the full 12-column tangent layout."""
    return torch.nn.functional.pad(y, (0, 12 - k)) if k < 12 else y


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
    landmark rows in point-sorted order — the segment kernels' work lists."""
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
    i32 = np.int32
    return {"_rig_ptr": rig_ptr.astype(i32), "_rig_obs": real.astype(i32),
            "_pt_ptr": pt_ptr.astype(i32), "_pt_obs": real[porder].astype(i32)}


def finalize_blocks(problem, rb: int = 128, prb: int = 128, ts: int = 4096,
                    prb2_cap: int = 4096, nhg_cap: int = 2048):
    """Reorder visual batches by rig into ragged tiles (host numpy, one-time)
    and attach their reduction plans. Mutates problem.{cfgs,datas}; the slot
    order and the `_pad`/`_rb_*`/`_rg_*`/`_cb_*` arrays match the JAX
    package's finalize_blocks one to one (its lane-major `_uvT`/`_sh4` copies
    and the two-grid point permutations are not built). Calibration-coupled
    batches tile at rb = 112, as in the JAX package, so the slot order stays
    the same; their window plan gets the port's chunked window-row lists."""
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
                new.update(seg.cal_plan_arrays(
                    (cbase[:, None] + cloc).reshape(-1), pad, n_c))
            else:
                wb = 0
        pnt = len(_tile_plan(np.sort(pt_full[pad < 0.5]), prb, ts)[1])
        new.update(segment_plan(new["rig"], new["point"], pad, R, L))
        problem.datas[bi] = {k: torch.from_numpy(np.ascontiguousarray(a)).to(device)
                             for k, a in new.items()}
        problem.datas[bi].update(payload)
        problem.cfgs[bi] = dataclasses.replace(
            cfg, block_info=BlockInfo(rb_b, nt, ts, prb, pnt, ts, prb2, nhg, wb))
    return problem


def plan_of(data) -> seg.SegPlan:
    return seg.SegPlan(data["rig"], data["point"], data["_rig_ptr"], data["_rig_obs"],
                       data["_pt_ptr"], data["_pt_obs"])


def cal_plan_of(data, info) -> seg.CalPlan | None:
    """The window-row plan of a batch with a calibration-window plan."""
    if info.wb == 0 or "_cal_chunk_ptr" not in data:
        return None
    base = data["_cb_base"].repeat_interleave(info.ts)
    return seg.CalPlan((base + data["_cb_local"]).to(torch.int32), data["_cal_chunk_ptr"],
                       data["_cal_chunk_obs"], data["_cal_row_chunk"])


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
    J_cal: torch.Tensor | None = None  # (d, 23, N) [extr | intr]
    cplan: seg.CalPlan | None = None


def _single_pass(b: VisBatch):
    """Single-pass criterion of the JAX package: bounded per-tile point
    windows and a point table inside the accumulator cap."""
    return b.info.prb2 > 0 and b.info.nhg > 0


def _cal_fast(b: VisBatch):
    """Single-pass calibration-coupled batch (rig + window columns)."""
    return b.cplan is not None


def _split(cfgs, lg):
    """(visual (cfg, lin, w) triples, rest graph). Point-coupled small
    batches (below the blocking threshold) would need the generic Schur
    cross terms: not ported."""
    vis, rest_lins, rest_w = [], [], []
    for cfg, lin, w in zip(cfgs, lg.lins, lg.w):
        if cfg.block_info is not None:
            vis.append((cfg, lin, w))
            continue
        if fct.POINTS in lin.groups:
            raise NotImplementedError(
                f"point-coupled non-blocked batch ({cfg.kind}): the generic Schur path "
                "is not ported")
        rest_lins.append(lin)
        rest_w.append(w)
    rest = engine.LinearizedGraph(
        lins=tuple(rest_lins), w=tuple(rest_w), cost=lg.cost, stored_cost=(), valid0=(),
        num_invalid=lg.num_invalid, num_optional=lg.num_optional)
    return vis, rest


def _vis_batches(cfgs, datas, lg):
    """[(VisBatch, Lin)] for every blocked visual batch. A batch whose
    non-point groups are the rig plus cam_extr/cam_intr (sharing the window
    row) with a window plan folds the calibration Jacobians into J_cal."""
    out = []
    for (cfg, lin, w), data in zip(zip(cfgs, lg.lins, lg.w), datas):
        if cfg.block_info is None:
            continue
        info = cfg.block_info
        rig_k = RIG_COLS[cfg.kind]
        extra = tuple(zip(lin.groups[2:], lin.jac[2:]))
        cplan = cal_plan_of(data, info) if lin.groups[2:] else None
        if lin.groups[:2] != (fct.POINTS, fct.RIG) or (lin.groups[2:] and (
                cplan is None or lin.groups[2:] != (fct.CAM_EXTR, fct.CAM_INTR)
                or tuple(J.shape[1] for _, J in extra) != seg.CAL_SPLITS)):
            raise NotImplementedError(
                f"blocked batch with groups {lin.groups}: only rig-only and "
                "calibration-window-coupled batches are ported")
        b = VisBatch(info=info, w=w * (1.0 - data["_pad"]), rig_k=rig_k,
                     J=lin.jac[1][:, :rig_k, :].contiguous(), J_pt=lin.jac[0],
                     plan=plan_of(data),
                     cal_groups=tuple((g, J.shape[1]) for g, J in extra),
                     J_cal=torch.cat([J for _, J in extra], dim=1) if extra else None,
                     cplan=cplan)
        if not _single_pass(b):
            raise NotImplementedError("two-grid (unbounded point window) batch: not ported")
        out.append((b, lin))
    return out


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
    (ell, ell2) is the deterministic two-level transpose plan of rows."""

    rows: torch.Tensor  # (S, N) int64 packed-row ids
    J: torch.Tensor  # (S, d, K, N)
    w: torch.Tensor  # (N,)
    ell: torch.Tensor  # (n_chunks, ELL_WIDTH) int64 flat (S*N) slots per row chunk
    ell2: torch.Tensor  # (nb + 1, max chunks per row) int64 chunks per row


# row entries summed per chunk of the two-level transpose plan: a one-level
# plan pads every row to the busiest one (the gravity row is touched by every
# inertial factor: 12,000 at the full-sensor size, ~80M padded entries)
ELL_WIDTH = 64


def two_level_plan(rows_flat, n_rows, width=ELL_WIDTH):
    """Transpose plan of an index array, built on its device: the entries of
    each row (in index order) cut into chunks of at most `width`; ell
    (n_chunks, width) lists each chunk's entries (sentinel len(rows_flat)),
    ell2 (n_rows, max chunks per row) each row's chunks (sentinel n_chunks).
    Sums over ell then ell2 run in a fixed order (deterministic)."""
    n = rows_flat.shape[0]
    device = rows_flat.device
    order = torch.argsort(rows_flat, stable=True)
    srt = rows_flat[order]
    counts = torch.bincount(rows_flat, minlength=n_rows)
    pos = torch.arange(n, device=device) - (torch.cumsum(counts, 0) - counts)[srt]
    n_ch = (counts + width - 1) // width
    ch_start = torch.cumsum(n_ch, 0) - n_ch
    n_chunks, max_ch = int(n_ch.sum()), max(int(n_ch.max()), 1)
    ell = torch.full((n_chunks, width), n, dtype=torch.int64, device=device)
    ell[ch_start[srt] + pos // width, pos % width] = order
    j = torch.arange(max_ch, device=device)
    ell2 = torch.where(j[None, :] < n_ch[:, None], ch_start[:, None] + j[None, :],
                       torch.full((), n_chunks, device=device))
    return ell, ell2


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
        ell, ell2 = two_level_plan(rows.reshape(-1), nb + 1)
        stacks.append(RestStack(rows, torch.cat(J_p, dim=-1), torch.cat(w_p, dim=-1), ell, ell2))
    return tuple(stacks)


def rest_hmatvec(stacks, v, x: Tangent) -> Tangent:
    """H_rest x via the stacked operands (engine._hmatvec over the rest
    graph's reduced groups, up to summation order)."""
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
    blocks0: dict  # per-group UNdamped block-Jacobi blocks (rest graph + window self blocks)
    rest_stacks: tuple = ()  # tuple[RestStack]


class RcsSystem(NamedTuple):
    vis: tuple
    rest: object
    H_ll: torch.Tensor  # (L, 3, 3) damped
    H_ll_inv: torch.Tensor
    diag_r: Tangent  # undamped reduced diagonal
    lam: torch.Tensor
    precond_inv: Tangent | None
    rest_stacks: tuple = ()


_PRECOND_GROUPS = (fct.RIG, fct.CAM_INTR, fct.CAM_EXTR, fct.IMU_CALIB, fct.IMU_EXTR,
                   fct.DET_BIAS, fct.GRAVITY)


def _precond_blocks_static(rest, v, masks):
    """Lambda-free block-Jacobi blocks of the rest graph per group."""
    dims = fct.GROUP_DIMS
    kw = dict(dtype=v.points.dtype, device=v.points.device)
    blocks = {g: torch.zeros((getattr(masks, g).shape[0] if getattr(masks, g).ndim > 1 else 1,
                              dims[g], dims[g]), **kw) for g in _PRECOND_GROUPS}
    for lin, w in zip(rest.lins, rest.w):
        for group, idx, J, ell in zip(lin.groups, lin.idx, lin.jac, lin.ell):
            B = ((J * w[None, None, :])[:, :, None, :] * J[:, None, :, :]).sum(0)
            if group == fct.GRAVITY:
                blocks[group] = blocks[group] + B.sum(-1)[None]
            else:
                blocks[group] = blocks[group] + fct.scatter_rows(
                    ell, idx, B, blocks[group].shape[0])
    return blocks


def assemble(cfgs, datas, lg, v, masks: Masks) -> RcsAsm:
    """Everything lambda-independent for this linearization: rig-only
    batches through K2, calibration-coupled ones through K8 (which also
    gives the window gradient, diagonal and block-Jacobi self blocks)."""
    pairs = _vis_batches(cfgs, datas, lg)
    _, rest = _split(cfgs, lg)
    diag_r, _ = engine._hess_diag(rest, v)
    g_r, g_l = engine._accumulate_grad(rest, v)
    H_ll0 = v.points.new_zeros((v.points.shape[0], 3, 3))
    blocks0 = _precond_blocks_static(rest, v, masks)
    for b, lin in pairs:
        if _cal_fast(b):
            gr_b, dg_b, gc_b, dc_b, blocks_c, gl_b, H_b = seg.seg_assemble_cal(
                b.J, b.J_cal, b.J_pt, lin.res, b.w, b.plan, b.cplan)
            g_r, diag_r = _cal_scatter_back(b, g_r, gc_b), _cal_scatter_back(b, diag_r, dc_b)
            for (g, _), Bc in zip(b.cal_groups, blocks_c):
                blocks0[g] = blocks0[g] + Bc
        else:
            gr_b, dg_b, gl_b, H_b = seg.seg_assemble_rig(b.J, b.J_pt, lin.res, b.w, b.plan)
        g_r = g_r._replace(rig=g_r.rig + _padk(gr_b, b.rig_k))
        diag_r = diag_r._replace(rig=diag_r.rig + _padk(dg_b, b.rig_k))
        g_l = g_l + gl_b
        H_ll0 = H_ll0 + H_b
    return RcsAsm(tuple(b for b, _ in pairs), rest, H_ll0, diag_r, g_r, g_l, blocks0,
                  build_rest_stacks(rest, v))


def _precond_finish(asm: RcsAsm, v, masks, lam, H_ll_inv, precond="gauss_seidel"):
    """Per-lambda: rig blocks with the Schur self-correction (K3), damp,
    mask, invert. `precond`: "identity" -> None; "jacobi" -> no Schur
    correction; "gauss_seidel"/"lower_prec" -> corrected (reference
    Preconditioner.h)."""
    if precond == "identity":
        return None
    schur_corr = precond in ("gauss_seidel", "lower_prec")
    blocks = dict(asm.blocks0)
    Hinv_used = H_ll_inv if schur_corr else torch.zeros_like(H_ll_inv)
    for b in asm.vis:
        blocks[fct.RIG] = blocks[fct.RIG] + _padkk(
            seg.seg_precond_rig(b.J, b.J_pt, b.w, Hinv_used, b.plan), b.rig_k)
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
                     asm.rest_stacks)


# ---------------------------------------------------------------------------
# Matvec / PCG (per lambda)
# ---------------------------------------------------------------------------


def w_transpose_x(rs: RcsSystem, v, x: Tangent):
    """W^T x (L, 3) (K6, or K10's down pass for calibration-coupled batches)."""
    t = torch.zeros_like(v.points)
    for b in rs.vis:
        x_r = x.rig[:, :b.rig_k].contiguous()
        if _cal_fast(b):
            _, _, t_b, _ = seg.seg_schur_down_cal(b.J, b.J_cal, b.J_pt, b.w, x_r,
                                                  _cal_table(b, x), b.plan, b.cplan,
                                                  want_y=False)
        else:
            _, t_b, _ = seg.seg_schur_down(b.J, b.J_pt, b.w, x_r, b.plan, want_y=False)
        t = t + t_b
    return t


def w_y(rs: RcsSystem, v, yl):
    """W y_l (Tangent) (K5, or K10's up pass)."""
    y = zero_tangent(v)
    yl = yl.contiguous()
    for b in rs.vis:
        if _cal_fast(b):
            y_r, y_c = seg.seg_schur_up_cal(b.J, b.J_cal, b.J_pt, b.w, yl, b.plan, b.cplan)
            y = _cal_scatter_back(b, y, y_c)
        else:
            y_r = seg.seg_schur_up(b.J, b.J_pt, b.w, yl, b.plan)
        y = y._replace(rig=y.rig + _padk(y_r, b.rig_k))
    return y


def _matvec_factor_sums(rs: RcsSystem, v, x: Tangent) -> Tangent:
    """H_rr x - W H_ll^-1 W^T x, no damping. One visual batch (the bench
    shapes) runs as K4 or K9; several batches sum their down passes before
    the landmark solve and subtract their up passes after."""
    hx = rest_hmatvec(rs.rest_stacks, v, x)
    if len(rs.vis) == 1:
        b = rs.vis[0]
        x_r = x.rig[:, :b.rig_k].contiguous()
        if _cal_fast(b):
            y_r, y_c = seg.seg_schur_pcg_cal(b.J, b.J_cal, b.J_pt, b.w, x_r, _cal_table(b, x),
                                             rs.H_ll_inv, b.plan, b.cplan)
            hx = _cal_scatter_back(b, hx, y_c)
        else:
            y_r = seg.seg_schur_pcg(b.J, b.J_pt, b.w, x_r, rs.H_ll_inv, b.plan)
        return hx._replace(rig=hx.rig + _padk(y_r, b.rig_k))
    t = torch.zeros_like(v.points)
    for b in rs.vis:
        x_r = x.rig[:, :b.rig_k].contiguous()
        if _cal_fast(b):
            y_b, y_c, t_b, _ = seg.seg_schur_down_cal(b.J, b.J_cal, b.J_pt, b.w, x_r,
                                                      _cal_table(b, x), b.plan, b.cplan)
            hx = _cal_scatter_back(b, hx, y_c)
        else:
            y_b, t_b, _ = seg.seg_schur_down(b.J, b.J_pt, b.w, x_r, b.plan)
        hx = hx._replace(rig=hx.rig + _padk(y_b, b.rig_k))
        t = t + t_b
    return t_sub(hx, w_y(rs, v, engine._chol_solve(rs.H_ll_inv, t)))


def matvec(rs: RcsSystem, v, x: Tangent) -> Tangent:
    """S x = (H_rr + damping) x - W H_ll^-1 W^T x."""
    S = _matvec_factor_sums(rs, v, x)
    return Tangent(*(h + rs.lam * (d * xv) + rs.lam * xv
                     for h, d, xv in zip(S, rs.diag_r, x)))


def pcg(rs: RcsSystem, v, b: Tangent, max_iters: int, rel_tol):
    """Packed-state PCG on the reduced system (reference PCG.cpp:15-97).

    Runs exactly `max_iters` iterations with no host synchronization; the
    stop test rr > rel_tol^2 |b|^2 (checked before each iteration, as the
    JAX package's while_loop does) is an on-device mask that freezes x, r, z,
    p once met. Returns (x, rel, iters) with rel and iters as 0-d tensors."""
    counts, dims, K = pack_info(b)
    bp = pack_t(b, counts, dims, K)
    Pm = (pack_blocks(rs.precond_inv, counts, dims, K)
          if rs.precond_inv is not None else None)

    def prec(rp):
        return rp if Pm is None else (Pm * rp[:, None, :]).sum(-1)

    tol2 = float(rel_tol) ** 2
    x = torch.zeros_like(bp)
    r = bp
    z = prec(bp)
    p = z
    rz = (bp * z).sum()
    b_norm2 = (bp * bp).sum()
    rr = b_norm2
    iters = torch.zeros((), dtype=torch.int64, device=bp.device)
    for _ in range(max_iters):
        active = rr > tol2 * b_norm2
        Ap = pack_t(matvec(rs, v, unpack_t(p, counts, dims, K)), counts, dims, K)
        pAp = (p * Ap).sum()
        alpha = rz / torch.where(pAp == 0, torch.ones_like(pAp), pAp)
        x_n = x + alpha * p
        r_n = r - alpha * Ap
        z_n = prec(r_n)
        rz_n = (r_n * z_n).sum()
        rr_n = (r_n * r_n).sum()
        beta = rz_n / torch.where(rz == 0, torch.ones_like(rz), rz)
        p_n = z_n + beta * p
        x = torch.where(active, x_n, x)
        r = torch.where(active, r_n, r)
        p = torch.where(active, p_n, p)
        rz = torch.where(active, rz_n, rz)
        rr = torch.where(active, rr_n, rr)
        iters = iters + active.to(torch.int64)
    rel = torch.sqrt(rr / torch.where(b_norm2 == 0, torch.ones_like(b_norm2), b_norm2))
    return unpack_t(x, counts, dims, K), rel, iters


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
