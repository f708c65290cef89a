"""Segment kernels of the blocked reduced-camera-system solver (K2-K6, K8-K10,
K12-K14).

Port of the single-pass rig-grid entries and of the table entries of the
general (two-grid) path of
`visual_inertial_bundle_adjustment_tpu/ops/segments.py`. Every entry
reduces per-observation products of a blocked visual batch into rig rows,
landmark rows and, for calibration-coupled batches, calibration-window rows:

  seg_assemble_rig    g_r, diag(J_r^T w J_r) per rig; g_l, H_ll0 per landmark (K2)
  seg_precond_rig     per-rig blocks sum w J_r J_r^T - A H_ll^-1[pt] A^T,
                      A = J_r^T w J_p (K3)
  seg_schur_down      y = sum_rig J_r^T w J_r x and t = W^T x (K6)
  seg_schur_up        W z = sum_rig J_r^T w J_p z[pt] (K5)
  seg_schur_pcg       the PCG matvec y = J_r^T w J_r x - W H_ll^-1 W^T x (K4)
  seg_assemble_cal    K2 plus, per window row, g_c, diag_c and the full
                      self-blocks of each calibration split (K8)
  seg_schur_down_cal  K6 with u = J_r x_r[rig] + J_c x_c[win]: y_r, y_c, t (K10)
  seg_schur_up_cal    K5 into rig and window rows (K10)
  seg_schur_pcg_cal   K4's function over rig and window columns (K9)
  seg_schur_pcg_cols      K4 on C right-hand sides, x (R, k, C)
  seg_schur_pcg_cal_cols  K9 on C right-hand sides, x_r (R, k, C), x_c (n_c, kc, C)
  seg_mv_fused_table    wu = w (J x[row]), y[row] = sum J^T wu, J read once (K12)
  seg_mv_scatter_table  y[row] = sum J^T u (K13a)
  seg_mv_gather_table   u = J x[row] (K13b)
  seg_reduce_table      y[row] = sum contrib[:, slot] (K13c)
  seg_reduce_partials   tile partials (nt, rb, D) of contrib (K14a)
  seg_gather_from_tiles per-slot rows of gathered tile rows (K14b)
  seg_mv_fused          wu = w (J x_g), tile partials of J^T wu (K14c)
  seg_mv_gather         u = J x_g (K14d)
  seg_mv_scatter        tile partials of J^T u (K14e)

K12 and K13 take a RowPlan: one index family of the batch (rig rows,
landmark rows, or the rows of another variable group) with the CSR list of
each row's real slots; the solver's general path runs on them (the landmark
family is a list over the rig-ordered arrays). The JAX entries take per-tile
local indices and bases of a rig grid or of a second, point-sorted grid;
K14a-e keep that layout (the grid's local indices, a TilePlan of runs for
the reduce side, gather_tiles / scatter_partials around them), and
profile_matvec.py composes the general-path matvec from them.

The rig Jacobian carries rig_k = 6 (pose) or 9 (pose + velocity, rolling
shutter) columns; the window Jacobian J_c the calibration columns of the
batch's folded groups, in cal_groups order: [extr 6 | intr 17] (kc = 23),
or extr or intr alone (kc = 6, 17).

Kernels: csrc/assemble_rig.cu, csrc/precond_rig.cu, csrc/schur.cu,
csrc/cal_assemble.cu, csrc/cal_pcg.cu, csrc/cal_pcg_cols.cuh (its units
csrc/cal_pcg_cols.cu, csrc/cal_pcg_cols_k9.cu),
csrc/table_segments.cu, csrc/tile_segments.cu, on the
group-per-segment skeleton of csrc/tile_reduce.cuh, templated on rig_k (and
on kc for the window kernels). They replace the Pallas kernels
_assemble_rig_kernel (JAX ops/segments.py:840), _precond_rig_kernel (:1861),
_schur_down_kernel (:586), _schur_up_kernel (:725), _down_light_kernel
(:1318), _up_du_kernel (:1347), _assemble_cal_kernel (:1674),
_schur_down_cal_kernel (:1005), _schur_up_cal_kernel (:1146),
_down_light_cal_kernel (:1468), _up_du_cal_kernel (:1519),
_mv_fused_tbl_kernel (:304), _mv_scatter_tbl_kernel (:366),
_mv_gather_tbl_kernel (:406), _reduce_tbl_kernel (:441), _seg_reduce_kernel
(:97), _seg_gather_kernel (:135), _mv_fused_kernel (:170), _mv_gather_kernel
(:221) and _mv_scatter_kernel (:249).

Design on the card. The TPU grid ran tiles in order and accumulated into
VMEM-resident tables through one-hot MXU dots; on Hopper blocks run in
parallel, so each output row is instead owned by one thread group that walks
that row's observations through a CSR list and reduces in a fixed order —
deterministic, with no atomics. Rig rows (~300 observations each at the
full-sensor size) and landmark rows (~30) are single segments (K3 takes a
warp per rig row and walks the row's slot range itself: rows are contiguous
runs of the rig-sorted tiles, and the pads among them weigh 0). Window rows
are few and long (120 rows of ~15k observations), so K8 cuts their lists
into chunks of CHUNK slots: one group per chunk writes a partial row, and a
second pass sums each row's partials in chunk order; K9 and K10 instead
write one partial row per (rig, window row) pair of a rig row's walk, and
a second pass sums each window row's partials in rig order. What bounds them:
bytes of J read per pass — 2 x (rig_k + 3 (+ 23)) floats per observation.

Walking a landmark's list reads the rig-ordered arrays at scattered slots,
one 32-byte sector per float. K4, K6, K9 and K10 therefore go through each
slot's point-sorted position (SegPlan.pt_pos, built with the lists): a down
pass, in slot order and coalesced, writes each slot's 3 landmark-side values
there as one float4, and one landmark pass (csrc/pt_segments.cuh) sums each
landmark's contiguous range and, for K4 and K9, applies H_ll^-1. K6 is two
launches (down to the positions, per slot or, with y, per rig row; the
landmark sums); K4 three (the same, then up per rig row with w J_r x
recomputed); K9 four (the same, with one window partial per (rig, window
row) pair in its up pass, then the window rows' sums); K10's down pass two
(t only: K9's down, then the landmark sums; with y: a 128-thread group
per rig row over its pairs storing p beside y_r and the pair partials,
then the landmark sums and the window rows' sums in one launch), its up
pass two (the same walk with w J_p z[point] in registers, then the
window rows' sums). K2's slots pass (and so K8's first) writes one
32-byte sector a slot at the same
positions, sqrt(w) J_p and sqrt(w) res (robust weights, w >= 0), and a
16-lane group per landmark sums its range. On a scattered family
(RowPlan.scattered: the landmark rows) K13a writes J^T u and K13c copies
contrib slot-major, coalesced, and each gathers a slot's values as one or
two sectors of that copy.

The column K4 and K9 (the covariance columns, C right-hand sides in one
call) run over a point-sorted copy of the batch's slot data instead,
PtRecords, made once per reduced system (point_sorted_records; rcs.
with_column_records): one record per real slot at its point-sorted
position, each Jacobian column as its two residual rows, then w and the
slot's rig, window and point rows. A landmark pass fuses the down pass into
the landmark sums (z = H_ll^-1 W^T x for every column); a rig pass computes
each slot's du for its column in registers (K4; K9 at 32 columns, its lane
classes split over a block's warps) or into a shared-memory tile (K9 at 1
or 8 columns) and sums the rig rows (and K9's (rig, window row) pairs);
K9's window rows then sum their pair partials. Each pass reads a record once for a tile of 32
columns, and nothing is stored per (slot, column); every column is summed
in the single-column kernel's order, so each column has its bits.

K3-K6, K9 and K10 also take bf16 Jacobians (J_r, J_c and J_p of one type):
the PCG loop's copies under rcs.MATVEC_BF16. Each kernel has a bf16
instantiation that upcasts an element where it loads it and computes in
float32 as before (csrc/tile_reduce.cuh jf), so it gives the float32
instantiation's bits on the upcast values; each plain version upcasts its
J to w's type once, at entry.

The plain PyTorch versions below compute the same functions with
`index_add_` over the global rig/point/window index (or tile row) of each
slot; CPU tensors take them. Nothing that a CUDA tensor reaches sums with
`index_add_` or any other float atomics.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import _kernels

CHUNK = 1024  # window-row slots per partial sum (K8)
# calibration column splits of J_c by its width kc, in cal_groups order:
# cam extr and cam intr (6 | 17), or one of them alone
CAL_SPLITS = {23: (6, 17), 6: (6,), 17: (17,)}
RIG_KS = (6, 9)  # rig Jacobian widths the kernels are built for
# the Jacobian element types of the kernels, by the code their C entries
# take (csrc/tile_reduce.cuh VIBA_BY_JTYPE): float32, and bf16 for the PCG
# loop's copies (rcs.MATVEC_BF16), which K3-K6, K9 and K10 also read (the
# code is also what a launch adds to its wrapper's bf16_launches)
J_TYPES = {torch.float32: 0, torch.bfloat16: 1}


class SegPlan(NamedTuple):
    """Per-batch reduction plan (host-built in rcs.finalize_blocks)."""

    rig: torch.Tensor  # (N,) int32 global rig row of each slot (pads: tile base)
    point: torch.Tensor  # (N,) int32 global point row of each slot (pads: 0)
    rig_ptr: torch.Tensor  # (R+1,) int32 CSR offsets into rig_obs
    rig_obs: torch.Tensor  # (n_real,) int32 real slots, rig-sorted
    pt_ptr: torch.Tensor  # (L+1,) int32 CSR offsets into pt_obs
    pt_obs: torch.Tensor  # (n_real,) int32 real slots, point-sorted
    # (N,) int32 point-sorted position of each slot: pt_pos[pt_obs[j]] = j,
    # -1 on the pads (K4 and K9 write slot values there, so each landmark's
    # are one contiguous run)
    pt_pos: torch.Tensor

    @property
    def n_rows(self):
        return self.rig_ptr.shape[0] - 1

    @property
    def n_pts(self):
        return self.pt_ptr.shape[0] - 1


class CalPlan(NamedTuple):
    """Window-row reduction plan of a calibration-coupled batch: each row's
    real slots (slot order) cut into chunks of at most CHUNK slots (K8);
    and the (rig, window row) pairs of K9's up pass and K10's passes, in rig
    order, each pair's J_c^T du summed into one partial row
    (pair_plan_arrays)."""

    win: torch.Tensor  # (N,) int32 global window row of each slot (pads: tile base)
    chunk_ptr: torch.Tensor  # (n_chunks+1,) int32 CSR offsets into chunk_obs
    chunk_obs: torch.Tensor  # (n_real,) int32 real slots, window-sorted
    row_chunk: torch.Tensor  # (n_c+1,) int32 offsets of each row's chunks
    rig_pair: torch.Tensor  # (R+1,) int32 offsets of each rig's pairs
    pair_ptr: torch.Tensor  # (n_pairs+1,) int32 CSR offsets into pair_obs
    pair_obs: torch.Tensor  # (n_real,) int32 real slots by (rig, window row)
    pair_part: torch.Tensor  # (n_pairs,) int32 partial row of each pair
    win_pair: torch.Tensor  # (n_c+1,) int32 offsets of each row's partials

    @property
    def n_rows(self):
        return self.row_chunk.shape[0] - 1

    @property
    def n_chunks(self):
        return self.chunk_ptr.shape[0] - 1

    @property
    def n_pairs(self):
        return self.pair_ptr.shape[0] - 1


class RowPlan(NamedTuple):
    """One index family of a blocked batch for the table kernels (K12, K13):
    the row of every slot and the CSR list of each segment's real slots. A
    segment is a whole row, or, for a family of few long rows (row_chunk
    given), a chunk of at most CHUNK slots whose partial sums a second pass
    adds in chunk order. A scattered family (the landmark rows, whose slots
    lie far apart in the rig-ordered arrays) is reduced by K13a and K13c
    through slot-major copies."""

    row: torch.Tensor  # (N,) int32 row of each slot (pads: any valid row)
    ptr: torch.Tensor  # (n_seg+1,) int32 CSR offsets into obs
    obs: torch.Tensor  # (n_real,) int32 real slots, row-sorted
    row_chunk: torch.Tensor | None = None  # (n_rows+1,) int32 chunk offsets per row
    scattered: bool = False  # lists that reach slots far apart (K13a, K13c gather)

    @property
    def n_seg(self):
        return self.ptr.shape[0] - 1

    @property
    def n_rows(self):
        return (self.ptr if self.row_chunk is None else self.row_chunk).shape[0] - 1


def rig_rows(plan: SegPlan) -> RowPlan:
    """The rig family of a batch (slot order: contiguous runs per rig)."""
    return RowPlan(plan.rig, plan.rig_ptr, plan.rig_obs)


def point_rows(plan: SegPlan) -> RowPlan:
    """The landmark family of a batch, over the rig-ordered arrays."""
    return RowPlan(plan.point, plan.pt_ptr, plan.pt_obs, scattered=True)


def chunked_rows(row, arrays, prefix="_cal_") -> RowPlan:
    """A chunked family from cal_plan_arrays' tensors (keys `<prefix>*`)."""
    return RowPlan(row, arrays[prefix + "chunk_ptr"], arrays[prefix + "chunk_obs"],
                   arrays[prefix + "row_chunk"])


def cal_plan_arrays(win, pad, n_rows, chunk=CHUNK):
    """Host numpy arrays of a CalPlan (keys `_cal_*`) for window rows `win`
    (N,) of a blocked batch with pad flags `pad`."""
    real = np.nonzero(pad < 0.5)[0]
    w = win[real].astype(np.int64)
    order = np.argsort(w, kind="stable")
    obs = real[order]
    counts = np.bincount(w, minlength=n_rows)
    n_ch = -(-counts // chunk)
    row_chunk = np.zeros(n_rows + 1, np.int64)
    np.cumsum(n_ch, out=row_chunk[1:])
    row_start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    starts = np.concatenate([row_start[r] + chunk * np.arange(n_ch[r]) for r in range(n_rows)]
                            + [np.zeros(0, np.int64)])
    chunk_ptr = np.concatenate([starts, [len(obs)]]).astype(np.int64)
    i32 = np.int32
    return {"_cal_chunk_ptr": chunk_ptr.astype(i32), "_cal_chunk_obs": obs.astype(i32),
            "_cal_row_chunk": row_chunk.astype(i32)}


def pair_plan_arrays(rig, win, pad, n_rig, n_win):
    """Host numpy arrays (keys `_cal_*`) of K9's (rig, window row) pairs for
    rig rows `rig` and window rows `win` (N,) of a blocked batch with pad
    flags `pad`: the real slots sorted by (rig, window row), slot order
    inside a pair; each rig's pairs; and where each pair's partial row goes,
    so that a window row's partials lie together, in rig order."""
    real = np.nonzero(pad < 0.5)[0]
    r, w = rig[real].astype(np.int64), win[real].astype(np.int64)
    order = np.lexsort((w, r))  # by rig, then window row; stable
    obs, key = real[order], r[order] * n_win + w[order]
    first = np.flatnonzero(np.r_[True, key[1:] != key[:-1]]) if len(key) else np.zeros(0, int)
    pr, pw = key[first] // n_win, key[first] % n_win
    rig_pair = np.zeros(n_rig + 1, np.int64)
    np.cumsum(np.bincount(pr, minlength=n_rig), out=rig_pair[1:])
    win_pair = np.zeros(n_win + 1, np.int64)
    np.cumsum(np.bincount(pw, minlength=n_win), out=win_pair[1:])
    part = np.empty(len(first), np.int64)
    part[np.argsort(pw, kind="stable")] = np.arange(len(first))
    i32 = np.int32
    return {"_cal_rig_pair": rig_pair.astype(i32),
            "_cal_pair_ptr": np.r_[first, len(obs)].astype(i32), "_cal_pair_obs": obs.astype(i32),
            "_cal_pair_part": part.astype(i32), "_cal_win_pair": win_pair.astype(i32)}


def _rows_sum(contrib, idx, n_rows):
    """contrib (D, N) summed into (n_rows, D) rows by idx (N,)."""
    out = torch.zeros((n_rows, contrib.shape[0]), dtype=contrib.dtype,
                      device=contrib.device)
    return out.index_add_(0, idx, contrib.T)


def _tri_to_full(tri, k=3):
    """(n, k(k+1)/2) row-major upper triangle -> (n, k, k) symmetric."""
    iu = torch.triu_indices(k, k)
    full = tri.new_zeros((tri.shape[0], k, k))
    full[:, iu[0], iu[1]] = tri
    full[:, iu[1], iu[0]] = tri
    return full


def _chunk_ptrs(cplan):
    """K8's window chunk lists: chunk_ptr, chunk_obs, row_chunk."""
    ck = _kernels.check
    return (ck(cplan.chunk_ptr, "chunk_ptr", torch.int32),
            ck(cplan.chunk_obs, "chunk_obs", torch.int32),
            ck(cplan.row_chunk, "row_chunk", torch.int32))


def _jac_args(J_r, J_p, w, mv=False):
    """(N, rig_k, J type code, pointers of J_r, J_p and w). float32 J, or
    with mv (a kernel of the PCG loop) bf16 J too, J_r and J_p of one
    type; w float32."""
    d, k, n = J_r.shape
    if d != 2 or k not in RIG_KS:
        raise ValueError(f"kernels take rig J blocks of shape (2, k in {RIG_KS}, N), "
                         f"got {tuple(J_r.shape)}")
    jt = J_r.dtype if mv and J_r.dtype in J_TYPES else torch.float32
    ck = _kernels.check
    return n, k, J_TYPES[jt], (ck(J_r, "J_r", jt, (2, k, n)), ck(J_p, "J_p", jt, (2, 3, n)),
                               ck(w, "w", torch.float32, (n,)))


def _cal_splits(J_c):
    kc = J_c.shape[1]
    if kc not in CAL_SPLITS:
        raise ValueError(f"J_c: window Jacobians of {tuple(CAL_SPLITS)} columns, got {kc}")
    return CAL_SPLITS[kc]


def _jc_arg(J_c, n, dtype=torch.float32):
    """The pointer of J_c, of J_r's type `dtype`."""
    return _kernels.check(J_c, "J_c", dtype, (2, sum(_cal_splits(J_c)), n))


def _upcast(w, *J):
    """The Jacobians in w's type, as the kernels upcast bf16 J (rcs.
    MATVEC_BF16) where they load it: the plain versions compute the
    kernels' function (a product of two bf16 tensors would stay bf16)."""
    return tuple(None if a is None else a.to(w.dtype) for a in J)


def _empty(shape, like):
    return torch.empty(shape, dtype=torch.float32, device=like.device)


# ---------------------------------------------------------------------------
# K2: lambda-independent assembly
# ---------------------------------------------------------------------------


def _assemble_rig_plain(J_r, J_p, res, w, plan):
    wres = res * w[None, :]
    g_r = _rows_sum((J_r * wres[:, None, :]).sum(0), plan.rig, plan.n_rows)
    diag_r = _rows_sum((J_r * J_r * w[None, None, :]).sum(0), plan.rig, plan.n_rows)
    g_l = (J_p * wres[:, None, :]).sum(0)  # (3, N)
    Jw = J_p * w[None, None, :]
    tri = torch.stack([(Jw[:, a] * J_p[:, b]).sum(0)
                       for a, b in ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))])
    pt = _rows_sum(torch.cat([g_l, tri]), plan.point, plan.n_pts)
    return g_r, diag_r, pt[:, :3].contiguous(), _tri_to_full(pt[:, 3:])


def _k2_ptrs(plan):
    """The lists and positions K2's passes read: rig_ptr, rig_obs, pt_ptr,
    pt_pos."""
    ck = _kernels.check
    return (ck(plan.rig_ptr, "rig_ptr", torch.int32), ck(plan.rig_obs, "rig_obs", torch.int32),
            ck(plan.pt_ptr, "pt_ptr", torch.int32),
            ck(plan.pt_pos, "pt_pos", torch.int32, (plan.rig.shape[0],)))


def _sector_scratch(plan, like):
    """K2's point-sorted sectors, sqrt(w) (J_p row 0, res 0 | J_p row 1,
    res 1) a real slot; every row is written by its slot: no memset."""
    return _empty((plan.pt_obs.shape[0], 8), like)


@_kernels.register("assemble_rig")
def seg_assemble_rig(J_r, J_p, res, w, plan: SegPlan):
    """g_r (R, k), diag_r (R, k), g_l (L, 3), H_ll0 (L, 3, 3) of one batch;
    w >= 0 (robust weights: the kernel stores sqrt(w) J_p). On the card K2
    in two launches (csrc/assemble_rig.cu viba_assemble_rig: a group per rig
    row beside each slot's sector stored at its point-sorted position, then
    a 16-lane group per landmark)."""
    if not _kernels.on_card(w, "assemble_rig"):
        return _assemble_rig_plain(J_r, J_p, res, w, plan)
    n, k, _, jargs = _jac_args(J_r, J_p, w)
    R, L = plan.n_rows, plan.n_pts
    g_r, diag_r = _empty((R, k), w), _empty((R, k), w)
    g_l, H = _empty((L, 3), w), _empty((L, 3, 3), w)
    res_p = _kernels.check(res, "res", torch.float32, (2, n))
    _kernels.launch("viba_assemble_rig", R, L, n, k, *_k2_ptrs(plan), *jargs, res_p,
                    g_r.data_ptr(), diag_r.data_ptr(), g_l.data_ptr(), H.data_ptr(),
                    _sector_scratch(plan, w).data_ptr())
    seg_assemble_rig.launches += 1
    return g_r, diag_r, g_l, H


# ---------------------------------------------------------------------------
# K3: Schur-corrected block-Jacobi rig blocks (per lambda)
# ---------------------------------------------------------------------------


def _precond_rig_plain(J_r, J_p, w, hinv, plan):
    J_r, J_p = _upcast(w, J_r, J_p)
    Hn = hinv.index_select(0, plan.point)  # (N, 3, 3)
    Jw = J_r * w[None, None, :]
    A = (Jw[:, :, None, :] * J_p[:, None, :, :]).sum(0)  # (k, 3, N)
    C = (A[:, :, None, :] * Hn.permute(1, 2, 0)[None]).sum(1)  # (k, 3, N)
    corr = (C[:, None, :, :] * A[None, :, :, :]).sum(2)  # (k, k, N)
    B = (Jw[:, :, None, :] * J_r[:, None, :, :]).sum(0)  # (k, k, N)
    k = J_r.shape[1]
    M = _rows_sum((B - corr).reshape(k * k, -1), plan.rig, plan.n_rows).reshape(-1, k, k)
    return 0.5 * (M + M.transpose(-1, -2))


@_kernels.register("precond_rig")
def seg_precond_rig(J_r, J_p, w, hinv, plan: SegPlan):
    """(R, k, k) rig blocks sum w J J^T - (J^T w J_p) H_ll^-1 (J^T w J_p)^T,
    symmetric (CG needs a symmetric preconditioner; the kernel accumulates
    the upper triangle over each rig row's slot range: the pads there have
    w = 0). J float32, or bf16 (rcs.MATVEC_BF16)."""
    if not _kernels.on_card(w, "precond_rig"):
        return _precond_rig_plain(J_r, J_p, w, hinv, plan)
    n, k, jt, jargs = _jac_args(J_r, J_p, w, mv=True)
    R, L = plan.n_rows, plan.n_pts
    blocks = _empty((R, k, k), w)
    ck = _kernels.check
    _kernels.launch("viba_precond_rig", R, n, k, jt,
                    ck(plan.rig_ptr, "rig_ptr", torch.int32),
                    ck(plan.rig_obs, "rig_obs", torch.int32),
                    ck(plan.point, "point", torch.int32, (n,)), *jargs,
                    ck(hinv, "hinv", torch.float32, (L, 3, 3)), blocks.data_ptr())
    seg_precond_rig.launches += 1
    seg_precond_rig.bf16_launches += J_TYPES[J_r.dtype]
    return blocks


# ---------------------------------------------------------------------------
# K6 / K5 / K4: Schur matvec halves
# ---------------------------------------------------------------------------


def _schur_down_staged(J_r, J_p, w, x_table, plan, want_y):
    """(y or None, t, wu (2, N) = w J_r x): K6's function with the per-slot
    wu staged, which the plain K4 composition reuses."""
    J_r, J_p = _upcast(w, J_r, J_p)
    xg = x_table.index_select(0, plan.rig)  # (N, k)
    wu = (J_r * xg.T[None]).sum(1) * w[None, :]  # (d, N)
    y = _rows_sum((J_r * wu[:, None, :]).sum(0), plan.rig, plan.n_rows) if want_y else None
    t = _rows_sum((J_p * wu[:, None, :]).sum(0), plan.point, plan.n_pts)
    return y, t, wu


def _launch_schur_down(J_r, J_p, w, x_table, plan, want_y):
    """K6 in two launches (csrc/schur.cu viba_schur_down): p = J_p^T w J_r x
    at each slot's point-sorted position (per slot, or per rig row with y),
    then t = the landmark sums of p."""
    n, k, jt, jargs = _jac_args(J_r, J_p, w, mv=True)
    R, L = plan.n_rows, plan.n_pts
    n_real = plan.pt_obs.shape[0]
    ck = _kernels.check
    y = _empty((R, k), w) if want_y else None
    t = _empty((L, 3), w)
    p = _empty((n_real, 4), w)  # float4 per slot, point-sorted
    _kernels.launch("viba_schur_down", R, L, n, n_real, k, jt, int(bool(want_y)),
                    ck(plan.rig, "rig", torch.int32, (n,)),
                    ck(plan.pt_pos, "pt_pos", torch.int32, (n,)),
                    ck(plan.pt_ptr, "pt_ptr", torch.int32, (L + 1,)),
                    ck(plan.rig_ptr, "rig_ptr", torch.int32, (R + 1,)),
                    ck(plan.rig_obs, "rig_obs", torch.int32, (n_real,)), *jargs,
                    ck(x_table, "x_table", torch.float32, (R, k)),
                    y.data_ptr() if want_y else None, t.data_ptr(), p.data_ptr())
    return y, t


@_kernels.register("schur_down")
def seg_schur_down(J_r, J_p, w, x_table, plan: SegPlan, want_y=True):
    """(y (R, k) = seg-sum_rig J_r^T w J_r x, or None without want_y;
    t (L, 3) = seg-sum_pt J_p^T w J_r x = W^T x). J float32, or bf16
    (rcs.MATVEC_BF16)."""
    if not _kernels.on_card(w, "schur_down"):
        return _schur_down_staged(J_r, J_p, w, x_table, plan, want_y)[:2]
    out = _launch_schur_down(J_r, J_p, w, x_table, plan, want_y)
    seg_schur_down.launches += 1
    seg_schur_down.bf16_launches += J_TYPES[J_r.dtype]
    return out


def _schur_up_plain(J_r, J_p, w, z, plan, wu):
    J_r, J_p = _upcast(w, J_r, J_p)
    zg = z.index_select(0, plan.point)  # (N, 3)
    wu2 = (J_p * zg.T[None]).sum(1) * w[None, :]  # (d, N)
    du = wu2 if wu is None else wu - wu2
    return _rows_sum((J_r * du[:, None, :]).sum(0), plan.rig, plan.n_rows)


def _launch_schur_up(J_r, J_p, w, z, plan):
    """K5 in one launch (csrc/schur.cu viba_schur_up: a 128-thread group per
    rig row, each thread's slots in batches whose loads are all in flight
    before the first product)."""
    n, k, jt, jargs = _jac_args(J_r, J_p, w, mv=True)
    R, L = plan.n_rows, plan.n_pts
    y = _empty((R, k), w)
    ck = _kernels.check
    _kernels.launch("viba_schur_up", R, n, k, jt,
                    ck(plan.rig_ptr, "rig_ptr", torch.int32),
                    ck(plan.rig_obs, "rig_obs", torch.int32),
                    ck(plan.point, "point", torch.int32, (n,)), *jargs,
                    ck(z, "z", torch.float32, (L, 3)), y.data_ptr())
    return y


@_kernels.register("schur_up")
def seg_schur_up(J_r, J_p, w, z, plan: SegPlan, wu=None):
    """y (R, k) = seg-sum_rig J_r^T w J_p z[pt] (= W z); with the staged
    wu = w J_r x of _schur_down_staged (plain version only; K4 replaced
    that composition on the card): seg-sum_rig J_r^T (wu - w J_p z[pt]).
    J float32, or bf16 (rcs.MATVEC_BF16)."""
    if not _kernels.on_card(w, "schur_up"):
        return _schur_up_plain(J_r, J_p, w, z, plan, wu)
    if wu is not None:
        raise ValueError("seg_schur_up: the kernel takes no staged wu (seg_schur_pcg is the "
                         "composition's kernel)")
    y = _launch_schur_up(J_r, J_p, w, z, plan)
    seg_schur_up.launches += 1
    seg_schur_up.bf16_launches += J_TYPES[J_r.dtype]
    return y


def _launch_schur_pcg(J_r, J_p, w, x_table, hinv, plan):
    """K4 in three launches (csrc/schur.cu viba_schur_pcg): p = J_p^T w J_r x
    at each slot's point-sorted position, z = H_ll^-1 (landmark sums of p),
    then per rig row y = sum J_r^T (w J_r x - w J_p z[pt])."""
    n, k, jt, jargs = _jac_args(J_r, J_p, w, mv=True)
    R, L = plan.n_rows, plan.n_pts
    n_real = plan.pt_obs.shape[0]
    ck = _kernels.check
    p = _empty((n_real, 4), w)  # float4 per slot, point-sorted
    z, y = _empty((L, 3), w), _empty((R, k), w)
    _kernels.launch("viba_schur_pcg", R, L, n, n_real, k, jt,
                    ck(plan.rig, "rig", torch.int32, (n,)),
                    ck(plan.point, "point", torch.int32, (n,)),
                    ck(plan.pt_pos, "pt_pos", torch.int32, (n,)),
                    ck(plan.pt_ptr, "pt_ptr", torch.int32, (L + 1,)),
                    ck(plan.rig_ptr, "rig_ptr", torch.int32, (R + 1,)),
                    ck(plan.rig_obs, "rig_obs", torch.int32, (n_real,)), *jargs,
                    ck(x_table, "x_table", torch.float32, (R, k)),
                    ck(hinv, "hinv", torch.float32, (L, 3, 3)), p.data_ptr(), z.data_ptr(),
                    y.data_ptr())
    return y


@_kernels.register("schur_pcg")
def seg_schur_pcg(J_r, J_p, w, x_table, hinv, plan: SegPlan):
    """K4, the PCG Schur matvec y = seg-sum_rig J_r^T w J_r x - W H_ll^-1 W^T x
    of one rig-only batch. Plain version: K6's down (t, staged wu) ->
    z = H_ll^-1 t -> K5's up with wu; on the card one entry of three
    launches around the plan's point-sorted positions. J float32, or bf16
    (rcs.MATVEC_BF16)."""
    if not _kernels.on_card(w, "schur_pcg"):
        _, t, wu = _schur_down_staged(J_r, J_p, w, x_table, plan, False)
        return _schur_up_plain(J_r, J_p, w, (hinv * t[:, None, :]).sum(-1), plan, wu)
    y = _launch_schur_pcg(J_r, J_p, w, x_table, hinv, plan)
    seg_schur_pcg.launches += 1
    seg_schur_pcg.bf16_launches += J_TYPES[J_r.dtype]
    return y


# ---------------------------------------------------------------------------
# K8: lambda-independent assembly of a calibration-coupled batch
# ---------------------------------------------------------------------------


def _cal_entries(splits):
    """Window-row outputs of the assembly kernel, in kernel order: (a, -1)
    is g_c[a]; (a, b) with a <= b inside one split is the self-block entry."""
    ents = [(a, -1) for a in range(sum(splits))]
    off = 0
    for dim in splits:
        ents += [(off + a, off + b) for a in range(dim) for b in range(a, dim)]
        off += dim
    return ents


def n_cal_out(splits):
    """Assembly outputs per window row: 23 + 21 + 153 = 197 at (6, 17)."""
    return len(_cal_entries(splits))


def _assemble_cal_plain(J_r, J_c, J_p, res, w, plan, cplan):
    g_r, diag_r, g_l, H = _assemble_rig_plain(J_r, J_p, res, w, plan)
    n_c = cplan.n_rows
    wres = res * w[None, :]
    g_c = _rows_sum((J_c * wres[:, None, :]).sum(0), cplan.win, n_c)
    diag_c = _rows_sum((J_c * J_c * w[None, None, :]).sum(0), cplan.win, n_c)
    blocks, off = [], 0
    for dim in _cal_splits(J_c):
        Js = J_c[:, off:off + dim]
        B = ((Js * w[None, None, :])[:, :, None, :] * Js[:, None, :, :]).sum(0)
        blocks.append(_rows_sum(B.reshape(dim * dim, -1), cplan.win, n_c).reshape(-1, dim, dim))
        off += dim
    return g_r, diag_r, g_c, diag_c, blocks, g_l, H


@_kernels.register("assemble_cal")
def seg_assemble_cal(J_r, J_c, J_p, res, w, plan: SegPlan, cplan: CalPlan):
    """All lambda-independent assembly of a calibration-coupled batch:
    g_r, diag_r (R, k); g_c, diag_c (n_c, kc); blocks_c, the window
    variables' block-Jacobi blocks per split of J_c ([(n_c, 6, 6), (n_c, 17,
    17)] at kc = 23; no Schur correction); g_l (L, 3); H_ll0 (L, 3, 3);
    w >= 0, as for seg_assemble_rig."""
    if not _kernels.on_card(w, "assemble_cal"):
        return _assemble_cal_plain(J_r, J_c, J_p, res, w, plan, cplan)
    n, k, _, jargs = _jac_args(J_r, J_p, w)
    R, L, n_c = plan.n_rows, plan.n_pts, cplan.n_rows
    splits = _cal_splits(J_c)
    kc = sum(splits)
    g_r, diag_r = _empty((R, k), w), _empty((R, k), w)
    g_l, H = _empty((L, 3), w), _empty((L, 3, 3), w)
    part = _empty((max(cplan.n_chunks, 1), n_cal_out(splits)), w)
    g_c, diag_c = _empty((n_c, kc), w), _empty((n_c, kc), w)
    blocks = [_empty((n_c, dim, dim), w) for dim in splits]
    by_dim = {dim: b.data_ptr() for dim, b in zip(splits, blocks)}
    q = _sector_scratch(plan, w)
    _kernels.launch("viba_assemble_cal", R, L, n, k, kc, n_c, cplan.n_chunks,
                    *_k2_ptrs(plan),
                    *_chunk_ptrs(cplan), *jargs, _jc_arg(J_c, n),
                    _kernels.check(res, "res", torch.float32, (2, n)),
                    g_r.data_ptr(), diag_r.data_ptr(), g_l.data_ptr(), H.data_ptr(),
                    part.data_ptr(), g_c.data_ptr(), diag_c.data_ptr(), by_dim.get(6),
                    by_dim.get(17), q.data_ptr())
    seg_assemble_cal.launches += 1
    return g_r, diag_r, g_c, diag_c, blocks, g_l, H


# ---------------------------------------------------------------------------
# K10 / K9: Schur matvec halves over rig and window columns
# ---------------------------------------------------------------------------


def _schur_down_cal_plain(J_r, J_c, J_p, w, x_r, x_c, plan, cplan, want_y):
    """(y_r, y_c (both None without want_y), t, wu (2, N) = w u): K10's
    down function with the per-slot wu staged, which the plain K9
    composition reuses."""
    J_r, J_c, J_p = _upcast(w, J_r, J_c, J_p)
    xg_r = x_r.index_select(0, plan.rig)
    xg_c = x_c.index_select(0, cplan.win)
    wu = ((J_r * xg_r.T[None]).sum(1) + (J_c * xg_c.T[None]).sum(1)) * w[None, :]
    t = _rows_sum((J_p * wu[:, None, :]).sum(0), plan.point, plan.n_pts)
    if not want_y:
        return None, None, t, wu
    y_r = _rows_sum((J_r * wu[:, None, :]).sum(0), plan.rig, plan.n_rows)
    y_c = _rows_sum((J_c * wu[:, None, :]).sum(0), cplan.win, cplan.n_rows)
    return y_r, y_c, t, wu


def _pair_ptrs(cplan, R, n_c, n_real):
    """The (rig, window row) pair plan K9 and K10 walk: rig_pair, pair_ptr,
    pair_obs, pair_part, win_pair."""
    ck = _kernels.check
    return (ck(cplan.rig_pair, "rig_pair", torch.int32, (R + 1,)),
            ck(cplan.pair_ptr, "pair_ptr", torch.int32),
            ck(cplan.pair_obs, "pair_obs", torch.int32, (n_real,)),
            ck(cplan.pair_part, "pair_part", torch.int32, (cplan.n_pairs,)),
            ck(cplan.win_pair, "win_pair", torch.int32, (n_c + 1,)))


def _launch_schur_down_cal(J_r, J_c, J_p, w, x_r, x_c, plan, cplan, want_y):
    """K10's down pass in two launches (csrc/cal_pcg.cu
    viba_schur_down_cal): p = J_p^T w u at each slot's point-sorted position
    (per slot; with y, a 128-thread group per rig row over its (rig, window
    row) pairs, y_r and one window partial a pair beside it), then the
    landmark sums of p (with y in one launch with the window rows' sums of
    their partials)."""
    n, k, jt, (jr, jp, wp) = _jac_args(J_r, J_p, w, mv=True)
    R, L, n_c = plan.n_rows, plan.n_pts, cplan.n_rows
    kc = J_c.shape[1]
    n_real = plan.pt_obs.shape[0]
    ck = _kernels.check
    y_r = _empty((R, k), w) if want_y else None
    y_c = _empty((n_c, kc), w) if want_y else None
    part = _empty((max(cplan.n_pairs, 1), kc), w) if want_y else None
    t = _empty((L, 3), w)
    p = _empty((max(n_real, 1), 4), w)  # float4 per slot, point-sorted
    _kernels.launch("viba_schur_down_cal", R, L, n, n_real, k, kc, n_c, jt, int(bool(want_y)),
                    ck(plan.rig, "rig", torch.int32, (n,)), ck(cplan.win, "win", torch.int32, (n,)),
                    ck(plan.pt_pos, "pt_pos", torch.int32, (n,)),
                    ck(plan.pt_ptr, "pt_ptr", torch.int32, (L + 1,)),
                    *_pair_ptrs(cplan, R, n_c, n_real), jr, _jc_arg(J_c, n, J_r.dtype), jp, wp,
                    ck(x_r, "x_r", torch.float32, (R, k)), ck(x_c, "x_c", torch.float32, (n_c, kc)),
                    p.data_ptr(), *(a.data_ptr() if a is not None else None
                                    for a in (part, y_r, y_c)), t.data_ptr())
    return y_r, y_c, t


@_kernels.register("schur_down_cal")
def seg_schur_down_cal(J_r, J_c, J_p, w, x_r, x_c, plan: SegPlan, cplan: CalPlan,
                       want_y=True):
    """One pass over a calibration-coupled batch with u = J_r x_r[rig] +
    J_c x_c[win]: (y_r (R, k) = seg-sum_rig J_r^T w u, y_c (n_c, kc) =
    seg-sum_win J_c^T w u (both None unless want_y), t (L, 3) = W^T x).
    J float32, or bf16 (rcs.MATVEC_BF16), J_r, J_c and J_p of one type."""
    if not _kernels.on_card(w, "schur_down_cal"):
        return _schur_down_cal_plain(J_r, J_c, J_p, w, x_r, x_c, plan, cplan, want_y)[:3]
    out = _launch_schur_down_cal(J_r, J_c, J_p, w, x_r, x_c, plan, cplan, want_y)
    seg_schur_down_cal.launches += 1
    seg_schur_down_cal.bf16_launches += J_TYPES[J_r.dtype]
    return out


def _schur_up_cal_plain(J_r, J_c, J_p, w, z, plan, cplan, wu):
    J_r, J_c, J_p = _upcast(w, J_r, J_c, J_p)
    zg = z.index_select(0, plan.point)
    wu2 = (J_p * zg.T[None]).sum(1) * w[None, :]
    du = wu2 if wu is None else wu - wu2
    return (_rows_sum((J_r * du[:, None, :]).sum(0), plan.rig, plan.n_rows),
            _rows_sum((J_c * du[:, None, :]).sum(0), cplan.win, cplan.n_rows))


def _launch_schur_up_cal(J_r, J_c, J_p, w, z, plan, cplan):
    """K10's up pass in two launches (csrc/cal_pcg.cu
    viba_schur_up_cal): a 128-thread group per rig row over its (rig, window
    row) pairs, w J_p z[point] in registers, y_r and one window partial a
    pair; then the window rows' sums of their partials."""
    n, k, jt, (jr, jp, wp) = _jac_args(J_r, J_p, w, mv=True)
    R, L, n_c = plan.n_rows, plan.n_pts, cplan.n_rows
    kc = J_c.shape[1]
    y_r, y_c = _empty((R, k), w), _empty((n_c, kc), w)
    part = _empty((max(cplan.n_pairs, 1), kc), w)
    ck = _kernels.check
    _kernels.launch("viba_schur_up_cal", R, n, k, kc, n_c, jt,
                    *_pair_ptrs(cplan, R, n_c, plan.pt_obs.shape[0]),
                    ck(plan.point, "point", torch.int32, (n,)), jr, _jc_arg(J_c, n, J_r.dtype),
                    jp, wp, ck(z, "z", torch.float32, (L, 3)), part.data_ptr(), y_r.data_ptr(),
                    y_c.data_ptr())
    return y_r, y_c


@_kernels.register("schur_up_cal")
def seg_schur_up_cal(J_r, J_c, J_p, w, z, plan: SegPlan, cplan: CalPlan):
    """(y_r (R, k), y_c (n_c, kc)) = segment sums of (J_r, J_c)^T w J_p z[pt]
    (= W z over rig and window columns). J float32, or bf16 (rcs.
    MATVEC_BF16), J_r, J_c and J_p of one type."""
    if not _kernels.on_card(w, "schur_up_cal"):
        return _schur_up_cal_plain(J_r, J_c, J_p, w, z, plan, cplan, None)
    out = _launch_schur_up_cal(J_r, J_c, J_p, w, z, plan, cplan)
    seg_schur_up_cal.launches += 1
    seg_schur_up_cal.bf16_launches += J_TYPES[J_r.dtype]
    return out


def _launch_schur_pcg_cal(J_r, J_c, J_p, w, x_r, x_c, hinv, plan, cplan):
    """K9 in four launches (csrc/cal_pcg.cu viba_schur_pcg_cal): p =
    J_p^T w u at each slot's point-sorted position, z = H_ll^-1 (landmark
    sums of p), then per rig row y_r and one J_c^T du partial per (rig,
    window row) pair, then the window rows' sums of their pair partials."""
    n, k, jt, (jr, jp, wp) = _jac_args(J_r, J_p, w, mv=True)
    R, L, n_c = plan.n_rows, plan.n_pts, cplan.n_rows
    kc = J_c.shape[1]
    n_real = plan.pt_obs.shape[0]
    ck = _kernels.check
    p = _empty((n_real, 4), w)  # float4 per slot, point-sorted
    z = _empty((L, 3), w)
    part = _empty((max(cplan.n_pairs, 1), kc), w)
    y_r, y_c = _empty((R, k), w), _empty((n_c, kc), w)
    _kernels.launch("viba_schur_pcg_cal", R, L, n, n_real, k, kc, n_c, jt,
                    ck(plan.rig, "rig", torch.int32, (n,)), ck(cplan.win, "win", torch.int32, (n,)),
                    ck(plan.point, "point", torch.int32, (n,)),
                    ck(plan.pt_pos, "pt_pos", torch.int32, (n,)),
                    ck(plan.pt_ptr, "pt_ptr", torch.int32, (L + 1,)),
                    *_pair_ptrs(cplan, R, n_c, n_real), jr, _jc_arg(J_c, n, J_r.dtype), jp, wp,
                    ck(x_r, "x_r", torch.float32, (R, k)), ck(x_c, "x_c", torch.float32, (n_c, kc)),
                    ck(hinv, "hinv", torch.float32, (L, 3, 3)), p.data_ptr(), z.data_ptr(),
                    part.data_ptr(), y_r.data_ptr(), y_c.data_ptr())
    return y_r, y_c


@_kernels.register("schur_pcg_cal")
def seg_schur_pcg_cal(J_r, J_c, J_p, w, x_r, x_c, hinv, plan: SegPlan, cplan: CalPlan):
    """K9, the PCG Schur matvec (y_r, y_c) = H_batch x - W H_ll^-1 W^T x of
    one calibration-coupled batch. Plain version: K10's down (t, staged wu)
    -> z = H_ll^-1 t -> K10's up; on the card one entry of four launches
    around the plan's point-sorted positions and (rig, window row) pairs.
    J float32, or bf16 (rcs.MATVEC_BF16), J_r, J_c and J_p of one type."""
    if not _kernels.on_card(w, "schur_pcg_cal"):
        _, _, t, wu = _schur_down_cal_plain(J_r, J_c, J_p, w, x_r, x_c, plan, cplan, False)
        return _schur_up_cal_plain(J_r, J_c, J_p, w, (hinv * t[:, None, :]).sum(-1), plan,
                                   cplan, wu)
    out = _launch_schur_pcg_cal(J_r, J_c, J_p, w, x_r, x_c, hinv, plan, cplan)
    seg_schur_pcg_cal.launches += 1
    seg_schur_pcg_cal.bf16_launches += J_TYPES[J_r.dtype]
    return out


# ---------------------------------------------------------------------------
# K4 / K9 on C right-hand sides (the covariance columns)
# ---------------------------------------------------------------------------

# float64 elements a temporary of the plain column versions may take on the
# card (2 GB): the columns run in groups that fit
_PLAIN_COLS_ELEMS = 1 << 28


def _rows_sum_cols(contrib, idx, n_rows):
    """contrib (C, D, N) summed into (C, n_rows, D) rows by idx (N,), each
    column as _rows_sum sums it."""
    C, D, N = contrib.shape
    out = torch.zeros((n_rows, C * D), dtype=contrib.dtype, device=contrib.device)
    out.index_add_(0, idx, contrib.permute(2, 0, 1).reshape(N, C * D))
    return out.reshape(n_rows, C, D).transpose(0, 1)


def _gather_cols(x, idx):
    """x (rows, k, C) at rows idx (N,) as (C, k, N)."""
    return x.permute(2, 0, 1).index_select(1, idx).transpose(1, 2)


def _schur_pcg_cols_plain(J_r, J_c, J_p, w, x_r, x_c, hinv, plan, cplan):
    """The plain K4 (J_c None) or K9 composition of seg_schur_pcg /
    seg_schur_pcg_cal with the columns carried through as a leading axis:
    every product and sum of a column runs as in the single-column version
    (the same bits on the CPU). Returns y_r (R, k, C) and y_c (n_c, kc, C)
    or None."""
    J_r, J_c, J_p = _upcast(w, J_r, J_c, J_p)
    C = x_r.shape[-1]
    width = max(J_r.shape[1], 3 if J_c is None else J_c.shape[1])
    group = max(1, _PLAIN_COLS_ELEMS // max(J_r.shape[0] * width * J_r.shape[-1], 1))
    if C > group:
        outs = [_schur_pcg_cols_plain(J_r, J_c, J_p, w, x_r[..., c:c + group],
                                      None if x_c is None else x_c[..., c:c + group], hinv,
                                      plan, cplan) for c in range(0, C, group)]
        return (torch.cat([o[0] for o in outs], dim=-1),
                None if J_c is None else torch.cat([o[1] for o in outs], dim=-1))
    u = (J_r[None] * _gather_cols(x_r, plan.rig)[:, None]).sum(2)  # (C, d, N)
    if J_c is not None:
        u = u + (J_c[None] * _gather_cols(x_c, cplan.win)[:, None]).sum(2)
    wu = u * w
    t = _rows_sum_cols((J_p[None] * wu[:, :, None]).sum(1), plan.point, plan.n_pts)
    z = (hinv[None] * t[:, :, None, :]).sum(-1)  # (C, L, 3)
    zg = z.index_select(1, plan.point).transpose(1, 2)  # (C, 3, N)
    du = wu - (J_p[None] * zg[:, None]).sum(2) * w
    y_r = _rows_sum_cols((J_r[None] * du[:, :, None]).sum(1), plan.rig, plan.n_rows)
    y_c = None
    if J_c is not None:
        y_c = _rows_sum_cols((J_c[None] * du[:, :, None]).sum(1), cplan.win,
                             cplan.n_rows).permute(1, 2, 0)
    return y_r.permute(1, 2, 0), y_c


def rec_layout(k, kc=0):
    """Float offsets of a slot record (csrc/pt_segments.cuh SlotRec): J_r
    then J_c column by column as (row 0, row 1) pairs, padded to whole
    float4s (the J block), then J_p's pairs, w, and the rig, window and point
    rows as int32 bits; `floats` the record's length, whole float4s."""
    nj = (2 * (k + kc) + 3) // 4 * 4
    return {"jr": 0, "jc": 2 * k, "jp": nj, "w": nj + 6, "rig": nj + 7, "win": nj + 8,
            "point": nj + 9, "floats": nj + 12}


class PtRecords(NamedTuple):
    """The point-sorted slot records of one batch for the column kernels
    (made once per reduced system: J is constant over its PCG)."""

    rec: torch.Tensor  # (n_real, rec_layout(k, kc)["floats"]) float32
    # (n_real,) int32 the record of each slot in the order the rig pass
    # walks them: plan.rig_obs (K4) or cplan.pair_obs (K9)
    rig_pos: torch.Tensor
    k: int
    kc: int
    # each landmark's records in rig order (then its first and last hold its
    # least and largest rig): the landmark pass may stage x_r by rig windows
    rig_sorted: bool


def _pairs(J, idx):
    """J (2, m, N) at slots idx as (len(idx), 2m): (J[0, a], J[1, a]) a column."""
    return J.index_select(2, idx).permute(2, 1, 0).reshape(idx.shape[0], -1)


def point_sorted_records(J_r, J_p, w, plan: SegPlan, J_c=None, cplan: CalPlan | None = None):
    """PtRecords of a batch: record j is real slot plan.pt_obs[j] (rec_layout;
    the window row 0 without J_c). float32 only (the card's type: the rows
    are stored as int32 bits)."""
    if J_r.dtype != torch.float32:
        raise ValueError(f"point_sorted_records: float32 Jacobians, got {J_r.dtype}")
    real = plan.pt_obs.long()
    k, kc = J_r.shape[1], 0 if J_c is None else J_c.shape[1]
    lay = rec_layout(k, kc)
    rec = J_r.new_zeros((real.shape[0], lay["floats"]))
    rec[:, :2 * k] = _pairs(J_r, real)
    if kc:
        rec[:, lay["jc"]:lay["jc"] + 2 * kc] = _pairs(J_c, real)
    rec[:, lay["jp"]:lay["jp"] + 6] = _pairs(J_p, real)
    rec[:, lay["w"]] = w.index_select(0, real)
    win = (torch.zeros_like(plan.rig) if cplan is None else cplan.win).index_select(0, real)
    rows = torch.stack([plan.rig.index_select(0, real), win, plan.point.index_select(0, real)], 1)
    rec[:, lay["rig"]:lay["point"] + 1] = rows.to(torch.int32).view(torch.float32)
    order = plan.rig_obs if cplan is None else cplan.pair_obs
    rig_pos = plan.pt_pos.index_select(0, order.long()).to(torch.int32)
    rig = rows[:, 0].long()
    first = torch.zeros_like(rig, dtype=torch.bool)
    first[plan.pt_ptr[:-1][plan.pt_ptr[:-1] < rig.shape[0]].long()] = True
    rig_sorted = bool(((rig[1:] >= rig[:-1]) | first[1:]).all()) if rig.shape[0] > 1 else True
    return PtRecords(rec, rig_pos, k, kc, rig_sorted)


def _rec_args(rec, J_r, J_p, w, plan, J_c=None, cplan=None):
    """The pointers of the records' rig-side order and of the records, and
    their rig_sorted flag, the records made here when the caller has
    none."""
    if rec is None:  # float32 records (bf16 J, rcs.MATVEC_BF16, upcast exactly)
        rec = point_sorted_records(*_upcast(w, J_r, J_p), w, plan, *_upcast(w, J_c), cplan)
    k, kc = J_r.shape[1], 0 if J_c is None else J_c.shape[1]
    if (rec.k, rec.kc) != (k, kc):
        raise ValueError(f"rec: records of (k, kc) = {(rec.k, rec.kc)}, batch {(k, kc)}")
    n_real = plan.pt_obs.shape[0]
    ck = _kernels.check
    return (ck(rec.rig_pos, "rig_pos", torch.int32, (n_real,)),
            ck(rec.rec, "rec", torch.float32, (n_real, rec_layout(k, kc)["floats"])),
            int(rec.rig_sorted))


def _cols_arg(x, name, rows, k):
    C = x.shape[-1] if x.ndim == 3 else 0
    _kernels.check(x, name, torch.float32, (rows, k, C))
    if C == 0:
        raise ValueError(f"{name}: expected at least one column")
    return C, x.data_ptr()


@_kernels.register("schur_pcg_cols")
def seg_schur_pcg_cols(J_r, J_p, w, x_table, hinv, plan: SegPlan, rec: PtRecords | None = None):
    """K4 on C right-hand sides: y (R, k, C), column c the y of
    seg_schur_pcg on x_table[..., c]. On the card one entry of two launches
    (csrc/schur.cu viba_schur_pcg_cols) over the point-sorted records `rec`
    (point_sorted_records; made here when None): the landmark pass, then
    the rig rows, each record read once a tile of 32 columns. The CPU path
    ignores rec."""
    if not _kernels.on_card(w, "schur_pcg_cols"):
        return _schur_pcg_cols_plain(J_r, None, J_p, w, x_table, None, hinv, plan, None)[0]
    _, k, _, _ = _jac_args(J_r, J_p, w, mv=True)
    R, L = plan.n_rows, plan.n_pts
    C, x_ptr = _cols_arg(x_table, "x_table", R, k)
    ck = _kernels.check
    y = _empty((R, k, C), w)
    z = _empty((max(L, 1), 3, C), w)
    rig_pos, rec_ptr, rig_sorted = _rec_args(rec, J_r, J_p, w, plan)
    _kernels.launch("viba_schur_pcg_cols", R, L, k, C, rig_sorted,
                    ck(plan.rig_ptr, "rig_ptr", torch.int32, (R + 1,)), rig_pos,
                    ck(plan.pt_ptr, "pt_ptr", torch.int32, (L + 1,)), rec_ptr, x_ptr,
                    ck(hinv, "hinv", torch.float32, (L, 3, 3)), z.data_ptr(), y.data_ptr())
    seg_schur_pcg_cols.launches += 1
    return y


@_kernels.register("schur_pcg_cal_cols")
def seg_schur_pcg_cal_cols(J_r, J_c, J_p, w, x_r, x_c, hinv, plan: SegPlan, cplan: CalPlan,
                           rec: PtRecords | None = None):
    """K9 on C right-hand sides: (y_r (R, k, C), y_c (n_c, kc, C)), column c
    the result of seg_schur_pcg_cal on column c of x_r and x_c. On the card
    one entry of three launches (csrc/cal_pcg_cols.cu
    viba_schur_pcg_cal_cols) over the point-sorted records `rec`
    (point_sorted_records; made here when None): the landmark pass; the rig
    rows with one window partial per (rig, window row) pair; the window
    rows' sums. The CPU path ignores rec."""
    if not _kernels.on_card(w, "schur_pcg_cal_cols"):
        return _schur_pcg_cols_plain(J_r, J_c, J_p, w, x_r, x_c, hinv, plan, cplan)
    _, k, _, _ = _jac_args(J_r, J_p, w, mv=True)
    R, L, n_c = plan.n_rows, plan.n_pts, cplan.n_rows
    kc = J_c.shape[1]
    C, xr_ptr = _cols_arg(x_r, "x_r", R, k)
    C_c, xc_ptr = _cols_arg(x_c, "x_c", n_c, kc)
    if C_c != C:
        raise ValueError(f"x_c: {C_c} columns, x_r {C}")
    n_pairs = cplan.n_pairs
    ck = _kernels.check
    y_r, y_c = _empty((R, k, C), w), _empty((n_c, kc, C), w)
    z = _empty((max(L, 1), 3, C), w)
    part = _empty((max(n_pairs, 1), kc, C), w)
    rig_pos, rec_ptr, rig_sorted = _rec_args(rec, J_r, J_p, w, plan, J_c, cplan)
    _kernels.launch("viba_schur_pcg_cal_cols", R, L, k, kc, n_c, C, rig_sorted,
                    ck(cplan.rig_pair, "rig_pair", torch.int32, (R + 1,)),
                    ck(cplan.pair_ptr, "pair_ptr", torch.int32),
                    ck(cplan.pair_part, "pair_part", torch.int32, (n_pairs,)),
                    ck(cplan.win_pair, "win_pair", torch.int32, (n_c + 1,)), rig_pos,
                    ck(plan.pt_ptr, "pt_ptr", torch.int32, (L + 1,)), rec_ptr, xr_ptr,
                    xc_ptr, ck(hinv, "hinv", torch.float32, (L, 3, 3)), z.data_ptr(),
                    part.data_ptr(), y_r.data_ptr(), y_c.data_ptr())
    seg_schur_pcg_cal_cols.launches += 1
    return y_r, y_c


# ---------------------------------------------------------------------------
# K12 / K13: table kernels of the general (two-grid) path
# ---------------------------------------------------------------------------

TABLE_KS = (3, 6, 9)  # Jacobian widths the table kernels are built for


def _group_threads(rows: RowPlan):
    """Threads per segment: a block for long segments, 16 for short ones."""
    return 128 if rows.obs.shape[0] > 64 * max(rows.n_seg, 1) else 16


def _table_jac(J, what):
    d, k, n = J.shape
    if d != 2 or k not in TABLE_KS:
        raise ValueError(f"{what}: kernels take J blocks of shape (2, k in {TABLE_KS}, N), "
                         f"got {tuple(J.shape)}")
    return n, k, _kernels.check(J, "J", torch.float32, (2, k, n))


def _rows_args(rows: RowPlan, n):
    """(n_seg, n_rows, G, ptr, obs, row_chunk or None) of a launch."""
    ck = _kernels.check
    ck(rows.row, "row", torch.int32, (n,))
    return (rows.n_seg, rows.n_rows, _group_threads(rows), ck(rows.ptr, "ptr", torch.int32),
            ck(rows.obs, "obs", torch.int32),
            ck(rows.row_chunk, "row_chunk", torch.int32) if rows.row_chunk is not None else None)


def _rows_out(rows: RowPlan, width, like):
    """(partials or None, output table) of a reduction into rows."""
    part = _empty((max(rows.n_seg, 1), width), like) if rows.row_chunk is not None else None
    # a family without a segment launches nothing: its rows are zero
    alloc = torch.empty if rows.n_seg > 0 else torch.zeros
    return part, alloc((rows.n_rows, width), dtype=torch.float32, device=like.device)


def _mv_fused_plain(J, w, x_table, rows):
    xg = x_table.index_select(0, rows.row)  # (N, k)
    wu = (J * xg.T[None]).sum(1) * w[None, :]
    return wu, _rows_sum((J * wu[:, None, :]).sum(0), rows.row, rows.n_rows)


@_kernels.register("mv_fused_table")
def seg_mv_fused_table(J, w, x_table, rows: RowPlan):
    """K12: (wu (2, N) = w (J x[row]), y (n_rows, k) = seg-sum J^T wu), the
    rig side of the general-path matvec with J read once."""
    if not _kernels.on_card(w, "mv_fused_table"):
        return _mv_fused_plain(J, w, x_table, rows)
    n, k, jp = _table_jac(J, "seg_mv_fused_table")
    n_seg, n_rows, G, ptr, obs, row_chunk = _rows_args(rows, n)
    wu = torch.zeros((2, n), dtype=torch.float32, device=w.device)
    part, y = _rows_out(rows, k, w)
    _kernels.launch("viba_seg_mv_fused", n_seg, n_rows, n, k, G, ptr, obs, rows.row.data_ptr(),
                    row_chunk, jp, _kernels.check(w, "w", torch.float32, (n,)),
                    _kernels.check(x_table, "x_table", torch.float32, (n_rows, k)),
                    wu.data_ptr(), part.data_ptr() if part is not None else None, y.data_ptr())
    seg_mv_fused_table.launches += 1
    return wu, y


def _mv_scatter_plain(J, u, rows):
    return _rows_sum((J * u[:, None, :]).sum(0), rows.row, rows.n_rows)


def _launch_mv_scatter_slot_major(J, u, rows: RowPlan):
    """K13a on a scattered family: q = J^T u written slot-major, then one
    warp per row gathering its slots' rows (csrc/table_segments.cu
    viba_seg_mv_scatter_slot_major)."""
    n, k, jp = _table_jac(J, "seg_mv_scatter_table")
    if k != 3 or rows.row_chunk is not None:
        raise ValueError(f"K13a on a scattered family takes 3-column J on unchunked rows, got "
                         f"{k} columns" + (", chunked" if rows.row_chunk is not None else ""))
    ck = _kernels.check
    ck(rows.row, "row", torch.int32, (n,))
    q = _empty((n, 4), u)  # float4 per slot, slot order
    y = _empty((rows.n_rows, 3), u)
    _kernels.launch("viba_seg_mv_scatter_slot_major", rows.n_rows, n,
                    ck(rows.ptr, "ptr", torch.int32, (rows.n_rows + 1,)),
                    ck(rows.obs, "obs", torch.int32), jp, ck(u, "u", torch.float32, (2, n)),
                    q.data_ptr(), y.data_ptr())
    return y


@_kernels.register("mv_scatter_table")
def seg_mv_scatter_table(J, u, rows: RowPlan):
    """K13a: y (n_rows, k) = seg-sum over each row's slots of J^T u. A
    scattered family (the landmark rows) goes through a slot-major copy of
    J^T u; the others walk their lists."""
    if not _kernels.on_card(u, "mv_scatter_table"):
        return _mv_scatter_plain(J, u, rows)
    if rows.scattered:
        y = _launch_mv_scatter_slot_major(J, u, rows)
        seg_mv_scatter_table.launches += 1
        return y
    n, k, jp = _table_jac(J, "seg_mv_scatter_table")
    n_seg, n_rows, G, ptr, obs, row_chunk = _rows_args(rows, n)
    part, y = _rows_out(rows, k, u)
    _kernels.launch("viba_seg_mv_scatter", n_seg, n_rows, n, k, G, ptr, obs, row_chunk, jp,
                    _kernels.check(u, "u", torch.float32, (2, n)),
                    part.data_ptr() if part is not None else None, y.data_ptr())
    seg_mv_scatter_table.launches += 1
    return y


def _mv_gather_plain(J, x_table, rows):
    return (J * x_table.index_select(0, rows.row).T[None]).sum(1)


@_kernels.register("mv_gather_table")
def seg_mv_gather_table(J, x_table, rows: RowPlan):
    """K13b: u (2, N) = J x[row] per slot."""
    if not _kernels.on_card(x_table, "mv_gather_table"):
        return _mv_gather_plain(J, x_table, rows)
    n, k, jp = _table_jac(J, "seg_mv_gather_table")
    ck = _kernels.check
    u = _empty((2, n), x_table)
    _kernels.launch("viba_seg_mv_gather", n, k, ck(rows.row, "row", torch.int32, (n,)), jp,
                    ck(x_table, "x_table", torch.float32, (rows.n_rows, k)), u.data_ptr())
    seg_mv_gather_table.launches += 1
    return u


def _reduce_plain(contrib, rows):
    return _rows_sum(contrib, rows.row, rows.n_rows)


SLOT_MAJOR_MAX_D = 96  # K13c's slot-major copy stages 128 x D floats: at most 48 KB


def _launch_reduce_slot_major(contrib, rows: RowPlan):
    """K13c on a scattered family: contrib copied slot-major, then one warp
    per row gathering its slots' rows (csrc/table_segments.cu
    viba_seg_reduce_slot_major)."""
    D, n = contrib.shape
    if D > SLOT_MAJOR_MAX_D:
        raise ValueError(f"K13c on a scattered family takes at most {SLOT_MAJOR_MAX_D} "
                         f"columns, got {D}")
    ck = _kernels.check
    ck(rows.row, "row", torch.int32, (n,))
    slot_major = _empty((n, D), contrib)
    y = _empty((rows.n_rows, D), contrib)
    _kernels.launch("viba_seg_reduce_slot_major", rows.n_rows, n, D,
                    ck(rows.ptr, "ptr", torch.int32, (rows.n_rows + 1,)),
                    ck(rows.obs, "obs", torch.int32),
                    ck(contrib, "contrib", torch.float32, (D, n)), slot_major.data_ptr(),
                    y.data_ptr())
    return y


@_kernels.register("reduce_table")
def seg_reduce_table(contrib, rows: RowPlan):
    """K13c: segment-sum contrib (D, N) into (n_rows, D). Slots outside the
    family's lists (the padded ones) must carry zeros. A scattered family
    (the landmark rows) reduces through a slot-major copy; the others walk
    their lists."""
    if not _kernels.on_card(contrib, "reduce_table"):
        return _reduce_plain(contrib, rows)
    if rows.scattered:
        y = _launch_reduce_slot_major(contrib, rows)
        seg_reduce_table.launches += 1
        return y
    D, n = contrib.shape
    n_seg, n_rows, G, ptr, obs, row_chunk = _rows_args(rows, n)
    part, y = _rows_out(rows, D, contrib)
    _kernels.launch("viba_seg_reduce", n_seg, n_rows, n, D, G, ptr, obs, row_chunk,
                    _kernels.check(contrib, "contrib", torch.float32, (D, n)),
                    part.data_ptr() if part is not None else None, y.data_ptr())
    seg_reduce_table.launches += 1
    return y


# ---------------------------------------------------------------------------
# K14: tile-partials kernels (one grid of ragged tiles, rig- or point-sorted)
# ---------------------------------------------------------------------------
#
# A grid of nt tiles of ts slots; slot s of tile t addresses row local[s] of
# the tile's rb-row window [base_t, base_t + rb). The reduce-side entries
# return per-tile partials (nt, rb, D), which scatter_partials adds into the
# global rows; the gather side takes per-tile rows (nt, rb, D) that
# gather_tiles cuts out of a table. Pad slots address a row like any other
# (their local index, usually 0) and their contributions count: K14a sums
# whatever contrib holds. Locals outside [0, rb) address nothing.

TILE_KS = (3, 6, 9)  # Jacobian widths of the tile mat-vec kernels
# widest row of a gathered tile that K14d stages in shared memory (rb x D
# floats); K14b's flat walk stages nothing and takes any width
TILE_MAX_D = 64


class TilePlan(NamedTuple):
    """Runs of a tile grid, for the reduce-side kernels: the slots of each
    (tile, row) as maximal runs of consecutive slots, in slot order. Built
    on the device from the local indices (tile_plan)."""

    run_ptr: torch.Tensor  # (nt*rb + 1,) int32 offsets of each (tile, row)'s runs
    run_start: torch.Tensor  # (n_runs,) int32 first slot of each run
    run_len: torch.Tensor  # (n_runs,) int32 slots in each run


def tile_plan(local, nt, ts, rb) -> TilePlan:
    """The TilePlan of a grid's local indices (N = nt*ts,), built on their
    device with a stable sort (deterministic)."""
    n = nt * ts
    loc = local.to(torch.int64)
    slot = torch.arange(n, device=local.device)
    key = torch.where((loc >= 0) & (loc < rb), (slot // ts) * rb + loc,
                      torch.full_like(loc, nt * rb))
    order = torch.argsort(key, stable=True)
    k = key[order]
    new = torch.ones(n, dtype=torch.bool, device=local.device)
    new[1:] = (k[1:] != k[:-1]) | (order[1:] != order[:-1] + 1)
    first = torch.nonzero(new).reshape(-1)
    length = torch.diff(torch.cat([first, first.new_full((1,), n)]))
    keep = k[first] < nt * rb
    run_key, first, length = k[first][keep], first[keep], length[keep]
    run_ptr = torch.zeros(nt * rb + 1, dtype=torch.int64, device=local.device)
    run_ptr[1:] = torch.cumsum(torch.bincount(run_key, minlength=nt * rb), 0)
    i32 = torch.int32
    return TilePlan(run_ptr.to(i32), order[first].to(i32), length.to(i32))


def _rows_from_bases(bases, nt, rb):
    """Expand (nt,) tile bases to the rows each tile addresses (nt*rb,)."""
    return (bases[:, None].to(torch.int32)
            + torch.arange(rb, dtype=torch.int32, device=bases.device)[None, :]).reshape(-1)


def gather_tiles(table, rows, nt, rb):
    """(n_rows, D) table + addressed rows (nt*rb,) -> (nt, rb, D) tile rows
    (rows past the table read zeros)."""
    D = table.shape[-1]
    text = torch.cat([table, table.new_zeros((rb, D))], dim=0)
    return text.index_select(0, rows.to(torch.int64)).reshape(nt, rb, D)


def partials_plan(rows, n_rows) -> RowPlan:
    """The RowPlan that scatter_partials reduces through: entry e of the
    flattened (nt*rb) partials adds into rows[e]; each row lists its entries
    in tile order; entries addressing rows >= n_rows (a tile window past the
    table) are left out, as the reference drops them."""
    r = rows.to(torch.int64)
    keep = r < n_rows
    order = torch.argsort(torch.where(keep, r, torch.full_like(r, n_rows)), stable=True)
    order = order[:int(keep.sum())]
    ptr = torch.zeros(n_rows + 1, dtype=torch.int64, device=rows.device)
    ptr[1:] = torch.cumsum(torch.bincount(r[keep], minlength=n_rows), 0)
    return RowPlan(torch.where(keep, r, torch.zeros_like(r)).to(torch.int32),
                   ptr.to(torch.int32), order.to(torch.int32))


def scatter_partials(part, rows, n_rows, rb, plan: RowPlan | None = None):
    """(nt, rb, D) tile partials + addressed rows (nt*rb,) -> (n_rows, D):
    each row's partials summed in tile order. On the card through K13c over
    `plan` (partials_plan(rows, n_rows), built here if not given): no
    atomics."""
    D = part.shape[-1]
    flat = part.reshape(-1, D)
    if not _kernels.on_card(part, "reduce_table"):
        out = torch.zeros((n_rows + rb, D), dtype=part.dtype, device=part.device)
        return out.index_add_(0, rows.to(torch.int64), flat)[:n_rows]
    plan = partials_plan(rows, n_rows) if plan is None else plan
    return seg_reduce_table(flat.T.contiguous(), plan)


def _tile_key(local, nt, ts, rb):
    """Flat (tile, row) index of each slot and whether it addresses a row."""
    loc = local.to(torch.int64)
    ok = (loc >= 0) & (loc < rb)
    tile = torch.arange(nt * ts, device=local.device) // ts
    return torch.where(ok, tile * rb + loc, torch.zeros_like(loc)), ok


def _reduce_partials_plain(contrib, local, nt, ts, rb):
    key, ok = _tile_key(local, nt, ts, rb)
    out = contrib.new_zeros((nt * rb, contrib.shape[0]))
    out.index_add_(0, key, (contrib * ok.to(contrib.dtype)[None]).T)
    return out.reshape(nt, rb, -1)


def _gather_tiles_plain(xt, local, nt, ts, rb):
    key, ok = _tile_key(local, nt, ts, rb)
    return xt.reshape(nt * rb, -1).index_select(0, key) * ok.to(xt.dtype)[:, None]


def _tile_jac(J, nt, ts):
    d, k, n = J.shape
    if d != 2 or k not in TILE_KS or n != nt * ts:
        raise ValueError(f"tile kernels take J of shape (2, k in {TILE_KS}, {nt * ts}), "
                         f"got {tuple(J.shape)}")
    return k, _kernels.check(J, "J", torch.float32, (2, k, n))


def _plan_args(plan: TilePlan, local, nt, ts, rb):
    plan = tile_plan(local, nt, ts, rb) if plan is None else plan
    ck = _kernels.check
    return (ck(plan.run_ptr, "run_ptr", torch.int32, (nt * rb + 1,)),
            ck(plan.run_start, "run_start", torch.int32),
            ck(plan.run_len, "run_len", torch.int32))


def _local_arg(local, nt, ts):
    return _kernels.check(local, "local", torch.int32, (nt * ts,))


def _xt_arg(xt, nt, rb, D):
    if D > TILE_MAX_D:
        raise ValueError(f"gathered tile rows wider than {TILE_MAX_D}: {D}")
    return _kernels.check(xt, "xt", torch.float32, (nt, rb, D))


@_kernels.register("reduce_partials")
def seg_reduce_partials(contrib, local, nt, ts, rb, plan: TilePlan | None = None):
    """K14a: contrib (D, nt*ts), local (nt*ts,) -> tile partials (nt, rb, D),
    each row's slots summed in a fixed order (csrc/tile_segments.cu
    viba_tile_reduce: each tile's rows cut into pieces across its warps,
    contrib read in the piece walk)."""
    if not _kernels.on_card(contrib, "reduce_partials"):
        return _reduce_partials_plain(contrib, local, nt, ts, rb)
    D, n = contrib.shape
    part = _empty((nt, rb, D), contrib)
    _kernels.launch("viba_tile_reduce", nt, rb, n, D, *_plan_args(plan, local, nt, ts, rb),
                    _kernels.check(contrib, "contrib", torch.float32, (D, nt * ts)),
                    part.data_ptr())
    seg_reduce_partials.launches += 1
    return part


@_kernels.register("gather_from_tiles")
def seg_gather_from_tiles(xt, local, nt, ts, rb):
    """K14b: xt (nt, rb, D) addressed tile rows -> per-slot rows (nt*ts, D)
    (csrc/tile_segments.cu viba_tile_gather: a flat stream of float4 over the
    output)."""
    if not _kernels.on_card(xt, "gather_from_tiles"):
        return _gather_tiles_plain(xt, local, nt, ts, rb)
    D = xt.shape[-1]
    out = _empty((nt * ts, D), xt)
    _kernels.launch("viba_tile_gather", nt, ts, rb, D, _local_arg(local, nt, ts),
                    _kernels.check(xt, "xt", torch.float32, (nt, rb, D)), out.data_ptr())
    seg_gather_from_tiles.launches += 1
    return out


def _mv_fused_tiles_plain(J, w, xt, local, nt, ts, rb):
    xg = _gather_tiles_plain(xt, local, nt, ts, rb)  # (N, k)
    wu = (J * xg.T[None]).sum(1) * w[None, :]
    return wu, _reduce_partials_plain((J * wu[:, None, :]).sum(0), local, nt, ts, rb)


@_kernels.register("mv_fused")
def seg_mv_fused(J, w, xt, local, nt, ts, rb, plan: TilePlan | None = None):
    """K14c, the rig-side matvec tile pass: J (2, k, nt*ts), w (nt*ts,), xt
    (nt, rb, k) gathered tile rows -> (wu (2, nt*ts) = w (J x_g), tile
    partials (nt, rb, k) of J^T wu), J read once (csrc/tile_segments.cu
    viba_tile_mv_fused: a CTA per tile staging w (J x) and J^T wu in shared
    memory, wu stored for every slot, each row's slots cut into pieces
    across its warps)."""
    if not _kernels.on_card(J, "mv_fused"):
        return _mv_fused_tiles_plain(J, w, xt, local, nt, ts, rb)
    k, jp = _tile_jac(J, nt, ts)
    wu = _empty((2, nt * ts), J)
    part = _empty((nt, rb, k), J)
    _kernels.launch("viba_tile_mv_fused", nt, rb, nt * ts, k,
                    *_plan_args(plan, local, nt, ts, rb), jp,
                    _kernels.check(w, "w", torch.float32, (nt * ts,)),
                    _kernels.check(xt, "xt", torch.float32, (nt, rb, k)),
                    _local_arg(local, nt, ts), wu.data_ptr(), part.data_ptr())
    seg_mv_fused.launches += 1
    return wu, part


@_kernels.register("mv_gather")
def seg_mv_gather(J, xt, local, nt, ts, rb):
    """K14d: u (2, nt*ts) = J @ gathered tile rows (xt (nt, rb, k))."""
    if not _kernels.on_card(J, "mv_gather"):
        return (J * _gather_tiles_plain(xt, local, nt, ts, rb).T[None]).sum(1)
    k, jp = _tile_jac(J, nt, ts)
    u = _empty((2, nt * ts), J)
    _kernels.launch("viba_tile_mv_gather", nt, ts, rb, k, _local_arg(local, nt, ts), jp,
                    _xt_arg(xt, nt, rb, k), u.data_ptr())
    seg_mv_gather.launches += 1
    return u


@_kernels.register("mv_scatter")
def seg_mv_scatter(J, u, local, nt, ts, rb, plan: TilePlan | None = None):
    """K14e: tile partials (nt, rb, k) of the segment sums of J^T u, each
    row's slots summed in a fixed order (csrc/tile_segments.cu
    viba_tile_mv_scatter: a CTA per tile staging J^T u in shared memory, each
    row's slots cut into pieces across its warps)."""
    if not _kernels.on_card(J, "mv_scatter"):
        return _reduce_partials_plain((J * u[:, None, :]).sum(0), local, nt, ts, rb)
    k, jp = _tile_jac(J, nt, ts)
    part = _empty((nt, rb, k), J)
    _kernels.launch("viba_tile_mv_scatter", nt, rb, nt * ts, k,
                    *_plan_args(plan, local, nt, ts, rb), jp,
                    _kernels.check(u, "u", torch.float32, (2, nt * ts)), part.data_ptr())
    seg_mv_scatter.launches += 1
    return part
