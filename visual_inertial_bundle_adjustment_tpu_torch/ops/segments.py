"""Segment kernels of the blocked reduced-camera-system solver (K2-K6).

Port of the single-pass rig-grid entries of
`visual_inertial_bundle_adjustment_tpu/ops/segments.py`. Every entry
reduces per-observation products of a rig-only visual batch into rig rows
and/or landmark rows:

  seg_assemble_rig  g_r, diag(J_r^T w J_r) per rig; g_l, H_ll0 per landmark (K2)
  seg_precond_rig   per-rig blocks sum w J_r J_r^T - A H_ll^-1[pt] A^T,
                    A = J_r^T w J_p, symmetrized (K3)
  seg_schur_down    y = sum_rig J_r^T w J_r x and t = W^T x (K6, and the
                    down half of K4; stages wu = w J_r x[rig])
  seg_schur_up      W z = sum_rig J_r^T w J_p z[pt] (K5), or with the staged
                    wu: sum_rig J_r^T (wu - w J_p z[pt]) (the up half of K4)
  seg_schur_pcg     K4: down -> z = H_ll^-1 t (torch) -> up, the PCG matvec
                    y = J_r^T w J_r x - W H_ll^-1 W^T x

Kernels: csrc/assemble_rig.cu, csrc/precond_rig.cu, csrc/schur.cu, built on
the group-per-segment skeleton of csrc/tile_reduce.cuh. They replace the
Pallas kernels _assemble_rig_kernel (JAX ops/segments.py:840),
_precond_rig_kernel (:1861), _schur_down_kernel (:586), _schur_up_kernel
(:725), _down_light_kernel (:1318) and _up_du_kernel (:1347).

Design on the card. The TPU grid ran tiles in order and accumulated into
VMEM-resident tables through one-hot MXU dots; on Hopper blocks run in
parallel, so each output row is instead owned by one thread group that walks
that row's observations through a CSR list and reduces in a fixed order —
deterministic, with no atomics and no cross-block combine. The rig CSR lists
a rig's real slots in slot order (rig-sorted ragged tiles, so reads are
contiguous); the landmark CSR lists each point's slots (the point-sorted
order finalize_blocks derives, gathered reads). What bounds them: bytes of J
read per pass — per observation 48 B of J_r (2 x 6 columns) + 24 B of J_p +
12 B of res/w/wu, ~33 MB per pass over the bias-only headline's 394k
observations (~10 us at the H100's 3.35 TB/s); the point-side gathers read
whole 32 B sectors, so the landmark pass moves ~4x its payload. K4 reads J
twice per PCG iteration (down + up).

The plain PyTorch versions below compute the same functions with
`index_add_` over the global rig/point index of each slot; CPU tensors take
them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import _kernels


class SegPlan(NamedTuple):
    """Per-batch reduction plan (host-built in rcs.finalize_blocks)."""

    rig: torch.Tensor  # (N,) int32 global rig row of each slot (pads: tile base)
    point: torch.Tensor  # (N,) int32 global point row of each slot (pads: 0)
    rig_ptr: torch.Tensor  # (R+1,) int32 CSR offsets into rig_obs
    rig_obs: torch.Tensor  # (n_real,) int32 real slots, rig-sorted
    pt_ptr: torch.Tensor  # (L+1,) int32 CSR offsets into pt_obs
    pt_obs: torch.Tensor  # (n_real,) int32 real slots, point-sorted

    @property
    def n_rows(self):
        return self.rig_ptr.shape[0] - 1

    @property
    def n_pts(self):
        return self.pt_ptr.shape[0] - 1


def _rows_sum(contrib, idx, n_rows):
    """contrib (D, N) summed into (n_rows, D) rows by idx (N,)."""
    out = torch.zeros((n_rows, contrib.shape[0]), dtype=contrib.dtype,
                      device=contrib.device)
    return out.index_add_(0, idx, contrib.T)


def _tri_to_full(tri):
    """(n, 6) upper triangle [00,01,02,11,12,22] -> (n, 3, 3) symmetric."""
    a00, a01, a02, a11, a12, a22 = tri.unbind(-1)
    return torch.stack([torch.stack([a00, a01, a02], -1),
                        torch.stack([a01, a11, a12], -1),
                        torch.stack([a02, a12, a22], -1)], -2)


def _plan_ptrs(plan):
    ck = _kernels.check
    return (ck(plan.rig_ptr, "rig_ptr", torch.int32), ck(plan.rig_obs, "rig_obs", torch.int32),
            ck(plan.pt_ptr, "pt_ptr", torch.int32), ck(plan.pt_obs, "pt_obs", torch.int32))


def _jac_args(J_r, J_p, w):
    d, k, n = J_r.shape
    if d != 2 or k != 6:
        raise ValueError(f"kernels take rig J blocks of shape (2, 6, N), got {tuple(J_r.shape)}")
    ck = _kernels.check
    return n, (ck(J_r, "J_r", torch.float32, (2, 6, n)),
               ck(J_p, "J_p", torch.float32, (2, 3, n)),
               ck(w, "w", torch.float32, (n,)))


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


@_kernels.register("assemble_rig")
def seg_assemble_rig(J_r, J_p, res, w, plan: SegPlan):
    """g_r (R, 6), diag_r (R, 6), g_l (L, 3), H_ll0 (L, 3, 3) of one batch."""
    if not _kernels.on_card(w):
        return _assemble_rig_plain(J_r, J_p, res, w, plan)
    n, jargs = _jac_args(J_r, J_p, w)
    R, L = plan.n_rows, plan.n_pts
    kw = dict(dtype=torch.float32, device=w.device)
    g_r, diag_r = torch.empty((R, 6), **kw), torch.empty((R, 6), **kw)
    g_l, tri = torch.empty((L, 3), **kw), torch.empty((L, 6), **kw)
    _kernels.launch("viba_assemble_rig", R, L, n, *_plan_ptrs(plan), *jargs,
                    _kernels.check(res, "res", torch.float32, (2, n)),
                    g_r.data_ptr(), diag_r.data_ptr(), g_l.data_ptr(), tri.data_ptr())
    seg_assemble_rig.launches += 1
    return g_r, diag_r, g_l, _tri_to_full(tri)


# ---------------------------------------------------------------------------
# K3: Schur-corrected block-Jacobi rig blocks (per lambda)
# ---------------------------------------------------------------------------


def _precond_rig_plain(J_r, J_p, w, hinv, plan):
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
    """(R, 6, 6) rig blocks sum w J J^T - (J^T w J_p) H_ll^-1 (J^T w J_p)^T,
    symmetrized (CG needs a symmetric preconditioner)."""
    if not _kernels.on_card(w):
        return _precond_rig_plain(J_r, J_p, w, hinv, plan)
    n, jargs = _jac_args(J_r, J_p, w)
    R, L = plan.n_rows, plan.n_pts
    M = torch.empty((R, 6, 6), dtype=torch.float32, device=w.device)
    ck = _kernels.check
    _kernels.launch("viba_precond_rig", R, n,
                    ck(plan.rig_ptr, "rig_ptr", torch.int32),
                    ck(plan.rig_obs, "rig_obs", torch.int32),
                    ck(plan.point, "point", torch.int32, (n,)), *jargs,
                    ck(hinv, "hinv", torch.float32, (L, 3, 3)), M.data_ptr())
    seg_precond_rig.launches += 1
    return 0.5 * (M + M.transpose(-1, -2))


# ---------------------------------------------------------------------------
# K6 / K5 / K4: Schur matvec halves
# ---------------------------------------------------------------------------


def _schur_down_plain(J_r, J_p, w, x_table, plan, want_y):
    xg = x_table.index_select(0, plan.rig)  # (N, k)
    wu = (J_r * xg.T[None]).sum(1) * w[None, :]  # (d, N)
    y = _rows_sum((J_r * wu[:, None, :]).sum(0), plan.rig, plan.n_rows) if want_y else None
    t = _rows_sum((J_p * wu[:, None, :]).sum(0), plan.point, plan.n_pts)
    return y, t, wu


@_kernels.register("schur_down")
def seg_schur_down(J_r, J_p, w, x_table, plan: SegPlan, want_y=True):
    """One pass over the batch: (y (R, 6) = seg-sum_rig J_r^T w J_r x or
    None, t (L, 3) = seg-sum_pt J_p^T w J_r x = W^T x, wu (2, N) = w J_r x)."""
    if not _kernels.on_card(w):
        return _schur_down_plain(J_r, J_p, w, x_table, plan, want_y)
    n, jargs = _jac_args(J_r, J_p, w)
    R, L = plan.n_rows, plan.n_pts
    kw = dict(dtype=torch.float32, device=w.device)
    y = torch.empty((R, 6), **kw) if want_y else None
    t = torch.empty((L, 3), **kw)
    wu = torch.zeros((2, n), **kw)
    _kernels.launch("viba_schur_down", R, L, n, int(bool(want_y)), *_plan_ptrs(plan),
                    *jargs, _kernels.check(x_table, "x_table", torch.float32, (R, 6)),
                    y.data_ptr() if want_y else None, t.data_ptr(), wu.data_ptr())
    seg_schur_down.launches += 1
    return y, t, wu


def _schur_up_plain(J_r, J_p, w, z, plan, wu):
    zg = z.index_select(0, plan.point)  # (N, 3)
    wu2 = (J_p * zg.T[None]).sum(1) * w[None, :]  # (d, N)
    du = wu2 if wu is None else wu - wu2
    return _rows_sum((J_r * du[:, None, :]).sum(0), plan.rig, plan.n_rows)


@_kernels.register("schur_up")
def seg_schur_up(J_r, J_p, w, z, plan: SegPlan, wu=None):
    """y (R, 6) = seg-sum_rig J_r^T w J_p z[pt] (= W z); with the staged
    wu = w J_r x of seg_schur_down: seg-sum_rig J_r^T (wu - w J_p z[pt])."""
    if not _kernels.on_card(w):
        return _schur_up_plain(J_r, J_p, w, z, plan, wu)
    n, jargs = _jac_args(J_r, J_p, w)
    R, L = plan.n_rows, plan.n_pts
    y = torch.empty((R, 6), dtype=torch.float32, device=w.device)
    ck = _kernels.check
    _kernels.launch("viba_schur_up", R, n,
                    ck(plan.rig_ptr, "rig_ptr", torch.int32),
                    ck(plan.rig_obs, "rig_obs", torch.int32),
                    ck(plan.point, "point", torch.int32, (n,)), *jargs,
                    ck(z, "z", torch.float32, (L, 3)),
                    ck(wu, "wu", torch.float32, (2, n)) if wu is not None else None,
                    y.data_ptr())
    seg_schur_up.launches += 1
    return y


def seg_schur_pcg(J_r, J_p, w, x_table, hinv, plan: SegPlan):
    """K4, the PCG Schur matvec y = seg-sum_rig J_r^T w J_r x - W H_ll^-1 W^T x
    of one rig-only batch: down (t, staged wu) -> z = H_ll^-1 t -> up."""
    _, t, wu = seg_schur_down(J_r, J_p, w, x_table, plan, want_y=False)
    z = (hinv * t[:, None, :]).sum(-1)
    return seg_schur_up(J_r, J_p, w, z, plan, wu=wu)
