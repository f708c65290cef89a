"""Fused linearization of blocked rolling-shutter visual batches (kernel K7).

The full-sensor hot path (reference RollingShutterVisualFactor,
viba/problem/VisualFactor.cpp:122-214). Per observation:

  dtt   = intr[15] tpf - intr[16]                  capture time rel. midpoint
  seg   = segment of the rig's RS table at the primal dtt (constant under AD)
  (q_t, dP_t) = seg base RVP combined with the constant-signal integral
                over dtl = dtt - seg_dt
  p_mid = dP_t + R(T) vel dtt + R(T) g dtt^2 / 2
  p_rig = R(q_t)^T (R(T) p + t(T) - p_mid)         pose shifted to capture time
  p_cam = R(E) p_rig + t(E)
  res   = sqrt_h (proj(intr, p_cam) - obs)         (the robust loss is outside)
  valid = z >= MIN_Z and the segment is inside the table

with the Jacobian over 35 tangents [point 3 | pose 6 | vel 3 | extr 6 |
intr 17], masked per variable row: J_pt (2, 3, N), J_r (2, 12, N) (pose,
vel; omega columns zero) and, with the calibration groups active,
J_cal (2, 23, N) = [extr 6 | intr 17].

Kernel: csrc/rs_linearize.cu (one thread per observation, the primal chain
in float64 registers, the chain rule written out by hand, one instantiation
per mode: camera model x Jacobian x calibration columns). Replaces the Pallas kernel
rs_fused._rs_kernel of the JAX package (ops/rs_fused.py:131, entry `_run_rs`
:361), which took its Jacobian from two in-kernel linear-transpose passes
over lane vectors. What bounds it on the card: bytes — per observation it
reads 4 indices, pad, tpf, obs_uv, sqrt_h (44 B), gathers pose/vel/point
rows and one 20-float RS segment (~150 B, mostly L2 hits), and writes res,
valid, J_pt, J_r and J_cal (2 x 38 floats + 3: 316 B).

The plain PyTorch version below is the factor's generic path: the segment
lookup of ops/rolling_shutter.py and vmapped reverse-mode AD of
problem.factors._rs_visual_local. CPU tensors take it.
"""

from __future__ import annotations

import torch

from . import _kernels
from . import camera as cam_ops


def _cfg(camera_kind, with_cal):
    from ..problem import factors as fct

    groups = ((fct.POINTS, fct.RIG, fct.CAM_EXTR, fct.CAM_INTR) if with_cal
              else (fct.POINTS, fct.RIG))
    return fct, fct.BatchCfg(kind="rs_visual", camera_kind=camera_kind, active_groups=groups)


def _rs_plain(camera_kind, data, v, masks, with_jac, with_cal):
    fct, cfg = _cfg(camera_kind, with_cal)
    if not with_jac:
        res, valid = fct.residual_generic(cfg, data, v)
        return res.T.contiguous(), valid
    lin = fct.linearize_generic(cfg, data, v, masks)
    out = (lin.res, lin.valid, lin.jac[0], lin.jac[1])
    if with_cal:
        out += (torch.cat([lin.jac[2], lin.jac[3]], dim=1),)
    return out


@_kernels.register("rs_linearize")
def rs_linearize(camera_kind, data, v, masks, with_jac, with_cal):
    """K7 wrapper: (res (2,N), valid (N,)[, J_pt (2,3,N), J_r (2,12,N)[,
    J_cal (2,23,N)]]). `masks` is read only with the Jacobian."""
    if not _kernels.on_card(v.points, "rs_linearize"):
        return _rs_plain(camera_kind, data, v, masks, with_jac, with_cal)
    ck = _kernels.check
    f32, i32 = torch.float32, torch.int32
    n = data["rig"].shape[0]
    R, L = v.pose_q.shape[0], v.points.shape[0]
    n_c, n_e = v.cam_intr.shape[0], v.cam_extr_q.shape[0]
    # the tables are read by rs_row, one row per rig of the session that
    # made them: a merged multi-session problem keeps each session's own
    # (pipeline/multi_session.py), fewer rows than the merged rigs
    tab = data["rs_tables"]
    n_rs, K = tab.dt.shape
    kw = dict(dtype=f32, device=v.points.device)
    res = torch.empty((2, n), **kw)
    valid = torch.empty((n,), **kw)
    J_pt = torch.empty((2, 3, n), **kw) if with_jac else None
    J_r = torch.empty((2, 12, n), **kw) if with_jac else None
    J_cal = torch.empty((2, 23, n), **kw) if with_jac and with_cal else None
    use_masks = with_jac and masks is not None
    count = tab.count.to(torch.int64).contiguous()  # a no-op on the tables' own counts

    def opt(t):
        return t.data_ptr() if t is not None else None

    _kernels.launch(
        "viba_rs_linearize", n, R, K, int(camera_kind), int(bool(with_jac)),
        int(bool(with_cal)),
        ck(data["rig"], "rig", i32, (n,)), ck(data["rs_row"], "rs_row", i32, (n,)),
        ck(data["point"], "point", i32, (n,)), ck(data["intr"], "intr", i32, (n,)),
        ck(data["extr"], "extr", i32, (n,)), ck(data["_pad"], "_pad", f32, (n,)),
        ck(data["rs_tpf"], "rs_tpf", f32, (n,)), ck(data["obs_uv"], "obs_uv", f32, (n, 2)),
        ck(data["sqrt_h"], "sqrt_h", f32, (n, 2, 2)),
        ck(v.pose_q, "pose_q", f32, (R, 4)), ck(v.pose_t, "pose_t", f32, (R, 3)),
        ck(v.vel, "vel", f32, (R, 3)), ck(v.points, "points", f32, (L, 3)),
        ck(v.cam_intr, "cam_intr", f32, (n_c, cam_ops.MAX_PARAMS)),
        ck(v.cam_extr_q, "cam_extr_q", f32, (n_e, 4)),
        ck(v.cam_extr_t, "cam_extr_t", f32, (n_e, 3)),
        ck(masks.rig, "rig_mask", f32, (R, 12)) if use_masks else None,
        ck(masks.points, "pt_mask", f32, (L, 3)) if use_masks else None,
        ck(masks.cam_intr, "intr_mask", f32, (n_c, cam_ops.MAX_PARAMS)) if use_masks else None,
        ck(masks.cam_extr, "extr_mask", f32, (n_e, 6)) if use_masks else None,
        ck(tab.dt, "rs_dt", f32, (n_rs, K)), ck(tab.q, "rs_q", f32, (n_rs, K, 4)),
        ck(tab.dP, "rs_dP", f32, (n_rs, K, 3)), ck(tab.dV, "rs_dV", f32, (n_rs, K, 3)),
        ck(tab.i_gyro, "rs_i_gyro", f32, (n_rs, K, 3)),
        ck(tab.i_accel, "rs_i_accel", f32, (n_rs, K, 3)),
        ck(tab.i_dvel, "rs_i_dvel", f32, (n_rs, K, 3)),
        ck(count, "rs_count", torch.int64, (n_rs,)),
        ck(tab.gravity_w, "rs_gravity", f32, (3,)),
        res.data_ptr(), valid.data_ptr(), opt(J_pt), opt(J_r), opt(J_cal),
    )
    rs_linearize.launches += 1
    if not with_jac:
        return res, valid
    if with_cal:
        return res, valid, J_pt, J_r, J_cal
    return res, valid, J_pt, J_r


def linearize_rs_fused(camera_kind, data, v, masks, with_cal):
    """Fused linearize of a blocked rs_visual batch: (res, valid, J_pt,
    J_rig[, J_cal = extr 6 | intr 17]) in the blocked order."""
    return rs_linearize(camera_kind, data, v, masks, True, with_cal)


def residual_rs_fused(camera_kind, data, v):
    """(res (2, N), valid (N,)) of a blocked rs_visual batch."""
    return rs_linearize(camera_kind, data, v, None, False, False)
