"""Variable tables, tangent containers, masks, and retraction.

Port of `visual_inertial_bundle_adjustment_tpu/problem/structure.py`
(reference lib/small_thing/Variable.h:224-380): every variable group lives in
a flat structure-of-arrays table; the optimizer step is a `Tangent` of
per-group tangent tensors; retraction is one pure function over all tables.
Constant variables and disabled calibration dimensions are masks that zero
the corresponding tangent directions everywhere.

Tangent conventions:
  - rig: (R, 12) = [pose SE3 tangent (t, w), velocity 3, omega 3],
    pose retraction T <- exp(xi) * T (Variable.h:105)
  - landmark points: (L, 3) additive (kept separate for Schur elimination)
  - cam_intr: (Wci, 17) additive; cam_extr / imu_extr: (W, 6) SE3 left
  - imu_calib: (Wic, 23) manifold of models/imu.py
  - det_bias: (C, 2) additive; gravity: (2,) S2 tangent at fixed radius
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..models import imu as imu_model
from ..ops import lie

GRAVITY_MAG = 9.81  # reference viba/common/Constants.h:17

RIG_DIM = 12
POSE = slice(0, 6)
VEL = slice(6, 9)
OMEGA = slice(9, 12)


class VariableTables(NamedTuple):
    """All optimization variables as flat tables."""

    pose_q: torch.Tensor  # (R, 4) T_bodyImu_world rotation (wxyz)
    pose_t: torch.Tensor  # (R, 3) T_bodyImu_world translation
    vel: torch.Tensor  # (R, 3) vel_world
    omega: torch.Tensor  # (R, 3) body angular velocity (imu frame)
    points: torch.Tensor  # (L, 3) world landmarks
    gravity: torch.Tensor  # (3,) gravity vector in world, |g| = GRAVITY_MAG
    cam_intr: torch.Tensor  # (Wci, 17) camera intrinsics windows (+readout+toff)
    cam_extr_q: torch.Tensor  # (Wce, 4) T_Cam_BodyImu
    cam_extr_t: torch.Tensor  # (Wce, 3)
    imu_calib: torch.Tensor  # (Wic, 23) IMU calibration windows
    imu_extr_q: torch.Tensor  # (Wie, 4) T_Imu_BodyImu (secondary IMUs)
    imu_extr_t: torch.Tensor  # (Wie, 3)
    det_bias: torch.Tensor  # (C, 2) per-camera detector bias


class Tangent(NamedTuple):
    """Tangent over all non-landmark variables (the 'reduced' state)."""

    rig: torch.Tensor  # (R, 12)
    cam_intr: torch.Tensor  # (Wci, 17)
    cam_extr: torch.Tensor  # (Wce, 6)
    imu_calib: torch.Tensor  # (Wic, 23)
    imu_extr: torch.Tensor  # (Wie, 6)
    det_bias: torch.Tensor  # (C, 2)
    gravity: torch.Tensor  # (2,)


class Masks(NamedTuple):
    """1.0 where a tangent dim is free, 0.0 where constant/disabled."""

    rig: torch.Tensor  # (R, 12)
    points: torch.Tensor  # (L, 3)
    cam_intr: torch.Tensor  # (Wci, 17)
    cam_extr: torch.Tensor  # (Wce, 6)
    imu_calib: torch.Tensor  # (Wic, 23)
    imu_extr: torch.Tensor  # (Wie, 6)
    det_bias: torch.Tensor  # (C, 2)
    gravity: torch.Tensor  # (2,)


def tables_to(tables, device=None, dtype=None):
    """Move every floating-point tensor of a NamedTuple of tables."""
    return type(tables)(*(a.to(device=device, dtype=dtype) if a.is_floating_point()
                          else a.to(device=device) for a in tables))


def make_tables(num_rigs: int, num_points: int = 0, num_cam_intr: int = 0,
                num_cam_extr: int = 0, num_imu_calib: int = 0, num_imu_extr: int = 0,
                num_cameras: int = 0, dtype=torch.float64, device=None) -> VariableTables:
    """Identity-initialized tables of the given sizes."""
    kw = dict(dtype=dtype, device=device)
    return VariableTables(
        pose_q=lie.quat_identity((num_rigs,), dtype, device),
        pose_t=torch.zeros((num_rigs, 3), **kw),
        vel=torch.zeros((num_rigs, 3), **kw),
        omega=torch.zeros((num_rigs, 3), **kw),
        points=torch.zeros((num_points, 3), **kw),
        gravity=torch.tensor([0.0, 0.0, -GRAVITY_MAG], **kw),
        cam_intr=torch.zeros((num_cam_intr, 17), **kw),
        cam_extr_q=lie.quat_identity((num_cam_extr,), dtype, device),
        cam_extr_t=torch.zeros((num_cam_extr, 3), **kw),
        imu_calib=imu_model.identity_calib(dtype, device).expand(
            num_imu_calib, imu_model.CALIB_DIM).clone(),
        imu_extr_q=lie.quat_identity((num_imu_extr,), dtype, device),
        imu_extr_t=torch.zeros((num_imu_extr, 3), **kw),
        det_bias=torch.zeros((num_cameras, 2), **kw),
    )


def full_masks(v: VariableTables) -> Masks:
    kw = dict(dtype=v.points.dtype, device=v.points.device)
    return Masks(
        rig=torch.ones((v.pose_q.shape[0], RIG_DIM), **kw),
        points=torch.ones_like(v.points),
        cam_intr=torch.ones_like(v.cam_intr),
        cam_extr=torch.ones((v.cam_extr_q.shape[0], 6), **kw),
        imu_calib=torch.ones_like(v.imu_calib),
        imu_extr=torch.ones((v.imu_extr_q.shape[0], 6), **kw),
        det_bias=torch.ones_like(v.det_bias),
        gravity=torch.ones((2,), **kw),
    )


def zero_tangent(v: VariableTables) -> Tangent:
    kw = dict(dtype=v.points.dtype, device=v.points.device)
    return Tangent(
        rig=torch.zeros((v.pose_q.shape[0], RIG_DIM), **kw),
        cam_intr=torch.zeros_like(v.cam_intr),
        cam_extr=torch.zeros((v.cam_extr_q.shape[0], 6), **kw),
        imu_calib=torch.zeros_like(v.imu_calib),
        imu_extr=torch.zeros((v.imu_extr_q.shape[0], 6), **kw),
        det_bias=torch.zeros_like(v.det_bias),
        gravity=torch.zeros((2,), **kw),
    )


def apply_masks(t: Tangent, m: Masks) -> Tangent:
    return Tangent(*(getattr(t, f) * getattr(m, f) for f in Tangent._fields))


def retract(v: VariableTables, t: Tangent, points_step, m: Masks) -> VariableTables:
    """Box-plus on every variable table; masked dims move by zero."""
    t = apply_masks(t, m)
    pose_q, pose_t = lie.se3_boxplus((v.pose_q, v.pose_t), t.rig[:, POSE])
    ce_q, ce_t = lie.se3_boxplus((v.cam_extr_q, v.cam_extr_t), t.cam_extr)
    ie_q, ie_t = lie.se3_boxplus((v.imu_extr_q, v.imu_extr_t), t.imu_extr)
    return VariableTables(
        pose_q=lie.quat_normalize(pose_q),
        pose_t=pose_t,
        vel=v.vel + t.rig[:, VEL],
        omega=v.omega + t.rig[:, OMEGA],
        points=v.points + points_step * m.points,
        gravity=lie.s2_boxplus(v.gravity, GRAVITY_MAG, t.gravity),
        cam_intr=v.cam_intr + t.cam_intr,
        cam_extr_q=lie.quat_normalize(ce_q),
        cam_extr_t=ce_t,
        imu_calib=imu_model.calib_boxplus(v.imu_calib, t.imu_calib),
        imu_extr_q=lie.quat_normalize(ie_q),
        imu_extr_t=ie_t,
        det_bias=v.det_bias + t.det_bias,
    )


def apply_world_transformation(v: VariableTables, Tq, Tt) -> VariableTables:
    """Rigidly move the world frame: (Tq, Tt) = T_newWorld_oldWorld.

    Reference SingleSessionProblem::applyWorldTransformation
    (viba/problem/SingleSessionProblem.cpp:523-538): points -> T * p,
    T_bodyImu_world -> T_bodyImu_world * T^-1, velocities and gravity rotate.
    """
    Tq = torch.as_tensor(Tq, dtype=v.pose_q.dtype, device=v.pose_q.device)
    Tt = torch.as_tensor(Tt, dtype=v.pose_t.dtype, device=v.pose_t.device)
    inv_q, inv_t = lie.se3_inverse((Tq, Tt))
    pq, pt = lie.se3_mul((v.pose_q, v.pose_t), (inv_q[None], inv_t[None]))
    return v._replace(
        pose_q=lie.quat_normalize(pq),
        pose_t=pt,
        vel=lie.quat_rotate(Tq[None], v.vel),
        points=lie.se3_apply((Tq[None], Tt[None]), v.points),
        gravity=lie.quat_rotate(Tq, v.gravity),
    )


def step_to_var_ratios(v: VariableTables, t: Tangent, points_step):
    """|step| / |variable| statistics used by the variables-tolerance stop
    (Variable.h:104-110): SE3: max(|w|_inf, |v|_inf / (1 + |t|_inf));
    vectors: |s|_inf/(1+|x|_inf). Returns (max_ratio, rms_ratio) tensors."""

    def amax(a):
        return a.abs().amax(-1)

    def vec_ratio(step, val):
        return amax(step) / (1.0 + amax(val))

    def se3_ratio(step, val_t):
        return torch.maximum(amax(step[:, 3:6]), amax(step[:, 0:3]) / (1.0 + amax(val_t)))

    ratios = [se3_ratio(t.rig, v.pose_t), vec_ratio(t.rig[:, VEL], v.vel),
              vec_ratio(t.rig[:, OMEGA], v.omega)]
    if v.points.shape[0]:
        ratios.append(vec_ratio(points_step, v.points))
    if v.cam_intr.shape[0]:
        ratios.append(vec_ratio(t.cam_intr, v.cam_intr))
    if v.cam_extr_q.shape[0]:
        ratios.append(se3_ratio(t.cam_extr, v.cam_extr_t))
    if v.imu_calib.shape[0]:
        ratios.append(vec_ratio(t.imu_calib, v.imu_calib))
    if v.imu_extr_q.shape[0]:
        ratios.append(se3_ratio(t.imu_extr, v.imu_extr_t))
    all_r = torch.cat([r.reshape(-1) for r in ratios])
    return all_r.max(), torch.sqrt((all_r ** 2).mean())


# ---------------------------------------------------------------------------
# Tangent vector-space helpers (for PCG / LM algebra)
# ---------------------------------------------------------------------------


def t_add(a, b):
    return type(a)(*(x + y for x, y in zip(a, b)))


def t_sub(a, b):
    return type(a)(*(x - y for x, y in zip(a, b)))


def t_scale(a, s):
    return type(a)(*(x * s for x in a))


def t_axpy(alpha, x, y):
    return type(x)(*(alpha * xi + yi for xi, yi in zip(x, y)))


def t_dot(a, b):
    return sum((x * y).sum() for x, y in zip(a, b))


def t_norm(a):
    return torch.sqrt(t_dot(a, a))


# --- packed reduced-state layout: one (nb, K) tensor whose rows partition
# the groups, columns padded to the widest tangent dim; pads stay exactly
# zero end to end, so each PCG dot/axpy is one op. A tangent of C columns
# (every field with a trailing column axis: rig (R, 12, C), gravity (2, C))
# packs the same way into (nb, K, C) ---


def has_columns(t: Tangent) -> bool:
    """Whether the tangent carries a trailing column axis."""
    return t.gravity.ndim == 2


def pack_info(t: Tangent):
    counts, dims = [], []
    for f, a in zip(Tangent._fields, t):
        if f == "gravity":
            counts.append(1)
            dims.append(a.shape[0])
        else:
            counts.append(a.shape[0])
            dims.append(a.shape[1])
    return tuple(counts), tuple(dims), max(dims)


def pack_t(t: Tangent, counts, dims, K):
    parts = []
    for f, a, dim in zip(Tangent._fields, t, dims):
        if f == "gravity":
            a = a[None]
        parts.append(torch.nn.functional.pad(a, (0, 0) * (a.ndim - 2) + (0, K - dim)))
    return torch.cat(parts, dim=0)


def unpack_t(x, counts, dims, K):
    out = {}
    off = 0
    for f, n, dim in zip(Tangent._fields, counts, dims):
        a = x[off:off + n, :dim]
        out[f] = a[0] if f == "gravity" else a
        off += n
    return Tangent(**out)


def column(t: Tangent, c: int) -> Tangent:
    """Column c of a tangent with columns."""
    return Tangent(*(a[..., c] for a in t))


def stack_columns(ts) -> Tangent:
    """Tangents stacked along a trailing column axis."""
    return Tangent(*(torch.stack(a, dim=-1) for a in zip(*ts)))


def pack_blocks(p: Tangent, counts, dims, K):
    """Block-Jacobi inverse blocks -> one (nb, K, K) stack, zero-padded."""
    parts = []
    for B, dim in zip(p, dims):
        if B.ndim == 2:  # gravity (2, 2)
            B = B[None]
        parts.append(torch.nn.functional.pad(B, (0, K - dim, 0, K - dim)))
    return torch.cat(parts, dim=0)
