"""Fused linearization of blocked plain-visual batches (kernels K1, K11).

Per observation: the whitened residual and the analytic pose/point Jacobian
blocks of the visual factor (reference VisualFactor.cpp:36-120):

  p_rig = R(T) p + t(T)          T = exp(xi_pose) T0   (left boxplus)
  p_cam = R(E) p_rig + t(E)
  res   = sqrt_h (proj(intr, p_cam) - obs + bias_on * bias)

with the camera model's 2x3 Jacobian D wrt p_cam chained analytically:

  J_pt = sqrt_h D R(E) R(T),  J_pose = sqrt_h D R(E) [ I | -hat(p_rig) ]

J_r keeps the (2, 12, N) layout of the JAX package: columns 0-5 are
[trans, rot] x rig mask, columns 6-11 are zero.

Kernel: csrc/visual_linearize.cu, `visual_linearize_mode` (one thread per
observation, one template instantiation per camera model and mode; D from
three forward tangents carried in a small dual type; csrc/visual_body.cuh).
Replaces the Pallas kernel visual_fused._visual_kernel of the JAX package
(ops/visual_fused.py:139, entry `_run` :237). What bounds it on the card:
bytes — per observation it reads 5 indices, obs_uv, sqrt_h, pad, bias_on
(52 B) plus gathered pose/point rows (~56 B, L2-resident tables) and writes
res, valid, J_pt, J_r (132 B): about 0.1 GB per linearization at the bias-only
headline's 397,312 slots, ~28 us at the H100's 3.35 TB/s. The design keeps every table
gather an indexed load (no one-hot selection, no hi/lo point windows) and
writes each output column coalesced (observation axis last). The
residual-only instantiation compiles no Jacobian chain; the Jacobian's chain
below sqrt_h D runs in float32 (the primal chain and the residual in
float64).

With the camera calibration estimated (point + pose + cam extr + cam intr
active, a global-shutter camera) the batch goes through K11 instead:

  J_extr = sqrt_h D [ I | -hat(p_cam) ]   (left boxplus on E, as on T)
  J_intr = sqrt_h d proj / d intr         (17 columns; the readout and
                                           time-offset columns are zero)

returned as J_cal (2, 23, N) = [extr 6 | intr 17], each column times the mask
of its variable row. Kernel: csrc/visual_cal_linearize.cu,
`visual_cal_linearize_mode` (K1's body with the calibration columns, one
instantiation per camera model; the intrinsics columns from the projection's
own intermediates). Replaces the Pallas kernel
visual_fused._visual_cal_kernel of the JAX package (ops/visual_fused.py:347,
entry `_run_cal` :445), which took the Jacobian from an in-kernel
jax.linearize and two transpose passes. Bound: bytes, 316 B of outputs per
observation (2 x 38 Jacobian floats, res, valid) plus 52 B of inputs and the
gathered rows: ~0.19 ms for 1.75M observations at 3.35 TB/s. The residual of
such a batch is K1's residual-only launch.

The plain PyTorch versions below compute the same functions (D by three
forward-mode JVPs through ops/camera, d proj / d intr by forward-mode AD)
and serve CPU tensors.
"""

from __future__ import annotations

import torch

from . import _kernels
from . import camera as cam_ops
from . import lie

MIN_Z = 1e-6


def _inputs(data, v, masks):
    n = data["rig"].shape[0]
    rig_mask = masks.rig if masks is not None else None
    pt_mask = masks.points if masks is not None else None
    return n, rig_mask, pt_mask


def _rot_cols(q):
    """Rotation matrix columns R e_j (N, 3) each, as quat_rotate of e_j."""
    eye = torch.eye(3, dtype=q.dtype, device=q.device)
    return [lie.quat_rotate(q, eye[j].expand(q.shape[0], 3)) for j in range(3)]


def _visual_plain(camera_kind, data, v, masks, with_jac, with_cal=False):
    n, rig_mask, pt_mask = _inputs(data, v, masks)
    rig, point = data["rig"], data["point"]
    Tq, Tt = v.pose_q.index_select(0, rig), v.pose_t.index_select(0, rig)
    Eq = v.cam_extr_q.index_select(0, data["extr"])
    Et = v.cam_extr_t.index_select(0, data["extr"])
    intr = v.cam_intr.index_select(0, data["intr"])
    bias = v.det_bias.index_select(0, data["bias"])
    p = v.points.index_select(0, point)
    pr = lie.quat_rotate(Tq, p) + Tt
    pc = lie.quat_rotate(Eq, pr) + Et

    def proj(x):
        return cam_ops.project(camera_kind, intr, x)[0]

    uv = proj(pc)
    h = data["sqrt_h"]  # (N, 2, 2)
    err = uv - data["obs_uv"] + data["bias_on"][:, None] * bias
    res = (h * err[:, None, :]).sum(-1).T.contiguous()  # (2, N)
    valid = (pc[:, 2] >= MIN_Z).to(res.dtype)
    valid = torch.maximum(valid, data["_pad"].to(res.dtype))
    if not with_jac:
        return res, valid

    eye = torch.eye(3, dtype=pc.dtype, device=pc.device)
    # D[:, :, c] = d uv / d pc_c
    D = torch.stack([torch.func.jvp(proj, (pc,), (eye[c].expand(n, 3),))[1]
                     for c in range(3)], dim=-1)  # (N, 2, 3)
    A2 = (h[:, :, :, None] * D[:, None, :, :]).sum(2)  # (N, 2, 3) = sqrt_h D
    RE = torch.stack(_rot_cols(Eq), dim=-1)  # (N, 3, 3), RE[:, i, j] = R(E)_ij
    RT = torch.stack(_rot_cols(Tq), dim=-1)
    A3 = (A2[:, :, :, None] * RE[:, None, :, :]).sum(2)  # (N, 2, 3)
    J_pt = (A3[:, :, :, None] * RT[:, None, :, :]).sum(2)  # (N, 2, 3)
    J_rot = lie.cross(pr[:, None, :], A3)  # (N, 2, 3): pr x A3[r]
    if pt_mask is not None:
        J_pt = J_pt * pt_mask.index_select(0, point)[:, None, :]
    J6 = torch.cat([A3, J_rot], dim=-1)  # (N, 2, 6) [trans, rot]
    if rig_mask is not None:
        J6 = J6 * rig_mask.index_select(0, rig)[:, None, :6]
    J_r = torch.cat([J6, torch.zeros_like(J6)], dim=-1)  # (N, 2, 12)
    out = (res, valid, J_pt.permute(1, 2, 0).contiguous(), J_r.permute(1, 2, 0).contiguous())
    if not with_cal:
        return out
    J_extr = torch.cat([A2, lie.cross(pc[:, None, :], A2)], dim=-1)  # (N, 2, 6)
    dK = torch.func.vmap(torch.func.jacfwd(
        lambda k, xc: cam_ops.project(camera_kind, k, xc)[0]))(intr, pc)  # (N, 2, 17)
    # (jacfwd may return float64 tangents from float32 inputs: keep the inputs' type)
    J_intr = (h[:, :, :, None] * dK.to(pc.dtype)[:, None, :, :]).sum(2)
    if masks is not None:
        J_extr = J_extr * masks.cam_extr.index_select(0, data["extr"])[:, None, :]
        J_intr = J_intr * masks.cam_intr.index_select(0, data["intr"])[:, None, :]
    return out + (torch.cat([J_extr, J_intr], dim=-1).permute(1, 2, 0).contiguous(),)


@_kernels.register("visual_linearize")
def visual_linearize(camera_kind, data, v, masks, with_jac):
    """K1 wrapper: (res (2,N), valid (N,)[, J_pt (2,3,N), J_r (2,12,N)])."""
    if not _kernels.on_card(v.points):
        return _visual_plain(camera_kind, data, v, masks, with_jac)
    out = _launch_visual(camera_kind, data, v, masks, with_jac)
    visual_linearize.launches += 1
    return out


def _launch_visual(camera_kind, data, v, masks, with_jac):
    """Launch K1 (viba_visual_linearize: one instantiation per mode)."""
    n, rig_mask, pt_mask = _inputs(data, v, masks)
    ck = _kernels.check
    R, L = v.pose_q.shape[0], v.points.shape[0]
    f32 = torch.float32
    kw = dict(dtype=f32, device=v.points.device)
    res = torch.empty((2, n), **kw)
    valid = torch.empty((n,), **kw)
    J_pt = torch.empty((2, 3, n), **kw) if with_jac else None
    J_r = torch.empty((2, 12, n), **kw) if with_jac else None
    null = None
    _kernels.launch(
        "viba_visual_linearize", n, int(camera_kind), int(bool(with_jac)),
        ck(data["rig"], "rig", torch.int32, (n,)),
        ck(data["point"], "point", torch.int32, (n,)),
        ck(data["intr"], "intr", torch.int32, (n,)),
        ck(data["extr"], "extr", torch.int32, (n,)),
        ck(data["bias"], "bias", torch.int32, (n,)),
        ck(data["bias_on"], "bias_on", f32, (n,)),
        ck(data["obs_uv"], "obs_uv", f32, (n, 2)),
        ck(data["sqrt_h"], "sqrt_h", f32, (n, 2, 2)),
        ck(data["_pad"], "_pad", f32, (n,)),
        ck(v.pose_q, "pose_q", f32, (R, 4)),
        ck(v.pose_t, "pose_t", f32, (R, 3)),
        ck(rig_mask, "rig_mask", f32, (R, 12)) if rig_mask is not None else null,
        ck(v.points, "points", f32, (L, 3)),
        ck(pt_mask, "pt_mask", f32, (L, 3)) if pt_mask is not None else null,
        ck(v.cam_intr, "cam_intr", f32, (v.cam_intr.shape[0], cam_ops.MAX_PARAMS)),
        ck(v.cam_extr_q, "cam_extr_q", f32),
        ck(v.cam_extr_t, "cam_extr_t", f32),
        ck(v.det_bias, "det_bias", f32),
        res.data_ptr(), valid.data_ptr(),
        J_pt.data_ptr() if with_jac else null,
        J_r.data_ptr() if with_jac else null,
    )
    if with_jac:
        return res, valid, J_pt, J_r
    return res, valid


@_kernels.register("visual_cal_linearize")
def visual_cal_linearize(camera_kind, data, v, masks):
    """K11 wrapper: (res (2,N), valid (N,), J_pt (2,3,N), J_r (2,12,N),
    J_cal (2,23,N) = extr 6 | intr 17). `masks` None means no masking."""
    if not _kernels.on_card(v.points):
        return _visual_plain(camera_kind, data, v, masks, True, with_cal=True)
    out = _launch_visual_cal(camera_kind, data, v, masks)
    visual_cal_linearize.launches += 1
    return out


def _launch_visual_cal(camera_kind, data, v, masks):
    """Launch K11 (viba_visual_cal_linearize: one instantiation per camera
    model)."""
    ck = _kernels.check
    f32, i32 = torch.float32, torch.int32
    n = data["rig"].shape[0]
    R, L = v.pose_q.shape[0], v.points.shape[0]
    n_c, n_e = v.cam_intr.shape[0], v.cam_extr_q.shape[0]
    kw = dict(dtype=f32, device=v.points.device)
    res, valid = torch.empty((2, n), **kw), torch.empty((n,), **kw)
    J_pt, J_r = torch.empty((2, 3, n), **kw), torch.empty((2, 12, n), **kw)
    J_cal = torch.empty((2, 23, n), **kw)
    use_masks = masks is not None
    _kernels.launch(
        "viba_visual_cal_linearize", n, int(camera_kind),
        ck(data["rig"], "rig", i32, (n,)), ck(data["point"], "point", i32, (n,)),
        ck(data["intr"], "intr", i32, (n,)), ck(data["extr"], "extr", i32, (n,)),
        ck(data["bias"], "bias", i32, (n,)), ck(data["bias_on"], "bias_on", f32, (n,)),
        ck(data["obs_uv"], "obs_uv", f32, (n, 2)), ck(data["sqrt_h"], "sqrt_h", f32, (n, 2, 2)),
        ck(data["_pad"], "_pad", f32, (n,)),
        ck(v.pose_q, "pose_q", f32, (R, 4)), ck(v.pose_t, "pose_t", f32, (R, 3)),
        ck(v.points, "points", f32, (L, 3)),
        ck(v.cam_intr, "cam_intr", f32, (n_c, cam_ops.MAX_PARAMS)),
        ck(v.cam_extr_q, "cam_extr_q", f32, (n_e, 4)),
        ck(v.cam_extr_t, "cam_extr_t", f32, (n_e, 3)),
        ck(v.det_bias, "det_bias", f32, (v.det_bias.shape[0], 2)),
        ck(masks.rig, "rig_mask", f32, (R, 12)) if use_masks else None,
        ck(masks.points, "pt_mask", f32, (L, 3)) if use_masks else None,
        ck(masks.cam_intr, "intr_mask", f32, (n_c, cam_ops.MAX_PARAMS)) if use_masks else None,
        ck(masks.cam_extr, "extr_mask", f32, (n_e, 6)) if use_masks else None,
        res.data_ptr(), valid.data_ptr(), J_pt.data_ptr(), J_r.data_ptr(), J_cal.data_ptr(),
    )
    return res, valid, J_pt, J_r, J_cal


def linearize_visual_cal_fused(camera_kind, data, v, masks, info):
    """Fused linearize of a blocked calibration-coupled plain-visual batch:
    (res (2, N), valid (N,), J_pt (2, 3, N), J_rig (2, 12, N),
    J_cal (2, 23, N) = extr 6 | intr 17) in the blocked order."""
    return visual_cal_linearize(camera_kind, data, v, masks)


def linearize_visual_fused(camera_kind, data, v, masks, info):
    """Fused linearize of a blocked rig-only visual batch: (res (2, N),
    valid (N,), J_pt (2, 3, N), J_rig (2, 12, N)) in the blocked order."""
    return visual_linearize(camera_kind, data, v, masks, True)


def residual_visual_fused(camera_kind, data, v, masks, info):
    """(res (2, N), valid (N,)) of a blocked visual batch."""
    return visual_linearize(camera_kind, data, v, masks, False)
