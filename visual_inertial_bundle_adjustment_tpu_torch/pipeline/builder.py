"""Assemble an optimization Problem from a synthetic session.

Port of `visual_inertial_bundle_adjustment_tpu/pipeline/builder.py`
(reference SingleSessionAdapter.cpp:67-128): variable tables, preintegration
per consecutive rig pair, and the visual + inertial factor batches. The
problem is built on the host in float64 and then moved to `device` as
`dtype` — host preprocessing, like rcs.finalize_blocks.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models import imu as imu_model
from ..ops import camera as cam_ops
from ..ops import lie, losses
from ..ops import preintegration as pre
from ..problem import factors as fct
from ..problem.optimizer import Problem
from ..problem.structure import VariableTables, full_masks
from .synthetic import SyntheticSession

# reference viba/common/Constants.h:21-22
REPROJ_LOSS = (losses.HUBER_CUTOFF, 1.0, 3.0)
OBS_SQRT_H = 0.7  # fixed observation whitening (tools/save_observations)


def chol_inv_lower(cov):
    """sqrt information: L^-1 with cov = L L^T (batched), with the JAX
    package's trace-relative jitter."""
    d = cov.shape[-1]
    eye = torch.eye(d, dtype=cov.dtype, device=cov.device).expand(cov.shape)
    tr = torch.diagonal(cov, dim1=-2, dim2=-1).sum(-1)[..., None, None]
    eps = 1e-7 if cov.dtype == torch.float32 else 1e-14
    L = torch.linalg.cholesky(cov + eye * tr * eps)
    return torch.linalg.solve_triangular(L, eye, upper=False)


@dataclasses.dataclass
class BuildOptions:
    estimate_imu_calib: bool = False
    estimate_gravity: bool = True
    imu_calib_options: dict = dataclasses.field(default_factory=dict)  # options_mask kwargs
    estimate_cam_intr: bool = False
    estimate_cam_extr: bool = False
    fix_first_rig: bool = True
    init_pose_noise: float = 0.0  # rad / relative translation perturbation
    init_point_noise: float = 0.0
    init_vel_noise: float = 0.0
    seed: int = 0


def build_synthetic_problem(s: SyntheticSession, opts: BuildOptions = None, *,
                            device="cpu", dtype=torch.float64) -> Problem:
    opts = opts or BuildOptions()
    f64 = torch.float64
    rng = np.random.default_rng(opts.seed + 1000)
    R = s.num_rigs
    obs = s.observations()
    L = len(s.points_w)

    # --- variable tables (ground truth + perturbations as initialization) ---
    pose_q = torch.from_numpy(s.gt_pose_q)
    pose_t = torch.from_numpy(s.gt_pose_t)
    if opts.init_pose_noise > 0:
        xi = np.zeros((R, 6))
        xi[:, :3] = rng.normal(size=(R, 3)) * opts.init_pose_noise
        xi[:, 3:] = rng.normal(size=(R, 3)) * opts.init_pose_noise
        if opts.fix_first_rig:
            xi[0] = 0
        pose_q, pose_t = lie.se3_boxplus((pose_q, pose_t), torch.from_numpy(xi))
        pose_q = lie.quat_normalize(pose_q)
    points = torch.from_numpy(s.points_w + rng.normal(size=(L, 3)) * opts.init_point_noise)
    vel = torch.from_numpy(s.gt_vel_w + rng.normal(size=(R, 3)) * opts.init_vel_noise)
    init_calib = imu_model.identity_calib(f64)

    v = VariableTables(
        pose_q=pose_q, pose_t=pose_t, vel=vel, omega=torch.from_numpy(s.gt_omega),
        points=points, gravity=torch.from_numpy(s.gravity),
        cam_intr=cam_ops.pad_params(torch.from_numpy(s.camera_params))[None, :],
        cam_extr_q=torch.stack([torch.from_numpy(q) for q, _ in s.cam_extr]),
        cam_extr_t=torch.stack([torch.from_numpy(t) for _, t in s.cam_extr]),
        imu_calib=init_calib[None, :],
        imu_extr_q=lie.quat_identity((0,), f64),
        imu_extr_t=torch.zeros((0, 3), dtype=f64),
        det_bias=torch.zeros((s.num_cameras, 2), dtype=f64),
    )
    masks = full_masks(v)
    rig_mask = masks.rig.clone()
    if opts.fix_first_rig:
        rig_mask[0] = 0.0
    cam_intr_mask = torch.zeros_like(masks.cam_intr)
    if opts.estimate_cam_intr:
        # no rolling shutter in this slice: readout/time-offset frozen
        cam_intr_mask = torch.ones_like(masks.cam_intr)
        cam_intr_mask[:, cam_ops.READOUT] = 0.0
        cam_intr_mask[:, cam_ops.TIME_OFFSET] = 0.0
    calib_mask = (imu_model.options_mask(**opts.imu_calib_options) if opts.estimate_imu_calib
                  else np.zeros(imu_model.CALIB_DIM, bool))
    masks = masks._replace(
        rig=rig_mask,
        cam_intr=cam_intr_mask,
        cam_extr=masks.cam_extr if opts.estimate_cam_extr else torch.zeros_like(masks.cam_extr),
        imu_calib=torch.from_numpy(calib_mask.astype(np.float64)).expand(v.imu_calib.shape).clone(),
        det_bias=torch.zeros_like(masks.det_bias),
        gravity=masks.gravity if opts.estimate_gravity else torch.zeros_like(masks.gravity),
    )
    problem = Problem(v, masks)

    # --- visual factors ----------------------------------------------------
    n_obs = len(obs["point"])
    problem.add_batch(
        fct.BatchCfg(kind="visual", loss=REPROJ_LOSS, camera_kind=cam_ops.KIND_FISHEYE624,
                     label="visual"),
        fct.make_visual_batch(
            point=obs["point"], rig=obs["rig"], intr=np.zeros(n_obs, np.int64),
            extr=obs["cam"], bias=obs["cam"], obs_uv=obs["uv"],
            sqrt_h=np.broadcast_to(np.eye(2) * OBS_SQRT_H, (n_obs, 2, 2))),
    )

    # --- inertial factors (body IMU) ---------------------------------------
    intervals, num_steps = s.preint_intervals()
    calibs = init_calib.expand(R - 1, imu_model.CALIB_DIM)
    p = pre.preintegrate_batch(calibs, intervals, s.noise, num_steps)
    i32 = torch.int32
    problem.add_batch(
        fct.BatchCfg(kind="inertial", label="inertial"),
        {
            "prev_rig": torch.arange(R - 1, dtype=i32),
            "next_rig": torch.arange(1, R, dtype=i32),
            "calib": torch.zeros(R - 1, dtype=i32),
            "preint_q": p.rvp.q,
            "preint_dv": p.rvp.dV,
            "preint_dp": p.rvp.dP,
            "preint_dt": p.rvp.dt,
            "preint_J": p.J,
            "calib_eval": p.calib_eval.contiguous(),
            "calib_mask": torch.from_numpy(calib_mask.astype(np.float64))
            .expand(R - 1, imu_model.CALIB_DIM).contiguous(),
            "sqrt_info": chol_inv_lower(p.cov),
        },
    )
    return problem.to(device, dtype)
