"""Multi-session problems: N sessions, one optimizer, shared gravity.

Port of `visual_inertial_bundle_adjustment_tpu/pipeline/multi_session.py`
(reference viba/problem/MultiSessionProblem.h:24-142, MultiSessionProblemImpl.h,
BaseMapVisualFactor.{h,cpp}): several single-session problems share one
optimization (and one gravity variable), with cross-session loop-closure
landmarks unified across sessions and optional constant base-map keyrigs
observing them.

The variable tables of all sessions are concatenated with per-session row
offsets (`torch.cat` on the problems' device and dtype); every factor
batch's index arrays are shifted; the shared gravity is problem 0's;
loop-closure point equivalences are merged by union-find on the host in
float64 before concatenation, and only the merged tables move to the device.
The result is an ordinary `Problem`: `Problem._build` blocks its visual
batches (rcs.finalize_blocks) as it blocks a single session's.

Divergence from the JAX package (a reference fault, ROADMAP C): the JAX
merge_sessions copies an already-blocked batch's tile plans (`_rb_base`,
`_rb_rows`, the landmark windows `_rg_*`, the window plan `_cb_*`) unshifted
beside its shifted rig and landmark indices, so a blocked session after the
first one scatters into the first session's rows. The port refuses blocked
inputs (ValueError); merge the problems as the adapter built them, before
`_build()` or `rcs.finalize_blocks`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..problem import factors as fct
from ..problem.optimizer import Problem
from ..problem.structure import Masks, VariableTables

_GROUP_TO_TABLE_ROWS = {
    fct.RIG: lambda v: v.pose_q.shape[0],
    fct.POINTS: lambda v: v.points.shape[0],
    fct.CAM_INTR: lambda v: v.cam_intr.shape[0],
    fct.CAM_EXTR: lambda v: v.cam_extr_q.shape[0],
    fct.IMU_CALIB: lambda v: v.imu_calib.shape[0],
    fct.IMU_EXTR: lambda v: v.imu_extr_q.shape[0],
    fct.DET_BIAS: lambda v: v.det_bias.shape[0],
}


class _UnionFind:
    def __init__(self, n):
        self.p = np.arange(n)

    def find(self, a):
        while self.p[a] != a:
            self.p[a] = self.p[self.p[a]]
            a = self.p[a]
        return a

    def union(self, a, b):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.p[max(ra, rb)] = min(ra, rb)


@dataclasses.dataclass
class MergedSession:
    problem: Problem
    rig_offset: list  # per-session rig row offset
    point_offset: list
    point_map: np.ndarray  # global point id -> merged row


def _check_unblocked(si, p):
    blocked = [c.kind for c in p.cfgs if c.block_info is not None]
    if blocked:
        raise ValueError(
            f"merge_sessions: problem {si} is already blocked ({blocked} batches carry "
            "rcs.finalize_blocks tile plans, which index its own rig, landmark and window "
            "rows and would be stale after the merge's row shift); merge the problems "
            "before Problem._build()")


def merge_sessions(problems, point_matches=(), extra_batches=()):
    """Merge per-session Problems into one.

    problems: list of unblocked Problem (each from SessionAdapter.build()).
    point_matches: [(sess_a, point_row_a, sess_b, point_row_b), ...]
        loop-closure equivalences; matched landmarks become one variable.
    extra_batches: [(BatchCfg, data)] appended after re-indexing (e.g.
        base-map visual factors built against merged point rows).
    """
    for si, p in enumerate(problems):
        _check_unblocked(si, p)
    offs = {g: [0] for g in _GROUP_TO_TABLE_ROWS}
    for p in problems:
        for g, rows in _GROUP_TO_TABLE_ROWS.items():
            offs[g].append(offs[g][-1] + rows(p.variables))

    # union-find over the concatenated point index space
    total_pts = offs[fct.POINTS][-1]
    uf = _UnionFind(total_pts)
    for sa, pa, sb, pb in point_matches:
        uf.union(offs[fct.POINTS][sa] + pa, offs[fct.POINTS][sb] + pb)
    roots = np.asarray([uf.find(i) for i in range(total_pts)])
    uniq, point_map = np.unique(roots, return_inverse=True)

    p0 = problems[0].variables.points
    device, dtype = p0.device, p0.dtype

    def cat(field):
        return torch.cat([getattr(p.variables, field) for p in problems], dim=0)

    # merged points averaged over equivalence classes (host, float64)
    all_points = np.concatenate([p.variables.points.cpu().double().numpy() for p in problems])
    merged_points = np.zeros((len(uniq), 3))
    counts = np.bincount(point_map, minlength=len(uniq))
    np.add.at(merged_points, point_map, all_points)
    merged_points /= np.maximum(counts, 1)[:, None]

    v = VariableTables(
        pose_q=cat("pose_q"), pose_t=cat("pose_t"), vel=cat("vel"), omega=cat("omega"),
        points=torch.from_numpy(merged_points).to(device=device, dtype=dtype),
        gravity=problems[0].variables.gravity,  # SHARED (MultiSessionProblem.h:24)
        cam_intr=cat("cam_intr"), cam_extr_q=cat("cam_extr_q"), cam_extr_t=cat("cam_extr_t"),
        imu_calib=cat("imu_calib"), imu_extr_q=cat("imu_extr_q"), imu_extr_t=cat("imu_extr_t"),
        det_bias=cat("det_bias"),
    )

    def cat_mask(field):
        return torch.cat([getattr(p.masks, field) for p in problems], dim=0)

    pt_mask = np.ones((len(uniq), 3))
    all_pm = np.concatenate([p.masks.points.cpu().double().numpy() for p in problems])
    np.minimum.at(pt_mask, point_map, all_pm)
    mdtype = problems[0].masks.points.dtype
    masks = Masks(
        rig=cat_mask("rig"), points=torch.from_numpy(pt_mask).to(device=device, dtype=mdtype),
        cam_intr=cat_mask("cam_intr"), cam_extr=cat_mask("cam_extr"),
        imu_calib=cat_mask("imu_calib"), imu_extr=cat_mask("imu_extr"),
        det_bias=cat_mask("det_bias"), gravity=problems[0].masks.gravity,
    )

    merged = Problem(v, masks)
    point_map_t = torch.from_numpy(point_map.astype(np.int64))
    for si, p in enumerate(problems):
        for cfg, data in zip(p.cfgs, p.datas):
            spec = fct.REGISTRY[cfg.kind]
            new = dict(data)
            for g, field in spec["tangents"]:
                if field is None or g == fct.GRAVITY:
                    continue
                ix = data[field].to(torch.int64) + offs[g][si]
                if g == fct.POINTS:
                    ix = point_map_t.to(ix.device)[ix]
                new[field] = ix.to(torch.int32)
            # derived per-batch plans (build_transpose_plans' `_ell{i}`) index
            # the session's own rows: _build rebuilds them on the merged one
            new = {k: a for k, a in new.items() if not k.startswith("_ell")}
            merged.add_batch(cfg, new)
    for cfg, data in extra_batches:
        merged.add_batch(cfg, data)
    return MergedSession(
        problem=merged,
        rig_offset=offs[fct.RIG][:-1],
        point_offset=offs[fct.POINTS][:-1],
        point_map=point_map,
    )


def make_base_map_batch(point_rows, q_cam_world, t_cam_world, intr, obs_uv, sqrt_h,
                        camera_kind, label="base_map", device=None, dtype=torch.float64):
    """Batch of constant-keyrig observations of merged landmarks
    (reference BaseMapVisualFactor), on `device` as `dtype` (the merged
    problem's: pass its tables' device and dtype). The device is the first
    CUDA card unless the caller names another, as for the builder."""
    from . import builder

    device = torch.device(device) if device is not None else builder.default_device()
    cfg = fct.BatchCfg(kind="base_map_visual", loss=builder.REPROJ_LOSS,
                       camera_kind=camera_kind, label=label)

    def f(a):
        return torch.as_tensor(a).to(device=device, dtype=dtype)

    data = {
        "point": torch.as_tensor(point_rows).to(device=device, dtype=torch.int32),
        "q_cw": f(q_cam_world),
        "t_cw": f(t_cam_world),
        "intr": f(intr),
        "obs_uv": f(obs_uv),
        "sqrt_h": f(sqrt_h),
    }
    return cfg, data
