"""Landmark triangulation: batched RANSAC on ray pairs + robust refinement.

Port of `visual_inertial_bundle_adjustment_tpu/pipeline/triangulation.py`
(reference viba/single_session/Triangulation.cpp:30-165): all tracks are one
padded (P, T) batch — the JAX package's per-track `vmap` is the leading
dimension here. 10 RANSAC iterations on random ray pairs (closest-point
candidate, clamped-angle score, reference Triangulation.h:13-44 constants),
then two Huber-weighted 3x3 Gauss-Newton refinement passes against
reprojection error with inlier thresholds 3.0 / 2.5 px.

The ray pairs are the JAX package's: per track a threefry-2x32 key from
pointId + SEED_OFFSET, folded with the iteration and split in two, each
drawn through jax.random.randint's 64-bit modulus rule (ported to numpy
below, `_randint`; jax_threefry_partitionable key splitting, 64-bit
integers). So both packages try the same pairs, as the reference seeds its
mt19937 per point (InitPointTracks.cpp:44).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import camera as cam_ops
from ..ops import lie

# reference Triangulation.h:13-44
NUM_RANSAC = 10
OUTLIER_OBS_RAD = float(np.deg2rad(0.4))
MIN_INLIERS_CANDIDATE = 2
MIN_INLIER_OBS = 3
REFINE = [
    dict(outlier_threshold=3.0, skip_outliers=False, iters=3, loss_radius=1.5),
    dict(outlier_threshold=2.5, skip_outliers=True, iters=3, loss_radius=1.0),
]
MIN_INLIERS_AFTER_REFINE = 3
SEED_OFFSET = 1729


_U32 = np.uint32


def _rotl(x, d):
    return (x << _U32(d)) | (x >> _U32(32 - d))


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) on uint32 arrays, as jax.random."""
    with np.errstate(over="ignore"):
        ks = (k1, k2, k1 ^ k2 ^ _U32(0x1BD11BDA))
        x = [x1 + ks[0], x2 + ks[1]]
        rot = ((13, 15, 26, 6), (17, 29, 16, 24))
        for i in range(5):
            for r in rot[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + _U32(i + 1)
    return x[0], x[1]


def _split2(key):
    """jax.random.split(key) (partitionable threefry): two keys."""
    zero = np.zeros_like(key[0])
    a = threefry2x32(key[0], key[1], zero, zero)
    b = threefry2x32(key[0], key[1], zero, zero + _U32(1))
    return (a[0], a[1]), (b[0], b[1])


def _randint(key, lo, hi):
    """jax.random.randint(key, (), lo, hi) with 64-bit integers."""
    k_hi, k_lo = _split2(key)

    def bits64(k):
        y = threefry2x32(k[0], k[1], np.zeros_like(k[0]), np.zeros_like(k[0]))
        return (y[0].astype(np.uint64) << np.uint64(32)) | y[1].astype(np.uint64)

    span = np.where(hi <= lo, 1, hi - lo).astype(np.uint64)
    mult = np.uint64(2 ** 32) % span
    mult = (mult * mult) % span
    off = ((bits64(k_hi) % span) * mult + bits64(k_lo) % span) % span
    return lo + off.astype(np.int64)


def ransac_pairs(point_ids, count):
    """(a, b) (P, NUM_RANSAC) slot indices of each track's random ray pairs."""
    key = (np.zeros(len(point_ids), _U32), (point_ids.astype(np.int64) + SEED_OFFSET).astype(_U32))
    n1 = np.maximum(count, 1).astype(np.int64)
    n2 = np.maximum(count, 2).astype(np.int64)
    a_all, b_all = [], []
    for i in range(NUM_RANSAC):
        k = threefry2x32(key[0], key[1], np.zeros_like(key[0]), np.full_like(key[0], i))
        ka, kb = _split2(k)
        a = _randint(ka, np.zeros_like(n1), n1)
        off = _randint(kb, np.ones_like(n2), n2)
        a_all.append(a)
        b_all.append((a + off) % n1)
    return np.stack(a_all, 1), np.stack(b_all, 1)


def _huber_weight(s, a):
    r = torch.sqrt(torch.clamp(s, min=1e-30))
    return torch.where(s <= a * a, torch.ones_like(s), a / r)


def _guard(x):
    return torch.where(x.abs() < 1e-30, torch.full_like(x, 1e-30), x)


def _dot(a, b):
    return (a * b).sum(-1)


def _take_slot(x, i):
    """x (P, T, 3) at slot i (P,) -> (P, 3)."""
    return torch.gather(x, 1, i[:, None, None].expand(-1, 1, x.shape[-1]))[:, 0]


def _ransac_candidates(starts, dirs, valid, pairs_a, pairs_b):
    """Best closest-point candidate over the given ray pairs, per track."""
    P = starts.shape[0]
    dtype, device = starts.dtype, starts.device
    best_point = torch.zeros((P, 3), dtype=dtype, device=device)
    best_score = torch.full((P,), float("inf"), dtype=dtype, device=device)
    best_inl = torch.zeros(P, dtype=torch.int64, device=device)
    for i in range(NUM_RANSAC):
        a, b = pairs_a[:, i], pairs_b[:, i]
        sa, da = _take_slot(starts, a), _take_slot(dirs, a)
        sb, db = _take_slot(starts, b), _take_slot(dirs, b)
        ortho = lie.cross(da, db)
        onorm = torch.linalg.vector_norm(ortho, dim=-1)
        ok = onorm >= 1e-4
        on = ortho / torch.where(ok, onorm, torch.ones_like(onorm))[:, None]
        a_lat = lie.cross(on, da)
        b_lat = lie.cross(on, db)
        b_fact = _dot(a_lat, sa - sb) / _guard(_dot(a_lat, db))
        a_fact = _dot(b_lat, sb - sa) / _guard(_dot(b_lat, da))
        ok = ok & (b_fact >= 0.0) & (a_fact >= 0.0)
        cand = sa + a_fact[:, None] * da + on * (0.5 * _dot(on, sb - sa))[:, None]

        alt = cand[:, None, :] - starts
        alt = alt / torch.clamp(torch.linalg.vector_norm(alt, dim=-1, keepdim=True), min=1e-12)
        chord = torch.linalg.vector_norm(dirs - alt, dim=-1)
        ang = 2.0 * torch.asin(torch.clamp(chord * 0.5, 0.0, 1.0))
        is_inl = (ang < OUTLIER_OBS_RAD) & valid
        score = torch.where(valid, torch.where(is_inl, ang, torch.full_like(ang, OUTLIER_OBS_RAD)),
                            torch.zeros_like(ang)).sum(1)
        n_inl = is_inl.to(torch.int64).sum(1)
        ok = ok & (n_inl >= MIN_INLIERS_CANDIDATE)
        better = ok & (score < best_score)
        best_point = torch.where(better[:, None], cand, best_point)
        best_score = torch.where(better, score, best_score)
        best_inl = torch.where(better, n_inl, best_inl)
    return best_point, best_inl >= MIN_INLIERS_CANDIDATE


def _refine_pass(point, cam_q, cam_t, intr, obs_uv, sqrt_h, valid, camera_kind,
                 outlier_threshold, skip_outliers, iters, loss_radius):
    """Robust 3x3 Gauss-Newton on reprojection error (padded tracks)."""
    thr2 = outlier_threshold * outlier_threshold

    def project(p):
        pc = lie.quat_rotate(cam_q, p[:, None, :].expand_as(cam_t)) + cam_t
        return cam_ops.project(camera_kind, intr, pc)

    def werr_of(p):
        return (sqrt_h * (project(p)[0] - obs_uv)[..., None, :]).sum(-1)

    eye = torch.eye(3, dtype=point.dtype, device=point.device)
    pt = point
    for _ in range(iters):
        uv, pvalid = project(pt)
        err = uv - obs_uv
        werr = (sqrt_h * err[..., None, :]).sum(-1)
        is_inl = ((err * err).sum(-1) < thr2) & valid & pvalid
        use = valid & pvalid & (is_inl | (not skip_outliers))
        J = torch.stack([torch.func.jvp(werr_of, (pt,), (eye[i].expand_as(pt),))[1]
                         for i in range(3)], dim=-1)  # (P, T, 2, 3)
        w = _huber_weight((werr * werr).sum(-1), loss_radius) * use.to(pt.dtype)
        Jw = J * w[..., None, None]
        grad = (Jw * werr[..., None]).sum((1, 2))  # (P, 3)
        H = (Jw[..., :, :, None] * J[..., :, None, :]).sum((1, 2)) + eye * 1e-12
        pt = pt - torch.linalg.solve(H, grad[..., None])[..., 0]
    uv, pvalid = project(pt)
    is_inl = (((uv - obs_uv) ** 2).sum(-1) < thr2) & valid & pvalid
    return pt, is_inl


def triangulate_tracks(point_ids, cam_q, cam_t, intr, obs_uv, sqrt_h, valid,
                       camera_kind=cam_ops.KIND_FISHEYE624):
    """Batched triangulation. All tensors are (P, T, ...): P tracks padded to
    T observations, cam_q/cam_t = T_cam_world per observation, valid slots
    first. Returns (points (P, 3), ok (P,), inlier mask (P, T))."""
    device = cam_q.device
    pa, pb = ransac_pairs(point_ids.cpu().numpy(), valid.sum(1).cpu().numpy())
    qi = lie.quat_conj(cam_q)
    starts = -lie.quat_rotate(qi, cam_t)
    dirs = lie.quat_rotate(qi, cam_ops.unproject(camera_kind, intr, obs_uv))
    pt, ok = _ransac_candidates(starts, dirs, valid, torch.from_numpy(pa).to(device),
                                torch.from_numpy(pb).to(device))
    inl = valid
    for cfg in REFINE:
        pt, inl = _refine_pass(pt, cam_q, cam_t, intr, obs_uv, sqrt_h, valid, camera_kind, **cfg)
    ok = ok & (inl.to(torch.int64).sum(1) >= MIN_INLIERS_AFTER_REFINE)
    ok = ok & torch.isfinite(pt).all(-1)
    return pt, ok, inl
