"""Batched Lie-group operations: SO(3) (quaternion), SE(3), and the S2 sphere.

Port of `visual_inertial_bundle_adjustment_tpu/ops/lie.py`. All functions are
pure, dtype-polymorphic, and operate on arbitrary leading batch dimensions:
quaternions are `(..., 4)` in wxyz order, vectors `(..., 3)`, SE(3) elements
are `(q, t)` pairs, tangents are `(..., 6)` ordered [translation(3),
rotation(3)] (reference lib/small_thing/Variable.h:96-127 — left-multiplied
exp update, boxMinus(a, b) = log(a * b^-1)).

Small-angle branches use Taylor series selected by `torch.where` with safe
denominators, with no data-dependent Python branching, so every function
runs under `torch.func.vmap`/`jacfwd`/`jacrev`.
"""

from __future__ import annotations

import torch

# Threshold under which Taylor expansions replace trigonometric formulas.
_SMALL = 1e-6
_TINY = 1e-30  # added under sqrt so derivatives stay finite at exactly zero


def _safe(x, eps=1e-30):
    """Clamp |x| away from zero, preserving sign, to make unused branches finite."""
    return torch.where(x.abs() < eps, torch.full_like(x, eps), x)


def _safe_vecnorm(v, keepdim=False):
    return torch.sqrt((v * v).sum(-1, keepdim=keepdim) + _TINY)


def cross(a, b):
    """Broadcasting cross product over the last axis."""
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


# ---------------------------------------------------------------------------
# Quaternions / SO(3)
# ---------------------------------------------------------------------------


def quat_identity(batch_shape=(), dtype=torch.float64, device=None):
    q = torch.zeros(tuple(batch_shape) + (4,), dtype=dtype, device=device)
    q[..., 0] = 1.0
    return q


def quat_mul(a, b):
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_conj(q):
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_normalize(q):
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def quat_rotate(q, v):
    """Rotate vector(s) v by quaternion(s) q: R(q) @ v."""
    qv = q[..., 1:]
    w = q[..., :1]
    uv = cross(qv, v)
    uuv = cross(qv, uv)
    return v + 2.0 * (w * uv + uuv)


def quat_rotate_inv(q, v):
    return quat_rotate(quat_conj(q), v)


def so3_hat(w):
    """(..., 3) -> (..., 3, 3) skew-symmetric matrix."""
    zeros = torch.zeros_like(w[..., 0])
    wx, wy, wz = w.unbind(-1)
    return torch.stack(
        [
            torch.stack([zeros, -wz, wy], dim=-1),
            torch.stack([wz, zeros, -wx], dim=-1),
            torch.stack([-wy, wx, zeros], dim=-1),
        ],
        dim=-2,
    )


def so3_exp(w):
    """Axis-angle (..., 3) -> quaternion (..., 4)."""
    theta2 = (w * w).sum(-1, keepdim=True)
    small = theta2 < _SMALL * _SMALL
    # double-where: evaluate the exact branch at theta=1 when unused so both
    # AD modes see finite derivatives there
    t2s = torch.where(small, torch.ones_like(theta2), theta2)
    ts = torch.sqrt(t2s)
    half = 0.5 * ts
    sinc_half = torch.where(
        small, 0.5 - theta2 / 48.0 + theta2 * theta2 / 3840.0, torch.sin(half) / ts
    )
    cw = torch.where(small, 1.0 - theta2 / 8.0 + theta2 * theta2 / 384.0, torch.cos(half))
    return torch.cat([cw, sinc_half * w], dim=-1)


def so3_log(q):
    """Quaternion (..., 4) -> axis-angle (..., 3). Assumes normalized q."""
    w = q[..., :1]
    v = q[..., 1:]
    sign = torch.where(w < 0.0, -torch.ones_like(w), torch.ones_like(w))
    w = w * sign
    v = v * sign
    vnorm2 = (v * v).sum(-1, keepdim=True)
    small = vnorm2 < _SMALL * _SMALL
    vn2s = torch.where(small, torch.ones_like(vnorm2), vnorm2)
    vns = torch.sqrt(vn2s)
    angle = 2.0 * torch.atan2(vns, w)
    factor = torch.where(
        small,
        2.0 / _safe(w) - 2.0 * vnorm2 / (3.0 * _safe(w) ** 3),
        angle / vns,
    )
    return factor * v


def quat_to_matrix(q):
    """(..., 4) -> (..., 3, 3) rotation matrix."""
    w, x, y, z = q.unbind(-1)
    tx, ty, tz = 2.0 * x, 2.0 * y, 2.0 * z
    twx, twy, twz = tx * w, ty * w, tz * w
    txx, txy, txz = tx * x, ty * x, tz * x
    tyy, tyz, tzz = ty * y, tz * y, tz * z
    return torch.stack(
        [
            torch.stack([1.0 - (tyy + tzz), txy - twz, txz + twy], dim=-1),
            torch.stack([txy + twz, 1.0 - (txx + tzz), tyz - twx], dim=-1),
            torch.stack([txz - twy, tyz + twx, 1.0 - (txx + tyy)], dim=-1),
        ],
        dim=-2,
    )


def _eye_like(W):
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def so3_left_jacobian(w):
    """Left Jacobian J_l of SO(3) at axis-angle w: (..., 3, 3)."""
    theta2 = (w * w).sum(-1)
    small = theta2 < _SMALL * _SMALL
    t2s = torch.where(small, torch.ones_like(theta2), theta2)
    ts = torch.sqrt(t2s)
    c1 = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(ts)) / t2s)
    c2 = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (ts - torch.sin(ts)) / (t2s * ts))
    W = so3_hat(w)
    return _eye_like(W) + c1[..., None, None] * W + c2[..., None, None] * (W @ W)


def so3_left_jacobian_inverse(w):
    """Inverse left Jacobian J_l^{-1} of SO(3): (..., 3, 3)."""
    theta2 = (w * w).sum(-1)
    small = theta2 < _SMALL * _SMALL
    t2s = torch.where(small, torch.ones_like(theta2), theta2)
    ts = torch.sqrt(t2s)
    half = 0.5 * ts
    cot_term = torch.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 / t2s) - torch.cos(half) / (2.0 * ts * torch.sin(half)),
    )
    W = so3_hat(w)
    return _eye_like(W) - 0.5 * W + cot_term[..., None, None] * (W @ W)


# ---------------------------------------------------------------------------
# SE(3): pairs (q, t); tangent order [translation(3), rotation(3)]
# ---------------------------------------------------------------------------


def se3_mul(a, b):
    qa, ta = a
    qb, tb = b
    return quat_mul(qa, qb), ta + quat_rotate(qa, tb)


def se3_inverse(T):
    q, t = T
    qi = quat_conj(q)
    return qi, -quat_rotate(qi, t)


def se3_apply(T, p):
    q, t = T
    return quat_rotate(q, p) + t


def _mv3(M, x):
    """(..., 3, 3) @ (..., 3) as an elementwise contraction (same summation
    as the JAX package's `_mv3`)."""
    return (M * x[..., None, :]).sum(-1)


def se3_exp(xi):
    """Tangent (..., 6) [v, w] -> SE(3) via the full exponential: t = J_l(w) v."""
    v, w = xi[..., :3], xi[..., 3:]
    return so3_exp(w), _mv3(so3_left_jacobian(w), v)


def se3_log(T):
    """SE(3) -> tangent (..., 6) [v, w]."""
    q, t = T
    w = so3_log(q)
    v = _mv3(so3_left_jacobian_inverse(w), t)
    return torch.cat([v, w], dim=-1)


def se3_boxplus(T, xi):
    """Left-multiplicative retraction: exp(xi) * T (reference Variable.h:105)."""
    return se3_mul(se3_exp(xi), T)


def se3_boxminus(a, b):
    """log(a * b^-1) (reference Variable.h:115)."""
    return se3_log(se3_mul(a, se3_inverse(b)))


# ---------------------------------------------------------------------------
# S2: 3-vector of fixed norm with 2-dof tangent (gravity direction)
# Reference: lib/small_thing/Variable.h:164-221
# ---------------------------------------------------------------------------


def s2_ortho(v):
    """Local orthonormal tangent basis (..., 2, 3) at v (not necessarily unit)."""
    a = v.abs()
    pick0 = a[..., 0] < torch.minimum(a[..., 1], a[..., 2])
    pick1 = (~pick0) & (a[..., 1] < a[..., 2])
    pick2 = ~(pick0 | pick1)
    t1 = torch.stack([pick0, pick1, pick2], dim=-1).to(v.dtype)
    v2 = (v * v).sum(-1, keepdim=True)
    vn = torch.sqrt(v2)
    r0 = t1 - ((t1 * v).sum(-1, keepdim=True) / v2) * v
    r0 = r0 / torch.linalg.vector_norm(r0, dim=-1, keepdim=True)
    r1 = cross(r0, v) / vn
    return torch.stack([r0, r1], dim=-2)


def s2_boxplus(vec, radius, step):
    """Tangent-plane retraction with tan() scaling (reference Variable.h:190-198)."""
    angle = _safe_vecnorm(step) / radius
    factor = torch.where(
        angle > 1e-4, torch.tan(angle) / _safe(angle), 1.0 + angle * angle / 3.0
    )
    basis = s2_ortho(vec)  # (..., 2, 3)
    moved = vec + (basis * (factor[..., None] * step)[..., :, None]).sum(-2)
    return moved / torch.linalg.vector_norm(moved, dim=-1, keepdim=True) * radius


def s2_boxminus(vec, base, radius):
    """Inverse of s2_boxplus (reference Variable.h:201-208)."""
    dv = (vec / torch.linalg.vector_norm(vec, dim=-1, keepdim=True)
          - base / torch.linalg.vector_norm(base, dim=-1, keepdim=True))
    angle = 2.0 * torch.arcsin(torch.clamp(_safe_vecnorm(dv) * 0.5, 0.0, 1.0))
    factor = 1.0 / torch.cos(angle)
    return factor[..., None] * _mv3(s2_ortho(base), dv) * radius
