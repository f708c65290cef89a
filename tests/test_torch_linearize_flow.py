"""The data flow of the redesigned K1 and K11 kernels vs the JAX package (CPU).

The CUDA kernels (csrc/visual_body.cuh) compute, per observation: the pose
composition, the projection and the residual in float64 from the float32
inputs; the chain below A = sqrt_h d uv / d p_cam in float32 from float32
copies of q_E, q_T, p_rig and p_cam, with the rotations applied as
quaternions (R^T as the conjugate); and K11's intrinsics columns in float32
from the projection's own intermediates (camera.cuh ProjTerms,
intr_jac_col) instead of a second pass through the camera model. `_flow`
below writes that arithmetic out as torch ops, and the tests hold it against
the JAX package's own entries on the same inputs (the blocked batches
through factors.linearize_batch / residual_batch, whose fused hooks decline
on the CPU, evaluated in float64 on the float32-rounded inputs that the card
reads):

  * K1, Fisheye624 and pinhole, with the Jacobian and residual-only:
    res 1e-5, J 2e-4 relative to max-abs, valid exact;
  * K11, Fisheye624 and pinhole: res 1e-5, J 3e-4, valid exact;
  * the written-out intrinsics columns against jax.jacfwd of the JAX camera
    projection with respect to the parameters, at points on the optical
    axis, behind the camera, in the image plane and 1e-14 off the axis.

A pinhole batch is the same batch with `camera_kind` 0 and each camera's
parameters read as [f, f, cx, cy].
"""

import dataclasses
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_fixtures import (jax_active_cfgs, jax_gs, jax_problem, port_gs_from_jax,
                                  port_problem, rel)

from visual_inertial_bundle_adjustment_tpu.ops import camera as jcam
from visual_inertial_bundle_adjustment_tpu.problem import factors as jfct

MIN_Z = 1e-6
F32, F64 = torch.float32, torch.float64


def _blocked(p):
    (i,) = [i for i, c in enumerate(p.cfgs) if getattr(c, "block_info", None)]
    return i


# ---------------------------------------------------------------------------
# the kernels' arithmetic as torch ops
# ---------------------------------------------------------------------------


def _qrot(q, v):
    """camera.cuh qrot / qrot_f: v + 2 (w (q x v) + q x (q x v)), in v's type."""
    u = torch.cross(q[:, 1:], v, dim=-1)
    return v + 2.0 * (q[:, :1] * u + torch.cross(q[:, 1:], u, dim=-1))


def _conj(q):
    return torch.cat([q[:, :1], -q[:, 1:]], dim=-1)


def _project(kind, K, pc):
    """camera.cuh proj_fisheye624 / proj_pinhole on (N, 3) points: uv (N, 2)
    and the intermediates ProjTerms carries (a, b, rho2, th2, tr)."""
    x, y, z = pc.unbind(-1)
    z_safe = torch.where(z.abs() < MIN_Z, torch.full_like(z, MIN_Z), z)
    if kind != 1:
        a, b = x / z_safe, y / z_safe
        uv = torch.stack([K[:, 0] * a + K[:, 2], K[:, 1] * b + K[:, 3]], dim=-1)
        zero = torch.zeros_like(a)
        return uv, (a, b, zero, zero, zero)
    r = torch.sqrt(x * x + y * y + 1e-30)
    theta = torch.atan2(r, z)
    th2 = theta * theta
    m, acc = torch.ones_like(th2), torch.ones_like(th2)
    for i in range(6):
        acc = acc * th2
        m = m + K[:, 3 + i] * acc
    near = r < 1e-12
    r_safe = torch.where(near, torch.ones_like(r), r)
    scale = torch.where(near, 1.0 / z_safe, theta * m / r_safe)
    a, b = x * scale, y * scale
    rho2 = a * a + b * b
    p0, p1, s0, s1, s2, s3 = (K[:, c] for c in range(9, 15))
    tx = p0 * (rho2 + 2.0 * a * a) + 2.0 * p1 * a * b
    ty = p1 * (rho2 + 2.0 * b * b) + 2.0 * p0 * a * b
    u = K[:, 0] * (a + tx + s0 * rho2 + s1 * rho2 * rho2) + K[:, 1]
    v = K[:, 0] * (b + ty + s2 * rho2 + s3 * rho2 * rho2) + K[:, 2]
    tr = torch.where(near, torch.zeros_like(r), theta / r_safe)
    return torch.stack([u, v], dim=-1), (a, b, rho2, th2, tr)


def _intr_cols(kind, K, terms, x, y):
    """camera.cuh intr_jac_col for every column: d(u, v) / d(model params),
    (N, 2, 15), from the projection's intermediates."""
    a, b, rho2, th2, tr = terms
    du = torch.zeros(a.shape + (15,), dtype=a.dtype)
    dv = torch.zeros_like(du)
    if kind != 1:
        du[:, 0], dv[:, 1], du[:, 2], dv[:, 3] = a, b, 1.0, 1.0
        return torch.stack([du, dv], dim=1)
    f, p0, p1, s0, s1, s2, s3 = K[:, 0], K[:, 9], K[:, 10], K[:, 11], K[:, 12], K[:, 13], K[:, 14]
    du[:, 0] = a + p0 * (rho2 + 2 * a * a) + 2 * p1 * a * b + s0 * rho2 + s1 * rho2 * rho2
    dv[:, 0] = b + p1 * (rho2 + 2 * b * b) + 2 * p0 * a * b + s2 * rho2 + s3 * rho2 * rho2
    du[:, 1], dv[:, 2] = 1.0, 1.0
    ua = f * (1 + 6 * p0 * a + 2 * p1 * b + 2 * a * (s0 + 2 * s1 * rho2))
    ub = f * (2 * p0 * b + 2 * p1 * a + 2 * b * (s0 + 2 * s1 * rho2))
    va = f * (2 * p1 * a + 2 * p0 * b + 2 * a * (s2 + 2 * s3 * rho2))
    vb = f * (1 + 6 * p1 * b + 2 * p0 * a + 2 * b * (s2 + 2 * s3 * rho2))
    ds = tr
    for c in range(3, 9):  # k0..k5: (x, y) theta th2^(c-2) / r
        ds = ds * th2
        sx, sy = x * ds, y * ds
        du[:, c], dv[:, c] = ua * sx + ub * sy, va * sx + vb * sy
    du[:, 9], dv[:, 9] = f * (rho2 + 2 * a * a), f * 2 * a * b
    du[:, 10], dv[:, 10] = f * 2 * a * b, f * (rho2 + 2 * b * b)
    du[:, 11], du[:, 12] = f * rho2, f * rho2 * rho2
    dv[:, 13], dv[:, 14] = f * rho2, f * rho2 * rho2
    return torch.stack([du, dv], dim=1)


def _flow(kind, data, v, masks, with_jac, with_cal):
    """K1 (with_cal False) or K11 as the kernels compute it, on float32
    inputs, masks applied: res (2, N) and valid (N,) [, J_pt (2, 3, N),
    J_r (2, 12, N) [, J_cal (2, 23, N)]], float32."""
    g = {k: x for k, x in data.items() if isinstance(x, torch.Tensor)}
    rig, point = g["rig"].long(), g["point"].long()
    ci, ce, cb = g["intr"].long(), g["extr"].long(), g["bias"].long()
    Tq, Tt, P = v.pose_q[rig], v.pose_t[rig], v.points[point]
    Eq, Et, K = v.cam_extr_q[ce], v.cam_extr_t[ce], v.cam_intr[ci]
    # float64 primal chain and residual from the float32 inputs
    pr = _qrot(Tq.double(), P.double()) + Tt.double()
    pc = _qrot(Eq.double(), pr) + Et.double()
    K64 = K.double()
    uv, terms = _project(kind, K64, pc)
    h = g["sqrt_h"].double()
    err = uv - g["obs_uv"].double() + g["bias_on"].double()[:, None] * v.det_bias[cb].double()
    res = (h * err[:, None, :]).sum(-1).T.to(F32)
    valid = torch.maximum((pc[:, 2] >= MIN_Z).to(F32), g["_pad"])
    if not with_jac:
        return res, valid
    # A = sqrt_h d uv / d p_cam: three forward tangents in float64, then float32
    eye = torch.eye(3, dtype=F64)
    D = torch.stack([torch.func.jvp(lambda p: _project(kind, K64, p)[0], (pc,),
                                    (eye[c].expand_as(pc),))[1] for c in range(3)], dim=-1)
    A = (h[:, :, :, None] * D[:, None, :, :]).sum(2).to(F32)  # (N, 2, 3)
    # the float32 chain below A, rotations as quaternions
    qE, qT = _conj(Eq.double()).to(F32), _conj(Tq.double()).to(F32)
    prf, pcf = pr.to(F32), pc.to(F32)
    pm, rm = masks.points[point], masks.rig[rig]
    J_pt, J_r, J_e = [], [], []
    for row in range(2):
        Ar = _qrot(qE, A[:, row])
        J_pt.append(_qrot(qT, Ar) * pm)
        J6 = torch.cat([Ar, torch.cross(prf, Ar, dim=-1)], dim=-1) * rm[:, :6]
        J_r.append(torch.cat([J6, torch.zeros_like(J6)], dim=-1))
        J_e.append(torch.cat([A[:, row], torch.cross(pcf, A[:, row], dim=-1)], dim=-1))
    out = (res, valid, torch.stack(J_pt).permute(0, 2, 1), torch.stack(J_r).permute(0, 2, 1))
    if not with_cal:
        return out
    em, im = masks.cam_extr[ce], masks.cam_intr[ci]
    terms32 = tuple(t.to(F32) for t in terms)
    dK = _intr_cols(kind, K, terms32, pcf[:, 0], pcf[:, 1])  # (N, 2, 15), float32
    hf = g["sqrt_h"]
    J_i = (hf[:, :, :, None] * dK[:, None, :, :]).sum(2) * im[:, None, :15]  # (N, 2, 15)
    J_cal = torch.cat([torch.stack(J_e, dim=1) * em[:, None, :], J_i,
                       torch.zeros_like(J_i[:, :, :2])], dim=-1)
    return out + (J_cal.permute(1, 2, 0),)


# ---------------------------------------------------------------------------
# the same inputs on both sides
# ---------------------------------------------------------------------------


def _round_f32(x):
    """Floating arrays rounded to float32 and back (the values the card reads)."""
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a).astype(np.float32).astype(np.float64)
        if np.issubdtype(np.asarray(a).dtype, np.floating) else a, x)


def _pinhole(intr):
    """Each camera's parameters read as pinhole [f, f, cx, cy]."""
    out = np.array(intr)
    out[:, 1:4] = np.array(intr)[:, 0:3]
    return out


def _inputs(pj, p, kind):
    """(JAX cfg, data, variables, masks) and the port's float32 (data,
    variables, masks) of the blocked batch, equal value for value."""
    i = _blocked(pj)
    cfg = dataclasses.replace(jax_active_cfgs(pj)[i], camera_kind=kind)
    vj = _round_f32(pj.variables)
    if kind == 0:
        vj = vj._replace(cam_intr=_pinhole(vj.cam_intr))
    dj = _round_f32({k: a for k, a in pj.datas[i].items()})
    mj = pj.masks
    vt = p.variables._replace(**{f: getattr(p.variables, f).to(F32)
                                 for f in ("pose_q", "pose_t", "points", "cam_intr",
                                           "cam_extr_q", "cam_extr_t", "det_bias")})
    if kind == 0:
        vt = vt._replace(cam_intr=torch.from_numpy(_pinhole(vt.cam_intr.numpy())))
    dt = {k: (a.to(F32) if isinstance(a, torch.Tensor) and a.is_floating_point() else a)
          for k, a in p.datas[i].items()}
    mt = type(p.masks)(*(a.to(F32) for a in p.masks))
    to_j = lambda tree: jax.tree_util.tree_map(jnp.asarray, tree)  # noqa: E731
    return cfg, to_j(dj), to_j(vj), mj, dt, vt, mt


def _check(got, want, real, tol):
    got, want = got.double().numpy(), np.asarray(want)
    assert np.abs(want).max() > 0
    assert rel(got[..., real], want[..., real]) < tol


# ---------------------------------------------------------------------------
# K1, K11
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_jac", [True, False])
@pytest.mark.parametrize("kind", [0, 1])
def test_k1_flow_matches_jax(kind, with_jac):
    pj, p = jax_problem(), port_problem()
    cfg, dj, vj, mj, dt, vt, mt = _inputs(pj, p, kind)
    real = dt["_pad"].numpy() < 0.5
    out = _flow(kind, dt, vt, mt, with_jac, False)
    assert all(o.dtype == F32 for o in out)
    if not with_jac:
        res_j, valid_j = jax.jit(lambda d, v: jfct.residual_batch(cfg, d, v))(dj, vj)
        _check(out[0], np.asarray(res_j).T, real, 1e-5)
        np.testing.assert_array_equal(out[1].numpy(), np.asarray(valid_j))
        return
    lin = jax.jit(lambda d, v, m: jfct.linearize_batch(cfg, d, v, m))(dj, vj, mj)
    assert lin.groups == (jfct.POINTS, jfct.RIG)
    _check(out[0], lin.res, real, 1e-5)
    np.testing.assert_array_equal(out[1].numpy(), np.asarray(lin.valid))
    for got, want in zip(out[2:], lin.jac):
        _check(got, want, real, 2e-4)
    assert float(out[3][:, 6:].abs().max()) == 0.0


@pytest.mark.parametrize("kind", [0, 1])
def test_k11_flow_matches_jax(kind):
    pj, p = jax_gs()[0], port_gs_from_jax()
    cfg, dj, vj, mj, dt, vt, mt = _inputs(pj, p, kind)
    assert cfg.active_groups == ("points", "rig", "cam_extr", "cam_intr")
    real = dt["_pad"].numpy() < 0.5
    res, valid, J_pt, J_r, J_cal = _flow(kind, dt, vt, mt, True, True)
    lin = jax.jit(lambda d, v, m: jfct.linearize_batch(cfg, d, v, m))(dj, vj, mj)
    _check(res, lin.res, real, 1e-5)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(lin.valid))
    for got, want in ((J_pt, lin.jac[0]), (J_r, lin.jac[1]), (J_cal[:, :6], lin.jac[2]),
                      (J_cal[:, 6:], lin.jac[3])):
        _check(got, want, real, 3e-4)
    assert float(J_cal[:, 21:].abs().max()) == 0.0


# ---------------------------------------------------------------------------
# the intrinsics columns at the guarded corners
# ---------------------------------------------------------------------------


def _edge_points(rng):
    p = rng.normal(size=(40, 3)) * [1.0, 1.0, 0.5] + [0.0, 0.0, 2.0]
    p[0] = [0.0, 0.0, 3.0]  # on the optical axis
    p[1] = [0.3, -0.2, -1.0]  # behind the camera
    p[2] = [0.1, 0.1, 0.0]  # in the image plane
    p[3] = [1e-14, 0.0, 1.0]
    return p


@pytest.mark.parametrize("kind", [0, 1])
def test_intrinsics_columns_match_jacfwd(kind):
    """The written-out intrinsics columns from the projection's
    intermediates (float64 here, to hold the algebra) against jax.jacfwd of
    the JAX projection with respect to the 17 parameters; the readout and
    time-offset columns are zero there."""
    golden = json.loads((pathlib.Path(__file__).parent / "data/fisheye624_golden.json")
                        .read_text())
    params = np.asarray(golden[1]["params"], np.float64)
    if kind == 0:
        params = np.asarray([450.0, 460.0, 320.0, 240.0])
    padded = np.asarray(jcam.pad_params(jnp.asarray(params), readout=0.016, time_offset=1e-3))
    pts = _edge_points(np.random.default_rng(11))
    Ks = np.broadcast_to(padded, (pts.shape[0], padded.shape[0]))
    want = np.asarray(jax.vmap(jax.jacfwd(lambda k, x: jcam.project(kind, k, x)[0]))(
        jnp.asarray(Ks), jnp.asarray(pts)))  # (N, 2, 17)
    K = torch.from_numpy(np.ascontiguousarray(Ks))
    pc = torch.from_numpy(pts)
    uv, terms = _project(kind, K, pc)
    got = _intr_cols(kind, K, terms, pc[:, 0], pc[:, 1]).numpy()
    assert rel(uv.numpy(), np.asarray(jax.vmap(lambda k, x: jcam.project(kind, k, x)[0])(
        jnp.asarray(Ks), jnp.asarray(pts)))) < 1e-12
    assert np.abs(want[..., 15:]).max() == 0.0
    assert rel(got, want[..., :15]) < 1e-10
    if kind == 1:  # the optical-axis guard: no k0..k5 derivative at r < 1e-12
        assert np.all(got[[0, 3], :, 3:9] == 0.0)
