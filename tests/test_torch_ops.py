"""PyTorch port vs the JAX package: Lie groups, losses, cameras, IMU model,
motion integrals (float64 on the CPU, tolerance 1e-10 relative to the
reference's max-abs). Inputs are made with numpy from a seed and include the
guarded corners: zero and tiny rotation angles, angles near pi, points on the
optical axis and behind the camera, residuals at every loss breakpoint."""

import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_fixtures import rel, t

from visual_inertial_bundle_adjustment_tpu.models import imu as jimu
from visual_inertial_bundle_adjustment_tpu.ops import camera as jcam
from visual_inertial_bundle_adjustment_tpu.ops import lie as jlie
from visual_inertial_bundle_adjustment_tpu.ops import losses as jlosses
from visual_inertial_bundle_adjustment_tpu.ops import motion as jmotion
from visual_inertial_bundle_adjustment_tpu_torch.models import imu as timu
from visual_inertial_bundle_adjustment_tpu_torch.ops import camera as tcam
from visual_inertial_bundle_adjustment_tpu_torch.ops import lie as tlie
from visual_inertial_bundle_adjustment_tpu_torch.ops import losses as tlosses
from visual_inertial_bundle_adjustment_tpu_torch.ops import motion as tmotion

TOL = 1e-10


def _to(x, conv):
    if isinstance(x, np.ndarray):
        return conv(x)
    if isinstance(x, (tuple, list)):
        return tuple(_to(a, conv) for a in x)
    return x


def _leaves(out):
    if isinstance(out, (tuple, list)):
        return [leaf for o in out for leaf in _leaves(o)]
    return [np.asarray(out.numpy() if isinstance(out, torch.Tensor) else out)]


def assert_same(jax_fn, port_fn, *args, tol=TOL):
    """jax_fn and port_fn on the same numpy args agree leaf by leaf."""
    out_j = _leaves(jax_fn(*_to(args, lambda a: jnp.asarray(a))))
    out_t = _leaves(port_fn(*_to(args, t)))
    assert len(out_j) == len(out_t)
    for a, b in zip(out_t, out_j):
        assert a.shape == b.shape
        if b.dtype == bool:
            np.testing.assert_array_equal(a, b)
        else:
            assert rel(a, b) < tol


def _rotvecs(rng, n=16):
    """Rotation vectors: generic, tiny, zero, near pi."""
    w = rng.normal(size=(n, 3)) * 0.8
    w[10:13] *= 1e-7
    w[13] = 0.0
    u = rng.normal(size=3)
    w[14] = u / np.linalg.norm(u) * (np.pi - 1e-6)
    w[15] = u / np.linalg.norm(u) * 3.0
    return w


def _quats(rng, n=16):
    q = np.array(jlie.so3_exp(jnp.asarray(_rotvecs(rng, n))))
    q[::3] *= -1.0  # both hemispheres
    return q


LIE_NAMES = ("quat_mul", "quat_conj", "quat_normalize", "quat_rotate", "quat_rotate_inv",
             "so3_hat", "so3_exp", "so3_log", "quat_to_matrix", "so3_left_jacobian",
             "so3_left_jacobian_inverse", "se3_mul", "se3_inverse", "se3_apply", "se3_exp",
             "se3_log", "se3_boxplus", "se3_boxminus", "s2_ortho", "s2_boxplus")
IMU_NAMES = ("gyro_nonorth_matrix", "accel_nonorth_matrix", "calib_boxplus", "calib_boxminus",
             "compensate", "compensate_with_jac")


def _lie_cases():
    rng = np.random.default_rng(7)
    q1, q2 = _quats(rng), _quats(rng)
    v = rng.normal(size=(16, 3)) * 5.0
    w = _rotvecs(rng)
    t1, t2 = rng.normal(size=(16, 3)), rng.normal(size=(16, 3))
    xi = np.concatenate([rng.normal(size=(16, 3)), _rotvecs(rng)], -1)
    s2 = rng.normal(size=(16, 3))
    s2[0] = [0.0, 0.0, -9.81]
    s2[1] = [1.0, 0.0, 0.0]
    step = rng.normal(size=(16, 2)) * 0.3
    step[2] *= 1e-9
    return {
        "quat_mul": (q1, q2),
        "quat_conj": (q1,),
        "quat_normalize": (q1 * 3.7,),
        "quat_rotate": (q1, v),
        "quat_rotate_inv": (q1, v),
        "so3_hat": (w,),
        "so3_exp": (w,),
        "so3_log": (q1,),
        "quat_to_matrix": (q1,),
        "so3_left_jacobian": (w,),
        "so3_left_jacobian_inverse": (w,),
        "se3_mul": ((q1, t1), (q2, t2)),
        "se3_inverse": ((q1, t1),),
        "se3_apply": ((q1, t1), v),
        "se3_exp": (xi,),
        "se3_log": ((q1, t1),),
        "se3_boxplus": ((q1, t1), xi),
        "se3_boxminus": ((q1, t1), (q2, t2)),
        "s2_ortho": (s2,),
        "s2_boxplus": (s2, 9.81, step),
    }


@pytest.mark.parametrize("name", LIE_NAMES)
def test_lie_matches_jax(name):
    assert_same(getattr(jlie, name), getattr(tlie, name), *_lie_cases()[name])


def test_lie_cross_matches_numpy():
    rng = np.random.default_rng(8)
    a, b = rng.normal(size=(32, 3)), rng.normal(size=(32, 3))
    assert rel(tlie.cross(t(a), t(b)).numpy(), np.cross(a, b)) < TOL


@pytest.mark.parametrize("kind", [tlosses.TRIVIAL, tlosses.L1, tlosses.HUBER,
                                  tlosses.HUBER_CUTOFF, tlosses.CAUCHY])
def test_loss_jet2_matches_jax(kind):
    a, k = 1.0, 3.0
    s = np.concatenate([[0.0, 1e-12, 0.5, a * a, 2.0, k * k, 9.5, 1e4],
                        np.random.default_rng(kind).random(24) * 20.0])
    assert_same(lambda s: jlosses.loss_jet2(kind, a, k, s),
                lambda s: tlosses.loss_jet2(kind, a, k, s), s)


def _golden():
    return json.loads((pathlib.Path(__file__).parent / "data/fisheye624_golden.json").read_text())


@pytest.mark.parametrize("case", range(3))
def test_fisheye624_golden_and_jax(case):
    """The golden pairs (an independent 50-digit re-derivation of the model)
    to 1e-6 px, and the JAX package's projection to 1e-10."""
    c = _golden()[case]
    params = np.asarray(c["params"], np.float64)
    pts = np.asarray([p["point"] for p in c["pairs"]], np.float64)
    uv, valid = tcam.project(tcam.KIND_FISHEYE624, t(params), t(pts))
    assert bool(valid.all())
    err = np.linalg.norm(uv.numpy() - np.asarray([p["uv"] for p in c["pairs"]]), axis=-1)
    assert err.max() < 1e-6
    assert_same(lambda p, x: jcam.project(jcam.KIND_FISHEYE624, p, x),
                lambda p, x: tcam.project(tcam.KIND_FISHEYE624, p, x), params, pts)


def _points(rng):
    p = rng.normal(size=(40, 3)) * [1.0, 1.0, 0.5] + [0.0, 0.0, 2.0]
    p[0] = [0.0, 0.0, 3.0]  # on the optical axis
    p[1] = [0.3, -0.2, -1.0]  # behind the camera
    p[2] = [0.1, 0.1, 0.0]  # in the image plane
    p[3] = [1e-14, 0.0, 1.0]
    return p


@pytest.mark.parametrize("kind", [tcam.KIND_LINEAR, tcam.KIND_FISHEYE624])
def test_camera_project_matches_jax(kind):
    rng = np.random.default_rng(11)
    params = np.asarray(_golden()[1]["params"], np.float64)
    if kind == tcam.KIND_LINEAR:
        params = np.asarray([450.0, 460.0, 320.0, 240.0])
    padded = np.asarray(jcam.pad_params(jnp.asarray(params), readout=0.016, time_offset=1e-3))
    np.testing.assert_array_equal(
        tcam.pad_params(t(params), readout=0.016, time_offset=1e-3).numpy(), padded)
    assert_same(lambda p, x: jcam.project(kind, p, x), lambda p, x: tcam.project(kind, p, x),
                padded, _points(rng))


def _calib(rng, n=8):
    c = np.tile(np.array(jimu.identity_calib(jnp.float64)), (n, 1))
    c[:, jimu.GYRO_BIAS] += rng.normal(size=(n, 3)) * 1e-3
    c[:, jimu.ACCEL_BIAS] += rng.normal(size=(n, 3)) * 1e-2
    c[:, jimu.GYRO_SCALE] += rng.normal(size=(n, 3)) * 1e-3
    c[:, jimu.ACCEL_SCALE] += rng.normal(size=(n, 3)) * 1e-3
    c[:, jimu.GYRO_NONORTH] = rng.normal(size=(n, 6)) * 1e-3
    c[:, jimu.ACCEL_NONORTH] = rng.normal(size=(n, 3)) * 1e-3
    c[:, 21:] = rng.normal(size=(n, 2)) * 1e-3
    return c


def _imu_cases():
    rng = np.random.default_rng(13)
    c, base = _calib(rng), _calib(rng)
    step = rng.normal(size=(8, 23)) * 1e-3
    gyro, accel = rng.normal(size=(8, 3)), rng.normal(size=(8, 3)) * 9.0
    return {
        "gyro_nonorth_matrix": (c,),
        "accel_nonorth_matrix": (c,),
        "calib_boxplus": (c, step),
        "calib_boxminus": (c, base),
        "compensate": (c, gyro, accel),
        "compensate_with_jac": (c, gyro, accel),
    }


@pytest.mark.parametrize("name", IMU_NAMES)
def test_imu_model_matches_jax(name):
    assert_same(getattr(jimu, name), getattr(timu, name), *_imu_cases()[name])


def test_imu_constants_match_jax():
    np.testing.assert_array_equal(timu.identity_calib().numpy(),
                                  np.asarray(jimu.identity_calib(jnp.float64)))
    for opts in ({}, dict(accelBias=False), dict(gyroScale=True, accelNonorth=True),
                 dict(refImuTimeOffset=True, gyroAccelTimeOffset=True)):
        np.testing.assert_array_equal(timu.options_mask(**opts), jimu.options_mask(**opts))
    jn, tn = jimu.default_noise_model(jnp.float64), timu.default_noise_model()
    for f in tn._fields:
        assert rel(getattr(tn, f).numpy(), np.asarray(getattr(jn, f))) < TOL


@pytest.mark.parametrize("with_jac", [False, True])
def test_rvp_integrate_matches_jax(with_jac):
    rng = np.random.default_rng(17)
    gyro, accel = rng.normal(size=(12, 3)), rng.normal(size=(12, 3)) * 9.0
    gyro[0] = 0.0
    gyro[1] *= 1e-8
    dt = rng.random(12) * 0.01
    assert_same(lambda g, a, d: jmotion.rvp_integrate(g, a, d, with_jac),
                lambda g, a, d: tmotion.rvp_integrate(g, a, d, with_jac), gyro, accel, dt)
