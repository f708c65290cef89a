"""The port's full-sensor pipeline vs the JAX package, up to the blocked problem.

Held here in float64 on the CPU, on the tiny full-sensor session of
tests/_torch_port_fixtures.py (8 s, 80 landmarks, two IMUs, a rolling-shutter
camera with readout and time offset estimated):

  - camera unprojection, the RotVelPos interpolation helpers, RVP-only
    integration, the per-label IMU noise model            1e-10
  - RS tables, the segment lookup and rs_estimate         1e-9
  - write_session_dir: the same files, byte for byte; load_session: the
    same arrays
  - the adapter's variables, masks, cfgs and batch datas  1e-9 (landmarks 1e-6,
    see below); the same inlier observations
  - finalize_blocks: the same slot order, tile plan and calibration-window
    plan; the port's window-row lists cover every real slot once

Triangulation draws its RANSAC ray pairs from a numpy Generator where the
JAX package uses jax.random, so the candidates differ; two robust
Gauss-Newton passes then bring both to the same minimum within 1e-6 of the
landmarks' max-abs, and the inlier flags agree exactly.
"""

import dataclasses
import filecmp
import functools
import pathlib
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_fixtures import (FULL_SESSION, FULL_WRITE, full_session_dir, jax_full,
                                  port_full_built, rel, t)

from visual_inertial_bundle_adjustment_tpu.models import imu as jimu
from visual_inertial_bundle_adjustment_tpu.ops import camera as jcam
from visual_inertial_bundle_adjustment_tpu.ops import motion as jmotion
from visual_inertial_bundle_adjustment_tpu.ops import preintegration as jpre
from visual_inertial_bundle_adjustment_tpu.ops import rolling_shutter as jrs
from visual_inertial_bundle_adjustment_tpu.pipeline import session_data as jsd
from visual_inertial_bundle_adjustment_tpu.pipeline.synthetic import SyntheticSession as JSession
from visual_inertial_bundle_adjustment_tpu.pipeline.synthetic_io import (
    write_session_dir as jwrite)
from visual_inertial_bundle_adjustment_tpu_torch.models import imu as timu
from visual_inertial_bundle_adjustment_tpu_torch.ops import camera as tcam
from visual_inertial_bundle_adjustment_tpu_torch.ops import motion as tmotion
from visual_inertial_bundle_adjustment_tpu_torch.ops import preintegration as tpre
from visual_inertial_bundle_adjustment_tpu_torch.ops import rolling_shutter as trs
from visual_inertial_bundle_adjustment_tpu_torch.ops import segments as tseg
from visual_inertial_bundle_adjustment_tpu_torch.pipeline import builder as tbuilder
from visual_inertial_bundle_adjustment_tpu_torch.pipeline import session_data as tsd
from visual_inertial_bundle_adjustment_tpu_torch.pipeline.adapter import (AdapterOptions,
                                                                          SessionAdapter)
from visual_inertial_bundle_adjustment_tpu_torch.problem import rcs as trcs

TOL = 1e-9


def _fin(a):
    """+inf pads (RS dt) compared as zeros, after checking they coincide."""
    a = np.asarray(a, np.float64)
    return np.where(np.isfinite(a), a, 0.0)


def close(a, b, tol=TOL):
    """max |a - b| within tol of max(max |b|, 1): the RS interpolants of
    nearly constant signals are rounding noise around zero."""
    a, b = _fin(a), _fin(b)
    return float(np.abs(a - b).max()) <= tol * max(float(np.abs(b).max()), 1.0)


# ---------------------------------------------------------------------------
# ops: camera, motion, integration, noise model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", [jcam.KIND_FISHEYE624, jcam.KIND_LINEAR])
def test_unproject_matches_jax(kind):
    rng = np.random.default_rng(3)
    if kind == jcam.KIND_FISHEYE624:
        params = np.array([241.0, 320.0, 240.0, 0.35, -0.12, 0.04, -0.01, 0.002, -0.0004,
                           0.0004, -0.0002, 0.0012, -0.0008, 0.0006, -0.0003])
    else:
        params = np.array([300.0, 310.0, 320.0, 240.0])
    uv = rng.uniform([20, 20], [620, 460], size=(64, 2))
    ray_j = jcam.unproject(kind, jnp.asarray(params), jnp.asarray(uv))
    ray_t = tcam.unproject(kind, t(params), t(uv))
    assert rel(ray_t.numpy(), ray_j) < 1e-10


def _rvps(rng, n):
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return (q, rng.normal(size=(n, 3)), rng.normal(size=(n, 3)), rng.uniform(0.01, 0.1, n))


def test_motion_interpolation_helpers_match_jax():
    rng = np.random.default_rng(5)
    a, b = _rvps(rng, 16), _rvps(rng, 16)
    ja, jb = jmotion.RotVelPos(*map(jnp.asarray, a)), jmotion.RotVelPos(*map(jnp.asarray, b))
    ta, tb = tmotion.RotVelPos(*map(t, a)), tmotion.RotVelPos(*map(t, b))
    for fj, ft in ((jmotion.rvp_combine, tmotion.rvp_combine),
                   (jmotion.rvp_uncombine_left, tmotion.rvp_uncombine_left)):
        for x, y in zip(ft(ta, tb), fj(ja, jb)):
            assert rel(x.numpy(), y) < 1e-10
    small = list(a)
    small[0] = np.tile([1.0, 0.0, 0.0, 0.0], (16, 1))
    small[0][1] = [np.cos(1e-5), np.sin(1e-5), 0.0, 0.0]  # Taylor branch
    for rv in (a, small):
        ij = jmotion.rvp_differentiate(jmotion.RotVelPos(*map(jnp.asarray, rv)))
        it = tmotion.rvp_differentiate(tmotion.RotVelPos(*map(t, rv)))
        for x, y in zip(it, ij):
            assert rel(x.numpy(), y) < 1e-10
        dt = rng.uniform(-0.02, 0.02, 16)
        for x, y in zip(tmotion.rvp_integrate_interp(it, t(dt)),
                        jmotion.rvp_integrate_interp(ij, jnp.asarray(dt))):
            assert rel(x.numpy(), y) < 1e-10


def _intervals(rng, R, S, rate=200.0):
    gt = np.stack([np.arange(S) / rate - 0.01 + rng.random() * 0.004 for _ in range(R)])
    gv = rng.normal(size=(R, S, 3)) * 0.5
    av = rng.normal(size=(R, S, 3)) * 2 + np.array([0, 0, 9.8])
    return gt, gv, gt.copy(), av, np.full(R, 0.05)


def test_integrate_measurements_matches_jax():
    rng = np.random.default_rng(7)
    calib = np.tile(np.asarray(jimu.identity_calib(jnp.float64)), (4, 1))
    calib[:, 0:3] += 0.01
    calib[:, 21:23] = [0.001, -0.002]
    iv = _intervals(rng, 4, 30)
    num_steps = 2 * 30 + 4
    out_t = tpre.integrate_measurements(t(calib), tpre.PreintInterval(*map(t, iv)), num_steps)
    for i in range(4):
        out_j = jpre.integrate_measurements(jnp.asarray(calib[i]), jpre.PreintInterval(
            *(jnp.asarray(a[i]) for a in iv)), num_steps)
        for x, y in zip(out_t[0], out_j[0]):
            assert rel(x[i].numpy(), y) < 1e-10
        for x, y in zip(out_t[1], out_j[1]):
            assert rel(x[i].numpy(), y) < 1e-10
        for x, y in zip(out_t[2:], out_j[2:]):
            np.testing.assert_array_equal(x[i].numpy(), np.asarray(y))


@pytest.mark.parametrize("label", ["imu-left", "imu-right", "other"])
def test_noise_model_for_label_matches_jax(label):
    mj, mt = jimu.noise_model_for_label(label, jnp.float64), timu.noise_model_for_label(label)
    for f in mt._fields:
        assert rel(getattr(mt, f).numpy(), getattr(mj, f)) < 1e-15


# ---------------------------------------------------------------------------
# rolling-shutter tables
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _rs_tables():
    rng = np.random.default_rng(11)
    R, S = 5, 40
    calib = np.tile(np.asarray(jimu.identity_calib(jnp.float64)), (R, 1))
    calib[:, 0:3] += 0.01
    first, second = _intervals(rng, R, S), _intervals(rng, R, S)
    grav = np.array([0.0, 0.0, -9.81])
    num_steps = 2 * S + 4
    tj = jrs.build_rs_tables(jnp.asarray(calib), jpre.PreintInterval(*map(jnp.asarray, first)),
                             jpre.PreintInterval(*map(jnp.asarray, second)), jnp.asarray(grav),
                             num_steps, num_steps + 2)
    tt = trs.build_rs_tables(t(calib), tpre.PreintInterval(*map(t, first)),
                             tpre.PreintInterval(*map(t, second)), t(grav), num_steps,
                             num_steps + 2)
    return tj, tt


def test_rs_tables_match_jax():
    tj, tt = _rs_tables()
    for f in tt._fields:
        a, b = getattr(tt, f).numpy(), np.asarray(getattr(tj, f))
        np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b))
        assert close(a, b), f


def test_rs_segment_lookup_and_estimate_match_jax():
    tj, tt = _rs_tables()
    rng = np.random.default_rng(13)
    rows = rng.integers(0, 5, 300)
    td = rng.uniform(-0.07, 0.07, 300)
    td[:5] = np.asarray(tj.dt)[rows[:5], 3]  # exactly on sample times
    sj = jrs.rs_segment_lookup(tj, jnp.asarray(rows), jnp.asarray(td))
    st = trs.rs_segment_lookup(tt, torch.from_numpy(rows), t(td))
    assert 0 < int(st["seg_valid"].sum()) < 300
    for k in sj:
        assert close(st[k].numpy(), np.asarray(sj[k])), k
    vel, pq = rng.normal(size=3), rng.normal(size=4)
    pq /= np.linalg.norm(pq)
    r = 2
    ej = [jrs.rs_estimate(*(getattr(tj, f)[r] for f in tj._fields[:8]), tj.gravity_w,
                          jnp.asarray(x), jnp.asarray(vel), jnp.asarray(pq)) for x in td[:20]]
    et = trs.rs_estimate(*(getattr(tt, f)[r] for f in tt._fields[:8]), tt.gravity_w, t(td[:20]),
                         t(vel).expand(20, 3), t(pq).expand(20, 4))
    for i, e in enumerate(ej):
        assert close(et.q_mid_t[i].numpy(), e.q_mid_t)
        assert close(et.p_mid_t[i].numpy(), e.p_mid_t)
        assert bool(et.valid[i]) == bool(e.valid)


# ---------------------------------------------------------------------------
# session files and the adapter
# ---------------------------------------------------------------------------


def test_write_session_dir_matches_jax_byte_for_byte():
    path = pathlib.Path(tempfile.mkdtemp(prefix="viba_full_jax_"))
    jwrite(JSession(**FULL_SESSION), path, **FULL_WRITE)
    names = sorted(p.name for p in path.iterdir())
    assert names == sorted(p.name for p in full_session_dir().iterdir())
    for name in names:
        assert filecmp.cmp(path / name, full_session_dir() / name, shallow=False), name


def test_load_session_matches_jax():
    sj, st = jsd.load_session(full_session_dir()), tsd.load_session(full_session_dir())
    for f in dataclasses.fields(sj):
        a, b = getattr(sj, f.name), getattr(st, f.name)
        if f.name in ("factory", "online"):
            continue
        if isinstance(a, list) and a and isinstance(a[0], np.ndarray):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        elif isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b, f.name
    assert len(sj.online) == len(st.online)
    for cj, ct in zip([sj.factory] + sj.online[:3], [st.factory] + st.online[:3]):
        assert cj.timestamp_us == ct.timestamp_us
        for x, y in zip(cj.cameras + cj.imus, ct.cameras + ct.imus):
            for f in dataclasses.fields(x):
                np.testing.assert_array_equal(np.asarray(getattr(x, f.name)),
                                              np.asarray(getattr(y, f.name)))


@functools.lru_cache(maxsize=None)
def _unblocked():
    return port_full_built(blocked=False)


def test_adapter_builds_the_jax_problem():
    """Variables, masks, cfgs and every batch's data of the port's adapter
    equal the JAX package's (before blocking; the JAX problem is blocked
    after, so its unblocked batches and the variables are compared)."""
    pj, aj = jax_full()
    pt, at = _unblocked()
    assert (at.R, at.num_windows, at.num_cams, at.num_imus) == (aj.R, aj.num_windows,
                                                               aj.num_cams, aj.num_imus)
    np.testing.assert_array_equal(at.rig_window, aj.rig_window)
    for f in pt.variables._fields:
        tol = 1e-6 if f == "points" else TOL
        assert rel(getattr(pt.variables, f).numpy(), getattr(pj.variables, f)) < tol, f
    for f in pt.masks._fields:
        np.testing.assert_array_equal(getattr(pt.masks, f).numpy(), np.asarray(getattr(pj.masks, f)))
    assert [c.kind for c in pt.cfgs] == [c.kind for c in pj.cfgs]
    for ct, cj, dt, dj in zip(pt.cfgs, pj.cfgs, pt.datas, pj.datas):
        assert (ct.label, tuple(ct.loss), ct.camera_kind) == (cj.label, tuple(cj.loss),
                                                              cj.camera_kind)
        if cj.block_info is not None:
            continue  # the blocked batch: test_finalize_blocks_matches_jax
        for k, a in dj.items():
            if not k.startswith("_"):
                assert rel(dt[k].numpy().astype(np.float64), np.asarray(a, np.float64)) < TOL, k


def test_rs_tables_of_the_adapter_match_jax():
    pj, _ = jax_full()
    pt, _ = _unblocked()
    tj = next(d["rs_tables"] for c, d in zip(pj.cfgs, pj.datas) if c.kind == "rs_visual")
    tt = next(d["rs_tables"] for c, d in zip(pt.cfgs, pt.datas) if c.kind == "rs_visual")
    for f in tt._fields:
        assert close(getattr(tt, f).numpy(), getattr(tj, f)), f


def test_triangulation_matches_jax():
    """The same observations survive triangulation (inlier flags equal) and
    the landmarks agree within 1e-6 of their max-abs."""
    pj, _ = jax_full()
    pt, _ = _unblocked()
    assert rel(pt.variables.points.numpy(), pj.variables.points) < 1e-6
    dj = next(d for c, d in zip(pj.cfgs, pj.datas) if c.kind == "rs_visual")
    dt = next(d for c, d in zip(pt.cfgs, pt.datas) if c.kind == "rs_visual")
    real = np.asarray(dj["_pad"]) < 0.5
    assert int(real.sum()) == dt["point"].shape[0]
    assert sorted(zip(np.asarray(dj["point"])[real], np.asarray(dj["rig"])[real])) == sorted(
        zip(dt["point"].numpy(), dt["rig"].numpy()))


def test_finalize_blocks_matches_jax():
    """The blocked rs_visual batch: the calibration-coupled tile height
    (rb = 112), slot order, point windows and the window plan equal the JAX
    package's."""
    pj, _ = jax_full()
    pt, _ = port_full_built()
    (ij,) = [i for i, c in enumerate(pj.cfgs) if c.block_info is not None]
    (it,) = [i for i, c in enumerate(pt.cfgs) if c.block_info is not None]
    bj, bt = pj.cfgs[ij].block_info, pt.cfgs[it].block_info
    assert dataclasses.asdict(bt) == dataclasses.asdict(bj)
    assert bt.rb == 112 and bt.wb > 0
    dj, dt = pj.datas[ij], pt.datas[it]
    for k in ("rig", "point", "intr", "extr", "_pad", "_rb_local", "_rb_base", "_rg_pt_local",
              "_rg_hib", "_cb_local", "_cb_base", "rs_row", "rs_tpf", "obs_uv", "sqrt_h"):
        assert rel(dt[k].numpy().astype(np.float64), np.asarray(dj[k], np.float64)) < TOL, k


def test_window_plan_lists_every_real_slot():
    pt, _ = port_full_built()
    (i,) = [i for i, c in enumerate(pt.cfgs) if c.block_info is not None]
    data, info = pt.datas[i], pt.cfgs[i].block_info
    cplan = trcs.cal_plan_of(data, info)
    real = np.nonzero(data["_pad"].numpy() < 0.5)[0]
    obs = cplan.chunk_obs.numpy()
    np.testing.assert_array_equal(np.sort(obs), real)
    win = cplan.win.numpy()
    np.testing.assert_array_equal(win[real], data["intr"].numpy()[real])
    assert np.all(np.diff(win[obs]) >= 0)
    sizes = np.diff(cplan.chunk_ptr.numpy())
    assert sizes.min() >= 1 and sizes.max() <= tseg.CHUNK
    rc = cplan.row_chunk.numpy()
    for r in range(cplan.n_rows):  # each row's chunks hold exactly its slots
        sl = obs[cplan.chunk_ptr.numpy()[rc[r]]:cplan.chunk_ptr.numpy()[rc[r + 1]]]
        np.testing.assert_array_equal(np.sort(sl), real[win[real] == r])


def test_entry_points_default_to_the_card():
    """Without a device argument the builder and the adapter target the first
    CUDA card; on a machine without one the build fails instead of falling
    back to the CPU."""
    assert tbuilder.default_device() == torch.device("cuda", 0)
    ad = SessionAdapter(tsd.load_session(full_session_dir()),
                        AdapterOptions(estimate_readout=True), log=None)
    assert ad.device == torch.device("cuda", 0)
    if not torch.cuda.is_available():
        from _torch_port_fixtures import BUILD, port_session

        with pytest.raises((RuntimeError, AssertionError)):
            tbuilder.build_synthetic_problem(port_session(), tbuilder.BuildOptions(**BUILD))


def test_init_rigs_options_raise():
    with pytest.raises(NotImplementedError, match="init_rigs"):
        SessionAdapter(tsd.load_session(full_session_dir()),
                       AdapterOptions(map_keyrigs=([], [], [])), log=None, device="cpu")
