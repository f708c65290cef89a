"""PyTorch port vs the JAX package: the public functions of ported modules
that the port lacked until its capacity slice (float64 on the CPU, 1e-10
relative to the reference's max-abs unless stated), the numeric CSV parser
on a CSV written here, the pipeline entry points' default device, and the
list of public names the port still lacks.

The inputs reuse the cases of tests/test_lie.py, test_motion.py,
test_preintegration.py, test_imu_model.py and test_rolling_shutter.py:
generic, tiny, zero and near-pi rotations; random RotVelPos elements;
synthetic IMU streams with aligned and interleaved gyro / accel samples."""

import ast
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_fixtures import jax_problem, port_problem, rel, t
from test_preintegration import NOISE, make_stream, pad_interval, random_calib
from test_torch_ops import _quats, _rotvecs, assert_same

from visual_inertial_bundle_adjustment_tpu.models import imu as jimu
from visual_inertial_bundle_adjustment_tpu.ops import lie as jlie
from visual_inertial_bundle_adjustment_tpu.ops import motion as jmotion
from visual_inertial_bundle_adjustment_tpu.ops import preintegration as jpre
from visual_inertial_bundle_adjustment_tpu.ops import rolling_shutter as jrs
from visual_inertial_bundle_adjustment_tpu.pipeline import native as jnative
from visual_inertial_bundle_adjustment_tpu.problem import factors as jfct
from visual_inertial_bundle_adjustment_tpu.problem import structure as jst
from visual_inertial_bundle_adjustment_tpu_torch.models import imu as timu
from visual_inertial_bundle_adjustment_tpu_torch.ops import lie as tlie
from visual_inertial_bundle_adjustment_tpu_torch.ops import motion as tmotion
from visual_inertial_bundle_adjustment_tpu_torch.ops import preintegration as tpre
from visual_inertial_bundle_adjustment_tpu_torch.ops import rolling_shutter as trs
from visual_inertial_bundle_adjustment_tpu_torch.pipeline import builder as tbuilder
from visual_inertial_bundle_adjustment_tpu_torch.pipeline import multi_session as tms
from visual_inertial_bundle_adjustment_tpu_torch.pipeline import native as tnative
from visual_inertial_bundle_adjustment_tpu_torch.problem import factors as tfct
from visual_inertial_bundle_adjustment_tpu_torch.problem import structure as tst

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAXPKG, PORT = "visual_inertial_bundle_adjustment_tpu", "visual_inertial_bundle_adjustment_tpu_torch"


def _se3(rng, n=16):
    return _quats(rng, n), rng.normal(size=(n, 3))


def _xi(rng, n=16):
    """SE(3) tangents whose rotations are generic, tiny, zero and near pi."""
    return np.concatenate([rng.normal(size=(n, 3)), _rotvecs(rng, n)], -1)


def _lie_cases():
    rng = np.random.default_rng(17)
    # rotation matrices of both hemispheres' quaternions, generic and near pi
    mats = np.asarray(jlie.quat_to_matrix(jnp.asarray(_quats(rng))))
    return {
        "matrix_to_quat": (mats,),
        "se3_adj": (_se3(rng),),
        "se3_left_jacobian": (_xi(rng),),
        "se3_left_jacobian_inverse": (_xi(rng),),
    }


@pytest.mark.parametrize("name", sorted(_lie_cases()))
def test_lie_function_matches_jax(name):
    assert_same(getattr(jlie, name), getattr(tlie, name), *_lie_cases()[name])


@pytest.mark.parametrize("shape", [(), (5,), (2, 3)])
def test_identities_match_jax(shape):
    assert_same(lambda: jlie.se3_identity(shape, jnp.float64), lambda: tlie.se3_identity(shape))
    assert_same(lambda: jmotion.rvp_identity(shape, jnp.float64),
                lambda: tmotion.rvp_identity(shape))


def _rvp(rng, n=16):
    """Random RotVelPos elements as numpy (test_motion.rand_rvp's ranges)."""
    q = np.asarray(jlie.so3_exp(jnp.asarray(rng.normal(size=(n, 3)) * 0.8)))
    return q, rng.normal(size=(n, 3)), rng.normal(size=(n, 3)), rng.uniform(0.05, 0.5, n)


def _motion_cases():
    rng = np.random.default_rng(19)
    a, b = _rvp(rng), _rvp(rng)
    delta = rng.normal(size=(16, 9)) * 0.3
    delta[3, :3] = 0.0  # the zero rotation
    aJac, bJac = rng.normal(size=(16, 9, 12)), rng.normal(size=(16, 9, 12))
    return {
        "rvp_boxminus": (a, b),
        "rvp_boxplus": (b, delta),
        "rvp_uncombine_right": (a, b),
        "rvp_combine_jacs": (a, b, aJac, bJac),
    }


@pytest.mark.parametrize("name", sorted(_motion_cases()))
def test_motion_function_matches_jax(name):
    def rvps(mod, args):  # the leading RotVelPos arguments as the package's type
        n = 1 if name == "rvp_boxplus" else 2
        return [mod.RotVelPos(*a) for a in args[:n]] + list(args[n:])

    args = _motion_cases()[name]
    assert_same(lambda *a: getattr(jmotion, name)(*rvps(jmotion, a)),
                lambda *a: getattr(tmotion, name)(*rvps(tmotion, a)), *args)


@pytest.mark.parametrize("aligned", [False, True])
def test_preintegrate_matches_jax(aligned):
    """One interval (test_preintegration's stream and calibration; with gyro
    and accel samples interleaved, and aligned) through both packages'
    single-interval preintegrate."""
    t_len, num_steps = 0.5, 300
    stream = make_stream(t_len=t_len, seed=5, aligned=aligned)
    iv = [np.asarray(a) for a in pad_interval(*stream, t_len)]
    calib = np.asarray(random_calib())
    pj = jpre.preintegrate(jnp.asarray(calib), jpre.PreintInterval(*map(jnp.asarray, iv)), NOISE,
                           num_steps)
    pt = tpre.preintegrate(t(calib), tpre.PreintInterval(*map(t, iv)),
                           timu.default_noise_model(), num_steps)
    assert bool(pt.valid) and bool(pj.valid)
    for a, b in zip(pt.rvp, pj.rvp):
        assert a.shape == b.shape and rel(a.numpy(), b) < 1e-10
    for f in ("J", "cov", "omega_at_end", "calib_eval"):
        a, b = getattr(pt, f), getattr(pj, f)
        assert a.shape == b.shape and rel(a.numpy(), b) < 1e-10, f


def test_build_rs_table_matches_jax():
    """One rig's rolling-shutter table (test_rolling_shutter's halves: a
    stream split at its midpoint) through both packages' build_rs_table."""
    half, num_steps = 0.04, 80
    g_t, g_v, a_t, a_v = make_stream(t_len=2 * half, seed=9)
    calib = np.asarray(random_calib(4))
    halves = []
    for t0 in (0.0, half):  # each half's samples relative to its own start
        halves.append([np.asarray(a) for a in pad_interval(g_t - t0, g_v, a_t - t0, a_v, half)])
    grav = np.array([0.0, 0.0, -9.81])
    (out_j, g_j) = jrs.build_rs_table(jnp.asarray(calib),
                                      *(jpre.PreintInterval(*map(jnp.asarray, h)) for h in halves),
                                      jnp.asarray(grav), num_steps, num_steps + 2)
    (out_t, g_t_) = trs.build_rs_table(t(calib), *(tpre.PreintInterval(*map(t, h)) for h in halves),
                                       t(grav), num_steps, num_steps + 2)
    assert 2 < int(out_t[-1]) == int(out_j[-1])
    assert rel(g_t_.numpy(), g_j) == 0.0
    for a, b in zip(out_t, out_j):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape
        np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b))
        assert rel(np.where(np.isfinite(a), a, 0.0), np.where(np.isfinite(b), b, 0.0)) < 1e-10


def test_all_test_option_masks_match_jax():
    m = timu.all_test_option_masks()
    assert m.shape == (256, timu.CALIB_DIM) and m.dtype == bool
    np.testing.assert_array_equal(m, jimu.all_test_option_masks())


@pytest.mark.parametrize("sizes", [(5,), (7, 11, 2, 3, 4, 1, 2)])
def test_make_tables_match_jax(sizes):
    vj = jst.make_tables(*sizes, dtype=jnp.float64)
    vt = tst.make_tables(*sizes)
    for f in tst.VariableTables._fields:
        a, b = getattr(vt, f), np.asarray(getattr(vj, f))
        assert a.shape == b.shape and a.dtype == torch.float64, f
        np.testing.assert_array_equal(a.numpy(), b)


def test_tangent_algebra_matches_jax():
    rng = np.random.default_rng(23)
    shapes = [(9, 12), (2, 17), (3, 6), (1, 23), (0, 6), (2, 2), (2,)]
    a, b = ([rng.normal(size=s) for s in shapes] for _ in range(2))
    ja, jb = jst.Tangent(*map(jnp.asarray, a)), jst.Tangent(*map(jnp.asarray, b))
    ta, tb = tst.Tangent(*map(t, a)), tst.Tangent(*map(t, b))
    for x, y in zip(tst.t_add(ta, tb), jst.t_add(ja, jb)):
        assert rel(x.numpy(), y) < 1e-15
    for x, y in zip(tst.t_axpy(-0.7, ta, tb), jst.t_axpy(-0.7, ja, jb)):
        assert rel(x.numpy(), y) < 1e-15
    assert rel(tst.t_norm(ta).numpy(), jst.t_norm(ja)) < 1e-14


def test_batch_indices_match_jax():
    """Every batch of the bias-only fixture problem: the same groups in the
    same order, the same index arrays (gravity's all 0)."""
    pj, pt = jax_problem(), port_problem()
    for cj, dj, ct, dt in zip(pj.cfgs, pj.datas, pt.cfgs, pt.datas):
        ij, it = jfct.batch_indices(cj, dj), tfct.batch_indices(ct, dt)
        assert [g for g, _ in it] == [g for g, _ in ij]
        for (g, a), (_, b) in zip(it, ij):
            assert a.dtype in (torch.int32, torch.int64), g
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_parse_numeric_csv_matches_jax_and_raises_on_malformed_rows(tmp_path):
    """Numbers with a blank after the comma, exponents, a CR line end, a
    comment and a blank line, and more columns than read: both parsers give the same matrix. A
    row with a field missing or a text field among those read raises in the
    port; the JAX package's parser reads the text field as 0.0."""
    path = tmp_path / "num.csv"
    rng = np.random.default_rng(29)
    rows = rng.normal(size=(40, 6)) * np.array([1.0, 1e-6, 1e6, 1.0, 1.0, 1.0])
    lines = ["a,b,c,d,e,f"] + [",".join(f"{x:.17g}" for x in r) for r in rows]
    lines[3] = lines[3].replace(",", ", ")
    lines[5] += "\r"
    lines.insert(7, "# a comment")
    lines.insert(9, "")
    path.write_text("\n".join(lines) + "\n")
    for n_cols in (6, 4):
        got = tnative.parse_numeric_csv(path, n_cols)
        want = jnative.parse_numeric_csv(path, n_cols)
        assert got.shape == (40, n_cols) and got.dtype == np.float64
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, rows[:, :n_cols])
    for bad in ("1,2\n", "1,x,3\n", "1,,3\n"):
        path.write_text("a,b,c\n4,5,6\n" + bad)
        with pytest.raises(ValueError, match="malformed"):
            tnative.parse_numeric_csv(path, 3)
    path.write_text("a,b,c\n4,5,6\n1,x,3\n")
    np.testing.assert_array_equal(jnative.parse_numeric_csv(path, 3), [[4, 5, 6], [1, 0, 3]])


def test_make_base_map_batch_defaults_to_the_card(monkeypatch):
    """device=None resolves through builder.default_device(), as the
    builder's does: patched to the CPU, every tensor lands there; unpatched
    (the first CUDA card) a CPU-only build refuses."""
    rng = np.random.default_rng(31)
    n = 5
    args = (np.arange(n), _quats(rng)[:n], rng.normal(size=(n, 3)), rng.normal(size=(n, 16)),
            rng.normal(size=(n, 2)), np.tile(np.eye(2), (n, 1, 1)), 0)
    asked = []
    monkeypatch.setattr(tbuilder, "default_device",
                        lambda: asked.append(True) or torch.device("cpu"))
    cfg, data = tms.make_base_map_batch(*args)
    assert asked == [True] and cfg.kind == "base_map_visual"
    assert all(a.device.type == "cpu" for a in data.values())
    assert data["point"].dtype == torch.int32 and data["q_cw"].dtype == torch.float64
    monkeypatch.undo()
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError), match="CUDA|cuda"):
            tms.make_base_map_batch(*args)


def _public_names(package):
    out = {}
    for path in sorted((ROOT / package).rglob("*.py")):
        tree = ast.parse(path.read_text())
        out[path.relative_to(ROOT / package).as_posix()] = {
            node.name for node in tree.body
            if isinstance(node, (ast.FunctionDef, ast.ClassDef)) and not node.name.startswith("_")}
    return out


def test_only_multi_gpu_and_tpu_idioms_lack_a_port():
    """The public def / class names of each JAX module against the port's
    module of the same path: only three TPU idioms of ops/segments.py are
    left. The multi-GPU names (parallel/sharding.py, rcs.PointHaloPlan) have
    their counterparts now; the test keeps its name."""
    jax_names, port_names = _public_names(JAXPKG), _public_names(PORT)
    missing = {}
    for module, names in jax_names.items():
        lack = names - port_names.get(module, set())
        if lack:
            missing[module] = sorted(lack)
    assert missing == {
        "ops/segments.py": ["pt_table_from_kernel", "pt_table_to_kernel", "use_pallas"],
    }
