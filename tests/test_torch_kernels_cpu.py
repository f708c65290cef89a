"""The port's kernel modules vs the JAX package, on the tiny blocked problem.

On the CPU each kernel wrapper takes its plain PyTorch version (the CUDA
kernels build and run only on the card). Held here, in float64 to 1e-9
relative to the reference's max-abs:

  K1  ops/visual_fused.visual_linearize  vs the JAX generic AD linearizer
                                           (its fused Pallas linearizer
                                           declines on the CPU)
  K2  seg_assemble_rig, K3 seg_precond_rig, K6 seg_schur_down,
  K5  seg_schur_up, K4 seg_schur_pcg      vs the JAX entries of the same
                                           names on their XLA branches

The batch is blocked by rcs.finalize_blocks(pb, rb=8, prb=16, ts=64) and is
single-pass rig-only on the JAX side. Both sides take the same J, weights
and tables (numpy from a seed). Each CUDA kernel is held against its plain
version on the card by tests/test_torch_kernels_cuda.py.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_fixtures import jax_active_cfgs, jax_problem, port_problem, rel, t

from visual_inertial_bundle_adjustment_tpu.ops import segments as jseg
from visual_inertial_bundle_adjustment_tpu.problem import engine as jeng
from visual_inertial_bundle_adjustment_tpu.problem import factors as jfct
from visual_inertial_bundle_adjustment_tpu.problem import rcs as jrcs
from visual_inertial_bundle_adjustment_tpu_torch.ops import _kernels
from visual_inertial_bundle_adjustment_tpu_torch.ops import segments as tseg
from visual_inertial_bundle_adjustment_tpu_torch.ops import visual_fused
from visual_inertial_bundle_adjustment_tpu_torch.problem import factors as tfct
from visual_inertial_bundle_adjustment_tpu_torch.problem import rcs as trcs

TOL = 1e-9
SEGMENT_KERNELS = ("assemble_rig", "precond_rig", "schur_down", "schur_up", "schur_pcg")


def _blocked_index(p):
    (vi,) = [i for i, c in enumerate(p.cfgs) if getattr(c, "block_info", None)]
    return vi


@functools.lru_cache(maxsize=None)
def _jax_vis():
    """The JAX linearization and the blocked batch's VisBatch."""
    pj = jax_problem()
    cfgs = jax_active_cfgs(pj)
    datas = tuple(pj.datas)
    lg = jax.jit(lambda d, v, m: jeng.linearize(cfgs, d, v, m))(datas, pj.variables, pj.masks)
    (b, lin), = jrcs._vis_batches(cfgs, datas, lg)
    assert jrcs._single_pass(b) and jrcs._rig_only_fast(b)
    return lg, b, lin


@functools.lru_cache(maxsize=None)
def _port_blocked():
    p = port_problem()
    vi = _blocked_index(p)
    return p, p.cfgs[vi], p.datas[vi]


# ---------------------------------------------------------------------------
# K1 and the factor linearizers
# ---------------------------------------------------------------------------


def test_visual_linearize_plain_matches_jax():
    pj = jax_problem()
    cfg = jax_active_cfgs(pj)[_blocked_index(pj)]
    data = pj.datas[_blocked_index(pj)]
    assert "_uvT" in data  # the fused hook is present; on the CPU it declines
    lin = jax.jit(lambda d, v, m: jfct.linearize_batch(cfg, d, v, m))(
        data, pj.variables, pj.masks)
    res_j, valid_j = jax.jit(lambda d, v: jfct.residual_batch(cfg, d, v))(data, pj.variables)
    assert lin.groups == (jfct.POINTS, jfct.RIG)

    p, cfg_t, data_t = _port_blocked()
    res, valid, J_pt, J_r = visual_fused.visual_linearize(cfg_t.camera_kind, data_t, p.variables,
                                                          p.masks, True)
    assert rel(res.numpy(), lin.res) < TOL
    np.testing.assert_array_equal(valid.numpy(), np.asarray(lin.valid))
    assert rel(J_pt.numpy(), lin.jac[0]) < TOL
    assert rel(J_r.numpy(), lin.jac[1]) < TOL
    res_r, valid_r = visual_fused.visual_linearize(cfg_t.camera_kind, data_t, p.variables, None,
                                                   False)
    assert rel(res_r.numpy().T, res_j) < TOL
    np.testing.assert_array_equal(valid_r.numpy(), np.asarray(valid_j))


@pytest.mark.parametrize("kind", ["visual", "inertial"])
def test_generic_linearize_batch_matches_jax(kind):
    """The torch.func vmap(jacfwd/jacrev) path of factors.linearize_batch
    (the visual batch with its blocking hidden, and the inertial chain)."""
    pj = jax_problem()
    p = port_problem()
    (i,) = [i for i, c in enumerate(pj.cfgs) if c.kind == kind]
    cfg_j = dataclasses.replace(jax_active_cfgs(pj)[i], block_info=None)
    data_j = {k: a for k, a in pj.datas[i].items() if k != "_uvT"}
    lin_j = jax.jit(lambda d, v, m: jfct.linearize_batch(cfg_j, d, v, m))(
        data_j, pj.variables, pj.masks)
    cfg_t = dataclasses.replace(p.cfgs[i], block_info=None, active_groups=cfg_j.active_groups)
    lin_t = tfct.linearize_batch(cfg_t, p.datas[i], p.variables, p.masks)
    assert lin_t.groups == lin_j.groups
    assert rel(lin_t.res.numpy(), lin_j.res) < TOL
    np.testing.assert_array_equal(lin_t.valid.numpy(), np.asarray(lin_j.valid))
    for g, Jt, Jj in zip(lin_t.groups, lin_t.jac, lin_j.jac):
        assert rel(Jt.numpy(), Jj) < TOL, g
    res_t, valid_t = tfct.residual_batch(cfg_t, p.datas[i], p.variables)
    res_j, valid_j = jfct.residual_batch(cfg_j, data_j, pj.variables)
    assert rel(res_t.numpy(), res_j) < TOL
    np.testing.assert_array_equal(valid_t.numpy(), np.asarray(valid_j))


# ---------------------------------------------------------------------------
# K2-K6
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _segment_inputs():
    """Shared numpy inputs: the JAX batch's J, res and weights, plus random
    rig/landmark tables and SPD landmark-block inverses."""
    _, b, lin = _jax_vis()
    R, L = jax_problem().variables.pose_q.shape[0], jax_problem().variables.points.shape[0]
    rng = np.random.default_rng(21)
    A = rng.normal(size=(L, 3, 3))
    return dict(J=np.asarray(b.jac[0]), J_pt=np.asarray(b.J_pt), res=np.asarray(lin.res),
                w=np.asarray(b.w), x=rng.normal(size=(R, 6)), z=rng.normal(size=(L, 3)),
                hinv=A @ np.swapaxes(A, -1, -2) + np.eye(3))


def _jax_segment(name, a):
    _, b, _ = _jax_vis()
    i = b.info
    R, L = a["x"].shape[0], a["z"].shape[0]
    loc = (b.rb_local, b.rg_pt_local, b.rg_hib)
    geo = (i.nt, i.ts, i.rb, i.prb2 // 128, i.nhg)
    J, J_pt, w = jnp.asarray(a["J"]), jnp.asarray(a["J_pt"]), jnp.asarray(a["w"])
    if name == "assemble_rig":
        return jseg.seg_assemble_rig(J, J_pt, jnp.asarray(a["res"]), w, *loc, b.rb_base, L, *geo,
                                     R)
    if name == "precond_rig":
        return jseg.seg_precond_rig(J, J_pt, w, *loc, jnp.asarray(a["hinv"]), b.rb_base, *geo, R)
    if name == "schur_down":
        return jseg.seg_schur_down(J, J_pt, w, *loc, jnp.asarray(a["x"]), b.rb_base, L, *geo)
    if name == "schur_up":
        return jseg.seg_schur_up(J, J_pt, w, *loc, jnp.asarray(a["z"]), b.rb_base, *geo, R)
    return jseg.seg_schur_pcg(J, J_pt, w, *loc, jnp.asarray(a["x"]), jnp.asarray(a["hinv"]),
                              b.rb_base, L, *geo)


def _port_segment(name, a, plan):
    J, J_pt, w = a["J"], a["J_pt"], a["w"]
    if name == "assemble_rig":
        return tseg.seg_assemble_rig(J, J_pt, a["res"], w, plan)
    if name == "precond_rig":
        return tseg.seg_precond_rig(J, J_pt, w, a["hinv"], plan)
    if name == "schur_down":
        return tseg.seg_schur_down(J, J_pt, w, a["x"], plan)
    if name == "schur_up":
        return tseg.seg_schur_up(J, J_pt, w, a["z"], plan)
    return tseg.seg_schur_pcg(J, J_pt, w, a["x"], a["hinv"], plan)


@pytest.mark.parametrize("name", SEGMENT_KERNELS)
def test_segment_plain_matches_jax(name):
    a = _segment_inputs()
    out_j = _jax_segment(name, a)
    _, _, data = _port_blocked()
    out_t = _port_segment(name, {k: t(v) for k, v in a.items()}, trcs.plan_of(data))
    out_j = out_j if isinstance(out_j, tuple) else (out_j,)
    out_t = out_t if isinstance(out_t, tuple) else (out_t,)
    assert len(out_t) == len(out_j)
    for ot, oj in zip(out_t, out_j):
        assert rel(ot.numpy(), oj) < TOL


def test_segment_plan_lists_every_real_slot():
    """The CSR work lists of the segment kernels: every real slot once, rig
    lists in slot order, landmark lists grouped by point."""
    _, _, data = _port_blocked()
    plan = trcs.plan_of(data)
    real = np.nonzero(data["_pad"].numpy() < 0.5)[0]
    np.testing.assert_array_equal(plan.rig_obs.numpy(), real)
    np.testing.assert_array_equal(np.sort(plan.pt_obs.numpy()), real)
    pt = plan.point.numpy()[plan.pt_obs.numpy()]
    assert np.all(np.diff(pt) >= 0)
    np.testing.assert_array_equal(np.diff(plan.pt_ptr.numpy()),
                                  np.bincount(pt, minlength=plan.n_pts))
    rg = plan.rig.numpy()[plan.rig_obs.numpy()]
    np.testing.assert_array_equal(np.diff(plan.rig_ptr.numpy()),
                                  np.bincount(rg, minlength=plan.n_rows))


# ---------------------------------------------------------------------------
# Dispatch rule and launch counts
# ---------------------------------------------------------------------------


def test_cpu_tensors_take_the_plain_versions_and_count_nothing():
    a = {k: t(v) for k, v in _segment_inputs().items()}
    p, cfg, data = _port_blocked()
    _kernels.reset_launch_counts()
    visual_fused.visual_linearize(cfg.camera_kind, data, p.variables, p.masks, True)
    for name in SEGMENT_KERNELS:
        _port_segment(name, a, trcs.plan_of(data))
    assert {"visual_linearize", *SEGMENT_KERNELS} <= set(_kernels.launch_counts())
    assert all(n == 0 for n in _kernels.launch_counts().values())


def test_on_card_rejects_other_devices():
    assert _kernels.on_card(torch.zeros(2)) is False
    with pytest.raises(ValueError):
        _kernels.on_card(torch.empty(2, device="meta"))


# ---------------------------------------------------------------------------
# The build: one nvcc per source, each source's seconds kept in the log
# ---------------------------------------------------------------------------

FAKE_NVCC = """#!/bin/sh
prev=""
for a in "$@"; do
  [ "$prev" = "-o" ] && out="$a"
  prev="$a"
done
: > "$out"
case "$*" in
  *-shared*) ;;
  *) name=$(basename "$out" .o)
     echo "ptxas info    : Function properties for k_$name"
     echo "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"
     echo "ptxas info    : Used 12 registers" ;;
esac
"""


def test_build_log_times_each_source_and_keeps_the_ptxas_report(tmp_path, monkeypatch):
    """build() with a stand-in nvcc (it writes its -o file and a ptxas
    report): every csrc/*.cu compiles once, the log keeps each source's
    seconds to its nvcc's exit (build_seconds) and its ptxas report
    (resource_usage), and a second build() reuses the library."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(0o755)
    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(_kernels, "_nvcc", lambda: str(nvcc))
    out = _kernels.build()
    stems = sorted(p.stem for p in _kernels.CSRC.glob("*.cu"))
    seconds = _kernels.build_seconds()
    assert sorted(seconds) == sorted(s + ".cu" for s in stems) and "precond_rig.cu" in seconds
    # K8, K9 / K10 and the column K9 (at rig widths 6 and 9) compile as units
    # of their own
    assert {"cal_assemble.cu", "cal_pcg.cu", "cal_pcg_cols.cu",
            "cal_pcg_cols_k9.cu"} <= set(seconds)
    assert "cal_segments.cu" not in seconds
    assert all(0 <= s < 60 for s in seconds.values())
    assert _kernels.resource_usage() == [(f"k_{s}", 12, 0, 0) for s in stems]
    assert out.exists() and _kernels.build() == out
    assert [p.name for p in (tmp_path / "_build").iterdir() if p.is_dir()] == []


def test_each_c_entry_is_defined_in_one_source():
    """Every C entry point the loader binds (_SIGNATURES) is defined in
    exactly one csrc/*.cu, and the units K8-K10 were split into define
    theirs: a unit left out of the build would fail only at load on the
    card."""
    import re

    defined = {}
    for src in _kernels.CSRC.glob("*.cu"):
        for name in re.findall(r'extern "C" int (viba_\w+)\(', src.read_text()):
            defined.setdefault(name, []).append(src.name)
    assert {n: defined.get(n) for n in _kernels._SIGNATURES
            if len(defined.get(n, [])) != 1} == {}
    assert defined["viba_assemble_cal"] == ["cal_assemble.cu"]
    assert {n: defined[n] for n in ("viba_schur_pcg_cal", "viba_schur_down_cal",
                                    "viba_schur_up_cal")} == {
        n: ["cal_pcg.cu"] for n in ("viba_schur_pcg_cal", "viba_schur_down_cal",
                                    "viba_schur_up_cal")}
    assert defined["viba_schur_pcg_cal_cols"] == ["cal_pcg_cols.cu"]
