"""The covariance probe's parts (visual_inertial_bundle_adjustment_tpu_torch/
cov_probe.py) on the CPU, at the tiny bias-only problem of
tests/_torch_port_fixtures.py (blocked at 64-slot tiles):

  * permuted_copy: without a seed the copy is the problem bit for bit; with
    one, the same tiles and rig rows hold the same observations in another
    order, segment_plan accepts the layout, the damped system agrees to
    float64's rounding and the float64 covariance blocks of a converged
    solve move by less than 1e-6 of each block's largest entry;
  * plain_reference(only=...) routes exactly the named kernels through
    their plain versions, and every wrapper asks under its own name;
  * perturbed_tables moves the state by about an ulp, and a converged
    float64 solve's blocks by less than 1e-6;
  * median_check on fixed readings: it passes at a spread where one draw's
    worst entry reads 3x another's with the kernels unchanged, and fails
    on a defect's readings;
  * inject_defect changes the column K4's output inside its block only.

The port's covariances against the JAX package stay in
tests/test_torch_covariance.py.
"""

import inspect
import re

import numpy as np
import pytest
import torch
from _torch_port_fixtures import port_blocked_problem

from visual_inertial_bundle_adjustment_tpu_torch import cov_probe
from visual_inertial_bundle_adjustment_tpu_torch.ops import _kernels
from visual_inertial_bundle_adjustment_tpu_torch.ops import segments as seg
from visual_inertial_bundle_adjustment_tpu_torch.problem import rcs

RIGS, ROWS = [3, 11, 19], [0]


def _blocked(p):
    (bi,) = [i for i, c in enumerate(p.cfgs) if c.block_info is not None]
    return bi, p.cfgs[bi].block_info, p.datas[bi]


def test_copy_without_seed_is_the_problem():
    p = port_blocked_problem()
    q = cov_probe.permuted_copy(p, None)
    for (c0, d0), (c1, d1) in zip(zip(p.cfgs, p.datas), zip(q.cfgs, q.datas)):
        assert c1 == c0 and sorted(d1) == sorted(d0)
        for k, a in d0.items():
            assert type(d1[k]) is type(a)
            if isinstance(a, torch.Tensor):
                assert a.dtype == d1[k].dtype and torch.equal(a, d1[k]), k


def test_permuted_copy_keeps_each_rig_row_in_its_tile():
    p = port_blocked_problem()
    bi, info, d0 = _blocked(p)
    q = cov_probe.permuted_copy(p, 1)
    _, info1, d1 = _blocked(q)
    assert info1 == info
    for k in ("_pad", "_rig_ptr", "_rb_base", "_rg_hib", "_pt_ptr"):
        assert torch.equal(d0[k], d1[k]), k
    real = d0["_rig_obs"].long()
    assert torch.equal(real, d1["_rig_obs"].long())
    # the same observations in each (tile, rig row), not all in the same order
    moved = 0
    for a0, a1 in ((d0["obs_uv"], d1["obs_uv"]), (d0["point"], d1["point"])):
        x0, x1 = a0[real].reshape(len(real), -1), a1[real].reshape(len(real), -1)
        moved += int((x0 != x1).any(-1).sum())
        key = (real // info.ts) * 10_000 + d0["rig"][real].long()
        for kv in key.unique():
            m = key == kv
            s0 = sorted(map(tuple, x0[m].tolist()))
            assert s0 == sorted(map(tuple, x1[m].tolist()))
    assert moved > len(real) // 2
    # segment_plan accepts the copy's layout (its rig-sorted check) and
    # gives the lists finalize_blocks attached
    plan = rcs.segment_plan(d1["rig"].numpy(), d1["point"].numpy(), d1["_pad"].numpy(),
                            int(q.variables.pose_q.shape[0]), int(q.variables.points.shape[0]))
    for k, a in plan.items():
        assert np.array_equal(a, d1[k].numpy()), k


def _system(p, lam):
    ks = p._build()
    datas, v, m = tuple(p.datas), p.variables, p.masks
    asm = ks[6](datas, ks[0](datas, v, m, None), v, m)
    return rcs.with_damping(asm, v, m, lam)


def test_permuted_copies_are_equal_in_float64():
    """The copies' damped systems (every rig, calibration and landmark sum)
    agree to float64's rounding, and so do their float64 covariance blocks
    where the solve converges (lam 1e-4: measured 6e-9 of each block's
    largest entry). At the covariance damping 1e-9 the 400-iteration PCG is
    far from converged, and float64's own blocks move by up to ~2e-3 with
    the sum order alone on this problem (measured 1.8e-3 at 150 iterations,
    3.3e-4 at 400): there the float64 solve is not a fixed reference
    either."""
    p = port_blocked_problem()
    base_rs = _system(p, 1e-9)
    base = cov_probe.cov_blocks(p, RIGS, ROWS, lam=1e-4, pcg_iters=150)
    for seed in (1, 2):
        q = cov_probe.permuted_copy(p, seed)
        rs = _system(q, 1e-9)
        pairs = [(rs.H_ll_inv, base_rs.H_ll_inv)] + list(zip(rs.diag_r, base_rs.diag_r)) + \
            list(zip(rs.precond_inv, base_rs.precond_inv))
        for a, b in (ab for ab in pairs if ab[1].numel()):
            assert float((a - b).abs().max()) <= 1e-12 * float(b.abs().max())
        got = cov_probe.cov_blocks(q, RIGS, ROWS, lam=1e-4, pcg_iters=150)
        assert sorted(got) == sorted(base)
        for key, B in base.items():
            assert B.size and np.abs(got[key] - B).max() <= 1e-6 * np.abs(B).max(), key


def test_plain_reference_routes_only_the_named_kernels():
    import visual_inertial_bundle_adjustment_tpu_torch.ops.rs_fused  # noqa: F401
    import visual_inertial_bundle_adjustment_tpu_torch.ops.visual_fused  # noqa: F401

    names = sorted(_kernels.WRAPPERS)
    assert not any(_kernels.takes_plain(n) for n in names)
    with _kernels.plain_reference():
        assert all(_kernels.takes_plain(n) for n in names) and _kernels.takes_plain()
    for only in ({"precond_rig"}, {"schur_pcg_cols", "schur_up"}, set()):
        with _kernels.plain_reference(only=only):
            assert [n for n in names if _kernels.takes_plain(n)] == sorted(only)
            assert not _kernels.takes_plain()
            with _kernels.plain_reference():  # nested: every kernel, then back
                assert all(_kernels.takes_plain(n) for n in names)
            assert [n for n in names if _kernels.takes_plain(n)] == sorted(only)
    assert not any(_kernels.takes_plain(n) for n in names)
    with pytest.raises(ValueError, match="no kernel named"):
        with _kernels.plain_reference(only={"precond_rig", "precond"}):
            pass
    # each wrapper asks for its own kernel by name before it launches
    for name, fn in _kernels.WRAPPERS.items():
        asks = re.findall(r'_kernels\.on_card\([^,()]+(?:\.\w+)*, "(\w+)"\)',
                          inspect.getsource(fn))
        assert asks == [name], (name, asks)


# cov:bias's readings on three copies of one state (rig and calibration
# kinds; "corr" the worst entry error, "std" the worst std ratio, *_med and
# *_p90 their medians and 90th percentiles over the observed dimensions),
# the H100's at the 5-iteration state (cov_probe.py): one draw's worst
# entry read 3x another's with the kernels unchanged; and the kernels with a
# relative 1e-2 error in the column K4's output
def _readings(worst, med, cal_med):
    return [{"rig": dict(corr=w, std=w / 2, corr_med=m, std_med=m / 2, corr_p90=8 * m,
                         std_p90=4 * m),
             "cal": dict(corr=5.8e-5, std=c / 2, corr_med=c, std_med=c / 3, corr_p90=2.1e-5,
                         std_p90=c)}
            for w, m, c in zip(worst, med, cal_med)]


KERNELS = _readings([3.28e-4, 7.19e-4, 7.68e-4], [1.69e-5, 2.37e-5, 2.43e-5],
                    [4.25e-6, 5.90e-6, 5.76e-6])
PLAIN = _readings([1.05e-4, 3.26e-4, 3.17e-4], [1.16e-5, 1.72e-5, 1.62e-5],
                  [3.79e-6, 4.41e-6, 4.69e-6])
DEFECT = _readings([7.06e-3, 7.19e-3, 7.23e-3], [1.64e-4, 1.67e-4, 1.69e-4],
                   [2.29e-5, 2.29e-5, 2.30e-5])


def test_median_check_passes_a_spread_the_single_draw_failed():
    assert KERNELS[0]["rig"]["corr"] > cov_probe.COV_PLAIN_RATIO * PLAIN[0]["rig"]["corr"]
    stat, fail = cov_probe.median_check(KERNELS, PLAIN)
    assert fail == []
    assert stat["rig"]["corr_med"] == pytest.approx((2.37e-5, 1.62e-5, 2.37 / 1.62))
    assert stat["rig"]["corr"][2] < cov_probe.COV_PLAIN_RATIO  # read beside, not held


def test_median_check_fails_on_a_defect():
    stat, fail = cov_probe.median_check(DEFECT, PLAIN)
    assert stat["rig"]["corr_med"][2] > cov_probe.COV_PLAIN_RATIO
    assert [f.split(":")[0] for f in fail] == ["rig corr_med", "rig std_med", "cal corr_med",
                                               "cal std_med"]
    with pytest.raises(ValueError, match="at least 3 copies"):
        cov_probe.median_check(KERNELS[:2], PLAIN[:2])


def test_perturbed_copies_round_the_state_anew():
    """perturbed_tables moves every entry by a relative 1e-7 (about an ulp
    in float32), and the float64 covariance blocks of a converged solve
    (lam 1e-4) move by less than 1e-6 of each block's largest entry."""
    p = port_blocked_problem()
    base = cov_probe.cov_blocks(p, RIGS, ROWS, lam=1e-4, pcg_iters=150)
    for seed in (1, 2):
        q = cov_probe.shallow_copy(p)
        q.variables = cov_probe.perturbed_tables(p.variables, cov_probe.COPY_REL, seed)
        for a, b in zip(q.variables, p.variables):
            rel = (a - b).abs() / b.abs().clamp(min=1e-300)
            assert rel.numel() == 0 or float(rel.max()) <= 1.0001e-7
            assert not bool(b.any()) or float(rel.max()) > 0  # every table with a value moved
        got = cov_probe.cov_blocks(q, RIGS, ROWS, lam=1e-4, pcg_iters=150)
        for key, B in base.items():
            assert np.abs(got[key] - B).max() <= 1e-6 * np.abs(B).max(), key


@pytest.mark.parametrize("defect", ["rel:1e-2", "drop"])
def test_inject_defect_changes_the_column_kernel_inside_its_block(defect):
    p = port_blocked_problem()
    _, _, d = _blocked(p)
    plan = rcs.plan_of(d)
    rng = np.random.default_rng(5)
    n, R, L = d["rig"].shape[0], p.variables.pose_q.shape[0], p.variables.points.shape[0]
    J_r, J_p = (torch.from_numpy(rng.normal(size=s)) for s in ((2, 6, n), (2, 3, n)))
    w = torch.from_numpy(rng.random(n)) * (1 - d["_pad"])
    hinv = torch.eye(3, dtype=torch.float64).repeat(L, 1, 1)
    x = torch.from_numpy(rng.normal(size=(R, 6, 4)))
    args = (J_r, J_p, w, x, hinv, plan)
    clean = seg.seg_schur_pcg_cols(*args)
    with cov_probe.inject_defect(defect):
        bad = seg.seg_schur_pcg_cols(*args)
    assert torch.equal(seg.seg_schur_pcg_cols(*args), clean)
    err = float((bad - clean).abs().max() / clean.abs().max())
    assert err > (1e-3 if defect == "drop" else 5e-3)
    if defect.startswith("rel"):
        assert torch.allclose((bad / clean - 1).abs(), torch.full_like(clean, 1e-2))


def test_landmark_safeguard_bounds_only_blocks_float32_cannot_resolve():
    """engine._spd_safeguard before _inv3 (covariance.prepare_system's
    landmark inverses): in float64 it leaves the tiny problem's damped
    landmark blocks untouched at the covariance damping; in float32 a block
    of one ray's observations, whose 1e-9 damping float32 cannot add to its
    diagonal, gets a bounded, positive definite inverse where _inv3 returns
    rounding noise, and a well-conditioned block is untouched."""
    from visual_inertial_bundle_adjustment_tpu_torch.problem import engine

    p = port_blocked_problem()
    ks = p._build()
    datas, v, m = tuple(p.datas), p.variables, p.masks
    H0 = ks[6](datas, ks[0](datas, v, m, None), v, m).H_ll0
    lam = 1e-9
    H = H0 + torch.diag_embed(lam * torch.diagonal(H0, dim1=-2, dim2=-1) + lam)
    assert torch.equal(engine._spd_safeguard(H), H)

    rng = np.random.default_rng(11)
    ray = rng.normal(size=3)
    J = rng.normal(size=(20, 2, 3))
    J -= (J @ ray)[..., None] * ray / (ray @ ray)  # rank 2: nothing along the ray
    one_ray = torch.from_numpy(1e3 * np.einsum("sai,saj->ij", J, J))
    good = torch.from_numpy(np.diag([4e6, 2e6, 1e6]) + 1e5)
    H32 = torch.stack([one_ray, good]).float()
    H32 = H32 + torch.diag_embed(lam * torch.diagonal(H32, dim1=-2, dim2=-1) + lam)
    raw, safe = engine._inv3(H32), engine._inv3(engine._spd_safeguard(H32))
    assert float(raw[0].abs().max()) > 1e3 * float(safe[0].abs().max())
    assert float(torch.linalg.eigvalsh(safe[0].double()).min()) > 0
    assert torch.equal(safe[1], raw[1])
