"""The port's condensed factors (problem/condensed.py) against the JAX
package, in float64 on the CPU, on the tiny problem.

  * make_condensed_batch / make_condensed_rel_batch from the same (H, b):
    the same square-root information A, offset u and (relative kind) proxy
    Jacobian S and linearization points, within 1e-10;
  * both condensed kinds, registered at run time: residuals and Jacobians
    at a moved state against factors.linearize_batch, within 1e-9;
  * marginalize_onto_rigs / marginalize_rel_onto_rigs against the JAX
    package's, within 1e-6 of the largest entry (150 PCG iterations);
  * the relative factor is gauge invariant: its residual does not move
    under a rigid world transformation of every variable
    (tests/test_marginals.py's check, on the port).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_fixtures import rel, t, to_numpy

from visual_inertial_bundle_adjustment_tpu.problem import condensed as jcnd
from visual_inertial_bundle_adjustment_tpu.problem import factors as jfct
from visual_inertial_bundle_adjustment_tpu_torch import interop
from visual_inertial_bundle_adjustment_tpu_torch.ops import lie as tlie
from visual_inertial_bundle_adjustment_tpu_torch.problem import condensed as tcnd
from visual_inertial_bundle_adjustment_tpu_torch.problem import engine as teng
from visual_inertial_bundle_adjustment_tpu_torch.problem import factors as tfct
from visual_inertial_bundle_adjustment_tpu_torch.problem import structure as tst

jax.config.update("jax_enable_x64", True)

BASE, RIGS = 4, [5, 6]
PCG = dict(pcg_iters=150)


@functools.lru_cache(maxsize=None)
def _jax_problem():
    from __graft_entry__ import _tiny_problem

    return _tiny_problem()


def _port_problem():
    return interop.problem_from_numpy(**to_numpy(_jax_problem()), device="cpu",
                                      dtype=torch.float64)


def _spd(D, seed):
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(D, D))
    return M @ M.T + D * np.eye(D), rng.normal(size=D)


def _moved(v, seed):
    """The variables with every rig, velocity and gravity nudged."""
    rng = np.random.default_rng(seed)
    step = tst.zero_tangent(v)._replace(rig=t(rng.normal(size=(v.pose_q.shape[0], 12)) * 1e-2),
                                        gravity=t(rng.normal(size=2) * 1e-2))
    return tst.retract(v, step, torch.zeros_like(v.points), tst.full_masks(v))


def _jax_vars(v):
    return type(_jax_problem().variables)(**{f: jnp.asarray(a.numpy())
                                             for f, a in v._asdict().items()})


def _batch(kind, pkg, v):
    H, b = _spd(6 + 12 * len(RIGS) + 2 if kind == "rel" else 12 * len(RIGS) + 2, 3)
    if kind == "rel":
        return pkg.make_condensed_rel_batch(v, BASE, RIGS, H, b)
    return pkg.make_condensed_batch(v, RIGS, H, b)


@pytest.mark.parametrize("kind", ["abs", "rel"])
def test_condensed_batches_and_factors_match_jax(kind):
    pj, pt = _jax_problem(), _port_problem()
    jkind, jdata = _batch(kind, jcnd, pj.variables)
    tkind, tdata = _batch(kind, tcnd, pt.variables)
    assert tkind == jkind and tdata.keys() == jdata.keys()
    assert tfct.REGISTRY[tkind]["res_dim"] == jdata["A"].shape[-1]
    for key, a in jdata.items():
        if tdata[key].is_floating_point():
            assert rel(tdata[key].numpy(), a) < 1e-10, key
        else:
            np.testing.assert_array_equal(tdata[key].numpy(), a)
    if kind == "rel":
        S_t, _ = tcnd._abs_to_rel_jacobian(pt.variables, BASE, RIGS)
        S_j, _ = jcnd._abs_to_rel_jacobian(pj.variables, BASE, RIGS)
        assert rel(S_t, S_j) < 1e-12
    v = _moved(pt.variables, 9)
    got = tfct.linearize_batch(tfct.BatchCfg(kind=tkind), tdata, v, tst.full_masks(v))
    vj = _jax_vars(v)
    want = jfct.linearize_batch(jfct.BatchCfg(kind=jkind), jdata, vj,
                                type(pj.masks)(*(jnp.asarray(a.numpy())
                                                 for a in tst.full_masks(v))))
    assert np.abs(np.asarray(want.res)).max() > 1e-3
    assert rel(got.res.numpy(), want.res) < 1e-9
    assert got.groups == tuple(want.groups)
    for a, b in zip(got.jac, want.jac):
        assert rel(a.numpy(), b) < 1e-9


@pytest.mark.parametrize("kind", ["abs", "rel"])
def test_marginalize_matches_jax(kind):
    pj, pt = _jax_problem(), _port_problem()
    if kind == "rel":
        Hj, bj = jcnd.marginalize_rel_onto_rigs(pj, BASE, RIGS, **PCG)
        Ht, bt = tcnd.marginalize_rel_onto_rigs(pt, BASE, RIGS, **PCG)
    else:
        Hj, bj = jcnd.marginalize_onto_rigs(pj, RIGS, **PCG)
        Ht, bt = tcnd.marginalize_onto_rigs(pt, RIGS, **PCG)
    assert Ht.shape == Hj.shape and bt.shape == bj.shape
    assert rel(Ht, Hj) < 1e-6 and rel(bt, bj) < 1e-6
    assert pt.masks.rig[BASE].all()  # the base pose's mask restored


def test_relative_condensed_factor_gauge_invariant():
    pt = _port_problem()
    v = pt.variables
    H, b = _spd(6 + 12 * len(RIGS) + 2, 5)
    kind, data = tcnd.make_condensed_rel_batch(v, BASE, RIGS, H, b)
    cfg = tfct.BatchCfg(kind=kind)
    m = tst.full_masks(v)
    v0 = _moved(v, 4)
    res0 = teng.linearize((cfg,), (data,), v0, m).lins[0].res
    xi = np.random.default_rng(3).normal(size=6) * np.array([2.0, 2.0, 2.0, 0.6, 0.6, 0.6])
    Tq, Tt = tlie.se3_exp(t(xi))
    res1 = teng.linearize((cfg,), (data,), tst.apply_world_transformation(v0, Tq, Tt),
                          m).lins[0].res
    assert res0.abs().max() > 1e-3
    np.testing.assert_allclose(res1.numpy(), res0.numpy(), atol=1e-6 * max(res0.abs().max(), 1))
