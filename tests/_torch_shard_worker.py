"""The ranks of tests/test_torch_sharding.py (JAX-free: spawned processes
import this module, never tests/conftest.py).

`main(rank, world, workdir)` joins a gloo group of `world` CPU ranks over a
FileStore in `workdir`, loads the problems the test wrote there (float64,
built by the port's builder: `<name>.pt`), runs every case on its shard in
the same order on every rank, then the single-device references its rank
is given, and writes `rank<r>.pt`: {case: result} with numpy arrays.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from visual_inertial_bundle_adjustment_tpu_torch.parallel import sharding
from visual_inertial_bundle_adjustment_tpu_torch.problem import rcs
from visual_inertial_bundle_adjustment_tpu_torch.problem.optimizer import LMSettings, optimize

BLOCKS = dict(rb=8, prb=16, ts=64)  # tests/test_sharding.py's blocking
LAM = 1e-4
ITERS, TOL = 400, 1e-13  # tests/test_sharding.py's _one_step
HALO_ITERS = 60
# the identity-preconditioned step held against the JAX package: at 400
# unpreconditioned iterations the step hangs on the summation order (the
# port's single-device step and the JAX package's differ by 2e-6 in the rig
# step and 1e-4 in the new cost), at 40 they agree to 1e-15
IDENTITY_ITERS = 40
# tests/test_sharding.py's 6 LM iterations, the direct mode's PCG capped at
# 100 iterations an attempt (500 by default): the port's PCG runs its full
# count under a stop mask, each iteration a round of collectives on every
# rank, and 500 made this one case take 35 s of the file's time
OPT = dict(max_iterations=6, direct_pcg_iterations=100)


def load(workdir, name):
    return torch.load(os.path.join(workdir, name + ".pt"), weights_only=False)


def tangent(t):
    return {f: getattr(t, f).numpy() for f in t._fields}


def one_step(p, iters=ITERS, precond="gauss_seidel"):
    """One LM attempt (tests/test_sharding.py's _one_step): the linearization,
    the step kernel's outputs, and the callables."""
    ks = p._build()
    datas, v, m = tuple(p.datas), p.variables, p.masks
    lg = ks[0](datas, v, m, None)
    out = ks[7](ks[6](datas, lg, v, m), datas, lg, v, m, LAM, iters, TOL, precond)
    return lg, out, ks


def step_result(lg, out):
    return dict(cost=float(lg.cost), n_inv=int(lg.num_invalid), n_opt=int(lg.num_optional),
                x=tangent(out[0]), xl=out[1].numpy(), model=float(out[2]),
                new_cost=float(out[9].cost), v_new=tangent(out[7]))


def resolve_result(p, lg, out, ks):
    """k_resolve at the post-step state, as the optimizer's sub-step runs it."""
    g2 = ks[4](tuple(p.datas), out[7], p.masks)
    s_r, s_l = ks[2](lg, p.variables, out[5], *g2, ITERS, TOL)
    return dict(s_r=tangent(s_r), s_l=s_l.numpy())


def optimize_result(p):
    s = optimize(p, LMSettings(**OPT))
    return dict(final_cost=s.final_cost, iterations=s.num_iterations,
                v=tangent(p.variables))


def plan_result(p, logs):
    pt = p.pt_plan
    return dict(pt=None if pt is None else (pt.own_lo, pt.halo), bail=p.halo_bailout,
                t={g: (q.own_lo, q.halo) for g, q in p.t_plans.items()}, logs=logs,
                cfgs=[c.block_info for c in p.cfgs],
                slots=[int((d["_pad"] < 0.5).sum()) for d in p.datas if "_rb_base" in d])


def counts_result(mesh):
    return {"|".join(map(str, k)): v for k, v in mesh.counts.items()}


def sharded(workdir, name, world, generic=False):
    p = load(workdir, name)
    mesh = sharding.make_mesh(world, device="cpu")
    logs = []
    if generic:
        sharding.shard_problem(p, mesh)
    else:
        sharding.shard_blocked_problem(p, mesh, log=logs.append, **BLOCKS)
    return p, mesh, logs


def single(workdir, name, generic=False):
    p = load(workdir, name)
    if generic:
        p.use_blocked_engine = False
    else:
        rcs.finalize_blocks(p, **BLOCKS)
    return p


def run_cases(rank, world, workdir):
    out = {}
    for name in ("small", "cal", "halo"):
        p, _, logs = sharded(workdir, name, world)
        out[f"plans/{name}"] = plan_result(p, logs)

    p, _, _ = sharded(workdir, "small", world)
    out["step/small/identity"] = step_result(*one_step(p, IDENTITY_ITERS, "identity")[:2])
    p, _, _ = sharded(workdir, "small", world)
    lg, o, ks = one_step(p)
    out["step/small"] = step_result(lg, o)
    out["resolve/small"] = resolve_result(p, lg, o, ks)
    p, _, _ = sharded(workdir, "cal", world)
    out["step/cal"] = step_result(*one_step(p)[:2])
    p, mesh, _ = sharded(workdir, "halo", world)
    mesh.reset_counts()
    out["step/halo"] = step_result(*one_step(p, HALO_ITERS)[:2])
    out["counts/halo"] = counts_result(mesh)
    p, _, _ = sharded(workdir, "small", world)
    out["optimize/small"] = optimize_result(p)
    p, _, _ = sharded(workdir, "small", world, generic=True)
    out["step/generic"] = step_result(*one_step(p)[:2])

    # the single-device references, spread over the ranks
    refs = [("small", False), ("cal", False), ("halo", False), ("optimize", False),
            ("generic", True)]
    for i, (name, generic) in enumerate(refs):
        if i % world != rank:
            continue
        if name == "optimize":
            out["single/optimize/small"] = optimize_result(single(workdir, "small"))
            continue
        p = single(workdir, "small" if generic else name, generic)
        if name == "small":
            lg, o, ks = one_step(p)
            out["single/step/small"] = step_result(lg, o)
            out["single/resolve/small"] = resolve_result(p, lg, o, ks)
        else:
            key = "generic" if generic else name
            out[f"single/step/{key}"] = step_result(
                *one_step(p, HALO_ITERS if name == "halo" else ITERS)[:2])
    return out


def main(rank, world, workdir):
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(workdir, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        out = run_cases(rank, world, workdir)
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
