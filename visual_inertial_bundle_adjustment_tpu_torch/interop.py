"""Handoff of a problem given as numpy arrays into the port's Problem.

The tests hold the port against the JAX package on the same state: they take
the JAX package's problem apart into numpy (`np.asarray` on every leaf of its
variables, masks and datas, `dataclasses.asdict` on every cfg) and rebuild it
here. Nothing of JAX is imported; a blocked batch keeps its slot order and
gets the port's reduction plans.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .problem import factors as fct
from .problem import rcs
from .problem.optimizer import Problem
from .problem.structure import Masks, VariableTables

# keys of the JAX package's blocked layout that the port does not use: the
# lane-major copies, the two-grid point permutations, the calibration-window
# plan and the ELL plans of blocked batches
_DROPPED = ("_uvT", "_sh4", "_rb_rows", "_pt_perm", "_pt_w", "_pt_local", "_pt_inv",
            "_pt_rows", "_pt_base", "_cb_local", "_cb_base")


def _tensor(a, device, dtype):
    a = np.array(a)  # a writable copy: the caller's arrays may be read-only views
    if a.dtype.kind == "f":
        return torch.from_numpy(a).to(device=device, dtype=dtype)
    if a.dtype.kind in "iu":
        return torch.from_numpy(np.ascontiguousarray(a.astype(np.int32))).to(device)
    raise TypeError(f"unsupported array dtype {a.dtype}")


def problem_from_numpy(variables: dict, masks: dict, cfgs: list, datas: list, device,
                       dtype) -> Problem:
    """Port Problem from numpy tables: variables/masks keyed by their
    VariableTables/Masks field names, cfgs as dicts of BatchCfg fields (a
    blocked cfg's block_info as a dict of BlockInfo fields)."""
    v = VariableTables(**{f: _tensor(variables[f], device, dtype)
                          for f in VariableTables._fields})
    m = Masks(**{f: _tensor(masks[f], device, dtype) for f in Masks._fields})
    problem = Problem(v, m)
    bi_fields = {f.name for f in dataclasses.fields(rcs.BlockInfo)}
    for cfg_d, data in zip(cfgs, datas):
        cfg_d = dict(cfg_d)
        info = cfg_d.pop("block_info", None)
        cfg_d["loss"] = tuple(cfg_d["loss"])
        if cfg_d.get("active_groups") is not None:
            cfg_d["active_groups"] = tuple(cfg_d["active_groups"])
        if info is not None:
            info = rcs.BlockInfo(**{k: int(val) for k, val in dict(info).items()
                                    if k in bi_fields})
            info = dataclasses.replace(info, wb=0)  # calibration plans: not ported
        cfg = fct.BatchCfg(**cfg_d, block_info=info)
        d = {k: _tensor(a, device, dtype) for k, a in data.items()
             if k not in _DROPPED and not k.startswith("_ell")}
        if info is not None:
            plan = rcs.segment_plan(np.asarray(data["rig"]), np.asarray(data["point"]),
                                    np.asarray(data["_pad"]), v.pose_q.shape[0],
                                    v.points.shape[0])
            d.update({k: torch.from_numpy(a).to(device) for k, a in plan.items()})
        problem.add_batch(cfg, d)
    return problem
