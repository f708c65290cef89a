"""Handoff of a problem given as numpy arrays into the port's Problem.

The tests hold the port against the JAX package on the same state: they take
the JAX package's problem apart into numpy (`np.asarray` on every leaf of its
variables, masks and datas, `dataclasses.asdict` on every cfg, a dict of
fields for the RS tables) and rebuild it here. Nothing of JAX is imported; a
blocked batch keeps its slot order, calibration-window plan and point-sorted
second grid, and gets the port's reduction plans: the rig and landmark
lists with each slot's point-sorted position, the chunked window rows and
(rig, window row) pairs and, for the general (two-grid) path, the chunked
camera and detector-bias rows. A merged multi-session problem hands over
like any other (its `base_map_visual` batch: index and float arrays only).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .ops import rolling_shutter as rs
from .ops import segments as seg
from .problem import factors as fct
from .problem import rcs
from .problem.optimizer import Problem
from .problem.structure import Masks, VariableTables

# keys of the JAX package's blocked layout that the port does not use: the
# lane-major copies and the per-tile rig rows (the port derives them from
# `_rb_base`); the ELL plans are dropped too
_DROPPED = ("_uvT", "_sh4", "_rb_rows")


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
        cfg = fct.BatchCfg(**cfg_d, block_info=info)
        d = {k: _tensor(a, device, dtype) for k, a in data.items()
             if k not in _DROPPED and not k.startswith("_ell") and k != "rs_tables"}
        if "rs_tables" in data:
            d["rs_tables"] = rs.tables_to(rs.RSTables(**{
                f: torch.from_numpy(np.array(data["rs_tables"][f])) for f in rs.RSTables._fields}),
                device, dtype)
        if info is not None:
            pad = np.asarray(data["_pad"])
            plan = rcs.segment_plan(np.asarray(data["rig"]), np.asarray(data["point"]), pad,
                                    v.pose_q.shape[0], v.points.shape[0])
            has_cal = info.wb > 0 and "_cb_local" in data
            if has_cal:
                win = (np.repeat(np.asarray(data["_cb_base"]), info.ts)
                       + np.asarray(data["_cb_local"]))
                plan.update(seg.cal_plan_arrays(win, pad, v.cam_intr.shape[0]))
                plan.update(seg.pair_plan_arrays(np.asarray(data["rig"]), win, pad,
                                                 v.pose_q.shape[0], v.cam_intr.shape[0]))
            plan.update(rcs.group_plan_arrays(data, pad, v, has_cal))
            d.update({k: torch.from_numpy(a).to(device) for k, a in plan.items()})
        problem.add_batch(cfg, d)
    return problem
