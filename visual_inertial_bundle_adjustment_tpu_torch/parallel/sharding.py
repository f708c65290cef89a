"""Multi-GPU distribution: factor tiles sharded over torch.distributed ranks.

Port of `visual_inertial_bundle_adjustment_tpu/parallel/sharding.py`. The
JAX package shards a problem's factor batches over the mesh axis 'kf' of a
device mesh (shard_map): batches are built time-sorted, so a shard is a
contiguous span of the trajectory; the variable tables are replicated; and
every factor-to-table sum runs per shard and is completed by a psum (the
replacement of the reference's shared-memory parallel_for over factor
chunks and its atomic scatter-adds, lib/small_thing/Factor.h:668-734,
AtomicOps.h:21-112). Here a rank of an initialized torch.distributed group
holds its shard of the batches and a copy of the tables, the psums are
all-reduces over the group, and the per-PCG-iteration landmark, rig and
window sums ride neighbour halo exchanges of (halo, width) slabs
(rcs.PointHaloPlan, point_halo_plan, table_halo_plans), so the bytes a rank
exchanges in a PCG iteration do not grow with the session's length.

  make_mesh             the rank's Mesh over the initialized default group
  shard_blocked_problem the blocked layout (rcs.finalize_blocks), its tile
                        grid padded to a multiple of the rank count and cut
                        into contiguous tile spans; each rank keeps its span
                        with its reduction plans rebuilt over its own slots
                        (global row ids), and the halo plans
  shard_problem         the generic engine's factor rows cut into spans
  build_sharded_kernels the iteration callables of a sharded problem
                        (optimizer.iteration_kernels with the mesh); a
                        problem with a mesh takes them in Problem._build

Under sharding the PCG matvec takes the two-pass route (K6 or K10's down
pass, the landmark sums completed across the ranks, the 3x3 solve, K5 or
K10's up pass), never the fused K4 / K9, as in the JAX package (its
rcs.py:1154). The kernels run unchanged on a rank's plans: rows with no
local slot sum to zero.

Backends. NCCL serves one rank per card; gloo serves ranks on the CPU and
several ranks on one card (NCCL refuses two ranks on one device). gloo's
all_reduce takes CUDA tensors; its send and recv take host tensors only, so
on a card the halo slabs go through pinned host buffers (Mesh.exchange).
The caller picks the backend in init_process_group; nothing switches
silently, and a failed collective raises.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from ..ops import segments as seg
from ..problem import factors as fct
from ..problem import rcs
from ..problem.optimizer import iteration_kernels
from ..problem.structure import tables_to


class Mesh:
    """One rank's view of a one-axis mesh: its rank and the rank count of
    the default torch.distributed group, its device and the group's backend.

    It also counts the collectives that pass through it: `counts[(section,
    kind, shape)] = [calls, bytes]`, kind "all_reduce" (each tensor summed,
    by its shape; one call of the backend sums all tensors of one dtype) or
    "halo" (each slab this rank sends). The section is "pcg" inside the PCG
    iterations (engine.packed_pcg), else "step".

    It carries the halo plans of the problem sharded over it (`pt_plan`,
    `t_plans`: set by shard_blocked_problem, cleared by shard_problem), which
    the sharded solver reads from the mesh it is given; a Mesh serves one
    sharded problem."""

    def __init__(self, rank: int, size: int, device, backend: str, axis: str = "kf"):
        self.rank, self.size = int(rank), int(size)
        self.device = torch.device(device)
        self.backend = backend
        self.axis = axis
        self.counts: dict = {}
        self._section = "step"
        self.pt_plan = None
        self.t_plans: dict = {}

    @contextlib.contextmanager
    def section(self, name):
        """Collectives inside are counted under `name`."""
        prev, self._section = self._section, name
        try:
            yield
        finally:
            self._section = prev

    def reset_counts(self):
        self.counts = {}

    def _count(self, kind, t):
        c = self.counts.setdefault((self._section, kind, tuple(t.shape)), [0, 0])
        c[0] += 1
        c[1] += t.numel() * t.element_size()

    def all_reduce(self, tensors):
        """The sums over the ranks of `tensors` (new tensors; the inputs are
        left as they are): the tensors of one dtype flattened into one
        buffer, in order, and summed by one all_reduce of the group."""
        out = [None] * len(tensors)
        by_dtype: dict = {}
        for i, t in enumerate(tensors):
            self._count("all_reduce", t)
            by_dtype.setdefault(t.dtype, []).append(i)
        for idx in by_dtype.values():
            flat = torch.cat([tensors[i].reshape(-1) for i in idx])
            dist.all_reduce(flat)
            off = 0
            for i in idx:
                n = tensors[i].numel()
                out[i] = flat[off:off + n].view(tensors[i].shape)
                off += n
        return out

    def exchange(self, sends, peers, shape, dtype):
        """One neighbour exchange: sends [(peer rank, tensor)], and one slab of
        `shape` and `dtype` received from each rank of `peers`, returned in
        that order on this rank's device. NCCL: batch_isend_irecv of device
        tensors. gloo: its send and recv take host tensors, so a CUDA tensor
        goes through a pinned host buffer each way."""
        staged = self.backend == "gloo" and self.device.type == "cuda"
        ops, bufs = [], []
        for peer, t in sends:
            self._count("halo", t)
            t = t.contiguous()
            if staged:
                host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                host.copy_(t)
                t = host
            ops.append(dist.P2POp(dist.isend, t, peer))
        for peer in peers:
            buf = (torch.empty(shape, dtype=dtype, pin_memory=True) if staged
                   else torch.empty(shape, dtype=dtype, device=self.device))
            bufs.append(buf)
            ops.append(dist.P2POp(dist.irecv, buf, peer))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return [b.to(self.device) for b in bufs]


def make_mesh(num_devices: int | None = None, axis: str = "kf", device=None) -> Mesh:
    """This rank's Mesh over the default torch.distributed group, which the
    caller initializes (init_process_group with its backend, rank, world
    size and store). `num_devices`, if given, must be the world size. The
    device is the caller's, else the card rank % card count (two gloo
    ranks on one card share it)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: torch.distributed is not initialized "
                           "(init_process_group first)")
    size, rank = dist.get_world_size(), dist.get_rank()
    if num_devices is not None and num_devices != size:
        raise ValueError(f"make_mesh: {num_devices} devices asked, the group has {size} ranks")
    if device is None:
        device = torch.device("cuda", rank % max(torch.cuda.device_count(), 1))
    return Mesh(rank, size, device, dist.get_backend(), axis)


def _np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _rows(data):
    """Factor count of a host batch (factors._batch_size's rule)."""
    return next(a.shape[0] for k, a in data.items()
                if not k.startswith("_") and isinstance(a, np.ndarray) and a.ndim >= 1)


# index fields of the factor batches (factors.REGISTRY): a padding row
# repeats the batch's last index, so a shard's table support stays inside
# its time span (the halo plans read it)
_INDEX_FIELDS = ("prev_rig", "next_rig", "rig", "point", "intr", "extr", "bias", "calib",
                 "prev", "next", "idx", "prev_extr", "next_extr", "rs_row")


def _span(data, rank, n):
    """Rank `rank`'s contiguous 1/n of the factor rows of a host generic
    batch padded to a multiple of n (the arrays of another length kept)."""
    size = _rows(data)
    per = size // n
    return {k: (a[rank * per:(rank + 1) * per]
                if isinstance(a, np.ndarray) and a.ndim >= 1 and a.shape[0] == size else a)
            for k, a in data.items()}


def _pad_batch(data: dict, n_pad: int):
    """A host (numpy) factor batch with n_pad zero-weight rows appended: the
    whitening arrays (`sqrt_*`) are zero, so a padding row adds nothing to
    the cost, gradient or Hessian; `_pad` is 1 on them (and added, 0 on the
    real rows, to a batch without one, so that the failure counts of
    optional factors skip the padding rows); an index field repeats its last
    row; anything else its first."""
    if n_pad == 0:
        return data
    if "_pad" not in data:
        data = dict(data, _pad=np.zeros(_rows(data)))
    out = {}
    for k, a in data.items():
        if not isinstance(a, np.ndarray) or a.ndim == 0:
            out[k] = a
            continue
        if k == "_pad":
            row = np.ones_like(a[:1])
        elif k.startswith("sqrt_"):
            row = np.zeros_like(a[:1])
        elif k in _INDEX_FIELDS:
            row = a[-1:]
        else:
            row = a[:1]
        out[k] = np.concatenate([a, np.repeat(row, n_pad, axis=0)], 0)
    return out


def _active_groups(problem):
    """{group: whether its mask has any free entry}."""
    return {g: bool(getattr(problem.masks, g).any()) for g in fct.GROUP_DIMS}


# the blocked layout a rank keeps of a blocked batch besides its per-factor
# arrays: per slot, and per tile (`_TILE_KEYS`); every other `_` array is a
# plan over the whole grid, rebuilt over the rank's slots (_local_blocked)
_SLOT_KEYS = ("_pad", "_rb_local", "_rg_pt_local", "_cb_local")
_TILE_KEYS = ("_rb_base", "_rg_hib", "_cb_base")


def _host_batch(data):
    """A batch on the host: tensors as numpy (payload tuples, such as the RS
    tables, kept), the transpose plans dropped."""
    return {k: (a if isinstance(a, tuple) else _np(a)) for k, a in data.items()
            if not k.startswith("_ell")}


def _pad_tiles(data, info, nt_pad):
    """A host blocked batch with its tile grid padded to nt_pad tiles: the
    new slots are pads (`_pad` 1, every other array 0: rig, point and window
    row 0 at tile base 0)."""
    extra = (nt_pad - info.nt)
    out = {}
    for k, a in data.items():
        if isinstance(a, np.ndarray) and a.ndim >= 1 and (
                a.shape[0] == info.nt * info.ts or k in _TILE_KEYS):
            rows = extra * (1 if k in _TILE_KEYS else info.ts)
            fill = np.full((rows,) + a.shape[1:], 1.0 if k == "_pad" else 0, a.dtype)
            a = np.concatenate([a, fill], 0)
        out[k] = a
    return out


def shard_blocked_problem(problem, mesh: Mesh, log=None, **finalize_kw):
    """Blocked layout + tile sharding over the mesh, for this rank.

    rcs.finalize_blocks (finalize_kw; an already blocked batch stays as it
    is), then each blocked batch's tile grid padded to a multiple of the
    rank count with pad tiles and cut into contiguous spans of tiles, one a
    rank; generic batches padded with zero-weight rows and cut along the
    factor axis; the halo plans (point_halo_plan, table_halo_plans) made on
    the whole padded layout and kept as `problem.pt_plan` / `problem.t_plans`
    and on the mesh (the failed checks logged through `log`, default print).
    This rank keeps its span, its blocked batches' reduction plans rebuilt
    over its own slots with global row ids (rcs.segment_plan,
    seg.cal_plan_arrays and pair_plan_arrays, rcs.group_plan_arrays; the
    point-sorted second grid is dropped, as in the JAX package), and a copy
    of the tables, all on mesh.device. Requires every blocked batch to take a single-pass route
    (bounded per-tile landmark windows; rig-only, or rig and calibration
    windows): raises ValueError otherwise, as the JAX package does; the
    generic path (shard_problem) takes any layout."""
    n = mesh.size
    rcs.finalize_blocks(problem, **finalize_kw)
    ga = _active_groups(problem)
    cfgs, datas = [], []
    for cfg, data in zip(problem.cfgs, problem.datas):
        info = cfg.block_info
        data = _host_batch(data)
        if info is None:
            data = _pad_batch(data, (-_rows(data)) % n)
            cfgs.append(cfg)
            datas.append(data)
            continue
        groups = tuple(g for g, _ in fct.REGISTRY[cfg.kind]["tangents"]
                       if ga[g] and g != fct.POINTS)
        cal_ok = (info.wb > 0 and "_cb_local" in data and groups and groups[0] == fct.RIG
                  and all(g in (fct.RIG, fct.CAM_EXTR, fct.CAM_INTR) for g in groups))
        if not (info.prb2 > 0 and info.nhg > 0 and (groups == (fct.RIG,) or cal_ok)):
            raise ValueError(f"batch {cfg.label or cfg.kind} is not single-pass eligible; "
                             "use shard_problem (the generic engine) instead")
        data = {k: a for k, a in data.items()
                if not k.startswith("_") or k in _SLOT_KEYS + _TILE_KEYS}
        nt_pad = -(-info.nt // n) * n
        datas.append(_pad_tiles(data, info, nt_pad))
        cfgs.append(dataclasses.replace(cfg, block_info=dataclasses.replace(info, nt=nt_pad)))
    problem.cfgs, problem.datas = cfgs, datas
    problem.pt_plan = point_halo_plan(problem, n, log)
    problem.t_plans = table_halo_plans(problem, n, log)
    mesh.pt_plan, mesh.t_plans = problem.pt_plan, problem.t_plans

    local_cfgs, local = [], []
    for cfg, data in zip(problem.cfgs, problem.datas):
        info = cfg.block_info
        if info is None:
            data = _span(data, mesh.rank, n)
        else:
            per = info.nt // n
            cfg = dataclasses.replace(cfg, block_info=dataclasses.replace(info, nt=per, pnt=0))
            data = _local_blocked(data, info, mesh.rank, per, problem.variables)
        local_cfgs.append(cfg)
        local.append(_to_device(data, mesh.device))
    problem.cfgs, problem.datas = local_cfgs, local
    problem.variables = tables_to(problem.variables, mesh.device)
    problem.masks = tables_to(problem.masks, mesh.device)
    problem.mesh = mesh
    problem._kernels = None
    problem.active_cfgs = None
    return problem


def _local_blocked(data, info, rank, per, variables):
    """Rank `rank`'s span of `per` tiles of a padded host blocked batch, with
    its reduction plans over its own slots (global rig, landmark and window
    rows): rows with no local slot get empty lists."""
    R, L = variables.pose_q.shape[0], variables.points.shape[0]
    n_c = variables.cam_intr.shape[0]
    ts = info.ts
    slots = slice(rank * per * ts, (rank + 1) * per * ts)
    tiles = slice(rank * per, (rank + 1) * per)
    out = {}
    for k, a in data.items():
        if isinstance(a, np.ndarray) and a.ndim >= 1:
            a = a[tiles] if k in _TILE_KEYS else (a[slots] if a.shape[0] == info.nt * ts else a)
        out[k] = a
    pad = out["_pad"]
    out.update(rcs.segment_plan(out["rig"], out["point"], pad, R, L))
    if info.wb > 0:
        win = np.repeat(out["_cb_base"].astype(np.int64), ts) + out["_cb_local"]
        out.update(seg.cal_plan_arrays(win, pad, n_c))
        out.update(seg.pair_plan_arrays(out["rig"], win, pad, R, n_c))
    out.update(rcs.group_plan_arrays(out, pad, variables, info.wb > 0))
    return out


def _to_device(data, device):
    return {k: (type(a)(*(x.to(device) for x in a)) if isinstance(a, tuple)
                else torch.from_numpy(np.ascontiguousarray(a)).to(device))
            for k, a in data.items()}


def point_halo_plan(problem, n, log=None):
    """rcs.PointHaloPlan of the landmark table for n tile-sharded ranks, or
    None when the problem does not qualify (the (L, 3) sums of a PCG
    iteration then take an all-reduce, and the failed check is logged
    through `log`, default print, and kept as `problem.halo_bailout`).

    Reads the whole padded layout (shard_blocked_problem calls it before
    cutting). Qualifies when every point-coupled batch is blocked with
    bounded per-tile landmark windows, the tiles split evenly, and each
    rank's touched landmark range overlaps only its neighbours': true by
    construction for time-sorted sessions (tracks live seconds, ids are
    birth-ordered). SURVEY section 7 step 8: landmarks assigned to their
    owning keyframe block."""

    def bail(reason):
        problem.halo_bailout = reason
        (log or print)(f"point_halo_plan: disabled — {reason}; "
                       "landmark table falls back to full per-matvec psum")
        return None

    problem.halo_bailout = None
    L = int(problem.variables.points.shape[0])
    lo = np.full(n, L, np.int64)
    hi = np.zeros(n, np.int64)
    any_blocked = False
    for cfg, data in zip(problem.cfgs, problem.datas):
        if not any(g == fct.POINTS for g, _ in fct.REGISTRY[cfg.kind]["tangents"]):
            continue
        info = cfg.block_info
        if info is None or info.prb2 == 0 or "_rg_hib" not in data:
            return bail(f"point-coupled batch '{cfg.label or cfg.kind}' is "
                        "off the single-pass path")
        any_blocked = True
        nt = info.nt
        if nt % n:
            return bail(f"tile count {nt} not divisible by {n} shards")
        per = nt // n
        # the observed landmark ids of each span (pads carry zero weight)
        ids = _np(data["point"]).astype(np.int64).reshape(nt, -1)
        pad = _np(data["_pad"]).reshape(nt, -1) > 0.5
        for s in range(n):
            sl = slice(s * per, (s + 1) * per)
            b = ids[sl][~pad[sl]]
            if b.size == 0:
                continue
            lo[s] = min(lo[s], int(b.min()))
            hi[s] = max(hi[s], int(b.max()) + 1)
    if not any_blocked:
        return bail("no blocked point-coupled batches")
    hi = np.minimum(hi, L)
    if np.any(hi <= lo):
        return bail("a shard touches no points")
    if not (np.all(np.diff(lo) >= 0) and np.all(np.diff(hi) >= 0)):
        return bail("shard point ranges not time-ordered")
    own = _ownership(lo, hi, L, n)
    if not np.all(np.diff(own) > 0):
        return bail("degenerate ownership boundaries (a shard owns 0 rows)")
    halo = _halo_rows(lo, hi, own, n)
    if _reaches_past_neighbours(lo, hi, own, n):
        return bail("a shard's points reach beyond neighbor ownership "
                    "(non-adjacent coupling)")
    if int(np.min(np.diff(own))) < 2 * halo:
        return bail(f"ownership width {int(np.min(np.diff(own)))} < "
                    f"2x halo {halo} (too few points per shard)")
    return rcs.PointHaloPlan(own, halo, n)


def _ownership(lo, hi, rows, n):
    """Ownership boundaries (n+1,): at the middle of each neighbour overlap."""
    own = np.empty(n + 1, np.int64)
    own[0], own[n] = 0, rows
    for s in range(1, n):
        own[s] = (int(np.clip((lo[s] + hi[s - 1]) // 2, lo[s], hi[s - 1] + 1))
                  if lo[s] <= hi[s - 1] else (hi[s - 1] + lo[s]) // 2)
    return own


def _halo_rows(lo, hi, own, n):
    """Halo height: every rank's reach past its ownership, at least 8, a
    multiple of 8."""
    over = ([max(own[s] - lo[s], 0) for s in range(n)]
            + [max(hi[s] - own[s + 1], 0) for s in range(n)])
    return ((max(int(np.max(over)), 8) + 7) // 8) * 8


def _reaches_past_neighbours(lo, hi, own, n):
    return any(lo[s] < own[max(s - 1, 0)] or hi[s] > own[min(s + 2, n)] for s in range(n))


def _ranges_to_plan(lo, hi, rows, n, min_own_mult=1):
    """Per-rank contribution ranges [lo, hi) -> (PointHaloPlan, None) or
    (None, reason). min_own_mult: the ownership width required, in halos (1
    suffices for reduce + fetch: every exchanged slab lies inside the
    sending rank's owned range)."""
    lo, hi = np.asarray(lo, np.int64), np.minimum(np.asarray(hi, np.int64), rows)
    if np.any(hi <= lo):
        return None, "a shard touches no rows"
    if not (np.all(np.diff(lo) >= 0) and np.all(np.diff(hi) >= 0)):
        return None, "shard ranges not time-ordered"
    own = _ownership(lo, hi, rows, n)
    if not np.all(np.diff(own) > 0):
        return None, "degenerate ownership (a shard owns 0 rows)"
    halo = _halo_rows(lo, hi, own, n)
    if _reaches_past_neighbours(lo, hi, own, n):
        return None, "non-adjacent coupling (reach beyond neighbor ownership)"
    if int(np.min(np.diff(own))) < min_own_mult * halo:
        return None, (f"ownership width {int(np.min(np.diff(own)))} < "
                      f"{min_own_mult}x halo {halo}")
    return rcs.PointHaloPlan(own, halo, n), None


def table_halo_plans(problem, n, log=None):
    """Halo plans of the REDUCED tables (rig, and the calibration tables) for
    n tile-sharded ranks: {group: PointHaloPlan}. Each rank's row support
    comes from the whole padded layout: a blocked batch addresses rig rows
    [tile base, base + rb) (window rows [cal base, base + wb)); a generic
    batch's index arrays cut evenly along the factor axis. A group whose
    support is not banded or wide enough keeps the all-reduce (the reason
    logged through `log`, default print); an empty or fully constant table
    gets no plan."""
    emit = log or print
    targets = (fct.RIG, fct.CAM_INTR, fct.CAM_EXTR, fct.IMU_CALIB, fct.IMU_EXTR)
    v = problem.variables
    table_rows = {fct.RIG: int(v.pose_q.shape[0]), fct.CAM_INTR: int(v.cam_intr.shape[0]),
                  fct.CAM_EXTR: int(v.cam_extr_q.shape[0]),
                  fct.IMU_CALIB: int(v.imu_calib.shape[0]),
                  fct.IMU_EXTR: int(v.imu_extr_q.shape[0])}
    lo = {g: np.full(n, table_rows[g], np.int64) for g in targets}
    hi = {g: np.zeros(n, np.int64) for g in targets}
    for cfg, data in zip(problem.cfgs, problem.datas):
        info = cfg.block_info
        if info is not None:
            nt = info.nt
            if nt % n:
                for g in targets:
                    lo[g][:] = 0
                    hi[g][:] = table_rows[g]
                break
            per = nt // n
            pad_tile = (_np(data["_pad"]).reshape(nt, -1) > 0.5).all(axis=1)
            rb_base = _np(data["_rb_base"]).astype(np.int64)
            cb_base = _np(data["_cb_base"]).astype(np.int64) if "_cb_base" in data else None
            for s in range(n):
                sl = slice(s * per, (s + 1) * per)
                real = ~pad_tile[sl]
                if not real.any():
                    continue
                rbs = rb_base[sl][real]
                lo[fct.RIG][s] = min(lo[fct.RIG][s], int(rbs.min()))
                hi[fct.RIG][s] = max(hi[fct.RIG][s], int(rbs.max()) + info.rb)
                if cb_base is not None and info.wb > 0:
                    cbs = cb_base[sl][real]
                    for g in (fct.CAM_INTR, fct.CAM_EXTR):
                        lo[g][s] = min(lo[g][s], int(cbs.min()))
                        hi[g][s] = max(hi[g][s], int(cbs.max()) + info.wb)
            continue
        for group, field in fct.REGISTRY[cfg.kind]["tangents"]:
            if group not in targets or field is None or field not in data:
                continue
            idx = _np(data[field]).astype(np.int64)
            if idx.shape[0] % n:
                # a batch not cut evenly (shard_blocked_problem pads to n | size)
                lo[group][:] = np.minimum(lo[group], int(idx.min()))
                hi[group][:] = np.maximum(hi[group], int(idx.max()) + 1)
                continue
            per_shard = idx.reshape(n, -1)
            lo[group] = np.minimum(lo[group], per_shard.min(axis=1))
            hi[group] = np.maximum(hi[group], per_shard.max(axis=1) + 1)
    plans = {}
    for g in targets:
        rows = table_rows[g]
        if rows == 0 or not bool(getattr(problem.masks, g).any()):
            continue  # empty or fully constant table: no matvec traffic
        if np.all(hi[g] == 0):
            continue  # no factor touches this table
        plan, reason = _ranges_to_plan(lo[g], hi[g], rows, n)
        if plan is None:
            emit(f"table_halo_plans[{g}]: psum fallback — {reason}")
        else:
            plans[g] = plan
    return plans


def build_sharded_kernels(problem):
    """The iteration callables (k_linearize, k_solve, k_resolve, k_cost,
    k_grad, k_retract, k_assemble, k_step) of a problem sharded by
    shard_blocked_problem or shard_problem: optimizer.iteration_kernels over
    the rank's batches with the problem's mesh, which carries its halo plans,
    so that every table and scalar the JAX package psums is all-reduced.
    Problem._build returns them when `problem.mesh` is set, and optimize()
    runs unchanged on every rank. Raises ValueError when the mesh holds
    another problem's plans (a Mesh serves one sharded problem)."""
    mesh = problem.mesh
    if mesh.pt_plan is not problem.pt_plan or mesh.t_plans is not problem.t_plans:
        raise ValueError("the mesh holds another sharded problem's halo plans: "
                         "shard each problem over a Mesh of its own")
    cfgs = problem.resolve_cfgs()
    return iteration_kernels(cfgs, any(c.block_info is not None for c in cfgs), mesh)


def shard_problem(problem, mesh: Mesh):
    """The generic path over the mesh, for this rank: every batch's layout
    plans dropped (blocked grids and point permutations; `_pad` kept), the
    factor rows padded with zero-weight rows to a multiple of the rank count
    and cut into contiguous spans, the tables copied. The generic
    Schur-reduced engine (engine.solve_step) then all-reduces every factor
    sum. The escape hatch for layouts shard_blocked_problem refuses."""
    n = mesh.size
    cfgs, datas = [], []
    for cfg, data in zip(problem.cfgs, problem.datas):
        data = {k: a for k, a in _host_batch(data).items()
                if not k.startswith("_") or k == "_pad"}
        if cfg.block_info is not None:
            cfg = dataclasses.replace(cfg, block_info=None)
        data = _span(_pad_batch(data, (-_rows(data)) % n), mesh.rank, n)
        cfgs.append(cfg)
        datas.append(_to_device(data, mesh.device))
    problem.cfgs, problem.datas = cfgs, datas
    problem.variables = tables_to(problem.variables, mesh.device)
    problem.masks = tables_to(problem.masks, mesh.device)
    problem.use_blocked_engine = False
    problem.mesh = mesh
    problem.pt_plan, problem.t_plans = None, {}
    mesh.pt_plan, mesh.t_plans = problem.pt_plan, problem.t_plans
    problem._kernels = None
    problem.active_cfgs = None
    return problem
