"""Live optimization monitoring: per-iteration data, background runner, dashboard.

Port of `visual_inertial_bundle_adjustment_tpu/utils/monitoring.py`, the
replacement for the reference GUI pipeline
(interfaces/ark/main_AriaKit_ViBa_GUI.cpp:104-130 + gui/MonitoringState.h:20-100):
the reference runs the optimization in a std::thread and publishes
`IterationData` (cost, lambda, per-factor-type residual percentiles,
trajectory + point-cloud snapshots, per-rig calibration curves) into a
mutex-guarded `MonitoringState` rendered by a sokol/ImGui/ImPlot window.

Here the same data flows through `Monitor` (thread-safe) with two sinks
instead of a window: a JSONL stream and a self-contained HTML dashboard
(inline SVG: cost/damping curves, residual percentile bands, top-down + side
trajectory views with the point cloud). Snapshots copy the device tables to
the host once each.

Divergence from the JAX package, whose residual_percentiles keeps only the
padded slots of a blocked batch (`ok &= _pad > 0.5`): here only the real
slots count (`_pad < 0.5`).
"""

from __future__ import annotations

import dataclasses
import html as _html
import json
import os
import threading
import time
from typing import Optional

import numpy as np
import torch


def _host(a):
    """A device tensor (or array) as host numpy."""
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


@dataclasses.dataclass
class IterationData:
    """One LM iteration's monitoring payload (gui/MonitoringState.h:20-61)."""

    iteration: int = 0
    cost: float = 0.0
    prev_cost: float = 0.0
    damping: float = 0.0
    accepted: bool = True
    model_cost_reduction: float = 0.0
    applied_step_factor: float = 1.0
    pcg_iters: int = 0
    pcg_rel_residual: float = 0.0
    grad_norm: float = 0.0
    step_norm: float = 0.0
    num_failing: int = 0
    num_failing_prev: int = 0
    num_optional_total: int = 0
    iter_time_sec: float = 0.0
    # per-factor-class residual percentiles {label: {p50, p90, p99}}
    residual_percentiles: dict = dataclasses.field(default_factory=dict)
    # optional snapshots (decimated)
    trajectory: Optional[np.ndarray] = None  # (R', 3) positions
    points: Optional[np.ndarray] = None  # (L', 3)
    # per-window calibration curves {series name: [value per window]}
    # (reference RigCalibration, gui/MonitoringState.h:47-61)
    calib_curves: dict = dataclasses.field(default_factory=dict)

    def to_json(self):
        d = dataclasses.asdict(self)
        for k in ("trajectory", "points"):
            if d[k] is not None:
                d[k] = np.asarray(d[k]).round(4).tolist()
        d["calib_curves"] = {
            k: np.asarray(v, float).round(8).tolist()
            for k, v in d["calib_curves"].items()
        }
        return d


class Monitor:
    """Thread-safe monitoring state (reference MonitoringState, mutex-guarded).

    Use as `settings.iteration_callback = monitor.make_callback(problem)`.
    `snapshot_every` controls how often trajectory/point-cloud snapshots and
    residual percentiles are captured (they cost one residual evaluation).
    """

    def __init__(self, snapshot_every: int = 5, jsonl_path: Optional[str] = None,
                 keep_snapshots: int = 4, max_traj: int = 4000, max_points: int = 5000,
                 html_path: Optional[str] = None, html_every: int = 5):
        self._lock = threading.Lock()
        self.iterations: list[IterationData] = []
        self.snapshot_every = snapshot_every
        self.keep_snapshots = keep_snapshots
        self.max_traj = max_traj
        self.max_points = max_points
        self.jsonl_path = jsonl_path
        # live dashboard: rewrite the HTML artifact every html_every
        # iterations DURING the run (the reference GUI's value is watching a
        # 250-iteration run live, gui/MonitoringState.h:20-100; here the
        # watchable artifact is a file whose mtime advances)
        self.html_path = html_path
        self.html_every = html_every
        self.done = False
        self.summary = None
        self._t0 = time.time()
        # sensor layout of the calib tables (set_calib_layout); None disables
        # the per-window calibration curves
        self._calib_layout = None
        self.problem_stats = {}

    def set_calib_layout(self, num_cams: int, num_imus: int,
                         window_ts_sec=None):
        """Declare how calib-table rows map to sensors: row = w*nSensors+s
        (pipeline/adapter.py window layout). Enables per-window calibration
        curves in snapshots (reference RigCalibration temporal-variation
        plots, gui/MonitoringState.h:47-61)."""
        self._calib_layout = (int(num_cams), int(num_imus),
                              None if window_ts_sec is None
                              else np.asarray(window_ts_sec, float))

    def set_problem_stats(self, **stats):
        """Reference MonitoringState::setProblemStats (sizes shown in the
        dashboard header)."""
        with self._lock:
            self.problem_stats = dict(stats)

    # -- producer side ------------------------------------------------------

    def make_callback(self, problem):
        def cb(info: dict):
            it = IterationData(**{k: v for k, v in info.items()
                                  if k in {f.name for f in dataclasses.fields(IterationData)}})
            if self.snapshot_every and (it.iteration - 1) % self.snapshot_every == 0:
                self._capture(problem, it)
            self.publish(it)
        return cb

    def _capture(self, problem, it: IterationData):
        v = problem.variables
        traj = _host(v.pose_t)
        pts = _host(v.points)
        if traj.shape[0] > self.max_traj:
            traj = traj[:: traj.shape[0] // self.max_traj + 1]
        if pts.shape[0] > self.max_points:
            pts = pts[:: pts.shape[0] // self.max_points + 1]
        # world positions of the device: pose is T_bodyImu_world => invert
        it.trajectory = traj
        it.points = pts
        it.residual_percentiles = residual_percentiles(problem)
        if self._calib_layout is not None:
            it.calib_curves = calib_curves(v, *self._calib_layout)

    def publish(self, it: IterationData):
        with self._lock:
            # drop old snapshots beyond keep_snapshots (memory bound)
            snaps = [d for d in self.iterations if d.trajectory is not None]
            while len(snaps) >= self.keep_snapshots:
                snaps[0].trajectory = None
                snaps[0].points = None
                snaps.pop(0)
            self.iterations.append(it)
        if self.jsonl_path:
            with open(self.jsonl_path, "a") as f:
                f.write(json.dumps(it.to_json()) + "\n")
        if self.html_path and self.html_every and \
                it.iteration % self.html_every == 0:
            render_html(self, self.html_path)

    def finish(self, summary):
        with self._lock:
            self.done = True
            self.summary = summary
        if self.html_path:
            render_html(self, self.html_path)

    # -- consumer side ------------------------------------------------------

    def latest(self) -> Optional[IterationData]:
        with self._lock:
            return self.iterations[-1] if self.iterations else None

    def curve(self, field: str):
        with self._lock:
            return [(d.iteration, getattr(d, field)) for d in self.iterations]


def calib_curves(v, num_cams: int, num_imus: int, window_ts=None):
    """Per-window calibration series from the flat calib tables.

    Mirrors the reference GUI's RigCalibration content
    (gui/MonitoringState.h:47-61): per-IMU accel/gyro bias and time offsets,
    per-camera focal length and time offset, camera baseline distances. Rows
    of each table follow the adapter's (window, sensor) layout
    row = w*nSensors + s (pipeline/adapter.py)."""
    from ..models import imu as imu_model

    out = {}
    ic = _host(v.imu_calib)
    if ic.size and num_imus > 0 and ic.shape[0] % num_imus == 0:
        W = ic.shape[0] // num_imus
        for i in range(num_imus):
            rows = ic[np.arange(W) * num_imus + i]
            out[f"imu{i} gyro bias [rad/s]"] = np.linalg.norm(
                rows[:, imu_model.GYRO_BIAS], axis=-1)
            out[f"imu{i} accel bias [m/s^2]"] = np.linalg.norm(
                rows[:, imu_model.ACCEL_BIAS], axis=-1)
            out[f"imu{i} dt ref-gyro [ms]"] = rows[:, imu_model.DT_REF_GYRO] * 1e3
            out[f"imu{i} dt ref-accel [ms]"] = rows[:, imu_model.DT_REF_ACCEL] * 1e3
    intr = _host(v.cam_intr)
    if intr.size and num_cams > 0 and intr.shape[0] % num_cams == 0:
        W = intr.shape[0] // num_cams
        for c in range(num_cams):
            rows = intr[np.arange(W) * num_cams + c]
            out[f"cam{c} focal [px]"] = rows[:, 0]
            out[f"cam{c} time offset [ms]"] = rows[:, 16] * 1e3
            out[f"cam{c} readout [ms]"] = rows[:, 15] * 1e3
    ext_t = _host(v.cam_extr_t)
    if ext_t.size and num_cams > 1 and ext_t.shape[0] % num_cams == 0:
        W = ext_t.shape[0] // num_cams
        for c1 in range(num_cams):
            for c2 in range(c1 + 1, num_cams):
                d = np.linalg.norm(
                    ext_t[np.arange(W) * num_cams + c1]
                    - ext_t[np.arange(W) * num_cams + c2], axis=-1)
                out[f"baseline cam{c1}-cam{c2} [m]"] = d
    if window_ts is not None:
        out["_window_ts_sec"] = np.asarray(window_ts, float)
    return out


def residual_percentiles(problem, percentiles=(50, 90, 99)):
    """Per-factor-class whitened-residual percentiles over the real slots
    (the GUI's per-type percentile curves, gui/MonitoringState.h:34-38)."""
    from ..problem import histograms

    out = {}
    for cfg, res, ok in histograms.residuals(problem):
        mag = np.linalg.norm(res[ok], axis=-1)
        if mag.size:
            out[cfg.label or cfg.kind] = {
                f"p{p}": float(np.percentile(mag, p)) for p in percentiles
            }
    return out


def optimize_in_background(problem, settings, monitor: Monitor):
    """Run the optimization in a thread, publishing per-iteration data —
    the reference GUI's worker-thread pattern (main_AriaKit_ViBa_GUI.cpp:104).
    Returns the Thread (started); result lands in monitor.summary."""
    from ..problem.optimizer import optimize

    settings.iteration_callback = monitor.make_callback(problem)

    def run():
        summary = optimize(problem, settings)
        monitor.finish(summary)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t


# ---------------------------------------------------------------------------
# Self-contained HTML dashboard
# ---------------------------------------------------------------------------


def _svg_polyline(xs, ys, w, h, color, stroke=1.4, logy=False, label=""):
    xs = np.asarray(xs, float)
    ys = np.asarray(ys, float)
    if logy:
        ys = np.log10(np.maximum(ys, 1e-30))
    if xs.size < 2:
        return ""
    x0, x1 = xs.min(), max(xs.max(), xs.min() + 1e-9)
    y0, y1 = ys.min(), max(ys.max(), ys.min() + 1e-9)
    px = (xs - x0) / (x1 - x0) * (w - 20) + 10
    py = h - 10 - (ys - y0) / (y1 - y0) * (h - 20)
    pts = " ".join(f"{a:.1f},{b:.1f}" for a, b in zip(px, py))
    return (f'<polyline points="{pts}" fill="none" stroke="{color}" '
            f'stroke-width="{stroke}"><title>{_html.escape(label)}</title></polyline>')


def _svg_scatter(xy, w, h, color, r=1.0):
    xy = np.asarray(xy, float)
    if xy.shape[0] < 2:
        return ""
    lo = np.percentile(xy, 2, axis=0)
    hi = np.percentile(xy, 98, axis=0)
    span = np.maximum(hi - lo, 1e-9)
    p = (xy - lo) / span
    p = np.clip(p, -0.2, 1.2)
    out = []
    for a, b in p:
        out.append(f'<circle cx="{a*(w-20)+10:.1f}" cy="{h-10-b*(h-20):.1f}" '
                   f'r="{r}" fill="{color}" fill-opacity="0.5"/>')
    return "".join(out)


def _panel(title, body, w, h):
    return (f'<div class="panel"><h3>{_html.escape(title)}</h3>'
            f'<svg width="{w}" height="{h}" style="background:#14171c">{body}</svg></div>')


def render_html(monitor: Monitor, path: str, title="VI-BA optimization"):
    """Write a single-file dashboard: cost/λ curves, per-class residual
    percentiles, trajectory top/side views + point cloud."""
    with monitor._lock:
        its = list(monitor.iterations)
        summary = monitor.summary
        pstats = dict(monitor.problem_stats)
    W, H = 460, 240
    panels = []
    if its:
        ii = [d.iteration for d in its]
        panels.append(_panel(
            "cost (log10)", _svg_polyline(ii, [d.cost for d in its], W, H, "#6fb3ff",
                                          logy=True, label="cost"), W, H))
        panels.append(_panel(
            "damping λ (log10)", _svg_polyline(ii, [max(d.damping, 1e-12) for d in its], W, H,
                                               "#ffb366", logy=True, label="lambda"), W, H))
        # residual percentile curves per class
        classes = {}
        for d in its:
            for lbl, ps in d.residual_percentiles.items():
                classes.setdefault(lbl, []).append((d.iteration, ps))
        colors = ["#7dd87d", "#ff8080", "#c39cff", "#ffd166", "#66e0d0", "#f49ac2"]
        for ci, (lbl, series) in enumerate(sorted(classes.items())):
            body = ""
            for pi, p in enumerate(("p50", "p90", "p99")):
                body += _svg_polyline([s[0] for s in series], [s[1][p] for s in series],
                                      W, H, colors[(ci + pi) % len(colors)],
                                      stroke=1.0 + pi * 0.5, logy=True, label=f"{lbl} {p}")
            panels.append(_panel(f"residuals: {lbl} (p50/p90/p99, log10)", body, W, H))
        snap = next((d for d in reversed(its) if d.trajectory is not None), None)
        if snap is not None:
            for (a, b), name in (((0, 1), "top view (x,y)"), ((0, 2), "side view (x,z)")):
                body = ""
                if snap.points is not None:
                    body += _svg_scatter(np.asarray(snap.points)[:, [a, b]], W, H, "#556070")
                body += _svg_polyline(np.asarray(snap.trajectory)[:, a],
                                      np.asarray(snap.trajectory)[:, b],
                                      W, H, "#6fb3ff", logy=False, label="trajectory")
                panels.append(_panel(name, body, W, H))
        # per-window calibration curves, grouped by quantity (one curve per
        # sensor; x axis = window time if known, else window index)
        csnap = next((d for d in reversed(its) if d.calib_curves), None)
        if csnap is not None:
            curves = dict(csnap.calib_curves)
            ts = curves.pop("_window_ts_sec", None)
            groups = {}
            for name, ys in curves.items():
                quantity = name.split(" ", 1)[-1] if " " in name else name
                groups.setdefault(quantity, []).append((name, ys))
            for qi, (quantity, series) in enumerate(sorted(groups.items())):
                body = ""
                for si, (name, ys) in enumerate(series):
                    ys = np.asarray(ys, float)
                    xs = ts[: len(ys)] if ts is not None and len(ts) >= len(ys) \
                        else np.arange(len(ys))
                    body += _svg_polyline(xs, ys, W, H,
                                          colors[(qi + si) % len(colors)],
                                          label=name)
                panels.append(_panel(f"calib: {quantity}", body, W, H))
    stats_line = ""
    if pstats:
        stats_line = ("<p>" + " · ".join(
            f"{_html.escape(str(k))}: {_html.escape(str(v))}"
            for k, v in pstats.items()) + "</p>")
    footer = ""
    if summary is not None:
        footer = (f"<p>finished: cost {summary.initial_cost:.6g} → {summary.final_cost:.6g} "
                  f"in {summary.num_iterations} iterations</p>")
    doc = f"""<!doctype html><html><head><meta charset="utf-8">
<title>{_html.escape(title)}</title><style>
body{{background:#0d0f12;color:#dde3ea;font-family:system-ui,sans-serif;margin:16px}}
.panel{{display:inline-block;margin:6px;vertical-align:top}}
h3{{font-size:13px;font-weight:500;margin:2px 0 4px 2px;color:#9aa7b5}}
</style></head><body><h2>{_html.escape(title)}</h2>
{stats_line}{"".join(panels)}{footer}</body></html>"""
    # atomic replace: a live watcher (the point of --monitor-html) must never
    # read a truncated file mid-write
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        f.write(doc)
    os.replace(tmp, path)
    return path
