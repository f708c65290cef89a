"""Preprocessing tool: produce `session_observations.csv` + `vrs_source_info.json`.

Port of `visual_inertial_bundle_adjustment_tpu/tools/save_observations.py`
(numpy only): the same CSV schema, stage checkpointing and outputs, byte for
byte. The tracks CSV is parsed by `np.loadtxt` with the header's column
names (about ten times faster than genfromtxt at a 600 s session's 1.75M
rows), the keyframe and track-length filters are `np.isin`, and the stage
lines carry their seconds. The JAX tool's
`_triangulate_tracks` is not ported: it hands flat (N, ...) observations to
`triangulate_tracks`, which takes (P, T, ...) padded tracks, and raises
(ValueError) on any input; `run()` never calls it (ROADMAP C).

Counterpart of the reference's Python preprocessing pipeline
(tools/save_observations/save_observations.py:382-428 + vendored LaMAria):
MPS trajectory -> keyframe selection -> track triangulation -> observations
CSV with the fixed detector whitening sqrtH = 0.7*I
(save_observations.py:109). Stages checkpoint by output existence, like the
reference's directory-existence checkpointing (save_observations.py:330-375).

Input sources:
  - `--tracks-csv`: pre-extracted feature tracks
    (columns: point_id, capture_timestamp_ns, camera_index, x, y), e.g. from
    any feature tracker. Keyframing and the track-length filter run here.
  - `--vrs` + `--mps-path`: the reference's input. Image decoding and feature
    tracking require `projectaria_tools` + an external tracker; this path is
    gated and reports exactly what is missing (those SDKs are not
    redistributable with this repo).

Usage:
  python -m visual_inertial_bundle_adjustment_tpu_torch.tools.save_observations \
      --trajectory open_loop_trajectory.csv --tracks-csv tracks.csv \
      --calibration factory_calibration.json --output out_dir
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import shutil
import time
from pathlib import Path

import numpy as np

# reference save_observations.py:96-109
CSV_FIELDS = [
    "point_id", "capture_timestamp_ns", "camera_index",
    "projection_base_res_x", "projection_base_res_y",
    "sqrt_h_base_res_00", "sqrt_h_base_res_01",
    "sqrt_h_base_res_10", "sqrt_h_base_res_11",
]
DEFAULT_SQRT_H_BASE_RES = (0.7, 0.0, 0.0, 0.7)


@dataclasses.dataclass
class KeyframeSelectorOptions:
    """LaMAria keyframing thresholds (lamaria/config/options.py:21-24)."""

    max_rotation_deg: float = 20.0
    max_distance_m: float = 1.0
    max_elapsed_ns: int = int(1e9)


def _quat_mul(a, b):
    w1, x1, y1, z1 = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    w2, x2, y2, z2 = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return np.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], -1)


def _quat_conj(q):
    return q * np.array([1.0, -1.0, -1.0, -1.0])


def select_keyframes(timestamps_ns, q_world_rig, t_world_rig,
                     opts: KeyframeSelectorOptions | None = None) -> np.ndarray:
    """Accumulate relative rotation/translation/elapsed-time between
    consecutive frames and emit a keyframe whenever any threshold is crossed
    (lamaria/pipeline/keyframe_selection.py:48-88). Returns selected indices
    (the first frame is always a keyframe)."""
    opts = opts or KeyframeSelectorOptions()
    n = len(timestamps_ns)
    if n == 0:
        return np.zeros(0, np.int64)
    keep = [0]
    acc_rot = 0.0
    acc_dist = 0.0
    acc_dt = 0
    for i in range(1, n):
        dq = _quat_mul(_quat_conj(q_world_rig[i - 1]), q_world_rig[i])
        ang = 2.0 * np.arctan2(np.linalg.norm(dq[1:]), abs(dq[0]))
        acc_rot += np.degrees(ang)
        acc_dist += float(np.linalg.norm(t_world_rig[i] - t_world_rig[i - 1]))
        acc_dt += int(timestamps_ns[i] - timestamps_ns[i - 1])
        if (acc_rot > opts.max_rotation_deg or acc_dist > opts.max_distance_m
                or acc_dt > opts.max_elapsed_ns):
            keep.append(i)
            acc_rot, acc_dist, acc_dt = 0.0, 0.0, 0
    return np.asarray(keep, np.int64)


def write_observations_csv(path, point_id, timestamp_ns, camera_index, xy,
                           sqrt_h=None):
    """Reference CSV schema; timestamps written in microseconds under the
    capture_timestamp_ns column, matching save_observations.py:161 (the
    reference writes `capture_timestamp_ns // 1000` under that header)."""
    path = Path(path)
    n = len(point_id)
    if sqrt_h is None:
        sqrt_h = np.broadcast_to(np.asarray(DEFAULT_SQRT_H_BASE_RES), (n, 4))
    with open(path, "w") as f:
        f.write(",".join(CSV_FIELDS) + "\n")
        ts_us = np.asarray(timestamp_ns, np.int64) // 1000
        for i in range(n):
            f.write(f"{int(point_id[i])},{int(ts_us[i])},{int(camera_index[i])},"
                    f"{xy[i][0]:.6f},{xy[i][1]:.6f},"
                    f"{sqrt_h[i][0]:g},{sqrt_h[i][1]:g},{sqrt_h[i][2]:g},{sqrt_h[i][3]:g}\n")


def write_vrs_source_info(path, camera_ids, imu_ids, source_name="unknown"):
    """Sensor layout JSON (reference save_observations.py:174-202 emits the
    SLAM camera/imu stream labels in index order)."""
    with open(path, "w") as f:
        json.dump({"source": source_name, "camera_ids": list(camera_ids),
                   "imu_ids": list(imu_ids)}, f, indent=2)


# columns parsed as integers (every other column as float64)
_INT_COLUMNS = ("point_id", "capture_timestamp_ns", "capture_timestamp_us", "camera_index")


def _load_tracks_csv(path):
    """(point_id, capture timestamp in ns, camera_index, xy (N, 2)) of a
    tracks CSV: its header names the columns; the timestamp column may be
    `capture_timestamp_ns` or `capture_timestamp_us`, the coordinates
    `projection_base_res_{x,y}` or `x`/`y`."""
    with open(path) as f:
        names = [c.strip() for c in f.readline().strip().split(",")]
    dtype = [(n, np.int64 if n in _INT_COLUMNS else np.float64) for n in names]
    rows = np.loadtxt(path, delimiter=",", skiprows=1, dtype=dtype, ndmin=1)
    ts_field = ("capture_timestamp_ns" if "capture_timestamp_ns" in names
                else "capture_timestamp_us")
    ts = rows[ts_field].astype(np.int64)
    if ts_field == "capture_timestamp_us":
        ts = ts * 1000
    xf = "projection_base_res_x" if "projection_base_res_x" in names else "x"
    yf = "projection_base_res_y" if "projection_base_res_y" in names else "y"
    return (rows["point_id"].astype(np.int64), ts,
            rows["camera_index"].astype(np.int64),
            np.stack([rows[xf], rows[yf]], -1).astype(np.float64))


def run(args) -> Path:
    """The three stages into args.output, each skipped when its output
    exists; each stage's line gives its seconds."""
    timings = {}
    out = Path(args.output)
    out.mkdir(parents=True, exist_ok=True)

    # stage 1: trajectory (copy MPS open-loop into the session dir; a
    # closed-loop trajectory works too — SessionData prefers it anyway)
    src = None
    if args.trajectory:
        src = Path(args.trajectory)
    elif args.mps_path:
        src = Path(args.mps_path) / "slam" / "open_loop_trajectory.csv"
    t0 = time.perf_counter()
    closed = src is not None and "closed_loop" in src.name
    traj_out = out / ("closed_loop_framerate_trajectory.csv" if closed
                      else "open_loop_trajectory.csv")
    if not traj_out.exists():
        if src is None or not src.exists():
            raise SystemExit("need --trajectory (or --mps-path with slam/open_loop_trajectory.csv)")
        shutil.copy(src, traj_out)
        timings["trajectory"] = time.perf_counter() - t0
        print(f"[stage trajectory] {traj_out} ({timings['trajectory']:.2f} s)")
    else:
        print("[stage trajectory] exists, skipping")

    # stage 2: sensor layout
    info_out = out / "vrs_source_info.json"
    t0 = time.perf_counter()
    if not info_out.exists():
        cams = args.camera_ids.split(",") if args.camera_ids else ["camera-slam-left",
                                                                   "camera-slam-right"]
        imus = args.imu_ids.split(",") if args.imu_ids else ["imu-right", "imu-left"]
        write_vrs_source_info(info_out, cams, imus,
                              source_name=str(args.vrs or args.tracks_csv or "tracks"))
        timings["layout"] = time.perf_counter() - t0
        print(f"[stage layout] {info_out} ({timings['layout']:.2f} s)")
    else:
        print("[stage layout] exists, skipping")

    # stage 3: observations (keyframing + triangulation filter)
    obs_out = out / "session_observations.csv"
    if obs_out.exists():
        print("[stage observations] exists, skipping")
        return out
    t0 = time.perf_counter()
    if args.tracks_csv:
        pid, ts_ns, cam, xy = _load_tracks_csv(args.tracks_csv)
        timings["load_tracks"] = time.perf_counter() - t0
    elif args.vrs:
        try:
            import projectaria_tools  # noqa: F401
        except ImportError:
            raise SystemExit(
                "--vrs input needs projectaria_tools (image decoding) and a feature "
                "tracker; neither ships with this repo. Extract feature tracks with "
                "your tracker of choice and pass them via --tracks-csv "
                "(columns: point_id, capture_timestamp_ns, camera_index, x, y).")
        raise SystemExit("VRS feature extraction requires an external tracker; "
                         "use --tracks-csv with pre-extracted tracks.")
    else:
        raise SystemExit("need --tracks-csv or --vrs")

    # keyframe selection on the trajectory
    rows = np.genfromtxt(traj_out, delimiter=",", names=True, dtype=None, encoding="utf-8")
    rows = np.atleast_1d(rows)
    traj_ts_ns = rows["tracking_timestamp_us"].astype(np.int64) * 1000
    frame = "world" if closed else "odometry"
    q = np.stack([rows[f"q{a}_{frame}_device"] for a in "wxyz"], -1)
    t = np.stack([rows[f"t{a}_{frame}_device"] for a in "xyz"], -1)
    opts = KeyframeSelectorOptions(args.kf_max_rotation, args.kf_max_distance,
                                   int(args.kf_max_elapsed * 1e9))
    kf = select_keyframes(traj_ts_ns, q, t, opts)
    kf_ts = traj_ts_ns[kf]
    print(f"[stage observations] {len(kf)}/{len(traj_ts_ns)} keyframes")

    # snap observation timestamps to trajectory timestamps (exact match model,
    # like the reference's rig matching, Matcher.cpp:19-59), keep keyframes.
    # The reference writes microseconds under a *_ns header
    # (save_observations.py:161) — normalize scale against the trajectory.
    traj_set = set(traj_ts_ns.tolist())

    def match_count(arr):
        return sum(1 for x in arr[: min(200, len(arr))] if int(x) in traj_set)
    best = max(((sc, match_count(ts_ns // sc)) for sc in (1, 1000, 1_000_000)),
               key=lambda p: p[1])
    if best[1] == 0:
        raise SystemExit("observation timestamps match no trajectory frames")
    ts_ns = ts_ns // best[0]
    keep = np.isin(ts_ns, kf_ts)
    pid, ts_ns, cam, xy = pid[keep], ts_ns[keep], cam[keep], xy[keep]

    # min track length filter (InitPointTracks.cpp:17-65: >= 3 observations)
    uniq, counts = np.unique(pid, return_counts=True)
    keep = np.isin(pid, uniq[counts >= 3])
    pid, ts_ns, cam, xy = pid[keep], ts_ns[keep], cam[keep], xy[keep]
    timings["filter"] = time.perf_counter() - t0 - timings.get("load_tracks", 0.0)

    t0 = time.perf_counter()
    write_observations_csv(obs_out, pid, ts_ns, cam, xy)
    timings["write"] = time.perf_counter() - t0
    print(f"[stage observations] {obs_out}: {len(pid)} observations, "
          f"{len(np.unique(pid))} tracks ({timings.get('load_tracks', 0.0):.2f} s load, "
          f"{timings['filter']:.2f} s keyframes and filters, {timings['write']:.2f} s write)")
    return out


def build_arg_parser():
    p = argparse.ArgumentParser(
        description="Produce session_observations.csv + vrs_source_info.json "
                    "(reference tools/save_observations)")
    p.add_argument("--vrs", help="Aria VRS recording (gated: needs projectaria_tools)")
    p.add_argument("--mps-path", help="MPS output dir (slam/open_loop_trajectory.csv)")
    p.add_argument("--trajectory", help="open_loop_trajectory.csv (MPS format)")
    p.add_argument("--tracks-csv", help="pre-extracted feature tracks CSV")
    p.add_argument("--output", required=True)
    p.add_argument("--camera-ids", help="comma-separated SLAM camera stream labels")
    p.add_argument("--imu-ids", help="comma-separated SLAM imu stream labels")
    p.add_argument("--kf-max-rotation", type=float, default=20.0, help="deg")
    p.add_argument("--kf-max-distance", type=float, default=1.0, help="m")
    p.add_argument("--kf-max-elapsed", type=float, default=1.0, help="s")
    return p


def main(argv=None):
    run(build_arg_parser().parse_args(argv))


if __name__ == "__main__":
    main()
