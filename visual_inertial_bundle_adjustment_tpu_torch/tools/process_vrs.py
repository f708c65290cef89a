"""Extract `factory_calibration.json` + `imu_samples_<label>.csv` from a VRS.

Port of `visual_inertial_bundle_adjustment_tpu/tools/process_vrs.py` (the
standard library only; the same CSV schema, gate and messages).
Counterpart of the reference `process_vrs` executable
(interfaces/ark/main_ProcessVRS.cpp:29-99): open the VRS recording, dump the
device factory calibration as JSON, and write one EuRoC-style IMU CSV per IMU
stream (column schema lib/motion/imu_types/ImuDataFormat.h:14-23, writer
ImuDataWriter.cpp:13-41).

VRS decoding itself is only available through the `projectaria_tools` SDK,
which is not redistributable with this repo; the tool is gated on its
presence and reports exactly what is missing otherwise (same policy as
tools/save_observations.py's --vrs path).

Usage:
  python -m visual_inertial_bundle_adjustment_tpu_torch.tools.process_vrs \
      -i recording.vrs -o out_dir
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

# reference imu_types/ImuDataFormat.h:14-23
IMU_CSV_HEADER = (
    "#timestamp [ns], temperature [degC], "
    "w_RS_S_x [rad s^-1], w_RS_S_y [rad s^-1], w_RS_S_z [rad s^-1], "
    "a_RS_S_x [m s^-2], a_RS_S_y [m s^-2], a_RS_S_z [m s^-2]"
)


def write_imu_csv(path, rows):
    """rows: iterable of (timestamp_ns, temperature_c, gyro3, accel3).

    Matches reference ImuDataWriter::write (fixed 7-decimal floats,
    ImuDataWriter.cpp:27-41)."""
    with open(path, "w") as f:
        f.write(IMU_CSV_HEADER + "\n")
        for ts, temp, gyro, accel in rows:
            vals = [f"{float(v):.7f}" for v in (temp, *gyro, *accel)]
            f.write(f"{int(ts)}, " + ", ".join(vals) + "\n")


def process_vrs(vrs_path: Path, out_dir: Path) -> dict:
    """Extract calibration + IMU streams; returns per-stream sample counts."""
    try:
        from projectaria_tools.core import data_provider  # noqa: PLC0415
        from projectaria_tools.core.calibration import (  # noqa: PLC0415
            device_calibration_to_json_string,
        )
        from projectaria_tools.core.sensor_data import (  # noqa: PLC0415
            SensorDataType,
        )
    except ImportError as e:
        raise SystemExit(
            "process_vrs requires the projectaria_tools SDK for VRS decoding "
            f"(not installed: {e}).\nIf the recording was already processed, "
            "point the pipeline at the existing session directory instead."
        ) from e

    provider = data_provider.create_vrs_data_provider(str(vrs_path))
    if provider is None:
        raise SystemExit(f"Error, unable to open: {vrs_path}")
    out_dir.mkdir(parents=True, exist_ok=True)

    # factory calibration JSON (main_ProcessVRS.cpp:69-76)
    calib = provider.get_device_calibration()
    if calib is not None:
        (out_dir / "factory_calibration.json").write_text(
            device_calibration_to_json_string(calib)
        )
        print("Got device calib!")
    else:
        print("No device calib...")

    # one CSV per IMU stream, keyed by stream label (main_ProcessVRS.cpp:48-66)
    counts = {}
    for sid in provider.get_all_streams():
        label = provider.get_label_from_stream_id(sid) or "<none>"
        print(f"Stream {sid}: {label}")
        if provider.get_sensor_data_type(sid) != SensorDataType.IMU:
            continue
        n = provider.get_num_data(sid)
        rows = []
        for i in range(n):
            m = provider.get_imu_data_by_index(sid, i)
            rows.append(
                (m.capture_timestamp_ns, m.temperature, m.gyro_radsec, m.accel_msec2)
            )
        write_imu_csv(out_dir / f"imu_samples_{label}.csv", rows)
        counts[label] = len(rows)
    print(f"imu samples per stream: {counts}")
    return counts


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Process VRS extracting IMU + FactoryCalibration"
    )
    p.add_argument("-i", "--in", dest="vrs_in", required=True, help="VRS input")
    p.add_argument(
        "-o", "--out", dest="out", required=True,
        help="Output directory path (will be created)",
    )
    args = p.parse_args(argv)
    process_vrs(Path(args.vrs_in), Path(args.out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
