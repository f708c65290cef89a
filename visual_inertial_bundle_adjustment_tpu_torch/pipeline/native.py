"""ctypes bindings of the C++ CSV parsers (csrc/fastcsv.cpp).

Port of `visual_inertial_bundle_adjustment_tpu/pipeline/native.py`. The
source is compiled with `g++ -O3` at first use into the package's `_build/`
(listed in .gitignore); the library name carries a hash of the source, so an
edit rebuilds. A failed build raises, and so does a malformed row (a field
missing or too many, a text field, a trailing comma), as np.loadtxt does:
there is no numpy fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
SRC = _PKG / "csrc" / "fastcsv.cpp"
BUILD_DIR = _PKG / "_build"

_lib = None
_lock = threading.Lock()
_LL, _D, _I = ctypes.c_longlong, ctypes.c_double, ctypes.c_int
_PTR = ctypes.POINTER
# C entry points: name -> (restype, argtypes)
_SIGNATURES = {
    "imu_csv_count": (ctypes.c_long, [ctypes.c_char_p]),
    "imu_csv_parse": (_I, [ctypes.c_char_p, ctypes.c_long, _PTR(_LL), _PTR(_D), _PTR(_D)]),
    "obs_csv_count": (ctypes.c_long, [ctypes.c_char_p]),
    "obs_csv_parse": (_I, [ctypes.c_char_p, ctypes.c_long, _PTR(_LL), _PTR(_LL), _PTR(_I),
                           _PTR(_D), _PTR(_D)]),
    "num_csv_count": (ctypes.c_long, [ctypes.c_char_p]),
    "num_csv_parse": (_I, [ctypes.c_char_p, ctypes.c_long, _I, _PTR(_D)]),
}


def library_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libfastcsv-{digest}.so"


def lib():
    """The loaded parser library, built first if needed (raises on failure)."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            try:
                res = subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17", str(SRC),
                                      "-o", tmp], capture_output=True, text=True, timeout=300)
                if res.returncode != 0:
                    raise RuntimeError(f"g++ failed to build {SRC.name}:\n{res.stderr}")
                os.replace(tmp, path)  # atomic: concurrent builds agree
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        handle = ctypes.CDLL(str(path))
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.restype, fn.argtypes = restype, argtypes
        _lib = handle
        return _lib


def _ptr(a, ct):
    return a.ctypes.data_as(_PTR(ct))


def _count(fn, path):
    n = fn(str(path).encode())
    if n < 0:
        raise OSError(f"cannot read {path}")
    return n


def parse_imu_csv(path):
    """(times_ns int64 (N,), gyro (N, 3), accel (N, 3)) of an EuRoC IMU CSV."""
    h = lib()
    n = _count(h.imu_csv_count, path)
    t = np.empty(n, np.int64)
    g = np.empty((n, 3), np.float64)
    a = np.empty((n, 3), np.float64)
    if h.imu_csv_parse(str(path).encode(), n, _ptr(t, _LL), _ptr(g, _D), _ptr(a, _D)) != 0:
        raise ValueError(f"malformed IMU CSV {path}")
    return t, g, a


def parse_obs_csv(path):
    """(point_id, timestamp (second column, as written), camera_index, uv
    (N, 2), sqrt_h (N, 2, 2)) of a session_observations.csv whose columns
    come in the writer's order."""
    h = lib()
    n = _count(h.obs_csv_count, path)
    pid = np.empty(n, np.int64)
    ts = np.empty(n, np.int64)
    cam = np.empty(n, np.int32)
    uv = np.empty((n, 2), np.float64)
    sh = np.empty((n, 4), np.float64)
    if h.obs_csv_parse(str(path).encode(), n, _ptr(pid, _LL), _ptr(ts, _LL), _ptr(cam, _I),
                       _ptr(uv, _D), _ptr(sh, _D)) != 0:
        raise ValueError(f"malformed observations CSV {path}")
    return pid, ts, cam, uv, sh.reshape(-1, 2, 2)


def parse_numeric_csv(path, n_cols):
    """Row-major float64 (N, n_cols) matrix of the first n_cols columns of a
    CSV with one header line. Each of those fields must hold a number: a
    row with fewer fields or a text field among them raises ValueError. The
    JAX package's parser reads a text field as 0.0 and returns None where
    this one raises."""
    h = lib()
    n = _count(h.num_csv_count, path)
    out = np.empty((n, n_cols), np.float64)
    if h.num_csv_parse(str(path).encode(), n, n_cols, _ptr(out, _D)) != 0:
        raise ValueError(f"malformed numeric CSV {path}")
    return out
