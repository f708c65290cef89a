"""Build, load and dispatch the port's CUDA kernels.

The CUDA C++ sources in `csrc/` are compiled with `nvcc` for Hopper
(`-gencode arch=compute_90a,code=sm_90a`), one `nvcc` per source, all
started together, and linked into one shared library with a plain C
interface under `_build/` (listed in .gitignore), at first use; the library
name carries a hash of the sources, so an edit rebuilds. A failed build
raises. ptxas's per-kernel resource report (registers, spills) is kept next
to the library (`resource_usage()`). Nothing but the repository's sources
and the CUDA toolkit is used. The library is loaded with ctypes; every C
entry point returns the `cudaError_t` of its launch, and a nonzero code
raises.

Dispatch rule shared by every kernel wrapper: a CPU tensor takes the plain
PyTorch version; a CUDA tensor launches the kernel (or raises). The only
way a CUDA tensor reaches a plain version is inside `plain_reference()`,
which the on-card comparisons use on purpose.

TF32 stays off for every float32 product on the card (the TPU analogue,
default-precision dots, cost 2e-3 of Jacobian error).
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry points: name -> argument types (pointers and the stream as void*)
_SIGNATURES = {
    "viba_visual_linearize": [_I] * 3 + [_P] * 22 + [_P],
    "viba_assemble_rig": [_I] * 4 + [_P] * 13 + [_P],
    "viba_precond_rig": [_I] * 4 + [_P] * 8 + [_P],
    "viba_schur_down": [_I] * 7 + [_P] * 12 + [_P],
    "viba_schur_up": [_I] * 4 + [_P] * 8 + [_P],
    "viba_schur_pcg": [_I] * 6 + [_P] * 14 + [_P],
    "viba_schur_pcg_cols": [_I] * 5 + [_P] * 8 + [_P],
    "viba_rs_linearize": [_I] * 6 + [_P] * 34 + [_P],
    "viba_assemble_cal": [_I] * 7 + [_P] * 22 + [_P],
    "viba_schur_down_cal": [_I] * 9 + [_P] * 20 + [_P],
    "viba_schur_up_cal": [_I] * 6 + [_P] * 14 + [_P],
    "viba_schur_pcg_cal": [_I] * 8 + [_P] * 22 + [_P],
    "viba_schur_pcg_cal_cols": [_I] * 7 + [_P] * 14 + [_P],
    "viba_visual_cal_linearize": [_I] * 2 + [_P] * 25 + [_P],
    "viba_seg_mv_fused": [_I] * 5 + [_P] * 10 + [_P],
    "viba_seg_mv_scatter": [_I] * 5 + [_P] * 7 + [_P],
    "viba_seg_mv_scatter_slot_major": [_I] * 2 + [_P] * 6 + [_P],
    "viba_seg_mv_gather": [_I] * 2 + [_P] * 4 + [_P],
    "viba_seg_reduce": [_I] * 5 + [_P] * 6 + [_P],
    "viba_seg_reduce_slot_major": [_I] * 3 + [_P] * 5 + [_P],
    "viba_tile_reduce": [_I] * 4 + [_P] * 5 + [_P],
    "viba_tile_gather": [_I] * 4 + [_P] * 3 + [_P],
    "viba_tile_mv_fused": [_I] * 4 + [_P] * 9 + [_P],
    "viba_tile_mv_gather": [_I] * 4 + [_P] * 4 + [_P],
    "viba_tile_mv_scatter": [_I] * 4 + [_P] * 6 + [_P],
}

_state = threading.local()
_lib = None
_lib_lock = threading.Lock()
# wrappers that launch a kernel, by kernel name (each has a `launches`
# count, and `bf16_launches`, those of its launches that read bf16 J)
WRAPPERS: dict = {}


def register(name):
    """Mark `fn` as the wrapper of kernel `name` and give it its launch
    counts."""

    def deco(fn):
        fn.launches = fn.bf16_launches = 0
        WRAPPERS[name] = fn
        return fn

    return deco


def reset_launch_counts():
    for fn in WRAPPERS.values():
        fn.launches = fn.bf16_launches = 0


def launch_counts(bf16=False) -> dict:
    """Launches by kernel name since the last reset (bf16: only those that
    read bf16 Jacobians, the instantiations of rcs.MATVEC_BF16)."""
    return {name: fn.bf16_launches if bf16 else fn.launches for name, fn in WRAPPERS.items()}


@contextlib.contextmanager
def plain_reference():
    """Route CUDA tensors through the plain PyTorch versions (for comparing
    kernels with their references on the card; launches are not counted)."""
    prev = getattr(_state, "plain", False)
    _state.plain = True
    try:
        yield
    finally:
        _state.plain = prev


def to_f64(x):
    """The same inputs in float64, for evaluating a plain version as the
    reference of its kernel: float tensors cast, index tensors and other
    values kept, through NamedTuples, dicts, tuples and lists."""
    if isinstance(x, torch.Tensor):
        return x.double() if x.is_floating_point() else x
    if isinstance(x, dict):
        return {k: to_f64(a) for k, a in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(to_f64(a) for a in x))
    if isinstance(x, (tuple, list)):
        return type(x)(to_f64(a) for a in x)
    return x


def on_card(t: torch.Tensor) -> bool:
    """True when `t` lives on a CUDA device and the kernel must launch."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    return not getattr(_state, "plain", False)


def _sources():
    return sorted(list(CSRC.glob("*.cu")) + list(CSRC.glob("*.cuh")))


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (CUDA_HOME, /usr/local/cuda, PATH)")
    return found


def library_path() -> Path:
    h = hashlib.sha256()
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libviba_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/*.cu (one nvcc per source, in parallel) and link the
    shared library, unless it is up to date."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    nvcc = _nvcc()
    procs = []
    for src in (p for p in _sources() if p.suffix == ".cu"):
        obj = work / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.PIPE, text=True)))
    log, failed = [], []
    for src, _, proc in procs:
        stdout, stderr = proc.communicate()
        log.append(f"== {src.name}\n{stdout}{stderr}")
        if proc.returncode != 0:
            failed.append(f"{src.name} ({proc.returncode}):\n{stderr}")
    if failed:
        shutil.rmtree(work, ignore_errors=True)
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    tmp = work / "lib.so"
    link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *(str(o) for _, o, _ in procs)],
                          capture_output=True, text=True)
    if link.returncode != 0:
        shutil.rmtree(work, ignore_errors=True)
        raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stderr}")
    out.with_suffix(".log").write_text("\n".join(log))
    os.replace(tmp, out)
    shutil.rmtree(work, ignore_errors=True)
    return out


def resource_usage():
    """[(kernel, registers, spill store bytes, spill load bytes)] from the
    ptxas report of the current build."""
    text = library_path().with_suffix(".log").read_text()
    out, name, spill = [], None, (0, 0)
    for line in text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            out.append((name, int(m.group(1)), *spill))
            name, spill = None, (0, 0)
    return out


def lib():
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            handle.viba_error_string.argtypes = [ctypes.c_int]
            handle.viba_error_string.restype = ctypes.c_char_p
            _lib = handle
    return _lib


def check(t, name, dtype=torch.float32, shape=None):
    """Validate a tensor handed to a kernel; returns its device pointer."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    return t.data_ptr()


def launch(name, *args):
    """Call a C entry point on the current stream; raise on a launch error."""
    handle = lib()
    rc = getattr(handle, name)(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} "
                           f"({handle.viba_error_string(rc).decode()})")
