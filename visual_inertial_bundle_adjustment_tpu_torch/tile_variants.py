"""The design choices of K14e (`tile_scatter_staged`) measured one at a time.

Each variant is `csrc/tile_segments.cu` with one choice of the kept design
undone (a text edit of a copy of the source): the staged chunk's size, the
minimum of three CTAs an SM asked of ptxas (and with it the slots staged in
flight a thread), the size of a row piece, the run cache. Every variant is
compiled by `nvcc` into a library of its own (all in parallel, as
`ops/_kernels.build` does), its ptxas registers and spills printed, and its
K14e entry timed against the kept design's on the profile's two grids (the
two-grid problem of `profile_matvec`: the point-sorted grid at k 3, the rig
grid at k 6), by device time (torch.profiler), in turns. A variant that
keeps the kept design's sum order (the same chunks and pieces) must give its
bits. Run on a card:

    python -m visual_inertial_bundle_adjustment_tpu_torch.tile_variants

It prints a line per variant, the card's name and power limit, and last one
JSON object: per variant, its ptxas report and its device ms on each grid.
"""

from __future__ import annotations

import ctypes
import json
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from . import profile_matvec as pm
from .ops import _kernels

SOURCE = _kernels.CSRC / "tile_segments.cu"
_LB = "__launch_bounds__(kTileThreads, kScatterBlocks) tile_scatter_staged("
_UNROLL = "constexpr int kUnroll = K <= 3 ? 4 : (K <= 6 ? 2 : 1);"
# variant -> (edits of the source, whether it keeps the kept design's sum order)
VARIANTS = {
    "kept": ([], True),
    "chunk 24 KB": ([("kStageFloats = 12288;", "kStageFloats = 6144;")], False),
    "chunk 12 KB": ([("kStageFloats = 12288;", "kStageFloats = 3072;")], False),
    "no block minimum": ([(_LB, "__launch_bounds__(kTileThreads) tile_scatter_staged(")], True),
    "no block minimum, 2 / 1 slots in flight": (
        [(_LB, "__launch_bounds__(kTileThreads) tile_scatter_staged("),
         (_UNROLL, "constexpr int kUnroll = K <= 3 ? 2 : 1;")], True),
    "pieces of 256": ([("kPiece = 512;", "kPiece = 256;")], False),
    "pieces of 128": ([("kPiece = 512;", "kPiece = 128;")], False),
    "run cache 256": ([("kRunCache = 128;", "kRunCache = 256;")], True),
}


def variant_source(edits, text=None):
    """The source with `edits` applied; each edit's text must occur once."""
    text = SOURCE.read_text() if text is None else text
    for old, new in edits:
        if text.count(old) != 1:
            raise ValueError(f"{old!r} occurs {text.count(old)} times in {SOURCE.name}")
        text = text.replace(old, new)
    return text


def _ptxas(report, kernel):
    """{instantiation: (registers, spill bytes stored + loaded)} of `kernel`."""
    out, name, spill = {}, None, 0
    for line in report.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            if kernel in name:
                out[re.search(r"ILi(\d+)E", name).group(1)] = (int(m.group(1)), spill)
            name, spill = None, 0
    return out


def build(work: Path):
    """{variant: (ctypes library, ptxas report of tile_scatter_staged)}."""
    nvcc, procs = _kernels._nvcc(), {}
    for i, (name, (edits, _)) in enumerate(VARIANTS.items()):
        src = work / f"variant{i}.cu"
        src.write_text(variant_source(edits))
        cmd = [nvcc, *_kernels.NVCC_FLAGS, "-I", str(_kernels.CSRC), "-shared", str(src), "-o",
               str(work / f"libvariant{i}.so")]
        procs[name] = (work / f"libvariant{i}.so",
                       subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                        text=True))
    out = {}
    for name, (lib, proc) in procs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name!r}:\n{stderr}")
        handle = ctypes.CDLL(str(lib))
        handle.viba_tile_mv_scatter.argtypes = _kernels._SIGNATURES["viba_tile_mv_scatter"]
        handle.viba_tile_mv_scatter.restype = ctypes.c_int
        out[name] = (handle, _ptxas(stdout + stderr, "tile_scatter_staged"))
    return out


def _scatter(handle, J, u, grid):
    part = torch.empty((grid.nt, grid.rb, J.shape[1]), device=J.device)
    rc = handle.viba_tile_mv_scatter(grid.nt, grid.rb, grid.nt * grid.ts, J.shape[1],
                                     *(a.data_ptr() for a in grid.plan), J.data_ptr(),
                                     u.data_ptr(), part.data_ptr(),
                                     torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"viba_tile_mv_scatter: CUDA error {rc}")
    return part


def main():
    if not torch.cuda.is_available():
        raise SystemExit("tile_variants: no CUDA device")
    dev = torch.device("cuda", 0)
    _kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=_kernels.BUILD_DIR))
    try:
        libs = build(work)
        ctx = pm.setup(pm.build_two_grid_problem(dev, torch.float32))
        (tb,) = ctx.batches
        gen = torch.Generator(device=dev).manual_seed(3)
        grids = {"point grid k 3": (tb.J_pt_po, tb.pt), "rig grid k 6": (tb.b.J, tb.rig)}
        result = {name: dict(ptxas=report) for name, (_, report) in libs.items()}
        for label, (J, grid) in grids.items():
            u = torch.randn((2, grid.nt * grid.ts), generator=gen, device=dev)
            kept = _scatter(libs["kept"][0], J, u, grid)
            for name, (handle, _) in libs.items():
                if VARIANTS[name][1] and not torch.equal(_scatter(handle, J, u, grid), kept):
                    raise AssertionError(f"{name}: other bits than the kept design on {label}")
            fns = [lambda h=handle: _scatter(h, J, u, grid) for handle, _ in libs.values()]
            for name, (ms, _, _) in zip(libs, pm.in_turns(fns)):
                result[name][label] = ms
        for name, row in result.items():
            print(f"{name}: ptxas {row['ptxas']} | " + ", ".join(
                f"{label} {row[label]:.4f} ms" for label in grids), flush=True)
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip().splitlines()[0])
        print(json.dumps(result))
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
