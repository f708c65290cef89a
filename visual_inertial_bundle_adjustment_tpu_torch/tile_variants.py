"""The design choices of the tile pass of K14a, K14c and K14e measured one at a
time.

Each variant is `csrc/tile_segments.cu` with one choice of the kept design
undone (a text edit of a copy of the source). K14e (`tile_scatter_staged`):
the staged chunk's size, the minimum of three CTAs an SM asked of ptxas
(and with it the slots staged in flight a thread), the size of a row piece,
the run cache. K14a (`tile_reduce_split`): contrib read straight from global
memory in the piece walk or staged a chunk at a time in shared memory, its
own piece size, the 32-slot steps a lane loads before it adds them, and the
minimum of CTAs an SM. K14c (`tile_fused_staged`): each slot's x_row
from xt through the L2 or from xt staged in shared memory, each slot's row
from `local` or from a per-slot table expanded from the run list in shared
memory, and the minimum of CTAs an SM. Every variant is compiled by `nvcc`
into a library of its own (all in parallel, as `ops/_kernels.build` does),
its ptxas registers and spills printed, and the entries of the kernels it
concerns timed against the kept design's, by device time (torch.profiler),
in turns, on the profile's grids (the two-grid problem of `profile_matvec`):
K14e on the point-sorted grid at k 3 and the rig grid at k 6, K14a on the
point-sorted grid at D 9, K14c on the rig grid at k 6. A variant that keeps
the kept design's sum order must give its bits; every other within 1e-5 of
them, relative to max-abs. Run on a card:

    python -m visual_inertial_bundle_adjustment_tpu_torch.tile_variants \
        [--reference OTHER/tile_segments.cu]

`--reference` adds another tree's source of the file (for example a
commit's before a change to the shared pass): its K14e must give the kept
design's bits, and is timed beside it.

It prints a line per variant, the card's name and power limit, and last one
JSON object: per variant, its ptxas report and its device ms on each grid.
"""

from __future__ import annotations

import argparse
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
SCATTER, FUSED, REDUCE = "mv_scatter", "mv_fused", "reduce_partials"
# kernel -> (C entry, its kernel's name in the ptxas report)
ENTRIES = {SCATTER: ("viba_tile_mv_scatter", "tile_scatter_staged"),
           FUSED: ("viba_tile_mv_fused", "tile_fused_staged"),
           REDUCE: ("viba_tile_reduce", "tile_reduce_split")}


def _lb(blocks, kernel):
    return f"__launch_bounds__(kTileThreads, {blocks}) {kernel}("


def _no_minimum(blocks, kernel):
    return (_lb(blocks, kernel), f"__launch_bounds__(kTileThreads) {kernel}(")


_UNROLL = "constexpr int kUnroll = K <= 3 ? 4 : (K <= 6 ? 2 : 1);"
_ALL = (SCATTER, FUSED, REDUCE)
# variant -> (edits of the source, the kernels it concerns, whether it keeps
# the kept design's sum order)
VARIANTS = {
    "kept": ([], _ALL, True),
    "chunk 24 KB": ([("kStageFloats = 12288;", "kStageFloats = 6144;")], (SCATTER, FUSED), False),
    "chunk 12 KB": ([("kStageFloats = 12288;", "kStageFloats = 3072;")], (SCATTER, FUSED), False),
    "K14e no block minimum": ([_no_minimum("kScatterBlocks", "tile_scatter_staged")], (SCATTER,),
                              True),
    "K14e no block minimum, 2 / 1 slots in flight": (
        [_no_minimum("kScatterBlocks", "tile_scatter_staged"),
         (_UNROLL, "constexpr int kUnroll = K <= 3 ? 2 : 1;")], (SCATTER,), True),
    "pieces of 256": ([("kPiece = 512;", "kPiece = 256;")], (SCATTER, FUSED), False),
    "pieces of 128": ([("kPiece = 512;", "kPiece = 128;")], (SCATTER, FUSED), False),
    "run cache 256": ([("kRunCache = 128;", "kRunCache = 256;")], _ALL, True),
    "K14a staged": ([("kReduceDirect = true;", "kReduceDirect = false;")], (REDUCE,), False),
    "K14a pieces of 512": ([("kReducePiece = 128;", "kReducePiece = 512;")], (REDUCE,), False),
    "K14a pieces of 256": ([("kReducePiece = 128;", "kReducePiece = 256;")], (REDUCE,), False),
    "K14a pieces of 64": ([("kReducePiece = 128;", "kReducePiece = 64;")], (REDUCE,), False),
    "K14a one step in flight": ([("kReduceFlight = 4;", "kReduceFlight = 1;")], (REDUCE,), True),
    "K14a two steps in flight, four CTAs an SM": (
        [("kReduceFlight = 4;", "kReduceFlight = 2;"),
         ("kReduceDirect ? 3 : 2;", "kReduceDirect ? 4 : 2;")], (REDUCE,), True),
    "K14a eight steps in flight, two CTAs an SM": (
        [("kReduceFlight = 4;", "kReduceFlight = 8;"),
         ("kReduceDirect ? 3 : 2;", "kReduceDirect ? 2 : 2;")], (REDUCE,), True),
    "K14a four CTAs an SM": ([("kReduceDirect ? 3 : 2;", "kReduceDirect ? 4 : 2;")], (REDUCE,),
                             True),
    "K14a no block minimum": ([_no_minimum("kReduceBlocks", "tile_reduce_split")], (REDUCE,),
                              True),
    "K14c xt staged in shared memory": ([("kFusedXtShared = false;", "kFusedXtShared = true;")],
                                        (FUSED,), True),
    "K14c row table from the runs": ([("kFusedRowTable = false;", "kFusedRowTable = true;")],
                                     (FUSED,), True),
    "K14c no block minimum": ([_no_minimum("kFusedBlocks", "tile_fused_staged")], (FUSED,), True),
}
REFERENCE = "reference source"


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


def build(work: Path, variants):
    """{variant: (ctypes library, {kernel: ptxas report})} of `variants`:
    {name: (source text, kernels)}."""
    nvcc, procs = _kernels._nvcc(), {}
    for i, (name, (text, _)) in enumerate(variants.items()):
        src = work / f"variant{i}.cu"
        src.write_text(text)
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
        report = {}
        for kernel in variants[name][1]:
            entry, ptx_name = ENTRIES[kernel]
            fn = getattr(handle, entry)
            fn.argtypes = _kernels._SIGNATURES[entry]
            fn.restype = ctypes.c_int
            report[kernel] = _ptxas(stdout + stderr, ptx_name)
        out[name] = (handle, report)
    return out


def _launch(handle, entry, *args):
    rc = getattr(handle, entry)(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{entry}: CUDA error {rc}")


def _plan(grid):
    return [a.data_ptr() for a in grid.plan]


def _scatter(handle, J, u, grid):
    part = torch.empty((grid.nt, grid.rb, J.shape[1]), device=J.device)
    _launch(handle, "viba_tile_mv_scatter", grid.nt, grid.rb, grid.nt * grid.ts, J.shape[1],
            *_plan(grid), J.data_ptr(), u.data_ptr(), part.data_ptr())
    return (part,)


def _fused(handle, J, w, xt, grid):
    wu = torch.empty((2, grid.nt * grid.ts), device=J.device)
    part = torch.empty((grid.nt, grid.rb, J.shape[1]), device=J.device)
    _launch(handle, "viba_tile_mv_fused", grid.nt, grid.rb, grid.nt * grid.ts, J.shape[1],
            *_plan(grid), J.data_ptr(), w.data_ptr(), xt.data_ptr(), grid.local.data_ptr(),
            wu.data_ptr(), part.data_ptr())
    return wu, part


def _reduce(handle, contrib, grid):
    part = torch.empty((grid.nt, grid.rb, contrib.shape[0]), device=contrib.device)
    _launch(handle, "viba_tile_reduce", grid.nt, grid.rb, grid.nt * grid.ts, contrib.shape[0],
            *_plan(grid), contrib.data_ptr(), part.data_ptr())
    return (part,)


def _rel(a, b):
    return float((a.double() - b.double()).abs().max() / b.double().abs().max().clamp_min(1e-30))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reference", type=Path, default=None,
                    help="another tree's tile_segments.cu, whose K14e must give the kept bits")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tile_variants: no CUDA device")
    dev = torch.device("cuda", 0)
    variants = {name: (variant_source(edits), kernels, same)
                for name, (edits, kernels, same) in VARIANTS.items()}
    if args.reference is not None:
        variants[REFERENCE] = (args.reference.read_text(), (SCATTER,), True)
    _kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=_kernels.BUILD_DIR))
    try:
        libs = build(work, {name: (text, kernels) for name, (text, kernels, _) in variants.items()})
        ctx = pm.setup(pm.build_two_grid_problem(dev, torch.float32))
        (tb,) = ctx.batches
        g, p = tb.rig, tb.pt
        gen = torch.Generator(device=dev).manual_seed(3)
        k = tb.b.rig_k
        xt = g.gather(torch.randn((ctx.v.pose_q.shape[0], k), generator=gen, device=dev))
        contrib = torch.randn((9, p.nt * p.ts), generator=gen, device=dev)
        u_pt = torch.randn((2, p.nt * p.ts), generator=gen, device=dev)
        u_rig = torch.randn((2, g.nt * g.ts), generator=gen, device=dev)
        # label -> (kernel, call of a library)
        cases = {"K14e point grid k 3": (SCATTER, lambda h: _scatter(h, tb.J_pt_po, u_pt, p)),
                 f"K14e rig grid k {k}": (SCATTER, lambda h: _scatter(h, tb.b.J, u_rig, g)),
                 "K14a point grid D 9": (REDUCE, lambda h: _reduce(h, contrib, p)),
                 f"K14c rig grid k {k}": (FUSED, lambda h: _fused(h, tb.b.J, tb.b.w, xt, g))}
        result = {name: dict(ptxas=report) for name, (_, report) in libs.items()}
        for label, (kernel, call) in cases.items():
            names = [name for name in libs if kernel in variants[name][1]]
            kept = call(libs["kept"][0])
            for name in names:
                outs = call(libs[name][0])
                if variants[name][2]:
                    if not all(torch.equal(a, b) for a, b in zip(outs, kept)):
                        raise AssertionError(f"{name}: other bits than the kept design on {label}")
                elif not all(_rel(a, b) <= 1e-5 for a, b in zip(outs, kept)):
                    raise AssertionError(f"{name}: differs from the kept design on {label}")
            fns = [lambda h=libs[name][0]: call(h) for name in names]
            for name, (ms, _, _) in zip(names, pm.in_turns(fns)):
                result[name][label] = ms
        for name, row in result.items():
            print(f"{name}: ptxas {row['ptxas']} | " + ", ".join(
                f"{label} {row[label]:.4f} ms" for label in cases if label in row), flush=True)
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip().splitlines()[0])
        print(json.dumps(result))
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
