// K8 / K9 / K10: segment kernels of a calibration-coupled visual batch,
// in four translation units, one nvcc each (ops/_kernels.py compiles them
// in parallel):
//   cal_assemble.cu     K8, viba_assemble_cal;
//   cal_pcg.cu          K9 and K10 on one right-hand side, viba_schur_pcg_cal,
//                       viba_schur_down_cal, viba_schur_up_cal;
//   cal_pcg_cols.cu     K9 on C right-hand sides at rig width 6, and
//                       viba_schur_pcg_cal_cols;
//   cal_pcg_cols_k9.cu  the same at rig width 9 (both from the kernels of
//                       cal_pcg_cols.cuh).
// Each unit's head describes its kernels; this header holds what they
// share.
//
// The batch couples, besides rigs (J_r, K = rig_k columns) and landmarks
// (J_p, 3 columns), the calibration-window variables of each observation's
// window row (J_c, kc columns in the batch's cal_groups order: cam extr 6 |
// cam intr 17, or one of the two alone, kc = 23, 6 or 17 — a template
// parameter of the window kernels, dispatched on the runtime kc).
//
// Window rows are few and long (120 rows of ~15k observations at the
// full-sensor size): one group per row would leave most of the card idle.
// K8 cuts each row's slot list into chunks of at most CHUNK slots
// (ops/segments.py) whose partial rows a second pass sums in chunk order;
// K9 and K10 walk each rig row's (rig, window row) pairs and write one
// partial row a pair, which a second pass sums in rig order. Landmark rows
// (~30 observations) are summed over each slot's point-sorted position
// (pt_segments.cuh). Deterministic, no atomics. K9's and K10's kernels are
// templated on TJ too, J's element type (J_r, J_c and J_p alike): float, or
// bf16 for the PCG loop's copies (rcs.MATVEC_BF16; tile_reduce.cuh jf),
// which halve the J bytes their bounds count; K8 reads float J only.
#pragma once

#include "pt_segments.cuh"
#include "tile_reduce.cuh"

// dispatch on the window column count kc: cam extr (6), cam intr (17) or both (23)
#define VIBA_DISPATCH_KC(kc, CALL6, CALL17, CALL23) \
  ((kc) == 6 ? (CALL6) : (kc) == 17 ? (CALL17) : (kc) == 23 ? (CALL23) \
                                                         : static_cast<int>(cudaErrorInvalidValue))
