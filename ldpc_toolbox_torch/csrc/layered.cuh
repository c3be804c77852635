// Device code shared by every kernel source: the ten layout tables the
// layered, resident and streaming-sweep kernels read (csrc/lanes.cuh
// copies them into shared memory) and the rounding of an f32 value to its
// message storage type. csrc/lanes.cuh builds the thread-per-lane kernels
// on it.
//
// Bit-exactness with the JAX package (min-sum, f32 or bf16 storage), for
// every layered kernel:
// - every x of a check group comes from the layer-entry Qv, and the
//   group's deltas Rnew - Rold are added to Qv one rounding each, in edge
//   order, so two edges of one group into one variable group give
//   (Qv + d1) + d2;
// - a sign is x < 0 (-0.0 counts as positive); argmin takes the first
//   minimum; m2 folds as min(m2, max(m1, |x|)) from big; the scale
//   multiplies m1 and m2 before the sign (select commutes with it);
// - missing lane: x = big there and Rnew = 0;
// - storage rounds to nearest even (__float2bfloat16_rn); the Qv delta
//   uses the unrounded f32 Rnew minus the loaded Rold;
// - __fmul_rn, __fadd_rn and __fsub_rn keep nvcc from contracting the
//   scale, the reconstruction or the deltas into an FMA.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ldpc {

// v rounded to the storage type and read back as f32
__device__ __forceinline__ float round_msg(float v, const float*) { return v; }
__device__ __forceinline__ float round_msg(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The ten int32 layout tables, in the order of the wrappers' pointer
// array (ldpc_toolbox_torch/ops/resident_layered.py LAYERED_TABLES).
struct Tables {
  const int* chk_cs;     // (CG,) first edge of each check group
  const int* syn_vg;     // (E,) variable-group plane of each edge
  const int* syn_rot;    // (E,) s: check lane c reads variable lane c - s
  const int* chk_rot;    // (E,) (Z - s) % Z: variable lane w takes check lane w - rot
  const int* syn_mask;   // (E,) missing check lane, -1 none
  const int* var_cs;     // (VG,) first var-major edge of each variable group
  const int* rec_plane;  // (E,) var-major edge p -> the check-major edge feeding it
  const int* rec_group;  // (E,) its check group
  const int* rec_slot;   // (E,) its slot in that group
  const int* rec_rot;    // (E,) its roll: variable lane w reads check lane w - rot
  int CG, E, VG, Z;
};

inline Tables make_tables(const void* const* tab, int CG, int E, int VG,
                          int Z) {
  const int* const* p = reinterpret_cast<const int* const*>(tab);
  return Tables{p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7],
                p[8], p[9], CG, E, VG, Z};
}

}  // namespace ldpc
