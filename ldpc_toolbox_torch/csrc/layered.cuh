// Device code shared by the kernels of csrc/resident_layered.cu,
// csrc/compressed.cu and csrc/flooding.cu: the ten layout tables the
// layered and resident kernels read and the message load and store; and
// the streaming layered kernel's sweep (a thread per (lane, frame), the
// check state held as messages, every group's deltas parked).
// csrc/lanes.cuh builds the thread-per-lane kernels on it.
//
// A tile is Bt frames, frames innermost: planes are (P, Z, Bt), item
// i = lane * Bt + frame. In layered_sweep one thread block owns one tile;
// blockDim.x is a multiple of Bt, so a thread only ever sees one frame of
// a tile.
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

__device__ __forceinline__ float load_msg(const float* p) { return *p; }
__device__ __forceinline__ float load_msg(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_msg(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_msg(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
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

__device__ __forceinline__ int group_end(const Tables& t, int g) {
  return g + 1 < t.CG ? t.chk_cs[g + 1] : t.E;
}

// The Qv row (flat plane index) check lane c of edge e reads.
__device__ __forceinline__ int qv_at(const Tables& t, int e, int c, int f,
                                     int Bt) {
  int w = c - t.syn_rot[e];
  if (w < 0) w += t.Z;
  return (t.syn_vg[e] * t.Z + w) * Bt + f;
}

// Check state held as one message per edge: Rcv (E, Z, Bt) of one tile.
template <typename Msg>
struct MessageState {
  Msg* rcv;
  int ZB;
  __device__ __forceinline__ float rold(int e, int i) const {
    return load_msg(rcv + (size_t)e * ZB + i);
  }
  __device__ __forceinline__ void store(int e, int i, float rn) {
    store_msg(rcv + (size_t)e * ZB + i, rn);
  }
};

// One layered sweep of one tile over all check groups, in place on qv (the
// tile's (VG, Z, Bt) f32 posteriors) and the messages st.
//
// Every x of a group is formed from the layer-entry Qv; the group's deltas
// go to park (d, Z, Bt) f32, and after a barrier the thread that owns a Qv
// cell's (lane, frame) adds them in edge order, so two edges of one group
// into one variable group (DVB-S2, CCSDS C2) add in turn, and no float
// atomics are needed. park may point to shared or to device memory: the
// wrappers put it in shared memory when max degree x Z x Bt floats fit a
// block and in device memory otherwise (CCSDS C2: 32 x 511 x 4 x 4 =
// 261,632 bytes, above the 232,448 a block may hold). Check degree <= 64
// (the signs are kept in a 64-bit mask), checked by the wrappers.
//
// (Adding a group's deltas in place from the thread that read the cell,
// where no variable group repeats, needs neither park nor barrier, but
// measured slower on an H100: the read-modify-writes of Qv, which the
// compiler cannot move past the Rcv stores, form a serial chain.)
template <typename Msg>
__device__ void layered_sweep(float* qv, MessageState<Msg>& st,
                              const Tables& t, int Bt, float big, float scale,
                              float* park) {
  const int ZB = t.Z * Bt;
  for (int g = 0; g < t.CG; ++g) {
    const int e0 = t.chk_cs[g], d = group_end(t, g) - e0;
    for (int i = threadIdx.x; i < ZB; i += blockDim.x) {
      const int c = i / Bt, f = i - c * Bt;
      float m1 = 0.f, m2 = big;
      int arg = 0, par = 0;
      uint64_t negs = 0;
      for (int k = 0; k < d; ++k) {
        const int e = e0 + k;
        float x = __fsub_rn(qv[qv_at(t, e, c, f, Bt)], st.rold(e, i));
        if (c == t.syn_mask[e]) x = big;
        const float mk = fabsf(x);
        const int neg = x < 0.f;
        negs |= (uint64_t)neg << k;
        if (k == 0) {
          m1 = mk;
          par = neg;
        } else {
          m2 = fminf(m2, fmaxf(m1, mk));
          if (mk < m1) {
            m1 = mk;
            arg = k;
          }
          par ^= neg;
        }
      }
      if (scale != 1.f) {
        m1 = __fmul_rn(m1, scale);
        m2 = __fmul_rn(m2, scale);
      }
      for (int k = 0; k < d; ++k) {
        const int e = e0 + k;
        const bool missing = c == t.syn_mask[e];
        const int sgn =
            missing ? 0 : ((par ^ (int)((negs >> k) & 1u)) ? -1 : 1);
        const float loo = arg == k ? m2 : m1;
        const float rn = missing ? 0.f : (sgn < 0 ? -loo : loo);
        const float delta = __fsub_rn(rn, st.rold(e, i));  // before the store
        st.store(e, i, rn);
        park[k * ZB + i] = delta;
      }
    }
    __syncthreads();
    // each thread owns the Qv cells of one (variable lane, frame) and adds
    // the group's deltas in edge order
    for (int i = threadIdx.x; i < ZB; i += blockDim.x) {
      const int w = i / Bt, f = i - w * Bt;
      for (int k = 0; k < d; ++k) {
        const int e = e0 + k;
        int c = w - t.chk_rot[e];
        if (c < 0) c += t.Z;
        float* q = qv + (size_t)t.syn_vg[e] * ZB + i;
        *q = __fadd_rn(*q, park[k * ZB + c * Bt + f]);
      }
    }
    __syncthreads();
  }
}

// Shared-memory ints before the streaming sweep's park: 4 * Bt + 2.
__host__ __device__ constexpr int control_ints(int Bt) { return 4 * Bt + 2; }

// This block's park: its slice of the device park (nbt, park_elems), or,
// when park_all is null, the shared memory after the control ints.
__device__ __forceinline__ float* tile_park(float* park_all, size_t park_elems,
                                            int* ctl, int Bt) {
  return park_all ? park_all + blockIdx.x * park_elems
                  : reinterpret_cast<float*>(ctl + control_ints(Bt));
}

// Dynamic shared memory of a layered kernel: the control ints, then the
// park when it lives there (park_elems floats, 0 when in device memory).
inline size_t layered_smem(int Bt, size_t park_elems) {
  return sizeof(int) * control_ints(Bt) + sizeof(float) * park_elems;
}

}  // namespace ldpc
