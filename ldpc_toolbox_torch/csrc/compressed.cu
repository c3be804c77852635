// Min-sum decodes of frame tiles with the check state compressed to signs
// and two magnitudes a check, one thread block per tile of 4 frames, all
// iterations in one launch:
// - compressed_layered_kernel: the layered schedule;
// - compressed_flooding_kernel: the flooding schedule.
//
// Replaces these Pallas TPU kernels of
// ldpc_toolbox_tpu/ops/resident_compressed.py:
// - compressed_layered_decode -> compressed_layered_kernel. State: Qv f32
//   (VG, Z, 4); sigma int8 (E, Z, 4) in {-2, -1, 0, 1, 2}, |sigma| = 2 at
//   the argmin slot, 0 at the missing lane; min1, min2 (CG, Z, 4) in the
//   storage type, post-scale.
// - compressed_flooding_decode -> compressed_flooding_kernel. State: s f32
//   (VG, Z, 4), the posterior totals; ssign int8 (E, Z, 4), each edge's
//   c2v sign (+-1, 0 at the missing lane); min1, min2 (CG, Z, 4) in the
//   storage type and argm int8 (CG, Z, 4).
// Min-sum's check outputs are determined by (signs, min1, min2, argmin), so
// both are lossless: the only internal difference from the message kernels
// is the sign of some zeros, which no comparison, |.| or hard decision
// sees. On the TPU they let the f32 names' state fit the vector memory.
//
// What bounds them on an H100: the state (flagship DVB-S2 R1_2 at
// B = 1024: about 0.8 GB) lives in device memory and streams through it
// every iteration, and one block walks a tile's check groups in turn, so
// the latency of each group's dependent loads and barriers sets the pace
// as much as the bytes do (the earlier form, a thread per (lane, frame)
// with runtime edge loops, reached half of the state traffic's floor). Per
// edge lane and iteration this form moves about 16 bytes (layered: sigma
// read and written 2, Qv gathered, written and read by the syndrome 12,
// min1/min2 2.3 in f32) and 21 (flooding: s gathered 4, sigma 2, the
// variable phase's gathers of sigma, argm, min1 and min2 10, the check
// state 2.6, q and s 2.3); PERF.md has the times.
//
// What the design does about it:
// - one thread per lane of a tile, all four frames at once: Qv, s and q
//   move as one 16-byte (f32) or 8-byte (bf16) vector, sigma, argm and
//   the bits as one 4-byte word, min1 and min2 as one vector each, so each
//   table load and each mod-Z index is done once a lane, not once a frame;
// - the edge loops run to a compile-time bound (the degree bucket: 8, 16,
//   32 or 64), so a check's d gathers and sigma words are all issued
//   before its fold starts; the sigma words stay in registers until its
//   outputs;
// - in a group that reaches no variable group twice, the layered kernel's
//   check lane adds its deltas to Qv itself (Qv + delta, read again from
//   the cache it was gathered into, which measured faster than holding it
//   in registers): no park and one barrier a group. A group that does
//   (DVB-S2, CCSDS C2) parks its deltas, as the message kernels do, and
//   each variable lane adds them in edge order from registers;
// - the flooding variable phase loads argm, min1 and min2 of an edge
//   together and selects afterwards (no load waits on another), eight
//   edges at a time;
// - the flooding syndrome of an iteration is taken by the next
//   iteration's check phase, which gathers the same s: one pass over s an
//   iteration, not two;
// - the layout tables are copied into shared memory once a launch.
//
// The thread-per-lane machinery (vectors, tables, fold, sweep, syndrome,
// decode loop) is csrc/lanes.cuh's, shared with the message kernels.
//
// Bit-exactness with the JAX package: csrc/lanes.cuh's and csrc/layered.cuh's
// rules, and
// - Rold = w1 * min1 + w2 * min2 and c2v = sigma * select(argm == t, min2,
//   min1) are computed with __fmul_rn / __fadd_rn, op for op;
// - flooding v2c = store(s - c2v) (rounded to the storage type, as the
//   message kernels store it), big at the missing lane; s = q + sum of the
//   rebuilt c2v in var-major slot order (__fadd_rn); the syndrome reads
//   s <= 0 (Qv <= 0 for layered).

#include "lanes.cuh"

namespace {

using namespace ldpc;

// Rold of one frame from its sigma and its group's stored magnitudes.
__device__ __forceinline__ float rebuild(int s, float m1o, float m2o) {
  const int w2 = s - max(-1, min(s, 1));
  const int w1 = s - 2 * w2;
  return __fadd_rn(__fmul_rn((float)w1, m1o), __fmul_rn((float)w2, m2o));
}

// Check update of check lane c of group g in one tile (the layered
// schedule): every x from the layer-entry Qv, the new sigma and magnitudes
// in place, and the deltas Rnew - Rold either added to Qv (parked false;
// no other lane touches those cells in this group) or parked at
// park[(k * Z + c) * 4].
template <int DMAX, typename Msg>
__device__ __forceinline__ void layered_check_lane(
    float* qv, int8_t* ssign, Msg* min1, Msg* min2, float* park,
    const LaneTables& t, int g, int c, bool parked, float big, float scale) {
  const int Z = t.Z;
  const int e0 = t.chk_cs[g], d = t.chk_cs[g + 1] - e0;
  const size_t at = ((size_t)g * Z + c) * kBt;
  const F4 m1o = load4(min1 + at), m2o = load4(min2 + at);
  F4 q[DMAX];
  uint32_t sw[DMAX];
#pragma unroll
  for (int k = 0; k < DMAX; ++k) {
    if (k < d) {
      const int e = e0 + k;
      q[k] = load4(qv + ((size_t)t.qbase[e] + minus_mod(c, t.syn_rot[e], Z)) * kBt);
      sw[k] = load_word(ssign + ((size_t)e * Z + c) * kBt);
    }
  }
  Fold<DMAX> fold;
#pragma unroll
  for (int f = 0; f < kBt; ++f) fold.m2[f] = big;
#pragma unroll
  for (int k = 0; k < DMAX; ++k) {
    if (k < d) {
      const bool missing = c == t.syn_mask[e0 + k];
#pragma unroll
      for (int f = 0; f < kBt; ++f) {
        const float rold = rebuild(byte_of(sw[k], f), m1o.v[f], m2o.v[f]);
        fold.add(k, f, missing ? big : __fsub_rn(q[k].v[f], rold));
      }
    }
  }
  fold.scale_by(scale);
#pragma unroll
  for (int k = 0; k < DMAX; ++k) {
    if (k < d) {
      const int e = e0 + k;
      const bool missing = c == t.syn_mask[e];
      uint32_t nw = 0;
      F4 delta;
#pragma unroll
      for (int f = 0; f < kBt; ++f) {
        const int sgn = missing ? 0 : fold.sign(k, f);
        const bool is_arg = fold.arg[f] == k;
        const float loo = is_arg ? fold.m2[f] : fold.m1[f];
        const float rn = missing ? 0.f : (sgn < 0 ? -loo : loo);
        delta.v[f] = __fsub_rn(rn, rebuild(byte_of(sw[k], f), m1o.v[f], m2o.v[f]));
        nw |= byte_at(is_arg ? 2 * sgn : sgn, f);
      }
      store_word(ssign + ((size_t)e * Z + c) * kBt, nw);
      if (parked) {
        store4(park + ((size_t)k * Z + c) * kBt, delta);
      } else {
        float* cell = qv + ((size_t)t.qbase[e] + minus_mod(c, t.syn_rot[e], Z)) * kBt;
        F4 qk = load4(cell);
#pragma unroll
        for (int f = 0; f < kBt; ++f) qk.v[f] = __fadd_rn(qk.v[f], delta.v[f]);
        store4(cell, qk);
      }
    }
  }
  F4 m1s, m2s;
#pragma unroll
  for (int f = 0; f < kBt; ++f) {
    m1s.v[f] = fold.m1[f];
    m2s.v[f] = fold.m2[f];
  }
  store4(min1 + at, m1s);
  store4(min2 + at, m2s);
}

template <int DMAX, typename Msg>
__global__ void __launch_bounds__(kThreads, 2) compressed_layered_kernel(
    float* qv_all, int8_t* ssign_all, Msg* min1_all, Msg* min2_all,
    int8_t* bits_all, int* iters_out, int* conv_out, float* park_all, Tables t,
    size_t park_elems, int max_iterations, float big, float scale) {
  extern __shared__ __align__(16) int smem[];
  const size_t tile = blockIdx.x;
  const size_t lanes = (size_t)t.VG * t.Z;
  const LaneTables lt = load_tables(t, smem + kCtlInts);
  float* park = lane_park(park_all, park_elems, smem, t);
  float* qv = qv_all + tile * lanes * kBt;
  int8_t* ssign = ssign_all + tile * t.E * t.Z * kBt;
  Msg* min1 = min1_all + tile * t.CG * t.Z * kBt;
  Msg* min2 = min2_all + tile * t.CG * t.Z * kBt;
  int8_t* bits = bits_all + tile * lanes * kBt;
  decode_tile4<DMAX>(qv, bits, iters_out, conv_out, lt, max_iterations, smem,
                     [&](int, int* bad) {
                       layered_sweep4<DMAX>(qv, park, lt, [&](int g, int c, int, bool parked) {
                         layered_check_lane<DMAX>(qv, ssign, min1, min2, park, lt,
                                                  g, c, parked, big, scale);
                       });
                       syndrome4<DMAX>(qv, lt, bad);
                     });
}

// Check update of check lane c of group g in one tile (the flooding
// schedule): rebuilds v2c = store(s - c2v_old) from the old state, folds it
// and writes the new state in place. Returns the frames (bit f) for which
// the check fails on the hard decisions s <= 0 it read (kSyndrome; else 0).
template <int DMAX, bool kSyndrome, typename Msg>
__device__ __forceinline__ uint32_t flooding_check_lane(
    const float* s, int8_t* ssign, Msg* min1, Msg* min2, int8_t* argm,
    const LaneTables& t, int g, int c, float big, float scale) {
  const int Z = t.Z;
  const int e0 = t.chk_cs[g], d = t.chk_cs[g + 1] - e0;
  const size_t at = ((size_t)g * Z + c) * kBt;
  const F4 m1o = load4(min1 + at), m2o = load4(min2 + at);
  const uint32_t ao = load_word(argm + at);
  F4 sv[DMAX];
  uint32_t sw[DMAX];
#pragma unroll
  for (int k = 0; k < DMAX; ++k) {
    if (k < d) {
      const int e = e0 + k;
      sv[k] = load4(s + ((size_t)t.qbase[e] + minus_mod(c, t.syn_rot[e], Z)) * kBt);
      sw[k] = load_word(ssign + ((size_t)e * Z + c) * kBt);
    }
  }
  Fold<DMAX> fold;
  uint32_t odd = 0;
#pragma unroll
  for (int f = 0; f < kBt; ++f) fold.m2[f] = big;
#pragma unroll
  for (int k = 0; k < DMAX; ++k) {
    if (k < d) {
      const bool missing = c == t.syn_mask[e0 + k];
#pragma unroll
      for (int f = 0; f < kBt; ++f) {
        const float c2v = __fmul_rn((float)byte_of(sw[k], f),
                                    byte_of(ao, f) == k ? m2o.v[f] : m1o.v[f]);
        const float x = round_msg(__fsub_rn(sv[k].v[f], c2v), min1);
        fold.add(k, f, missing ? big : x);
        if (kSyndrome && !missing) odd ^= (uint32_t)(sv[k].v[f] <= 0.f) << f;
      }
    }
  }
  fold.scale_by(scale);
#pragma unroll
  for (int k = 0; k < DMAX; ++k) {
    if (k < d) {
      const int e = e0 + k;
      const bool missing = c == t.syn_mask[e];
      uint32_t nw = 0;
#pragma unroll
      for (int f = 0; f < kBt; ++f) nw |= byte_at(missing ? 0 : fold.sign(k, f), f);
      store_word(ssign + ((size_t)e * Z + c) * kBt, nw);
    }
  }
  F4 m1s, m2s;
  uint32_t aw = 0;
#pragma unroll
  for (int f = 0; f < kBt; ++f) {
    m1s.v[f] = fold.m1[f];
    m2s.v[f] = fold.m2[f];
    aw |= byte_at(fold.arg[f], f);
  }
  store4(min1 + at, m1s);
  store4(min2 + at, m2s);
  store_word(argm + at, aw);
  return odd;
}

// Variable update of variable lane w of group vg in one tile: s = q + the
// group's c2v in var-major slot order, each rebuilt from the check state
// at check lane w - rec_rot.
template <typename Msg>
__device__ __forceinline__ void flooding_var_lane(
    float* s, const Msg* q, const int8_t* ssign, const Msg* min1,
    const Msg* min2, const int8_t* argm, const LaneTables& t, int vg, int w) {
  const int Z = t.Z;
  const size_t at = ((size_t)vg * Z + w) * kBt;
  F4 tot = load4(q + at);
  for (int p0 = t.var_cs[vg], p1 = t.var_cs[vg + 1]; p0 < p1; p0 += kVarChunk) {
    F4 m1v[kVarChunk], m2v[kVarChunk];
    uint32_t aw[kVarChunk], sw[kVarChunk];
#pragma unroll
    for (int j = 0; j < kVarChunk; ++j) {
      const int p = p0 + j;
      if (p < p1) {
        const int c = minus_mod(w, t.rec_rot[p], Z);
        const size_t m = ((size_t)t.rec_gz[p] + c) * kBt;
        m1v[j] = load4(min1 + m);
        m2v[j] = load4(min2 + m);
        aw[j] = load_word(argm + m);
        sw[j] = load_word(ssign + ((size_t)t.rec_pz[p] + c) * kBt);
      }
    }
#pragma unroll
    for (int j = 0; j < kVarChunk; ++j) {
      const int p = p0 + j;
      if (p < p1) {
        const int slot = t.rec_slot[p];
#pragma unroll
        for (int f = 0; f < kBt; ++f) {
          const float sel = byte_of(aw[j], f) == slot ? m2v[j].v[f] : m1v[j].v[f];
          tot.v[f] = __fadd_rn(tot.v[f], __fmul_rn((float)byte_of(sw[j], f), sel));
        }
      }
    }
  }
  store4(s + at, tot);
}

template <int DMAX, typename Msg>
__global__ void __launch_bounds__(kThreads, 2) compressed_flooding_kernel(
    float* s_all, const Msg* q_all, int8_t* ssign_all, Msg* min1_all,
    Msg* min2_all, int8_t* argm_all, int8_t* bits_all, int* iters_out,
    int* conv_out, Tables t, int max_iterations, float big, float scale) {
  extern __shared__ __align__(16) int smem[];
  const size_t tile = blockIdx.x;
  const int Z = t.Z, cn = t.CG * Z, vn = t.VG * Z;
  const LaneTables lt = load_tables(t, smem + kCtlInts);
  float* s = s_all + tile * vn * kBt;
  const Msg* q = q_all + tile * vn * kBt;
  int8_t* ssign = ssign_all + tile * t.E * Z * kBt;
  Msg* min1 = min1_all + tile * cn * kBt;
  Msg* min2 = min2_all + tile * cn * kBt;
  int8_t* argm = argm_all + tile * cn * kBt;
  int8_t* bits = bits_all + tile * vn * kBt;
  // s starts as the channel planes; sigma = 0 everywhere rebuilds c2v = 0,
  // so the first check phase sees v2c = store(q) as the message kernels do
  for (int r = threadIdx.x; r < vn; r += blockDim.x)
    store4(s + (size_t)r * kBt, load4(q + (size_t)r * kBt));
  auto check_phase = [&](auto syndrome, int* bad) {
    uint32_t odd = 0;
    for (int r = threadIdx.x; r < cn; r += blockDim.x)
      odd |= flooding_check_lane<DMAX, decltype(syndrome)::value>(
          s, ssign, min1, min2, argm, lt, r / Z, r % Z, big, scale);
    if (decltype(syndrome)::value) report_odd(odd, bad);
  };
  // Iteration it's check phase runs at the end of iteration it - 1, where
  // it reads the s whose syndrome that iteration needs: the syndrome of
  // iteration it - 1 comes with it, and a tile whose frames have then all
  // passed has run one check phase for nothing (it leaves s as it was).
  decode_tile4<DMAX>(
      s, bits, iters_out, conv_out, lt, max_iterations, smem,
      [&](int it, int* bad) {
        if (it == 1) {
          check_phase(std::false_type{}, bad);
          __syncthreads();
        }
        for (int r = threadIdx.x; r < vn; r += blockDim.x)
          flooding_var_lane(s, q, ssign, min1, min2, argm, lt, r / Z, r % Z);
        __syncthreads();
        if (it < max_iterations) {
          check_phase(std::true_type{}, bad);
        } else {
          syndrome4<DMAX>(s, lt, bad);
        }
      });
}

template <int DMAX, typename Msg>
cudaError_t layered_launch(void* qv, void* ssign, void* min1, void* min2,
                           void* bits, void* iters, void* conv, void* park,
                           const Tables& t, int nbt, size_t park_elems,
                           int max_iterations, int threads, float big,
                           float scale, cudaStream_t stream) {
  return launch(compressed_layered_kernel<DMAX, Msg>, nbt, threads,
                smem_bytes(t, park ? 0 : park_elems), stream,
                static_cast<float*>(qv), static_cast<int8_t*>(ssign),
                static_cast<Msg*>(min1), static_cast<Msg*>(min2),
                static_cast<int8_t*>(bits), static_cast<int*>(iters),
                static_cast<int*>(conv), static_cast<float*>(park), t,
                park_elems, max_iterations, big, scale);
}

template <int DMAX, typename Msg>
cudaError_t flooding_launch(void* s, const void* q, void* ssign, void* min1,
                            void* min2, void* argm, void* bits, void* iters,
                            void* conv, const Tables& t, int nbt,
                            int max_iterations, int threads, float big,
                            float scale, cudaStream_t stream) {
  return launch(compressed_flooding_kernel<DMAX, Msg>, nbt, threads,
                smem_bytes(t, 0), stream, static_cast<float*>(s),
                static_cast<const Msg*>(q), static_cast<int8_t*>(ssign),
                static_cast<Msg*>(min1), static_cast<Msg*>(min2),
                static_cast<int8_t*>(argm), static_cast<int8_t*>(bits),
                static_cast<int*>(iters), static_cast<int*>(conv), t,
                max_iterations, big, scale);
}

template <int DMAX, typename Msg>
struct LayeredLaunch {
  template <typename... Args>
  static cudaError_t run(Args... args) {
    return layered_launch<DMAX, Msg>(args...);
  }
};

template <int DMAX, typename Msg>
struct FloodingLaunch {
  template <typename... Args>
  static cudaError_t run(Args... args) {
    return flooding_launch<DMAX, Msg>(args...);
  }
};

}  // namespace

// Both entry points take the ten layout tables as an array of device
// pointers (see Tables in layered.cuh), the tile shape (Bt must be 4) and
// the largest check degree (at most 64), and return the launch's
// cudaError_t. The storage type (min1, min2, and flooding's q) is bf16
// when msg_bf16, else f32; threads is at most 256.

// Layered: qv (nbt, VG, Z, 4) f32 working posteriors; ssign (nbt, E, Z, 4)
// int8, min1 and min2 (nbt, CG, Z, 4) zeroed state; bits (nbt, VG, Z, 4)
// int8 raw-channel bits in, decoded bits out; iters and conv (nbt, 4)
// int32 out; park (nbt, max_degree, Z, 4) f32 in device memory, or null
// to park in shared memory after the tables.
extern "C" int ldpc_compressed_layered_decode(
    void* qv, void* ssign, void* min1, void* min2, void* bits, void* iters,
    void* conv, void* park, const void* const* tables, int nbt, int CG, int E,
    int VG, int Z, int Bt, int max_degree, int max_iterations, int threads,
    float big, float scale, int msg_bf16, void* stream) {
  if (Bt != kBt || threads > kThreads) return cudaErrorInvalidValue;
  const Tables t = make_tables(tables, CG, E, VG, Z);
  const size_t park_elems = (size_t)max_degree * Z * kBt;
  return static_cast<int>(by_bucket<LayeredLaunch>(
      max_degree, msg_bf16, qv, ssign, min1, min2, bits, iters, conv, park, t,
      nbt, park_elems, max_iterations, threads, big, scale,
      static_cast<cudaStream_t>(stream)));
}

// Flooding: s (nbt, VG, Z, 4) f32 scratch; q (nbt, VG, Z, 4) channel
// planes; ssign (nbt, E, Z, 4), min1, min2 and argm (nbt, CG, Z, 4)
// zeroed state; bits, iters and conv as for layered.
extern "C" int ldpc_compressed_flooding_decode(
    void* s, const void* q, void* ssign, void* min1, void* min2, void* argm,
    void* bits, void* iters, void* conv, const void* const* tables, int nbt,
    int CG, int E, int VG, int Z, int Bt, int max_degree, int max_iterations,
    int threads, float big, float scale, int msg_bf16, void* stream) {
  if (Bt != kBt || threads > kThreads) return cudaErrorInvalidValue;
  const Tables t = make_tables(tables, CG, E, VG, Z);
  return static_cast<int>(by_bucket<FloodingLaunch>(
      max_degree, msg_bf16, s, q, ssign, min1, min2, argm, bits, iters, conv,
      t, nbt, max_iterations, threads, big, scale,
      static_cast<cudaStream_t>(stream)));
}

extern "C" const char* ldpc_compressed_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
