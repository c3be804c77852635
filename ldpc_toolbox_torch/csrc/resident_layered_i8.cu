// Horizontal-layered decode of frame tiles under the i8 rules: the int8
// instances of the resident message kernel of csrc/resident_layered.cu
// (all iterations in one launch, one thread block per tile, a thread per
// lane of a tile's four frames, on csrc/lanes.cuh), with the rules of
// csrc/i8.cuh. A source of its own, so that the parallel build keeps its
// length.
//
// Replaces the i8 path of ldpc_toolbox_tpu/ops/resident_layered.py
// resident_layered_decode, the Pallas kernel that keeps one tile's Qv
// (int16 for the i8 rules), Rcv (int8) and frozen bits in the TPU's vector
// memory and inlines MinstarApproxI8Rule or AminstarI8Rule
// (ops/fused_bp2.py).
//
// What bounds it on an H100: as for the float instances, the state lives
// in device memory (a flagship frame holds Qv int16 130 KB and Rcv int8
// 227 KB), and each iteration each edge lane of each frame reads and
// writes its Rcv (1 + 1 bytes), reads Qv for its check update (2) and
// reads and writes it for the posterior update (2 + 2), and the syndrome
// reads Qv again (2): about 10 bytes, half the bf16 instance's 20. The
// exact-order min* folds add integer work (MinstarApprox O(d^2) folds a
// check, each about twenty byte-SIMD operations on four frames), still far
// below the INT32 roof at the flagship's degree 7.
//
// What the design does about it: the float instance's form (Qv and Rcv of
// a lane as one 8-byte and one 4-byte vector, the edge loops unrolled to
// the check-degree bucket, the direct Qv update where a group reaches no
// variable group twice and the park otherwise, tables in shared memory,
// 256 threads), with the check's four frames folded as bytes of one word.
//
// Semantics (the JAX package's jnp path and Pallas kernel): x = clip(Qv -
// Rold, +-127) in int32 from the layer-entry Qv, 127 at the missing lane;
// Rnew from the rule, 0 at the missing lane, stored as int8; Qv += Rnew -
// Rold in int16, wrapping, in edge order; the syndrome and the hard
// decisions read Qv <= 0; iteration 0 tests the raw-channel bits, which a
// frame keeps if no iteration runs.

#include "i8.cuh"

namespace {

using namespace ldpc;

// Check update of check lane c of group g in one tile under FAMILY (flags:
// the partial hard limit): every x from the layer-entry Qv, Rnew in place,
// and the deltas Rnew - Rold either added to Qv (parked false; no other
// lane touches those cells in this group) or parked at park[(k * Z + c) *
// 4].
template <int DMAX, int FAMILY>
__device__ __forceinline__ void i8_check_lane(int16_t* qv, int8_t* rcv, int* park,
                                              const LaneTables& t, int g, int c,
                                              bool parked, int flags) {
  const int Z = t.Z;
  const int e0 = t.chk_cs[g], d = t.chk_cs[g + 1] - e0;
  uint2 q[DMAX];
  uint32_t r[DMAX];
#pragma unroll
  for (int k = 0; k < DMAX; ++k) {
    if (k < d) {
      const int e = e0 + k;
      q[k] = load_i16x4(qv + ((size_t)t.qbase[e] + minus_mod(c, t.syn_rot[e], Z)) * kBt);
      r[k] = load_word(rcv + ((size_t)e * Z + c) * kBt);
    }
  }
  I8Check<DMAX> in;
#pragma unroll
  for (int k = 0; k < DMAX; ++k) {
    if (k < d) {
      const bool missing = c == t.syn_mask[e0 + k];
      const I4 qk = widen16(q[k]);
      I4 x;
#pragma unroll
      for (int f = 0; f < kBt; ++f)
        x.v[f] = missing ? 127 : clip127(qk.v[f] - byte_of(r[k], f));
      in.set(k, x);
    }
  }
  i8_outputs<DMAX, FAMILY>(in, d, flags & kPartialHardLimit, [&](int k, uint32_t om) {
    const int e = e0 + k;
    const bool missing = c == t.syn_mask[e];
    uint32_t rn = 0;
    I4 delta;
#pragma unroll
    for (int f = 0; f < kBt; ++f) {
      const int v = missing ? 0 : in.out(k, f, om);
      rn |= byte_at(v, f);
      delta.v[f] = v - byte_of(r[k], f);
    }
    store_word(rcv + ((size_t)e * Z + c) * kBt, rn);
    if (parked) {
      store4(park + ((size_t)k * Z + c) * kBt, delta);
    } else {
      int16_t* cell = qv + ((size_t)t.qbase[e] + minus_mod(c, t.syn_rot[e], Z)) * kBt;
      I4 qk = load4(cell);
      add4(qk, delta);
      store4(cell, qk);
    }
  });
}

template <int DMAX, int FAMILY>
__global__ void __launch_bounds__(kThreads, 2) resident_layered_i8_kernel(
    int16_t* qv_all, int8_t* rcv_all, int8_t* bits_all, int* iters_out,
    int* conv_out, int* park_all, Tables t, size_t park_elems,
    int max_iterations, int flags) {
  extern __shared__ __align__(16) int smem[];
  const size_t tile = blockIdx.x;
  const size_t lanes = (size_t)t.VG * t.Z;
  const LaneTables lt = load_tables(t, smem + kCtlInts);
  int* park = lane_park(park_all, park_elems, smem, t);
  int16_t* qv = qv_all + tile * lanes * kBt;
  int8_t* rcv = rcv_all + tile * t.E * t.Z * kBt;
  int8_t* bits = bits_all + tile * lanes * kBt;
  decode_tile4<DMAX>(qv, bits, iters_out, conv_out, lt, max_iterations, smem,
                     [&](int, int* bad) {
                       layered_sweep4<DMAX>(qv, park, lt, [&](int g, int c, bool parked) {
                         i8_check_lane<DMAX, FAMILY>(qv, rcv, park, lt, g, c,
                                                     parked, flags);
                       });
                       syndrome4<DMAX>(qv, lt, bad);
                     });
}

template <int DMAX, int FAMILY>
struct I8Launch {
  static cudaError_t run(void* qv, void* rcv, void* bits, void* iters,
                         void* conv, void* park, const Tables& t, int nbt,
                         size_t park_elems, int max_iterations, int threads,
                         int flags, cudaStream_t stream) {
    return launch(resident_layered_i8_kernel<DMAX, FAMILY>, nbt, threads,
                  smem_bytes(t, park ? 0 : park_elems), stream,
                  static_cast<int16_t*>(qv), static_cast<int8_t*>(rcv),
                  static_cast<int8_t*>(bits), static_cast<int*>(iters),
                  static_cast<int*>(conv), static_cast<int*>(park), t,
                  park_elems, max_iterations, flags);
  }
};

}  // namespace

// Decodes nbt tiles in place under an i8 rule: qv (nbt, VG, Z, 4) int16
// working posteriors (the quantized channel LLRs on entry), rcv (nbt, E, Z,
// 4) zeroed int8 messages, bits (nbt, VG, Z, 4) int8 raw-channel bits in,
// decoded bits out; iters and conv (nbt, 4) int32 out; park (nbt,
// max_degree, Z, 4) int32 scratch in device memory, or null to park in
// shared memory. tables: the ten layered tables (see Tables in
// layered.cuh). kind: 0 MinstarApprox, 1 Aminstar; flags bit 0 the
// partial hard limit. Bt must be 4, the check degree at most 32 and
// threads at most 256. Returns the launch's cudaError_t.
extern "C" int ldpc_resident_layered_i8_decode(
    void* qv, void* rcv, void* bits, void* iters, void* conv, void* park,
    const void* const* tables, int nbt, int CG, int E, int VG, int Z, int Bt,
    int max_degree, int max_iterations, int threads, int kind, int flags,
    void* stream) {
  if (Bt != kBt || threads > kThreads) return cudaErrorInvalidValue;
  const Tables t = make_tables(tables, CG, E, VG, Z);
  const size_t park_elems = (size_t)max_degree * Z * kBt;
  return static_cast<int>(i8_by_bucket<I8Launch>(
      max_degree, kind, qv, rcv, bits, iters, conv, park, t, nbt, park_elems,
      max_iterations, threads, flags, static_cast<cudaStream_t>(stream)));
}

extern "C" const char* ldpc_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
