// The streaming layered sweep with one of its parts removed: a probe of
// where a sweep's time goes (P5). fused_layered_parts_kernel runs
// csrc/streaming.cuh LDPC_FUSED_LAYERED_BODY, the body of the production
// sweep fused_layered_kernel, with a SweepParts (lanes.cuh) that takes one
// part away: the Qv update, the lane rotations or the rule; or it moves Rcv
// alone (read and written back, nothing computed). The whole sweep is
// fused_layered_kernel itself (csrc/fused_layered.cu).
//
// Replaces the Pallas TPU kernel of tools/prof_layered_variants.py
// make_iteration, the bisect of ldpc_toolbox_tpu/ops/fused_layered.py
// fused_layered_iteration (variants normw, noroll, norule, dmaonly; full
// is the sweep itself).
//
// What bounds it on an H100: as the sweep's (csrc/fused_layered.cu): the
// bytes of a tile's Qv and Rcv, and the latency of the dependent loads and
// barriers of the check groups one block walks in turn; the Rcv-only form
// moves Rcv's bytes alone.
//
// What the design does about it: nothing of its own; the parts taken away
// are if-constexpr branches of the shared templates, whose default is the
// whole sweep, so every decode's instances are compiled as before.
// Instances: the min-sum rule (f32 and bf16 messages, f32 Qv) at the
// degree buckets 8 and 16.

#include "streaming.cuh"

namespace {

using namespace ldpc;

// Words of Rcv a thread has in flight: its loads issued before its stores.
constexpr int kRcvDepth = 8;

__device__ __forceinline__ uint2 load_volatile(const uint2* p) {
  uint2 v;
  asm volatile("ld.global.v2.u32 {%0, %1}, [%2];" : "=r"(v.x), "=r"(v.y) : "l"(p));
  return v;
}
__device__ __forceinline__ void store_volatile(uint2* p, uint2 v) {
  asm volatile("st.global.v2.u32 [%0], {%1, %2};" ::"l"(p), "r"(v.x), "r"(v.y) : "memory");
}

// Streams a tile's n 8-byte words of Rcv through the SMs: each read and
// written back in place (volatile, so that neither access is dropped),
// kRcvDepth words a thread in flight.
__device__ __forceinline__ void rcv_read_write(void* rcv, size_t n) {
  auto* p = static_cast<uint2*>(rcv);
  const size_t step = blockDim.x;
  size_t i = threadIdx.x;
  for (; i + (kRcvDepth - 1) * step < n; i += kRcvDepth * step) {
    uint2 v[kRcvDepth];
#pragma unroll
    for (int k = 0; k < kRcvDepth; ++k) v[k] = load_volatile(p + i + k * step);
#pragma unroll
    for (int k = 0; k < kRcvDepth; ++k) store_volatile(p + i + k * step, v[k]);
  }
  for (; i < n; i += step) store_volatile(p + i, load_volatile(p + i));
}

// fused_layered_kernel with the parts PARTS: one sweep of tile blockIdx.x
// in place on qv (VG, Z, 4) and rcv (E, Z, 4), then the hard bits qv <= 0.
template <int DMAX, class Rule, int PARTS>
__global__ void __launch_bounds__(Rule::SweepUnits::kBlock, 2) fused_layered_parts_kernel(
    typename Rule::Q* qv_all, typename Rule::Msg* rcv_all, int8_t* bits_all,
    typename Rule::P* park_all, Tables t, size_t park_elems, Rule rule) {
  if constexpr (PARTS == kSweepRcvOnly) {
    const size_t tile = blockIdx.x, lanes = (size_t)t.VG * t.Z;
    const size_t words = (size_t)t.E * t.Z * kBt;
    rcv_read_write(rcv_all + tile * words, words * sizeof(*rcv_all) / sizeof(uint2));
    __syncthreads();
    const auto* qv = qv_all + tile * lanes * kBt;
    for (size_t i = threadIdx.x; i < lanes; i += blockDim.x)
      store_word(bits_all + (tile * lanes + i) * kBt, hard_word(qv + i * kBt));
  } else {
    LDPC_FUSED_LAYERED_BODY(PARTS)
  }
}

template <int DMAX, typename Msg, int PARTS>
cudaError_t parts_launch(void* qv, void* rcv, void* bits, void* park, const Tables& t, int nbt,
                         size_t park_elems, int threads, float big, float scale,
                         cudaStream_t stream) {
  using Rule = MinSumRule<Msg>;
  return sweep_launch(fused_layered_parts_kernel<DMAX, Rule, PARTS>, Rule{big, scale}, qv, rcv,
                      bits, park, t, nbt, park_elems, threads, stream);
}

// The probe's buckets: 8 and 16 only, to keep its build short.
template <int PARTS, typename... Args>
cudaError_t by_bucket_parts(int max_degree, int msg_bf16, Args... args) {
  if (max_degree < 1 || max_degree > 16) return cudaErrorInvalidValue;
  if (max_degree <= 8)
    return msg_bf16 ? parts_launch<8, __nv_bfloat16, PARTS>(args...)
                    : parts_launch<8, float, PARTS>(args...);
  return msg_bf16 ? parts_launch<16, __nv_bfloat16, PARTS>(args...)
                  : parts_launch<16, float, PARTS>(args...);
}

}  // namespace

// One layered sweep of nbt tiles with a part taken away (lanes.cuh
// SweepParts: 1 no Qv update, 2 no rotations, 3 no rule, 4 Rcv only), in
// place on qv (nbt, VG, Z, 4) f32 and rcv (nbt, E, Z, 4) (bf16 when
// msg_bf16, else f32); bits (nbt, VG, Z, 4) int8 out: qv <= 0 after it.
// The other arguments as ldpc_fused_layered_iteration's
// (csrc/fused_layered.cu); the check degree at most 16. Returns the
// launch's cudaError_t.
extern "C" int ldpc_probe_layered_sweep(void* qv, void* rcv, void* bits, void* park,
                                        const void* const* tables, int nbt, int CG, int E,
                                        int VG, int Z, int Bt, int max_degree, int threads,
                                        float big, float scale, int msg_bf16, int parts,
                                        void* stream) {
  if (Bt != kBt) return cudaErrorInvalidValue;
  const Tables t = make_tables(tables, CG, E, VG, Z);
  const size_t park_elems = (size_t)max_degree * Z * kBt;
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  switch (parts) {
#define LDPC_PARTS(P)                                                                   \
  case P:                                                                               \
    err = by_bucket_parts<P>(max_degree, msg_bf16, qv, rcv, bits, park, t, nbt,         \
                             park_elems, threads, big, scale, s);                       \
    break;
    LDPC_PARTS(kSweepNoQvWrite)
    LDPC_PARTS(kSweepNoRoll)
    LDPC_PARTS(kSweepNoRule)
    LDPC_PARTS(kSweepRcvOnly)
#undef LDPC_PARTS
  }
  return static_cast<int>(err);
}

extern "C" const char* ldpc_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
