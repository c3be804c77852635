// Flooding decode of frame tiles under the i8 rules: the int8 instances of
// the resident flooding kernel of csrc/message_kernels.cuh (all iterations
// in one launch, one thread block per tile, a thread per lane of a tile's
// four frames, one message array in check-major cells, on csrc/lanes.cuh)
// and of the check and variable phase kernels of csrc/streaming.cuh, on
// I8Rule of csrc/i8.cuh. A source of its own, so that the parallel build
// keeps its length.
//
// Replaces the i8 path of ldpc_toolbox_tpu/ops/resident_flooding_dual.py
// resident_flooding_dual_decode and ops/resident_flooding.py
// resident_flooding_decode, the Pallas kernels that keep a tile's int8
// channel planes and messages in the TPU's vector memory and inline
// MinstarApproxI8Rule or AminstarI8Rule (ops/fused_bp2.py). As for the
// float instances, one array serves both. The phase kernels replace the
// i8 paths of ops/fused_bp2.py fused_check and fused_var.
//
// What bounds it on an H100: the state lives in device memory; each
// iteration each edge lane of each frame reads and writes its message in
// each phase (4 x 1 byte), and the syndrome reads the hard-bit words
// (1 byte an edge lane): about 5 bytes, half the bf16 instance's 10. The
// integer work binds instead: MinstarApprox folds a degree-7 check 25
// times, and the byte-SIMD intrinsics of the first form took 39 SASS
// instructions a fold (tools/count_math_ops.py); those folds alone, at the
// rate the card runs them, took 27 % of the flagship decode and the
// per-frame code around them most of the rest (PERF.md section 6).
//
// What the design does about it: the check and its rule work on words of
// a lane's four frames (csrc/i8.cuh: word arithmetic with no carry between
// bytes, 23 instructions a fold; the signs as bit masks), the variable
// update on 16-bit halves of them (Hopper's 16x2 integer min and max for
// the clips); the float instance's form otherwise (the check loop
// unrolled to the degree bucket, the variable phase loading its next
// lane before it stores, tables in shared memory, FloodUnits' block).
//
// Semantics (the JAX package's kernels and plane-gather path): v2c starts
// as the int8 channel value q at every edge; the check lane folds its d
// v2c (127 at the missing lane) and writes each c2v (0 at the missing
// lane); the variable lane takes tot = q (clipped to +-116 when
// Deg1Clip is on and the group has degree 1) plus its c2v in var-major
// slot order, clips tot to +-127 when Jones is on, writes the hard
// decision tot <= 0 and each v2c = clip(tot - c2v, +-127).

#include "i8.cuh"
#include "streaming.cuh"

namespace {

using namespace ldpc;

template <int DMAX, int FAMILY>
struct I8Launch {
  static cudaError_t run(void* msg, const void* q, void* post, void* bits,
                         void* iters, void* conv, const Tables& t, int nbt,
                         int max_iterations, int threads, int flags,
                         cudaStream_t stream) {
    return flooding_launch<DMAX>(I8Rule<FAMILY>{flags}, msg, q, post, bits,
                                 iters, conv, t, nbt, max_iterations, threads,
                                 stream);
  }
};

template <int DMAX, int FAMILY>
struct CheckLaunch {
  static cudaError_t run(const void* v2c, void* c2v, const FloodingTables& t,
                         int nbt, int threads, int flags, cudaStream_t stream) {
    return fused_check_launch<DMAX>(I8Rule<FAMILY>{flags}, v2c, c2v, t, nbt,
                                    threads, stream);
  }
};

}  // namespace

// The whole decode under an i8 rule. It takes the ten layered tables (see
// Tables in layered.cuh), the tile shape (Bt must be 4), the largest check
// degree (at most 32), kind (0 MinstarApprox, 1 Aminstar) and flags (bit 0
// PartialHardLimit, bit 1 Jones, bit 2 Deg1Clip); threads is at most
// I8Rule's FloodUnits block. msg (nbt, E, Z, 4) and post (nbt, VG, Z, 4)
// int8 scratch; q (nbt, VG, Z, 4) int8 quantized channel values; bits
// (nbt, VG, Z, 4) int8 raw-channel bits in, decoded bits out; iters and
// conv (nbt, 4) int32 out. Returns the launch's cudaError_t.
extern "C" int ldpc_resident_flooding_i8_decode(
    void* msg, const void* q, void* post, void* bits, void* iters, void* conv,
    const void* const* tables, int nbt, int CG, int E, int VG, int Z, int Bt,
    int max_degree, int max_iterations, int threads, int kind, int flags,
    void* stream) {
  if (Bt != kBt) return cudaErrorInvalidValue;
  const Tables t = make_tables(tables, CG, E, VG, Z);
  return static_cast<int>(i8_by_bucket<I8Launch>(
      max_degree, kind, msg, q, post, bits, iters, conv, t, nbt,
      max_iterations, threads, flags, static_cast<cudaStream_t>(stream)));
}

// The phases under an i8 rule. They take the layout's eleven int32 tables
// of csrc/flooding.cu (an array of device pointers), the tile shape (Bt
// must be 4), kind (0 MinstarApprox, 1 Aminstar) and flags (bit 0
// PartialHardLimit, bit 1 Jones, bit 2 Deg1Clip); threads is at most 256.
// Each returns the launch's cudaError_t.

// c2v (nbt, E, Z, 4) int8 from v2c (nbt, E, Z, 4) int8; max_degree the
// largest check degree (at most 32).
extern "C" int ldpc_fused_check_i8(const void* v2c, void* c2v,
                                   const void* const* tables, int nbt, int CG,
                                   int VG, int E, int Z, int Bt, int max_degree,
                                   int threads, int kind, int flags,
                                   void* stream) {
  const FloodingTables t = make_flooding_tables(tables, CG, VG, E, Z, Bt);
  return static_cast<int>(i8_by_bucket<CheckLaunch>(
      max_degree, kind, v2c, c2v, t, nbt, threads, flags,
      static_cast<cudaStream_t>(stream)));
}

// v2c (nbt, E, Z, 4) int8 and bits (nbt, VG, Z, 4) int8 from c2v and q
// (nbt, VG, Z, 4) int8; c2v null runs the initialisation (every v2c is q,
// 127 at the missing lanes, no clips). The variable update takes no degree
// bucket: one instance a family.
extern "C" int ldpc_fused_var_i8(const void* c2v, const void* q, void* v2c,
                                 void* bits, const void* const* tables, int nbt,
                                 int CG, int VG, int E, int Z, int Bt,
                                 int threads, int kind, int flags,
                                 void* stream) {
  const FloodingTables t = make_flooding_tables(tables, CG, VG, E, Z, Bt);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == kAminstar)
    return static_cast<int>(fused_var_launch(I8Rule<kAminstar>{flags}, c2v, q, v2c,
                                             bits, t, nbt, threads, s));
  if (kind == kMinstarApprox)
    return static_cast<int>(fused_var_launch(I8Rule<kMinstarApprox>{flags}, c2v, q,
                                             v2c, bits, t, nbt, threads, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// The i8 rules' word steps of csrc/i8.cuh on n words a and b (a byte in
// [0, 127] a frame), for the tests: out (4, n) holds tab4(a),
// minstar_approx4(a, b), minstar_full4(a, b) and phl4(a).
__global__ void i8_steps_kernel(const uint32_t* a, const uint32_t* b, uint32_t* out,
                                int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t x = a[i], y = b[i];
  out[i] = tab4(x);
  out[(size_t)n + i] = minstar_approx4(x, y);
  out[2 * (size_t)n + i] = minstar_full4(x, y);
  out[3 * (size_t)n + i] = phl4(x);
}

extern "C" int ldpc_i8_steps(const void* a, const void* b, void* out, int n,
                             void* stream) {
  if (n < 1) return cudaErrorInvalidValue;
  return static_cast<int>(launch(i8_steps_kernel, dim3((n + kThreads - 1) / kThreads),
                                 kThreads, 0, static_cast<cudaStream_t>(stream),
                                 static_cast<const uint32_t*>(a),
                                 static_cast<const uint32_t*>(b),
                                 static_cast<uint32_t*>(out), n));
}

extern "C" const char* ldpc_flooding_i8_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
