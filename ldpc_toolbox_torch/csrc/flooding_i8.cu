// Flooding decode of frame tiles under the i8 rules: the int8 instances of
// the resident message kernel of csrc/flooding.cu (all iterations in one
// launch, one thread block per tile, a thread per lane of a tile's four
// frames, one message array in check-major cells, on csrc/lanes.cuh), with
// the rules of csrc/i8.cuh. A source of its own, so that the parallel build
// keeps its length.
//
// Replaces the i8 path of ldpc_toolbox_tpu/ops/resident_flooding_dual.py
// resident_flooding_dual_decode and ops/resident_flooding.py
// resident_flooding_decode, the Pallas kernels that keep a tile's int8
// channel planes and messages in the TPU's vector memory and inline
// MinstarApproxI8Rule or AminstarI8Rule (ops/fused_bp2.py). As for the
// float instances, one array serves both.
//
// What bounds it on an H100: the state lives in device memory; each
// iteration each edge lane of each frame reads and writes its message in
// each phase (4 x 1 byte), and the syndrome reads the hard-bit words
// (1 byte an edge lane): about 5 bytes, half the bf16 instance's 10. The
// min* folds add integer work, far below the INT32 roof at the flagship's
// degree 7.
//
// What the design does about it: the float instance's form (a lane's four
// int8 messages as one word, the check loop unrolled to the degree bucket,
// the variable phase loading its next lane before it stores, tables in
// shared memory, 256 threads), with the check's four frames folded as
// bytes of one word.
//
// Semantics (the JAX package's kernels and plane-gather path): v2c starts
// as the int8 channel value q at every edge; the check lane folds its d
// v2c (127 at the missing lane) and writes each c2v (0 at the missing
// lane); the variable lane takes tot = q (clipped to +-116 when
// Deg1Clip is on and the group has degree 1) plus its c2v in var-major
// slot order, clips tot to +-127 when Jones is on, writes the hard
// decision tot <= 0 and each v2c = clip(tot - c2v, +-127).

#include "i8.cuh"

namespace {

using namespace ldpc;

// Variable update of variable lane w of group vg in one tile, from its
// first loads v.
__device__ __forceinline__ void i8_var_update(int8_t* msg, int8_t* post,
                                              const LaneTables& t, int vg, int w,
                                              const VarLoads<int8_t>& v,
                                              int flags) {
  const int p0 = t.var_cs[vg], p1 = t.var_cs[vg + 1];
  const bool clip_q = (flags & kDeg1Clip) && p1 - p0 == 1;
  I4 tot;
#pragma unroll
  for (int f = 0; f < kBt; ++f) {
    const int q = byte_of(v.q, f);
    tot.v[f] = clip_q ? min(max(q, -116), 116) : q;
  }
  auto add = [&](uint32_t y) {
#pragma unroll
    for (int f = 0; f < kBt; ++f) tot.v[f] += byte_of(y, f);
  };
#pragma unroll
  for (int j = 0; j < kVarChunk; ++j)
    if (p0 + j < p1) add(v.y0[j]);
  for (int c0 = p0 + kVarChunk; c0 < p1; c0 += kVarChunk) {
    uint32_t y[kVarChunk];
#pragma unroll
    for (int j = 0; j < kVarChunk; ++j)
      if (c0 + j < p1) y[j] = load_word(var_cell(msg, t, c0 + j, w));
#pragma unroll
    for (int j = 0; j < kVarChunk; ++j)
      if (c0 + j < p1) add(y[j]);
  }
  if (flags & kJones) {
#pragma unroll
    for (int f = 0; f < kBt; ++f) tot.v[f] = clip127(tot.v[f]);
  }
  store_word(post + ((size_t)vg * t.Z + w) * kBt, hard_bits(tot));
  auto output = [&](int p, uint32_t y) {
    uint32_t o = 0;
#pragma unroll
    for (int f = 0; f < kBt; ++f) o |= byte_at(clip127(tot.v[f] - byte_of(y, f)), f);
    store_word(var_cell(msg, t, p, w), o);
  };
#pragma unroll
  for (int j = 0; j < kVarChunk; ++j)
    if (p0 + j < p1) output(p0 + j, v.y0[j]);
  for (int p = p0 + kVarChunk; p < p1; ++p) output(p, load_word(var_cell(msg, t, p, w)));
}

// Check update of check lane c of group g in one tile under FAMILY (flags:
// the partial hard limit): folds the group's d v2c, read from its own
// cells (e, c) (127 at the missing lane, whatever the cell holds), and
// writes its d c2v to the same cells, 0 at the missing lane.
template <int DMAX, int FAMILY>
__device__ __forceinline__ void i8_check_lane(int8_t* msg, const LaneTables& t,
                                              int g, int c, int flags) {
  const int Z = t.Z;
  const int e0 = t.chk_cs[g], d = t.chk_cs[g + 1] - e0;
  uint32_t x[DMAX];
#pragma unroll
  for (int k = 0; k < DMAX; ++k)
    if (k < d) x[k] = load_word(msg + ((size_t)(e0 + k) * Z + c) * kBt);
  I8Check<DMAX> in;
#pragma unroll
  for (int k = 0; k < DMAX; ++k) {
    if (k < d) {
      const bool missing = c == t.syn_mask[e0 + k];
      I4 xk;
#pragma unroll
      for (int f = 0; f < kBt; ++f) xk.v[f] = missing ? 127 : byte_of(x[k], f);
      in.set(k, xk);
    }
  }
  i8_outputs<DMAX, FAMILY>(in, d, flags & kPartialHardLimit, [&](int k, uint32_t om) {
    const int e = e0 + k;
    uint32_t o = 0;
    if (c != t.syn_mask[e]) {
#pragma unroll
      for (int f = 0; f < kBt; ++f) o |= byte_at(in.out(k, f, om), f);
    }
    store_word(msg + ((size_t)e * Z + c) * kBt, o);
  });
}

// The whole flooding decode of one tile per block under FAMILY and flags.
// msg (E, Z, 4) int8 holds each edge's message in check-major cells, in
// check lane coordinates (v2c after a variable phase, c2v after a check
// phase); q (VG, Z, 4) the int8 channel values; post (VG, Z, 4) int8 the
// posterior hard decisions; bits the raw-channel bits on entry and the
// decoded bits on exit.
template <int DMAX, int FAMILY>
__global__ void __launch_bounds__(kThreads, 2) resident_flooding_i8_kernel(
    int8_t* msg_all, const int8_t* q_all, int8_t* post_all, int8_t* bits_all,
    int* iters_out, int* conv_out, Tables t, int max_iterations, int flags) {
  extern __shared__ __align__(16) int smem[];
  const size_t tile = blockIdx.x;
  const int Z = t.Z, cn = t.CG * Z, vn = t.VG * Z;
  const LaneTables lt = load_tables(t, smem + kCtlInts);
  int8_t* msg = msg_all + tile * t.E * Z * kBt;
  const int8_t* q = q_all + tile * vn * kBt;
  int8_t* post = post_all + tile * vn * kBt;
  int8_t* bits = bits_all + tile * vn * kBt;
  // v2c = q at every edge
  for (int r = threadIdx.x; r < vn; r += blockDim.x) {
    const int vg = r / Z, w = r % Z;
    const uint32_t qw = load_word(q + (size_t)r * kBt);
    for (int p = lt.var_cs[vg]; p < lt.var_cs[vg + 1]; ++p)
      store_word(var_cell(msg, lt, p, w), qw);
  }
  decode_tile4<DMAX>(
      post, bits, iters_out, conv_out, lt, max_iterations, smem,
      [&](int, int* bad) {
        for (int r = threadIdx.x; r < cn; r += blockDim.x)
          i8_check_lane<DMAX, FAMILY>(msg, lt, r / Z, r % Z, flags);
        __syncthreads();
        var_phase(msg, q, lt, [&](int vg, int w, const VarLoads<int8_t>& v) {
          i8_var_update(msg, post, lt, vg, w, v, flags);
        });
        __syncthreads();
        syndrome4<DMAX>(post, lt, bad);
      });
}

template <int DMAX, int FAMILY>
struct I8Launch {
  static cudaError_t run(void* msg, const void* q, void* post, void* bits,
                         void* iters, void* conv, const Tables& t, int nbt,
                         int max_iterations, int threads, int flags,
                         cudaStream_t stream) {
    return launch(resident_flooding_i8_kernel<DMAX, FAMILY>, nbt, threads,
                  smem_bytes(t, 0), stream, static_cast<int8_t*>(msg),
                  static_cast<const int8_t*>(q), static_cast<int8_t*>(post),
                  static_cast<int8_t*>(bits), static_cast<int*>(iters),
                  static_cast<int*>(conv), t, max_iterations, flags);
  }
};

}  // namespace

// The whole decode under an i8 rule. It takes the ten layered tables (see
// Tables in layered.cuh), the tile shape (Bt must be 4), the largest check
// degree (at most 32), kind (0 MinstarApprox, 1 Aminstar) and flags (bit 0
// PartialHardLimit, bit 1 Jones, bit 2 Deg1Clip); threads is at most 256.
// msg (nbt, E, Z, 4) and post (nbt, VG, Z, 4) int8 scratch; q (nbt, VG, Z,
// 4) int8 quantized channel values; bits (nbt, VG, Z, 4) int8 raw-channel
// bits in, decoded bits out; iters and conv (nbt, 4) int32 out. Returns
// the launch's cudaError_t.
extern "C" int ldpc_resident_flooding_i8_decode(
    void* msg, const void* q, void* post, void* bits, void* iters, void* conv,
    const void* const* tables, int nbt, int CG, int E, int VG, int Z, int Bt,
    int max_degree, int max_iterations, int threads, int kind, int flags,
    void* stream) {
  if (Bt != kBt || threads > kThreads) return cudaErrorInvalidValue;
  const Tables t = make_tables(tables, CG, E, VG, Z);
  return static_cast<int>(i8_by_bucket<I8Launch>(
      max_degree, kind, msg, q, post, bits, iters, conv, t, nbt,
      max_iterations, threads, flags, static_cast<cudaStream_t>(stream)));
}

extern "C" const char* ldpc_flooding_i8_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
