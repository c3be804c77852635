// Horizontal-layered decode of frame tiles under the i8 rules: the int8
// instances of the resident layered kernel of csrc/message_kernels.cuh
// (all iterations in one launch, one thread block per tile, a thread per
// lane of a tile's four frames, on csrc/lanes.cuh), on I8Rule of
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
// integer work binds instead: the exact-order MinstarApprox folds a
// degree-7 check 25 times, 39 SASS instructions a fold with byte-SIMD intrinsics
// (tools/count_math_ops.py), and the per-frame code around them as much
// again; and a tile walks its check groups in order (PERF.md section 6).
//
// What the design does about it: the check and its rule work on words of
// a lane's four frames (csrc/i8.cuh: word arithmetic with no carry between
// bytes, 23 instructions a fold; the signs as bit masks); x is computed
// per frame from the int16 Qv and packed into a word, the output word
// stored as it is; the float instance's form otherwise (Qv of a lane as
// one 8-byte vector, the edge loops unrolled to the check-degree bucket,
// the direct Qv update where a group reaches no variable group twice and
// the park otherwise, tables in shared memory, LayeredUnits' block).
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

template <int DMAX, int FAMILY>
struct I8Launch {
  static cudaError_t run(void* qv, void* rcv, void* bits, void* iters,
                         void* conv, void* park, const Tables& t, int nbt,
                         size_t park_elems, int max_iterations, int threads,
                         int flags, cudaStream_t stream) {
    return layered_launch<DMAX>(I8Rule<FAMILY>{flags}, qv, rcv, bits, iters,
                                conv, park, t, nbt, park_elems, max_iterations,
                                threads, stream);
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
  if (Bt != kBt) return cudaErrorInvalidValue;
  const Tables t = make_tables(tables, CG, E, VG, Z);
  const size_t park_elems = (size_t)max_degree * Z * kBt;
  return static_cast<int>(i8_by_bucket<I8Launch>(
      max_degree, kind, qv, rcv, bits, iters, conv, park, t, nbt, park_elems,
      max_iterations, threads, flags, static_cast<cudaStream_t>(stream)));
}

extern "C" const char* ldpc_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
