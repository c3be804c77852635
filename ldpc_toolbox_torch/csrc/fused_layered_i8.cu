// One horizontal-layered sweep of frame tiles under the i8 rules: the int8
// instances of fused_layered_kernel (csrc/streaming.cuh) on I8Rule of
// csrc/i8.cuh, int16 Qv, int8 Rcv and int32 parked deltas. A source of its
// own, so that the parallel build keeps its length.
//
// Replaces the i8 path of the Pallas TPU kernel
// ldpc_toolbox_tpu/ops/fused_layered.py fused_layered_iteration, which
// inlines MinstarApproxI8Rule or AminstarI8Rule (ops/fused_bp2.py) and
// keeps Qv in int16 (_I8RuleBase.qv_dtype).
//
// What bounds it on an H100, and the design: those of the resident i8
// layered kernel (csrc/resident_layered_i8.cu), one iteration a launch,
// then the hard bits qv <= 0.
//
// Semantics (the JAX package's): x = clip(Qv - Rold, +-127) from the
// layer-entry Qv, 127 at the missing lane; Rnew from the rule, 0 at the
// missing lane, stored as int8; Qv += Rnew - Rold in int16, wrapping, in
// edge order.

#include "i8.cuh"
#include "streaming.cuh"

namespace {

using namespace ldpc;

template <int DMAX, int FAMILY>
struct SweepLaunch {
  static cudaError_t run(void* qv, void* rcv, void* bits, void* park,
                         const Tables& t, int nbt, size_t park_elems,
                         int threads, int flags, cudaStream_t stream) {
    return fused_layered_launch<DMAX>(I8Rule<FAMILY>{flags}, qv, rcv, bits,
                                      park, t, nbt, park_elems, threads, stream);
  }
};

}  // namespace

// One layered sweep of nbt tiles under an i8 rule, in place on qv (nbt,
// VG, Z, 4) int16 and rcv (nbt, E, Z, 4) int8; bits (nbt, VG, Z, 4) int8
// out: qv <= 0 after it. park (nbt, max_degree, Z, 4) int32 scratch in
// device memory, or null to park in shared memory. tables: the ten layered
// tables (see Tables in layered.cuh). kind: 0 MinstarApprox, 1 Aminstar;
// flags bit 0 the partial hard limit. Bt must be 4, the check degree at
// most 32 and threads at most 256. Returns the launch's cudaError_t.
extern "C" int ldpc_fused_layered_iteration_i8(
    void* qv, void* rcv, void* bits, void* park, const void* const* tables,
    int nbt, int CG, int E, int VG, int Z, int Bt, int max_degree,
    int threads, int kind, int flags, void* stream) {
  if (Bt != kBt) return cudaErrorInvalidValue;
  const Tables t = make_tables(tables, CG, E, VG, Z);
  const size_t park_elems = (size_t)max_degree * Z * kBt;
  return static_cast<int>(i8_by_bucket<SweepLaunch>(
      max_degree, kind, qv, rcv, bits, park, t, nbt, park_elems, threads,
      flags, static_cast<cudaStream_t>(stream)));
}

extern "C" const char* ldpc_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
