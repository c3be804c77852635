// The f32 (float) instances of the streaming layered sweep, fused_layered_kernel
// of csrc/streaming.cuh, on the float rules of csrc/float_rules.cuh: the
// four rules (Phi, Tanh, Aminstar at check-degree buckets 8, 16, 32 and 64;
// MinstarApprox at 8, 16 and 32). A source of its own, so that the
// parallel build keeps its length.

#include "float_rules.cuh"

// One layered sweep of nbt tiles under a float rule, in float: in place on qv
// (nbt, VG, Z, 4) and rcv (nbt, E, Z, 4); bits (nbt, VG, Z, 4) int8 out: qv
// <= 0 after it. park (nbt, max_degree, Z, 4) scratch in device memory, or
// null to park in shared memory. tables: the ten layered tables (see
// Tables in layered.cuh). kind: 0 Phi, 1 Tanh, 2 MinstarApprox, 3
// Aminstar; big the missing-lane poke, clamp and prod_max Tanh's clamps.
// Bt must be 4, the check degree at most 64 (32 for MinstarApprox) and
// threads at most 256. Returns the launch's cudaError_t.
extern "C" int ldpc_fused_layered_iteration_float(
    void* qv, void* rcv, void* bits, void* park, const void* const* tables,
    int nbt, int CG, int E, int VG, int Z, int Bt, int max_degree,
    int threads, int kind, double big, double clamp, double prod_max,
    void* stream) {
  return ldpc::fused_layered_float_iteration<float>(
      qv, rcv, bits, park, tables, nbt, CG, E, VG, Z, Bt, max_degree, threads,
      kind, big, clamp, prod_max, stream);
}

extern "C" const char* ldpc_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
