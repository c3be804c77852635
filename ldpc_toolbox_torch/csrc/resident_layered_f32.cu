// The f32 (float) instances of the layered kernel of csrc/message_kernels.cuh
// on the float rules of csrc/float_rules.cuh: the four rules (Phi, Tanh,
// Aminstar at check-degree buckets 8, 16, 32 and 64; MinstarApprox at 8,
// 16 and 32).

#include "float_rules.cuh"

// Decodes nbt tiles in place under a float rule, in float: qv (nbt, VG, Z, 4)
// working posteriors (the channel LLRs on entry), rcv (nbt, E, Z, 4) zeroed
// messages, bits (nbt, VG, Z, 4) int8 raw-channel bits in, decoded bits
// out; iters and conv (nbt, 4) int32 out; park (nbt, max_degree, Z, 4)
// scratch in device memory, or null to park in shared memory. tables: the
// ten layered tables (see Tables in layered.cuh). kind: 0 Phi, 1 Tanh, 2
// MinstarApprox, 3 Aminstar; big the missing-lane poke, clamp and prod_max
// Tanh's clamps. Bt must be 4, the check degree at most 64 (32 for
// MinstarApprox) and threads at most 256 (a thread per frame pair of a lane
// in the check lanes). Returns the launch's cudaError_t.
extern "C" int ldpc_resident_layered_float_decode(
    void* qv, void* rcv, void* bits, void* iters, void* conv, void* park,
    const void* const* tables, int nbt, int CG, int E, int VG, int Z, int Bt,
    int max_degree, int max_iterations, int threads, int kind, double big,
    double clamp, double prod_max, void* stream) {
  return ldpc::resident_layered_float_decode<float>(
      qv, rcv, bits, iters, conv, park, tables, nbt, CG, E, VG, Z, Bt,
      max_degree, max_iterations, threads, kind, big, clamp, prod_max, stream);
}

extern "C" const char* ldpc_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
