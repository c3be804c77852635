// The f32 (float) instances of the flooding kernel of csrc/message_kernels.cuh
// and of the flooding phase kernels of csrc/streaming.cuh on the float
// rules of csrc/float_rules.cuh: the four rules (Phi, Tanh, Aminstar at
// check-degree buckets 8, 16, 32 and 64; MinstarApprox at 8, 16 and 32;
// the variable phase one instance a rule).

#include "float_rules.cuh"

// The whole decode under a float rule, in float. It takes the ten layered
// tables (see Tables in layered.cuh), the tile shape (Bt must be 4), the
// largest check degree (at most 64, 32 for MinstarApprox), kind (0 Phi, 1
// Tanh, 2 MinstarApprox, 3 Aminstar), big the missing-lane poke and
// Tanh's clamp and prod_max; threads is at most 384 (a frame pair of a
// check lane a thread; FloatRule's FloodUnits). msg (nbt, E, Z, 4)
// and post (nbt, VG, Z, 4) int8 scratch; q (nbt, VG, Z, 4) channel
// values; bits (nbt, VG, Z, 4) int8 raw-channel bits in, decoded bits
// out; iters and conv (nbt, 4) int32 out. Returns the launch's
// cudaError_t.
extern "C" int ldpc_resident_flooding_float_decode(
    void* msg, const void* q, void* post, void* bits, void* iters, void* conv,
    const void* const* tables, int nbt, int CG, int E, int VG, int Z, int Bt,
    int max_degree, int max_iterations, int threads, int kind, double big,
    double clamp, double prod_max, void* stream) {
  return ldpc::resident_flooding_float_decode<float>(
      msg, q, post, bits, iters, conv, tables, nbt, CG, E, VG, Z, Bt,
      max_degree, max_iterations, threads, kind, big, clamp, prod_max, stream);
}

// The phases under a float rule, in float. They take the layout's eleven
// int32 tables of csrc/flooding.cu (an array of device pointers), the tile
// shape (Bt must be 4), kind (0 Phi, 1 Tanh, 2 MinstarApprox, 3 Aminstar),
// big the missing-lane poke and Tanh's clamp and prod_max; threads is at
// most 384 for the check phase (a frame pair of a check lane a thread;
// FloatRule's FloodUnits) and 256 for the variable phase (a lane's four
// frames; VarUnits). Each returns the launch's cudaError_t.

// c2v (nbt, E, Z, 4) from v2c (nbt, E, Z, 4); max_degree the largest check
// degree (at most 64, 32 for MinstarApprox).
extern "C" int ldpc_fused_check_float(const void* v2c, void* c2v,
                                      const void* const* tables, int nbt,
                                      int CG, int VG, int E, int Z, int Bt,
                                      int max_degree, int threads, int kind,
                                      double big, double clamp, double prod_max,
                                      void* stream) {
  return ldpc::fused_check_float<float>(v2c, c2v, tables, nbt, CG, VG, E, Z, Bt,
                                       max_degree, threads, kind, big, clamp,
                                       prod_max, stream);
}

// v2c (nbt, E, Z, 4) and bits (nbt, VG, Z, 4) int8 from c2v and q (nbt, VG,
// Z, 4); c2v null runs the initialisation (every v2c is q, big at the
// missing lanes).
extern "C" int ldpc_fused_var_float(const void* c2v, const void* q, void* v2c,
                                    void* bits, const void* const* tables,
                                    int nbt, int CG, int VG, int E, int Z,
                                    int Bt, int threads, int kind, double big,
                                    double clamp, double prod_max, void* stream) {
  return ldpc::fused_var_float<float>(c2v, q, v2c, bits, tables, nbt, CG, VG, E, Z,
                                     Bt, threads, kind, big, clamp, prod_max,
                                     stream);
}

extern "C" const char* ldpc_flooding_float_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
