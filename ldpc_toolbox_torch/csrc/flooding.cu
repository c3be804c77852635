// Flooding min-sum decode of frame tiles: the three streaming phase kernels
// (check, variable, syndrome) and the whole decode in one launch.
//
// Replaces these Pallas TPU kernels of ldpc_toolbox_tpu/ops/:
// - fused_bp2.py fused_check       -> fused_check_kernel (csrc/streaming.cuh)
// - fused_bp2.py fused_var         -> fused_var_kernel (csrc/streaming.cuh;
//   the initialisation when c2v is null)
// - fused_bp2.py fused_syndrome_bits -> fused_syndrome_kernel
// - resident_flooding_dual.py resident_flooding_dual_decode and
//   resident_flooding.py resident_flooding_decode -> resident_flooding_kernel.
//   The two TPU kernels compute the same function and differ only in how
//   the state fits the TPU's vector memory (two message arrays, or one
//   aliased array). Here the state lives in device memory either way; the
//   kernel keeps one array, which serves both.
// The check, variable and resident kernels are the templates of
// csrc/streaming.cuh and csrc/message_kernels.cuh on MinSumRule (f32 and
// bf16 messages); csrc/flooding_i8.cu, _f32.cu and _f64.cu hold their
// instances on the other rules.
//
// Layout of the phase kernels (as the JAX package's): a tile is Bt frames,
// frames innermost. v2c planes (nbt, E, Z, Bt) are check-major in check
// lane coordinates; c2v planes (nbt, E, Z, Bt) are variable-major in
// variable lane coordinates; q and the hard bits (nbt, VG, Z, Bt) are per
// variable group. Moving a message between the sides is a mod-Z lane shift
// by the edge's lift shift; lanes are indexed mod Z directly (no padded
// plane height). Each plane has exactly one writer: chk_dest and var_dest
// are permutations of the edges, so no atomics touch a float.
//
// What bounds them on an H100: memory traffic, and for the resident kernel
// the latency of a tile's dependent loads. The flagship code (DVB-S2
// n = 64800, rate 1/2) has 226,800 edge lanes and 64,800 variable lanes a
// frame. A bf16 iteration at B = 1024 reads and writes every message once
// in each phase (4 x 464 MB), reads q (133 MB), writes the hard bits
// (66 MB) and reads them once per edge in the syndrome (232 MB): about
// 2.3 GB, 0.7 ms at 3.35 TB/s, about 10 bytes an edge lane. The state of
// one tile (1.8 MB of bf16 messages at Bt = 4) does not fit an SM's 227 KB
// of shared memory, and the batch's (0.5 GB) does not fit the 50 MB L2, so
// it streams through device memory every iteration. Min-sum does a few
// compares per byte, far below the compute roof.
//
// What the resident kernel's design does about it (the form of
// csrc/compressed.cu's kernels, on csrc/lanes.cuh):
// - one thread per lane of a tile, all four frames at once: messages and q
//   move as one 8-byte (bf16) or 16-byte (f32) vector, the hard bits as one
//   4-byte word, and each table load and mod-Z index is done once a lane;
// - one message array, check-major in check lane coordinates: the check
//   lane reads its d v2c from its own cells and writes its d c2v back to
//   them, and the variable lane reads each c2v from its cell (through the
//   rec_* tables) and writes its v2c back to the same cell;
// - the check lane's loop is unrolled to the check-degree bucket (8, 16, 32
//   or 64), so its d loads go out before its fold; the variable lane loads
//   its c2v eight at a time and keeps the first eight in registers for its
//   outputs;
// - a thread issues its next variable lane's loads (q and the first eight
//   c2v) before this lane's arithmetic and stores, so a lane of degree 2
//   or 3 (most of them) does not wait alone; the same for the check phase
//   gained nothing in bf16 and spilled in f32;
// - the syndrome is a pass of its own over the variable phase's hard-bit
//   words (4 bytes a lane): taking it with the next iteration's check
//   phase, as the compressed flooding kernel does with s, measured slower
//   here (the check lane's gathers of the bit words cost more than the
//   pass they save);
// - the layout tables are copied into shared memory once a launch.
// The phase kernels share the lane code (the check lane and the variable
// lane are the resident kernel's, reading and writing the phase's planes);
// the syndrome kernel keeps a thread per (lane, frame).
//
// Bit-exactness with the JAX package (min-sum, f32 or bf16 storage):
// - the check fold is the one of csrc/lanes.cuh: sign x < 0, first minimum
//   wins, m2 folds as min(m2, max(m1, mk)) from big, the scale multiplies
//   the magnitude (__fmul_rn) before the sign;
// - the variable rule sums in slot order, tot = q, then tot = tot + y_t
//   for each slot (__fadd_rn), and emits tot - y_t (__fsub_rn); the hard
//   bit is tot <= 0; the _rn intrinsics keep nvcc from forming an FMA;
// - storage is rounded to nearest even (__float2bfloat16_rn);
// - missing lanes: the check update sees big there and emits 0 there (the
//   phase kernels: big into v2c at var_omask in check coordinates, 0 into
//   c2v at chk_omask in variable coordinates), and the syndrome skips
//   syn_mask.

#include "streaming.cuh"

namespace {

using ldpc::FloodingTables;

__device__ __forceinline__ int chk_end(const FloodingTables& t, int g) {
  return g + 1 < t.CG ? t.chk_cs[g + 1] : t.E;
}

// Parity of check lane c, frame f of check group g over the hard bits of
// one tile: 1 if the check is unsatisfied.
__device__ __forceinline__ int syndrome_item(const int8_t* bits,
                                             const FloodingTables& t, int g, int c,
                                             int f) {
  const size_t ZB = (size_t)t.Z * t.Bt;
  const int e1 = chk_end(t, g);
  int par = 0;
  for (int e = t.chk_cs[g]; e < e1; ++e) {
    if (c == t.syn_mask[e]) continue;
    int w = c - t.syn_rot[e];
    if (w < 0) w += t.Z;
    par ^= bits[t.syn_vg[e] * ZB + w * t.Bt + f] & 1;
  }
  return par;
}

// Splits a flat (group, lane, frame) index of one tile.
struct Item {
  int g, lane, f;
};
__device__ __forceinline__ Item split(int r, const FloodingTables& t) {
  const int ZB = t.Z * t.Bt;
  Item it;
  it.g = r / ZB;
  const int rem = r - it.g * ZB;
  it.lane = rem / t.Bt;
  it.f = rem - it.lane * t.Bt;
  return it;
}

// Ors the unsatisfied checks of the tile's frames into bad[0..Bt), a zeroed
// shared array. blockDim.x is a multiple of Bt, so a thread only ever sees
// one frame and ors once.
__device__ __forceinline__ void syndrome_tile(const int8_t* bits,
                                              const FloodingTables& t, int* bad) {
  const int n = t.CG * t.Z * t.Bt;
  int odd = 0;
  for (int r = threadIdx.x; r < n; r += blockDim.x) {
    const Item it = split(r, t);
    odd |= syndrome_item(bits, t, it.g, it.lane, it.f);
  }
  if (odd) atomicOr(&bad[threadIdx.x % t.Bt], 1);
}

// One block per tile: flags[tile * Bt + f] = 1 if frame f has an
// unsatisfied check.
__global__ void fused_syndrome_kernel(const int8_t* bits_all, int* flags,
                                      FloodingTables t) {
  extern __shared__ int bad[];
  for (int f = threadIdx.x; f < t.Bt; f += blockDim.x) bad[f] = 0;
  __syncthreads();
  const size_t tile = blockIdx.x;
  syndrome_tile(bits_all + tile * t.VG * t.Z * t.Bt, t, bad);
  __syncthreads();
  for (int f = threadIdx.x; f < t.Bt; f += blockDim.x)
    flags[tile * t.Bt + f] = bad[f];
}

}  // namespace

// The resident decode and the check phase by degree bucket: the templates
// of csrc/message_kernels.cuh and csrc/streaming.cuh on the min-sum rule.
namespace ldpc {
namespace {

template <int DMAX, typename Msg>
struct ResidentLaunch {
  static cudaError_t run(void* msg, const void* q, void* post, void* bits,
                         void* iters, void* conv, const Tables& t, int nbt,
                         int max_iterations, int threads, float big,
                         float scale, cudaStream_t stream) {
    return flooding_launch<DMAX>(MinSumRule<Msg>{big, scale}, msg, q, post,
                                 bits, iters, conv, t, nbt, max_iterations,
                                 threads, stream);
  }
};

template <int DMAX, typename Msg>
struct CheckLaunch {
  static cudaError_t run(const void* v2c, void* c2v, const FloodingTables& t,
                         int nbt, int threads, float big, float scale,
                         cudaStream_t stream) {
    return fused_check_launch<DMAX>(MinSumRule<Msg>{big, scale}, v2c, c2v, t,
                                    nbt, threads, stream);
  }
};

}  // namespace
}  // namespace ldpc

// The phase entry points take the layout's eleven int32 tables as an array
// of device pointers (chk_cs, chk_dest, chk_rot, chk_omask, var_cs,
// var_dest, var_rot, var_omask, syn_vg, syn_rot, syn_mask) and the tile
// shape, and return the launch's cudaError_t. Messages are bf16 when
// msg_bf16, else f32; q has the messages' type. The check and variable
// phases take tiles of 4 frames (Bt) and at most 256 threads a block.

// c2v (nbt, E, Z, Bt) from v2c (nbt, E, Z, Bt); max_degree the largest
// check degree (at most 64).
extern "C" int ldpc_fused_check(const void* v2c, void* c2v,
                                const void* const* tables, int nbt, int CG,
                                int VG, int E, int Z, int Bt, int max_degree,
                                float big, float scale, int msg_bf16,
                                int threads, void* stream) {
  const FloodingTables t = ldpc::make_flooding_tables(tables, CG, VG, E, Z, Bt);
  return static_cast<int>(ldpc::by_bucket<ldpc::CheckLaunch>(
      max_degree, msg_bf16, v2c, c2v, t, nbt, threads, big, scale,
      static_cast<cudaStream_t>(stream)));
}

// v2c (nbt, E, Z, Bt) and bits (nbt, VG, Z, Bt) int8 from c2v and q
// (nbt, VG, Z, Bt); c2v null runs the initialisation.
extern "C" int ldpc_fused_var(const void* c2v, const void* q, void* v2c,
                              void* bits, const void* const* tables, int nbt,
                              int CG, int VG, int E, int Z, int Bt, float big,
                              int msg_bf16, int threads, void* stream) {
  const FloodingTables t = ldpc::make_flooding_tables(tables, CG, VG, E, Z, Bt);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      msg_bf16 ? ldpc::fused_var_launch(ldpc::MinSumRule<__nv_bfloat16>{big, 1.f}, c2v,
                                        q, v2c, bits, t, nbt, threads, s)
               : ldpc::fused_var_launch(ldpc::MinSumRule<float>{big, 1.f}, c2v, q,
                                        v2c, bits, t, nbt, threads, s));
}

// flags (nbt, Bt) int32 from bits (nbt, VG, Z, Bt) int8; threads must be a
// multiple of Bt.
extern "C" int ldpc_fused_syndrome(const void* bits, void* flags,
                                   const void* const* tables, int nbt, int CG,
                                   int VG, int E, int Z, int Bt, int threads,
                                   void* stream) {
  const FloodingTables t = ldpc::make_flooding_tables(tables, CG, VG, E, Z, Bt);
  fused_syndrome_kernel<<<nbt, threads, sizeof(int) * Bt,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(bits), static_cast<int*>(flags), t);
  return static_cast<int>(cudaGetLastError());
}

// The whole decode. It takes the ten layered tables instead (see Tables in
// layered.cuh), the tile shape (Bt must be 4) and the largest check degree
// (at most 64); threads is at most 256. msg (nbt, E, Z, 4) and post (nbt,
// VG, Z, 4) int8 scratch; q (nbt, VG, Z, 4) channel planes; bits (nbt, VG,
// Z, 4) int8 raw-channel bits in, decoded bits out; iters and conv (nbt, 4)
// int32 out.
extern "C" int ldpc_resident_flooding_decode(
    void* msg, const void* q, void* post, void* bits, void* iters, void* conv,
    const void* const* tables, int nbt, int CG, int E, int VG, int Z, int Bt,
    int max_degree, int max_iterations, int threads, float big, float scale,
    int msg_bf16, void* stream) {
  if (Bt != ldpc::kBt || threads > ldpc::kThreads) return cudaErrorInvalidValue;
  const ldpc::Tables t = ldpc::make_tables(tables, CG, E, VG, Z);
  return static_cast<int>(ldpc::by_bucket<ldpc::ResidentLaunch>(
      max_degree, msg_bf16, msg, q, post, bits, iters, conv, t, nbt,
      max_iterations, threads, big, scale, static_cast<cudaStream_t>(stream)));
}

extern "C" const char* ldpc_flooding_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
