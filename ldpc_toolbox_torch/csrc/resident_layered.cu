// Horizontal-layered min-sum decode of frame tiles with the check state
// held as messages (Rcv), one thread block per tile:
// resident_layered_kernel (csrc/message_kernels.cuh, on MinSumRule here),
// all iterations in one launch, a thread per lane of a tile's four frames
// (csrc/lanes.cuh, the form of the compressed kernels of
// csrc/compressed.cu). The streaming form's sweep, the same lane code one
// iteration a launch, is csrc/fused_layered.cu.
//
// Replaces the Pallas TPU kernel ldpc_toolbox_tpu/ops/resident_layered.py
// resident_layered_decode, which keeps one tile's Qv, Rcv and frozen bits
// in the TPU's vector memory for the whole decode.
//
// What bounds them on an H100: that state does not fit on an SM (one DVB-S2
// n=64800 frame holds Qv f32 259 KB and Rcv bf16 454 KB; an SM has 227 KB of
// shared memory), so Qv, Rcv and the bits live in device memory. Each
// iteration, each edge lane of each frame reads and writes its Rcv (2 + 2
// bytes in bf16, 4 + 4 in f32), reads Qv for the check update (4 bytes),
// reads and writes Qv for the posterior update (4 + 4) and reads Qv again
// for the syndrome (4): about 20 bytes. The flagship code has 630 * 360 =
// 226,800 edge lanes, so one iteration at B = 1024 moves about 4.6 GB:
// about 1.4 ms at the card's 3.35 TB/s. Min-sum does a few compares per
// byte, far below the compute roof, so memory traffic and the latency of
// a tile's dependent loads and barriers (one block walks its check groups
// in turn) bound the kernels.
//
// What the resident kernel's design does about it:
// - a thread per lane, all four frames at once: Qv moves as one 16-byte
//   vector, Rcv as one 8-byte (bf16) or 16-byte (f32) vector, and each
//   table load and mod-Z index is done once a lane;
// - the check lane's edge loops are unrolled to the check-degree bucket
//   (8, 16, 32 or 64): its d Qv gathers and d Rcv loads go out before its
//   fold, and Rold stays in registers (bf16 packed) through its outputs;
// - a group that reaches no variable group twice (82 of the flagship's 90)
//   adds its deltas to Qv from the check lane that gathered them: no park
//   and one barrier. A group that does parks its deltas (in shared memory
//   after the tables, or in device memory when they do not fit: CCSDS C2,
//   32 x 511 x 4 x 4 bytes) and its variable lanes add them in edge order;
// - the layout tables live in shared memory, 256 threads a block, two
//   blocks an SM.

#include "message_kernels.cuh"

namespace {

using namespace ldpc;

template <int DMAX, typename Msg>
struct ResidentLaunch {
  static cudaError_t run(void* qv, void* rcv, void* bits, void* iters,
                         void* conv, void* park, const Tables& t, int nbt,
                         size_t park_elems, int max_iterations, int threads,
                         float big, float scale, cudaStream_t stream) {
    return layered_launch<DMAX>(MinSumRule<Msg>{big, scale}, qv, rcv, bits,
                                iters, conv, park, t, nbt, park_elems,
                                max_iterations, threads, stream);
  }
};

}  // namespace

// The entry point takes the ten layout tables as an array of device
// pointers (see Tables in layered.cuh) and the tile shape, and returns the
// launch's cudaError_t. Messages are bf16 when msg_bf16, else f32. park is
// (nbt, max_degree, Z, Bt) f32 scratch in device memory, or null to park
// in shared memory.

// Decodes nbt tiles in place: qv (nbt, VG, Z, 4) f32 working posteriors,
// rcv (nbt, E, Z, 4) zeroed messages, bits (nbt, VG, Z, 4) int8
// raw-channel bits in, decoded bits out; iters and conv (nbt, 4) int32 out.
// Bt must be 4, the check degree at most 64 and threads at most 256.
extern "C" int ldpc_resident_layered_decode(
    void* qv, void* rcv, void* bits, void* iters, void* conv, void* park,
    const void* const* tables, int nbt, int CG, int E, int VG, int Z, int Bt,
    int max_degree, int max_iterations, int threads, float big, float scale,
    int msg_bf16, void* stream) {
  if (Bt != kBt) return cudaErrorInvalidValue;
  const Tables t = make_tables(tables, CG, E, VG, Z);
  const size_t park_elems = (size_t)max_degree * Z * kBt;
  return static_cast<int>(by_bucket<ResidentLaunch>(
      max_degree, msg_bf16, qv, rcv, bits, iters, conv, park, t, nbt,
      park_elems, max_iterations, threads, big, scale,
      static_cast<cudaStream_t>(stream)));
}

extern "C" const char* ldpc_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
