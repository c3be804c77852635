// One horizontal-layered sweep of frame tiles (the streaming layered form,
// one launch an iteration) with the check state held as messages (Rcv):
// fused_layered_kernel of csrc/streaming.cuh on the min-sum rule (f32 and
// bf16 messages, f32 Qv); csrc/fused_layered_i8.cu, _f32.cu and _f64.cu
// hold its instances on the other rules. A source of its own, so that the
// parallel build keeps its length.
//
// Replaces the Pallas TPU kernel ldpc_toolbox_tpu/ops/fused_layered.py
// fused_layered_iteration, one sweep with the Qv tile resident in the
// TPU's vector memory and Rcv slabs streamed in and out.
//
// What bounds it on an H100: memory traffic and the latency of a tile's
// dependent loads and barriers, as for the resident layered kernel (see
// csrc/resident_layered.cu): a tile's Qv and Rcv live in device memory,
// and one block walks the tile's check groups in turn.
//
// What the design does about it: the resident kernel's sweep itself
// (csrc/lanes.cuh layered_sweep4 over csrc/message_kernels.cuh
// layered_check_lane: a thread per lane of the tile's four frames, the
// edge loops unrolled to the degree bucket, the deltas added from the
// check lane where a group reaches no variable group twice and parked
// otherwise, the tables in shared memory), then a pass that writes the
// hard bits qv <= 0 as one word a lane.

#include "streaming.cuh"

namespace {

using namespace ldpc;

template <int DMAX, typename Msg>
struct SweepLaunch {
  static cudaError_t run(void* qv, void* rcv, void* bits, void* park,
                         const Tables& t, int nbt, size_t park_elems,
                         int threads, float big, float scale,
                         cudaStream_t stream) {
    return fused_layered_launch<DMAX>(MinSumRule<Msg>{big, scale}, qv, rcv,
                                      bits, park, t, nbt, park_elems, threads,
                                      stream);
  }
};

}  // namespace

// One layered sweep of nbt tiles, in place on qv (nbt, VG, Z, 4) f32 and
// rcv (nbt, E, Z, 4) (bf16 when msg_bf16, else f32); bits (nbt, VG, Z, 4)
// int8 out: qv <= 0 after it. tables: the ten layered tables (see Tables
// in layered.cuh); park (nbt, max_degree, Z, 4) f32 scratch in device
// memory, or null to park in shared memory. Bt must be 4, the check degree
// at most 64 and threads at most 256. Returns the launch's cudaError_t.
extern "C" int ldpc_fused_layered_iteration(
    void* qv, void* rcv, void* bits, void* park, const void* const* tables,
    int nbt, int CG, int E, int VG, int Z, int Bt, int max_degree,
    int threads, float big, float scale, int msg_bf16, void* stream) {
  if (Bt != kBt) return cudaErrorInvalidValue;
  const Tables t = make_tables(tables, CG, E, VG, Z);
  const size_t park_elems = (size_t)max_degree * Z * kBt;
  return static_cast<int>(by_bucket<SweepLaunch>(
      max_degree, msg_bf16, qv, rcv, bits, park, t, nbt, park_elems, threads,
      big, scale, static_cast<cudaStream_t>(stream)));
}

extern "C" const char* ldpc_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
