// Horizontal-layered min-sum decode of frame tiles with the check state
// held as messages (Rcv), one thread block per tile of Bt frames:
// - resident_layered_kernel: all iterations in one launch;
// - fused_layered_kernel: one sweep (the streaming form's iteration).
// The sweep, syndrome and decode loop are shared with the compressed
// kernels (csrc/layered.cuh).
//
// Replaces these Pallas TPU kernels of ldpc_toolbox_tpu/ops/:
// - resident_layered.py resident_layered_decode, which keeps one tile's
//   Qv, Rcv and frozen bits in the TPU's vector memory for the whole
//   decode -> resident_layered_kernel;
// - fused_layered.py fused_layered_iteration, one sweep with the Qv tile
//   resident and Rcv slabs streamed in and out -> fused_layered_kernel.
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
// the dependent index loads bound the kernels.
//
// What the design does about it: frames are innermost in every plane, so
// the threads of a warp touch neighbouring frames of neighbouring lanes and
// their accesses coalesce. A check group's signs stay in registers (a
// 64-bit mask) and its deltas in a park between the check update and the
// posterior update: in shared memory when they fit, in device memory
// otherwise (CCSDS C2: 32 x 511 x 4 x 4 bytes). The resident kernel runs
// all iterations in one launch and stops a tile whose frames have all
// converged. The streaming kernel updates Qv and Rcv in place. Tensor
// cores, TMA and a resident group pipeline are later work.

#include "layered.cuh"

namespace {

using namespace ldpc;

template <typename Msg>
__global__ void resident_layered_kernel(float* qv_all, Msg* rcv_all,
                                        int8_t* bits_all, int* iters_out,
                                        int* conv_out, float* park_all,
                                        Tables t, int Bt, size_t park_elems,
                                        int max_iterations, float big,
                                        float scale) {
  extern __shared__ int ctl[];
  const size_t tile = blockIdx.x;
  const int ZB = t.Z * Bt;
  float* qv = qv_all + tile * t.VG * ZB;
  MessageState<Msg> st{rcv_all + tile * t.E * ZB, ZB};
  float* park = tile_park(park_all, park_elems, ctl, Bt);
  decode_tile(qv, bits_all + tile * t.VG * ZB, iters_out, conv_out, t, Bt,
              max_iterations, ctl,
              [&] { layered_sweep(qv, st, t, Bt, big, scale, park); });
}

template <typename Msg>
__global__ void fused_layered_kernel(float* qv_all, Msg* rcv_all,
                                     int8_t* bits_all, float* park_all,
                                     Tables t, int Bt, size_t park_elems,
                                     float big, float scale) {
  extern __shared__ int ctl[];
  const size_t tile = blockIdx.x;
  const int ZB = t.Z * Bt;
  float* qv = qv_all + tile * t.VG * ZB;
  int8_t* bits = bits_all + tile * t.VG * ZB;
  MessageState<Msg> st{rcv_all + tile * t.E * ZB, ZB};
  layered_sweep(qv, st, t, Bt, big, scale, tile_park(park_all, park_elems, ctl, Bt));
  for (int i = threadIdx.x; i < t.VG * ZB; i += blockDim.x) bits[i] = qv[i] <= 0.f;
}

template <typename Msg>
cudaError_t resident_launch(void* qv, void* rcv, void* bits, void* iters,
                            void* conv, void* park, const Tables& t, int nbt,
                            int Bt, size_t park_elems, int max_iterations,
                            int threads, float big, float scale,
                            cudaStream_t stream) {
  const size_t smem = layered_smem(Bt, park ? 0 : park_elems);
  auto kernel = resident_layered_kernel<Msg>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<nbt, threads, smem, stream>>>(
      static_cast<float*>(qv), static_cast<Msg*>(rcv),
      static_cast<int8_t*>(bits), static_cast<int*>(iters),
      static_cast<int*>(conv), static_cast<float*>(park), t, Bt, park_elems,
      max_iterations, big, scale);
  return cudaGetLastError();
}

template <typename Msg>
cudaError_t fused_launch(void* qv, void* rcv, void* bits, void* park,
                         const Tables& t, int nbt, int Bt, size_t park_elems,
                         int threads, float big, float scale,
                         cudaStream_t stream) {
  const size_t smem = layered_smem(Bt, park ? 0 : park_elems);
  auto kernel = fused_layered_kernel<Msg>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<nbt, threads, smem, stream>>>(
      static_cast<float*>(qv), static_cast<Msg*>(rcv),
      static_cast<int8_t*>(bits), static_cast<float*>(park), t, Bt,
      park_elems, big, scale);
  return cudaGetLastError();
}

}  // namespace

// Every entry point takes the ten layout tables as an array of device
// pointers (see Tables in layered.cuh) and the tile shape, and returns the
// launch's cudaError_t. Messages are bf16 when msg_bf16, else f32. park is
// (nbt, max_degree, Z, Bt) f32 scratch in device memory, or null to park
// in shared memory; threads must be a multiple of Bt.

// Decodes nbt tiles in place: qv (nbt, VG, Z, Bt) f32 working posteriors,
// rcv (nbt, E, Z, Bt) zeroed messages, bits (nbt, VG, Z, Bt) int8
// raw-channel bits in, decoded bits out; iters and conv (nbt, Bt) int32 out.
extern "C" int ldpc_resident_layered_decode(
    void* qv, void* rcv, void* bits, void* iters, void* conv, void* park,
    const void* const* tables, int nbt, int CG, int E, int VG, int Z, int Bt,
    int max_degree, int max_iterations, int threads, float big, float scale,
    int msg_bf16, void* stream) {
  const Tables t = make_tables(tables, CG, E, VG, Z);
  const size_t park_elems = (size_t)max_degree * Z * Bt;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      msg_bf16 ? resident_launch<__nv_bfloat16>(
                     qv, rcv, bits, iters, conv, park, t, nbt, Bt, park_elems,
                     max_iterations, threads, big, scale, s)
               : resident_launch<float>(qv, rcv, bits, iters, conv, park, t,
                                        nbt, Bt, park_elems, max_iterations,
                                        threads, big, scale, s));
}

// One layered sweep of nbt tiles, in place on qv (nbt, VG, Z, Bt) f32 and
// rcv (nbt, E, Z, Bt); bits (nbt, VG, Z, Bt) int8 out: qv <= 0 after it.
extern "C" int ldpc_fused_layered_iteration(
    void* qv, void* rcv, void* bits, void* park, const void* const* tables,
    int nbt, int CG, int E, int VG, int Z, int Bt, int max_degree,
    int threads, float big, float scale, int msg_bf16, void* stream) {
  const Tables t = make_tables(tables, CG, E, VG, Z);
  const size_t park_elems = (size_t)max_degree * Z * Bt;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      msg_bf16 ? fused_launch<__nv_bfloat16>(qv, rcv, bits, park, t, nbt, Bt,
                                             park_elems, threads, big, scale, s)
               : fused_launch<float>(qv, rcv, bits, park, t, nbt, Bt,
                                     park_elems, threads, big, scale, s));
}

extern "C" const char* ldpc_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
