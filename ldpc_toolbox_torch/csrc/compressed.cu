// Min-sum decodes of frame tiles with the check state compressed to signs
// and two magnitudes a check, one thread block per tile of Bt frames, all
// iterations in one launch:
// - compressed_layered_kernel: the layered schedule (csrc/layered.cuh's
//   sweep with CompressedState);
// - compressed_flooding_kernel: the flooding schedule.
//
// Replaces these Pallas TPU kernels of
// ldpc_toolbox_tpu/ops/resident_compressed.py:
// - compressed_layered_decode -> compressed_layered_kernel. State: Qv f32
//   (VG, Z, Bt); sigma int8 (E, Z, Bt) in {-2, -1, 0, 1, 2}, |sigma| = 2 at
//   the argmin slot, 0 at the missing lane; min1, min2 (CG, Z, Bt) in the
//   storage type, post-scale.
// - compressed_flooding_decode -> compressed_flooding_kernel. State: s f32
//   (VG, Z, Bt), the posterior totals; ssign int8 (E, Z, Bt), each edge's
//   c2v sign (+-1, 0 at the missing lane); min1, min2 (CG, Z, Bt) in the
//   storage type and argm int8 (CG, Z, Bt).
// Min-sum's check outputs are determined by (signs, min1, min2, argmin), so
// both are lossless: the only internal difference from the message kernels
// is the sign of some zeros, which no comparison, |.| or hard decision
// sees. On the TPU they let the f32 names' state fit the vector memory.
//
// What bounds them on an H100: the state lives in device memory (flagship
// DVB-S2 R1_2 at B = 1024: about 0.8 GB either way) and streams through it
// every iteration. Layered, per edge lane an iteration: sigma read and
// written (2 bytes), Qv read for the check (4), read and written for the
// update (8), read for the syndrome (4), and min1/min2 read and written
// once a check lane (16 bytes in f32, 2.3 per edge lane): about 20.3
// bytes, against 24 for the f32 message kernel. Flooding, per edge lane:
// s read for the check (4) and for the syndrome (4), sigma read and written
// (2), and the variable phase gathers sigma, argm and one magnitude (6 in
// f32); per check lane min1, min2 and argm read and written (18 in f32,
// 2.6 per edge lane); per variable lane q read and s written (8, 2.3 per
// edge lane): about 21 bytes per edge lane, against about 18 for the bf16
// message kernel and 26 for f32. Min-sum does a few compares
// per byte, far below the compute roof.
//
// What the design does about it: as the message kernels (frames innermost
// so accesses coalesce; one block per tile, per-tile early exit); the
// layered kernel shares their sweep and its park. The flooding kernel's
// check phase keeps a check's fold in registers and writes its compressed
// state once; its variable phase rebuilds each c2v from that state through
// the var-major reconstruction tables (rec_*), so no c2v plane is stored.
//
// Bit-exactness with the JAX package: csrc/layered.cuh's rules, and
// - Rold = w1 * min1 + w2 * min2 and c2v = sigma * select(argm == t, min2,
//   min1) are computed with __fmul_rn / __fadd_rn, op for op;
// - flooding v2c = store(s - c2v) (rounded to the storage type, as the
//   message kernels store it), big at the missing lane; s = q + sum of the
//   rebuilt c2v in var-major slot order (__fadd_rn); the syndrome reads
//   s <= 0 (Qv <= 0 for layered).

#include "layered.cuh"

namespace {

using namespace ldpc;

template <typename Msg>
__global__ void compressed_layered_kernel(float* qv_all, int8_t* ssign_all,
                                          Msg* min1_all, Msg* min2_all,
                                          int8_t* bits_all, int* iters_out,
                                          int* conv_out, float* park_all,
                                          Tables t, int Bt, size_t park_elems,
                                          int max_iterations, float big,
                                          float scale) {
  extern __shared__ int ctl[];
  const size_t tile = blockIdx.x;
  const int ZB = t.Z * Bt;
  float* qv = qv_all + tile * t.VG * ZB;
  CompressedState<Msg> st{ssign_all + tile * t.E * ZB,
                          min1_all + tile * t.CG * ZB,
                          min2_all + tile * t.CG * ZB, ZB, 0.f, 0.f};
  float* park = tile_park(park_all, park_elems, ctl, Bt);
  decode_tile(qv, bits_all + tile * t.VG * ZB, iters_out, conv_out, t, Bt,
              max_iterations, ctl,
              [&] { layered_sweep(qv, st, t, Bt, big, scale, park); });
}

// Check update of check lane c, frame f of check group g in one tile:
// rebuilds v2c = store(s - c2v_old) from the old state, folds it, and
// writes the new state in place.
template <typename Msg>
__device__ __forceinline__ void compressed_check_item(
    const float* s, int8_t* ssign, Msg* min1, Msg* min2, int8_t* argm,
    const Tables& t, int g, int i, int Bt, float big, float scale) {
  const int ZB = t.Z * Bt;
  const int c = i / Bt, f = i - c * Bt;
  const int e0 = t.chk_cs[g], d = group_end(t, g) - e0;
  const int at = g * ZB + i;
  const float m1o = load_msg(min1 + at), m2o = load_msg(min2 + at);
  const int ao = argm[at];
  float m1 = 0.f, m2 = big;
  int arg = 0, par = 0;
  uint64_t negs = 0;  // d <= 64, checked by the wrapper
  for (int k = 0; k < d; ++k) {
    const int e = e0 + k;
    const float c2v =
        __fmul_rn((float)ssign[(size_t)e * ZB + i], ao == k ? m2o : m1o);
    float x = round_msg(__fsub_rn(s[qv_at(t, e, c, f, Bt)], c2v), min1);
    if (c == t.syn_mask[e]) x = big;
    const float mk = fabsf(x);
    const int neg = x < 0.f;
    negs |= (uint64_t)neg << k;
    if (k == 0) {
      m1 = mk;
      par = neg;
    } else {
      m2 = fminf(m2, fmaxf(m1, mk));
      if (mk < m1) {
        m1 = mk;
        arg = k;
      }
      par ^= neg;
    }
  }
  if (scale != 1.f) {
    m1 = __fmul_rn(m1, scale);
    m2 = __fmul_rn(m2, scale);
  }
  for (int k = 0; k < d; ++k) {
    const int e = e0 + k;
    const int8_t sg = c == t.syn_mask[e]
                          ? 0
                          : ((par ^ (int)((negs >> k) & 1u)) ? -1 : 1);
    ssign[(size_t)e * ZB + i] = sg;
  }
  store_msg(min1 + at, m1);
  store_msg(min2 + at, m2);
  argm[at] = (int8_t)arg;
}

// Variable update of variable lane w, frame f of variable group vg in one
// tile: s = q + the group's c2v in var-major slot order, each rebuilt from
// the check state at check lane w - rec_rot.
template <typename Msg>
__device__ __forceinline__ void compressed_var_item(
    float* s, const Msg* q, const int8_t* ssign, const Msg* min1,
    const Msg* min2, const int8_t* argm, const Tables& t, int vg, int i,
    int Bt) {
  const int ZB = t.Z * Bt;
  const int w = i / Bt, f = i - w * Bt;
  const int p0 = t.var_cs[vg];
  const int p1 = vg + 1 < t.VG ? t.var_cs[vg + 1] : t.E;
  const int at = vg * ZB + i;
  float tot = load_msg(q + at);
  for (int p = p0; p < p1; ++p) {
    int c = w - t.rec_rot[p];
    if (c < 0) c += t.Z;
    const int m = t.rec_group[p] * ZB + c * Bt + f;
    const float sel = argm[m] == t.rec_slot[p] ? load_msg(min2 + m)
                                               : load_msg(min1 + m);
    const float c2v =
        __fmul_rn((float)ssign[(size_t)t.rec_plane[p] * ZB + c * Bt + f], sel);
    tot = __fadd_rn(tot, c2v);
  }
  s[at] = tot;
}

template <typename Msg>
__global__ void __launch_bounds__(512) compressed_flooding_kernel(
    float* s_all, const Msg* q_all, int8_t* ssign_all, Msg* min1_all,
    Msg* min2_all, int8_t* argm_all, int8_t* bits_all, int* iters_out,
    int* conv_out, Tables t, int Bt, int max_iterations, float big,
    float scale) {
  extern __shared__ int ctl[];
  const size_t tile = blockIdx.x;
  const int ZB = t.Z * Bt;
  float* s = s_all + tile * t.VG * ZB;
  const Msg* q = q_all + tile * t.VG * ZB;
  int8_t* ssign = ssign_all + tile * t.E * ZB;
  Msg* min1 = min1_all + tile * t.CG * ZB;
  Msg* min2 = min2_all + tile * t.CG * ZB;
  int8_t* argm = argm_all + tile * t.CG * ZB;
  const int cn = t.CG * ZB, vn = t.VG * ZB;
  // s starts as the channel planes; sigma = 0 everywhere rebuilds c2v = 0,
  // so the first check phase sees v2c = store(q) as the message kernels do
  for (int r = threadIdx.x; r < vn; r += blockDim.x) s[r] = load_msg(q + r);
  decode_tile(s, bits_all + tile * t.VG * ZB, iters_out, conv_out, t, Bt,
              max_iterations, ctl, [&] {
                for (int r = threadIdx.x; r < cn; r += blockDim.x)
                  compressed_check_item(s, ssign, min1, min2, argm, t, r / ZB,
                                        r % ZB, Bt, big, scale);
                __syncthreads();
                for (int r = threadIdx.x; r < vn; r += blockDim.x)
                  compressed_var_item(s, q, ssign, min1, min2, argm, t,
                                      r / ZB, r % ZB, Bt);
                __syncthreads();
              });
}

template <typename Msg>
cudaError_t layered_launch(void* qv, void* ssign, void* min1, void* min2,
                           void* bits, void* iters, void* conv, void* park,
                           const Tables& t, int nbt, int Bt,
                           size_t park_elems, int max_iterations, int threads,
                           float big, float scale, cudaStream_t stream) {
  const size_t smem = layered_smem(Bt, park ? 0 : park_elems);
  auto kernel = compressed_layered_kernel<Msg>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<nbt, threads, smem, stream>>>(
      static_cast<float*>(qv), static_cast<int8_t*>(ssign),
      static_cast<Msg*>(min1), static_cast<Msg*>(min2),
      static_cast<int8_t*>(bits), static_cast<int*>(iters),
      static_cast<int*>(conv), static_cast<float*>(park), t, Bt, park_elems,
      max_iterations, big, scale);
  return cudaGetLastError();
}

template <typename Msg>
cudaError_t flooding_launch(void* s, const void* q, void* ssign, void* min1,
                            void* min2, void* argm, void* bits, void* iters,
                            void* conv, const Tables& t, int nbt, int Bt,
                            int max_iterations, int threads, float big,
                            float scale, cudaStream_t stream) {
  const size_t smem = layered_smem(Bt, 0);
  compressed_flooding_kernel<Msg><<<nbt, threads, smem, stream>>>(
      static_cast<float*>(s), static_cast<const Msg*>(q),
      static_cast<int8_t*>(ssign), static_cast<Msg*>(min1),
      static_cast<Msg*>(min2), static_cast<int8_t*>(argm),
      static_cast<int8_t*>(bits), static_cast<int*>(iters),
      static_cast<int*>(conv), t, Bt, max_iterations, big, scale);
  return cudaGetLastError();
}

}  // namespace

// Both entry points take the ten layout tables as an array of device
// pointers (see Tables in layered.cuh) and the tile shape, and return the
// launch's cudaError_t. The storage type (min1, min2, and flooding's q) is
// bf16 when msg_bf16, else f32; threads must be a multiple of Bt.

// Layered: qv (nbt, VG, Z, Bt) f32 working posteriors; ssign (nbt, E, Z,
// Bt) int8, min1 and min2 (nbt, CG, Z, Bt) zeroed state; bits (nbt, VG, Z,
// Bt) int8 raw-channel bits in, decoded bits out; iters and conv (nbt, Bt)
// int32 out; park (nbt, max_degree, Z, Bt) f32 in device memory, or null
// to park in shared memory.
extern "C" int ldpc_compressed_layered_decode(
    void* qv, void* ssign, void* min1, void* min2, void* bits, void* iters,
    void* conv, void* park, const void* const* tables, int nbt, int CG, int E,
    int VG, int Z, int Bt, int max_degree, int max_iterations, int threads,
    float big, float scale, int msg_bf16, void* stream) {
  const Tables t = make_tables(tables, CG, E, VG, Z);
  const size_t park_elems = (size_t)max_degree * Z * Bt;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      msg_bf16 ? layered_launch<__nv_bfloat16>(
                     qv, ssign, min1, min2, bits, iters, conv, park, t, nbt,
                     Bt, park_elems, max_iterations, threads, big, scale, s)
               : layered_launch<float>(qv, ssign, min1, min2, bits, iters,
                                       conv, park, t, nbt, Bt, park_elems,
                                       max_iterations, threads, big, scale,
                                       s));
}

// Flooding: s (nbt, VG, Z, Bt) f32 scratch; q (nbt, VG, Z, Bt) channel
// planes; ssign (nbt, E, Z, Bt), min1, min2 and argm (nbt, CG, Z, Bt)
// zeroed state; bits, iters and conv as for layered.
extern "C" int ldpc_compressed_flooding_decode(
    void* s, const void* q, void* ssign, void* min1, void* min2, void* argm,
    void* bits, void* iters, void* conv, const void* const* tables, int nbt,
    int CG, int E, int VG, int Z, int Bt, int max_iterations, int threads,
    float big, float scale, int msg_bf16, void* stream) {
  const Tables t = make_tables(tables, CG, E, VG, Z);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      msg_bf16 ? flooding_launch<__nv_bfloat16>(s, q, ssign, min1, min2, argm,
                                                bits, iters, conv, t, nbt, Bt,
                                                max_iterations, threads, big,
                                                scale, st)
               : flooding_launch<float>(s, q, ssign, min1, min2, argm, bits,
                                        iters, conv, t, nbt, Bt,
                                        max_iterations, threads, big, scale,
                                        st));
}

extern "C" const char* ldpc_compressed_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
