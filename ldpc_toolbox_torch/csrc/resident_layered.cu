// Whole horizontal-layered min-sum decode of frame tiles, one thread block
// per tile of Bt frames, all iterations in one launch.
//
// Replaces: the Pallas TPU kernel
// ldpc_toolbox_tpu/ops/resident_layered.py resident_layered_decode, which
// keeps one tile's Qv, Rcv and frozen bits in the TPU's vector memory for
// the whole decode.
//
// What bounds it on an H100: that state does not fit on an SM (one DVB-S2
// n=64800 frame holds Qv f32 259 KB and Rcv bf16 454 KB; an SM has 227 KB of
// shared memory), so Qv, Rcv and the bits live in device memory. Each
// iteration, each edge lane of each frame reads and writes its Rcv (2 + 2
// bytes in bf16, 4 + 4 in f32), reads Qv for the check update (4 bytes),
// reads and writes Qv for the posterior update (4 + 4) and reads Qv again
// for the syndrome (4): about 20 bytes. The flagship code has 630 * 360 =
// 226,800 edge lanes, so one iteration at B = 1024 moves about 4.6 GB:
// about 1.4 ms at the card's 3.35 TB/s. Min-sum does a few compares per
// byte, far below the compute roof, so memory traffic and the latency of
// the dependent index loads bound the kernel.
//
// What the design does about it: frames are innermost in every plane (a
// tile is (P, Z, Bt) planes), so the threads of a warp touch neighbouring
// frames of neighbouring lanes and their accesses coalesce. A check group's
// extrinsics and deltas stay in shared memory between the check update and
// the posterior update and never go to device memory. All iterations run in
// one launch, and a tile whose frames have all converged stops (per-tile
// early exit). Tensor cores, TMA and a resident group pipeline are later work.
//
// Bit-exactness with the JAX package (min-sum, f32 or bf16 Rcv):
// - every x of a group comes from the layer-entry Qv (phase 1, then a
//   barrier); the deltas are added to Qv in edge order by the thread that
//   owns the Qv cell (phase 2), so two edges of one group into one variable
//   group give (Qv + d1) + d2, as on the TPU, without atomics;
// - Rcv is stored rounded to nearest even (__float2bfloat16_rn), while the
//   Qv delta uses the unrounded f32 Rnew minus the loaded Rold;
// - a sign is x < 0 (-0.0 counts as positive); argmin takes the first
//   minimum; m2 folds as min(m2, max(m1, mk)) from big; the scale applies to
//   the magnitude before the sign;
// - missing lane: x = big there and Rnew = 0;
// - min-sum has one multiply (the scale), and __fmul_rn/__fsub_rn/__fadd_rn
//   keep nvcc from contracting it into an FMA. Rules with more float
//   arithmetic need the same care (or --fmad=false).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float load_msg(const float* p) { return *p; }
__device__ __forceinline__ float load_msg(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_msg(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_msg(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

struct Tables {
  const int* chk_cs;    // (CG,) first edge of each check group
  const int* syn_vg;    // (E,) variable-group plane of each edge
  const int* syn_rot;   // (E,) s: check lane c reads variable lane c - s
  const int* chk_rot;   // (E,) (Z - s) % Z: variable lane w takes check lane w - rot
  const int* syn_mask;  // (E,) missing check lane, -1 none
  int CG, E, VG, Z;
};

__device__ __forceinline__ int group_end(const Tables& t, int g) {
  return g + 1 < t.CG ? t.chk_cs[g + 1] : t.E;
}

// Sets bad[f] for every frame f of the tile with an unsatisfied check. The
// hard decisions are the raw-channel bits (iteration 0) or Qv <= 0.
template <bool kFromBits>
__device__ void syndrome(const float* qv, const int8_t* bits, const Tables& t,
                         int Bt, int* bad) {
  const int ZB = t.Z * Bt;
  int odd = 0;
  for (int g = 0; g < t.CG; ++g) {
    const int e0 = t.chk_cs[g], e1 = group_end(t, g);
    for (int i = threadIdx.x; i < ZB; i += blockDim.x) {
      const int c = i / Bt, f = i - c * Bt;
      int par = 0;
      for (int e = e0; e < e1; ++e) {
        if (c == t.syn_mask[e]) continue;
        int w = c - t.syn_rot[e];
        if (w < 0) w += t.Z;
        const int at = t.syn_vg[e] * ZB + w * Bt + f;
        par ^= kFromBits ? (bits[at] != 0) : (qv[at] <= 0.f);
      }
      odd |= par;
    }
  }
  // blockDim.x is a multiple of Bt, so a thread only ever sees one frame
  if (odd) atomicOr(&bad[threadIdx.x % Bt], 1);
}

template <typename Msg>
__global__ void resident_layered_kernel(float* qv_all, Msg* rcv_all,
                                        int8_t* bits_all, int* iters_out,
                                        int* conv_out, Tables t, int Bt,
                                        int max_degree, int max_iterations,
                                        float big, float scale) {
  extern __shared__ float smem[];
  const int ZB = t.Z * Bt;
  float* scratch = smem;  // (max_degree, Z, Bt): x, then Rnew - Rold
  int* bad = reinterpret_cast<int*>(smem + max_degree * ZB);
  int* conv = bad + Bt;
  int* iters = conv + Bt;
  int* newly = iters + Bt;
  int* any_new = newly + Bt;
  int* done = any_new + 1;

  const size_t tile = blockIdx.x;
  float* qv = qv_all + tile * t.VG * ZB;
  Msg* rcv = rcv_all + tile * t.E * ZB;
  int8_t* bits = bits_all + tile * t.VG * ZB;
  const int qn = t.VG * ZB;

  for (int f = threadIdx.x; f < Bt; f += blockDim.x) {
    bad[f] = 0;
    conv[f] = 0;
    iters[f] = 0;
  }
  __syncthreads();
  syndrome<true>(qv, bits, t, Bt, bad);
  __syncthreads();
  if (threadIdx.x == 0) {
    int all = 1;
    for (int f = 0; f < Bt; ++f) {
      conv[f] = !bad[f];
      bad[f] = 0;
      all &= conv[f];
    }
    *done = all;
  }
  __syncthreads();

  for (int it = 1; it <= max_iterations && !*done; ++it) {
    for (int g = 0; g < t.CG; ++g) {
      const int e0 = t.chk_cs[g], d = group_end(t, g) - e0;
      // phase 1: check update of each (check lane, frame) from the
      // layer-entry Qv
      for (int i = threadIdx.x; i < ZB; i += blockDim.x) {
        const int c = i / Bt, f = i - c * Bt;
        float m1 = 0.f, m2 = big;
        int arg = 0, par = 0;
        for (int k = 0; k < d; ++k) {
          const int e = e0 + k;
          int w = c - t.syn_rot[e];
          if (w < 0) w += t.Z;
          const float q = qv[t.syn_vg[e] * ZB + w * Bt + f];
          float x = q - load_msg(rcv + e * ZB + i);
          if (c == t.syn_mask[e]) x = big;
          scratch[k * ZB + i] = x;
          const float mk = fabsf(x);
          const int neg = x < 0.f;
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
        for (int k = 0; k < d; ++k) {
          const int e = e0 + k;
          float loo = arg == k ? m2 : m1;
          if (scale != 1.f) loo = __fmul_rn(loo, scale);
          float rn = (par ^ (scratch[k * ZB + i] < 0.f)) ? -loo : loo;
          if (c == t.syn_mask[e]) rn = 0.f;
          Msg* r = rcv + e * ZB + i;
          const float rold = load_msg(r);
          store_msg(r, rn);
          scratch[k * ZB + i] = __fsub_rn(rn, rold);
        }
      }
      __syncthreads();
      // phase 2: each thread owns the Qv cells of one (variable lane,
      // frame) and adds the group's deltas in edge order
      for (int i = threadIdx.x; i < ZB; i += blockDim.x) {
        const int w = i / Bt, f = i - w * Bt;
        for (int k = 0; k < d; ++k) {
          const int e = e0 + k;
          int c = w - t.chk_rot[e];
          if (c < 0) c += t.Z;
          float* q = qv + t.syn_vg[e] * ZB + i;
          *q = __fadd_rn(*q, scratch[k * ZB + c * Bt + f]);
        }
      }
      __syncthreads();
    }

    syndrome<false>(qv, bits, t, Bt, bad);
    __syncthreads();
    if (threadIdx.x == 0) {
      int all = 1, fresh = 0;
      for (int f = 0; f < Bt; ++f) {
        const int ok = !bad[f];
        newly[f] = ok && !conv[f];
        if (newly[f]) iters[f] = it;
        conv[f] |= ok;
        bad[f] = 0;
        all &= conv[f];
        fresh |= newly[f];
      }
      *any_new = fresh;
      *done = all;
    }
    __syncthreads();
    // freeze the bits of frames that converged in this iteration
    if (*any_new) {
      for (int i = threadIdx.x; i < qn; i += blockDim.x)
        if (newly[i % Bt]) bits[i] = qv[i] <= 0.f;
    }
    __syncthreads();
  }

  // frames that never converged keep their final hard decisions
  for (int i = threadIdx.x; i < qn; i += blockDim.x)
    if (!conv[i % Bt]) bits[i] = qv[i] <= 0.f;
  for (int f = threadIdx.x; f < Bt; f += blockDim.x) {
    iters_out[tile * Bt + f] = conv[f] ? iters[f] : max_iterations;
    conv_out[tile * Bt + f] = conv[f];
  }
}

template <typename Msg>
cudaError_t launch(void* qv, void* rcv, void* bits, void* iters, void* conv,
                   const Tables& t, int nbt, int Bt, int max_degree,
                   int max_iterations, int threads, float big, float scale,
                   cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (size_t)max_degree * t.Z * Bt + sizeof(int) * (4 * Bt + 2);
  auto kernel = resident_layered_kernel<Msg>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<nbt, threads, smem, stream>>>(
      static_cast<float*>(qv), static_cast<Msg*>(rcv),
      static_cast<int8_t*>(bits), static_cast<int*>(iters),
      static_cast<int*>(conv), t, Bt, max_degree, max_iterations, big, scale);
  return cudaGetLastError();
}

}  // namespace

// Decodes nbt tiles in place: qv (nbt, VG, Z, Bt) f32 working posteriors,
// rcv (nbt, E, Z, Bt) zeroed messages (bf16 when msg_bf16, else f32), bits
// (nbt, VG, Z, Bt) int8 raw-channel bits in, decoded bits out; iters and
// conv (nbt, Bt) int32 out. Returns the launch's cudaError_t.
extern "C" int ldpc_resident_layered_decode(
    void* qv, void* rcv, void* bits, void* iters, void* conv,
    const void* chk_cs, const void* syn_vg, const void* syn_rot,
    const void* chk_rot, const void* syn_mask, int nbt, int CG, int E, int VG,
    int Z, int Bt, int max_degree, int max_iterations, int threads, float big,
    float scale, int msg_bf16, void* stream) {
  const Tables t{static_cast<const int*>(chk_cs),
                 static_cast<const int*>(syn_vg),
                 static_cast<const int*>(syn_rot),
                 static_cast<const int*>(chk_rot),
                 static_cast<const int*>(syn_mask),
                 CG, E, VG, Z};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      msg_bf16 ? launch<__nv_bfloat16>(qv, rcv, bits, iters, conv, t, nbt, Bt,
                                       max_degree, max_iterations, threads, big,
                                       scale, s)
               : launch<float>(qv, rcv, bits, iters, conv, t, nbt, Bt,
                               max_degree, max_iterations, threads, big, scale,
                               s);
  return static_cast<int>(err);
}

extern "C" const char* ldpc_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
