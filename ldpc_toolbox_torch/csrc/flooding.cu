// Flooding min-sum decode of frame tiles: the three streaming phase kernels
// (check, variable, syndrome) and the whole decode in one launch.
//
// Replaces these Pallas TPU kernels of ldpc_toolbox_tpu/ops/:
// - fused_bp2.py fused_check       -> fused_check_kernel
// - fused_bp2.py fused_var         -> fused_var_kernel (init variant: kInit)
// - fused_bp2.py fused_syndrome_bits -> fused_syndrome_kernel
// - resident_flooding_dual.py resident_flooding_dual_decode and
//   resident_flooding.py resident_flooding_decode -> resident_flooding_kernel.
//   The two TPU kernels compute the same function and differ only in how
//   the state fits the TPU's vector memory (two message arrays, or one
//   aliased array). Here the state lives in device memory either way, so
//   one kernel with two arrays serves both.
//
// Layout (as the JAX package's): a tile is Bt frames, frames innermost.
// v2c planes (nbt, E, Z, Bt) are check-major in check lane coordinates;
// c2v planes (nbt, E, Z, Bt) are variable-major in variable lane
// coordinates; q and the hard bits (nbt, VG, Z, Bt) are per variable group.
// Moving a message between the sides is a mod-Z lane shift by the edge's
// lift shift; lanes are indexed mod Z directly (no padded plane height).
//
// What bounds it on an H100: memory traffic. The flagship code (DVB-S2
// n = 64800, rate 1/2) has 226,800 edge lanes and 64,800 variable lanes a
// frame. One bf16 iteration at B = 1024 reads and writes v2c and c2v once
// each (4 x 464 MB), reads q (133 MB), writes the bits (66 MB) and reads
// them once per edge in the syndrome (232 MB): about 2.3 GB, 0.7 ms at
// 3.35 TB/s. The state of one tile (2 x 1.8 MB of messages at Bt = 4) does
// not fit an SM's 227 KB of shared memory, and the batch's state (0.9 GB)
// does not fit the 50 MB L2, so it streams through device memory every
// iteration. Min-sum does a few compares per byte, far below the compute
// roof.
//
// What the design does about it: frames are innermost, so the threads of a
// warp touch neighbouring frames of neighbouring lanes of one plane, and
// every plane read and write coalesces (the mod-Z shift only splits an
// access at the wrap). Each message plane has exactly one writer: chk_dest
// and var_dest are permutations of the edges, so no atomics touch a float.
// The resident kernel runs all iterations of a tile in one block (one
// launch a decode, per-tile early exit once all its frames converged);
// the check-side state stays in registers between a check's fold and its
// outputs. Tensor cores, TMA and a compressed check state are later work.
//
// Bit-exactness with the JAX package (min-sum, f32 or bf16 storage):
// - the check fold is the one of csrc/resident_layered.cu: sign x < 0,
//   first minimum wins, m2 folds as min(m2, max(m1, mk)) from big, the
//   scale multiplies the magnitude (__fmul_rn) before the sign;
// - the variable rule sums in slot order, tot = q, then tot = tot + y_t
//   for each slot (__fadd_rn), and emits tot - y_t (__fsub_rn); the hard
//   bit is tot <= 0; the _rn intrinsics keep nvcc from forming an FMA;
// - storage is rounded to nearest even (__float2bfloat16_rn);
// - missing lanes: big into v2c at var_omask (check coordinates), 0 into
//   c2v at chk_omask (variable coordinates), and the syndrome skips
//   syn_mask.

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
  const int* chk_cs;     // (CG,) first v2c plane of each check group
  const int* chk_dest;   // (E,) check-major edge -> its c2v plane
  const int* chk_rot;    // (E,) check lane c goes to variable lane c + rot
  const int* chk_omask;  // (E,) missing lane in variable coordinates, -1 none
  const int* var_cs;     // (VG,) first c2v plane of each variable group
  const int* var_dest;   // (E,) variable-major edge -> its v2c plane
  const int* var_rot;    // (E,) variable lane w goes to check lane w + rot
  const int* var_omask;  // (E,) missing lane in check coordinates, -1 none
  const int* syn_vg;     // (E,) check-major edge -> its variable group
  const int* syn_rot;    // (E,) check lane c reads variable lane c - rot
  const int* syn_mask;   // (E,) missing lane in check coordinates, -1 none
  int CG, VG, E, Z, Bt;
};

__device__ __forceinline__ int chk_end(const Tables& t, int g) {
  return g + 1 < t.CG ? t.chk_cs[g + 1] : t.E;
}
__device__ __forceinline__ int var_end(const Tables& t, int g) {
  return g + 1 < t.VG ? t.var_cs[g + 1] : t.E;
}

// Check update of check lane c, frame f of check group g in one tile: folds
// the group's d v2c planes, writes output k to c2v plane chk_dest[e] at
// variable lane (c + chk_rot[e]) mod Z, 0 at the missing lane.
template <typename Msg>
__device__ __forceinline__ void check_item(const Msg* v2c, Msg* c2v,
                                           const Tables& t, int g, int c, int f,
                                           float big, float scale) {
  const size_t ZB = (size_t)t.Z * t.Bt;
  const int e0 = t.chk_cs[g], d = chk_end(t, g) - e0;
  const int at = c * t.Bt + f;
  float m1 = 0.f, m2 = big;
  int arg = 0, par = 0;
  uint64_t negs = 0;  // d <= 64, checked by the wrapper
  for (int k = 0; k < d; ++k) {
    const float x = load_msg(v2c + (e0 + k) * ZB + at);
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
  for (int k = 0; k < d; ++k) {
    const int e = e0 + k;
    float loo = arg == k ? m2 : m1;
    if (scale != 1.f) loo = __fmul_rn(loo, scale);
    float o = (par ^ (int)((negs >> k) & 1u)) ? -loo : loo;
    int w = c + t.chk_rot[e];
    if (w >= t.Z) w -= t.Z;
    if (w == t.chk_omask[e]) o = 0.f;
    store_msg(c2v + t.chk_dest[e] * ZB + w * t.Bt + f, o);
  }
}

// Variable update of variable lane w, frame f of variable group g in one
// tile: tot = q plus the group's c2v in slot order; output k = tot - y_k
// goes to v2c plane var_dest[e] at check lane (w + var_rot[e]) mod Z, big at
// the missing lane; the hard bit is tot <= 0. kInit: no c2v yet, every
// output is q (the flooding initialisation).
template <typename Msg, bool kInit>
__device__ __forceinline__ void var_item(const Msg* c2v, const Msg* q, Msg* v2c,
                                         int8_t* bits, const Tables& t, int g,
                                         int w, int f, float big) {
  const size_t ZB = (size_t)t.Z * t.Bt;
  const int e0 = t.var_cs[g], d = var_end(t, g) - e0;
  const int at = w * t.Bt + f;
  const float qv = load_msg(q + g * ZB + at);
  float tot = qv;
  if (!kInit)
    for (int k = 0; k < d; ++k)
      tot = __fadd_rn(tot, load_msg(c2v + (e0 + k) * ZB + at));
  for (int k = 0; k < d; ++k) {
    const int e = e0 + k;
    float o = kInit ? qv : __fsub_rn(tot, load_msg(c2v + (e0 + k) * ZB + at));
    int c = w + t.var_rot[e];
    if (c >= t.Z) c -= t.Z;
    if (c == t.var_omask[e]) o = big;
    store_msg(v2c + t.var_dest[e] * ZB + c * t.Bt + f, o);
  }
  bits[g * ZB + at] = tot <= 0.f;
}

// Parity of check lane c, frame f of check group g over the hard bits of
// one tile: 1 if the check is unsatisfied.
__device__ __forceinline__ int syndrome_item(const int8_t* bits,
                                             const Tables& t, int g, int c,
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
__device__ __forceinline__ Item split(int r, const Tables& t) {
  const int ZB = t.Z * t.Bt;
  Item it;
  it.g = r / ZB;
  const int rem = r - it.g * ZB;
  it.lane = rem / t.Bt;
  it.f = rem - it.lane * t.Bt;
  return it;
}

template <typename Msg>
__global__ void fused_check_kernel(const Msg* v2c, Msg* c2v, Tables t,
                                   int nbt, float big, float scale) {
  const size_t per_tile = (size_t)t.CG * t.Z * t.Bt;
  const size_t plane_tile = (size_t)t.E * t.Z * t.Bt;
  const size_t n = per_tile * nbt;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t tile = i / per_tile;
    const Item it = split((int)(i - tile * per_tile), t);
    check_item(v2c + tile * plane_tile, c2v + tile * plane_tile, t, it.g,
               it.lane, it.f, big, scale);
  }
}

template <typename Msg, bool kInit>
__global__ void fused_var_kernel(const Msg* c2v, const Msg* q, Msg* v2c,
                                 int8_t* bits, Tables t, int nbt, float big) {
  const size_t per_tile = (size_t)t.VG * t.Z * t.Bt;
  const size_t plane_tile = (size_t)t.E * t.Z * t.Bt;
  const size_t n = per_tile * nbt;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t tile = i / per_tile;
    const Item it = split((int)(i - tile * per_tile), t);
    var_item<Msg, kInit>(kInit ? nullptr : c2v + tile * plane_tile,
                         q + tile * per_tile, v2c + tile * plane_tile,
                         bits + tile * per_tile, t, it.g, it.lane, it.f, big);
  }
}

// Ors the unsatisfied checks of the tile's frames into bad[0..Bt), a zeroed
// shared array. blockDim.x is a multiple of Bt, so a thread only ever sees
// one frame and ors once.
__device__ __forceinline__ void syndrome_tile(const int8_t* bits,
                                              const Tables& t, int* bad) {
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
                                      Tables t) {
  extern __shared__ int bad[];
  for (int f = threadIdx.x; f < t.Bt; f += blockDim.x) bad[f] = 0;
  __syncthreads();
  const size_t tile = blockIdx.x;
  syndrome_tile(bits_all + tile * t.VG * t.Z * t.Bt, t, bad);
  __syncthreads();
  for (int f = threadIdx.x; f < t.Bt; f += blockDim.x)
    flags[tile * t.Bt + f] = bad[f];
}

// The whole flooding decode of one tile per block. v2c, c2v and post (the
// posterior hard bits) are the block's scratch in device memory; bits
// holds the raw-channel bits on entry and the decoded bits on exit.
template <typename Msg>
__global__ void __launch_bounds__(512)
    resident_flooding_kernel(Msg* v2c_all, Msg* c2v_all, const Msg* q_all,
                             int8_t* post_all, int8_t* bits_all,
                             int* iters_out, int* conv_out, Tables t,
                             int max_iterations, float big, float scale) {
  extern __shared__ int smem[];
  const int Bt = t.Bt;
  int* bad = smem;
  int* conv = bad + Bt;
  int* iters = conv + Bt;
  int* newly = iters + Bt;
  int* any_new = newly + Bt;
  int* done = any_new + 1;

  const size_t tile = blockIdx.x;
  const size_t ZB = (size_t)t.Z * Bt;
  Msg* v2c = v2c_all + tile * t.E * ZB;
  Msg* c2v = c2v_all + tile * t.E * ZB;
  const Msg* q = q_all + tile * t.VG * ZB;
  int8_t* post = post_all + tile * t.VG * ZB;
  int8_t* bits = bits_all + tile * t.VG * ZB;
  const int cn = t.CG * (int)ZB, vn = t.VG * (int)ZB;

  for (int f = threadIdx.x; f < Bt; f += blockDim.x) {
    bad[f] = 0;
    conv[f] = 0;
    iters[f] = 0;
  }
  // v2c0 = q rolled into check coordinates, big at the missing lanes
  for (int r = threadIdx.x; r < vn; r += blockDim.x) {
    const Item x = split(r, t);
    var_item<Msg, true>(nullptr, q, v2c, post, t, x.g, x.lane, x.f, big);
  }
  __syncthreads();
  // iteration 0 tests the raw-channel bits
  syndrome_tile(bits, t, bad);
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
    for (int r = threadIdx.x; r < cn; r += blockDim.x) {
      const Item x = split(r, t);
      check_item(v2c, c2v, t, x.g, x.lane, x.f, big, scale);
    }
    __syncthreads();
    for (int r = threadIdx.x; r < vn; r += blockDim.x) {
      const Item x = split(r, t);
      var_item<Msg, false>(c2v, q, v2c, post, t, x.g, x.lane, x.f, big);
    }
    __syncthreads();
    syndrome_tile(post, t, bad);
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
    // freeze the bits of the frames that converged in this iteration
    if (*any_new)
      for (int r = threadIdx.x; r < vn; r += blockDim.x)
        if (newly[r % Bt]) bits[r] = post[r];
    __syncthreads();
  }

  // frames that never converged take their last posterior bits (the raw
  // bits when no iteration ran)
  if (max_iterations > 0)
    for (int r = threadIdx.x; r < vn; r += blockDim.x)
      if (!conv[r % Bt]) bits[r] = post[r];
  for (int f = threadIdx.x; f < Bt; f += blockDim.x) {
    iters_out[tile * Bt + f] = conv[f] ? iters[f] : max_iterations;
    conv_out[tile * Bt + f] = conv[f];
  }
}

int grid_for(size_t items, int threads) {
  const size_t blocks = (items + threads - 1) / threads;
  const size_t cap = 132 * 32;  // grid-stride beyond a few waves
  return (int)(blocks < cap ? (blocks ? blocks : 1) : cap);
}

Tables make_tables(const void* const* tab, int CG, int VG, int E, int Z,
                   int Bt) {
  const int* const* p = reinterpret_cast<const int* const*>(tab);
  return Tables{p[0], p[1], p[2], p[3], p[4],  p[5], p[6], p[7],
                p[8], p[9], p[10], CG, VG, E, Z, Bt};
}

template <typename Msg>
cudaError_t check_launch(const void* v2c, void* c2v, const Tables& t, int nbt,
                         float big, float scale, int threads, cudaStream_t s) {
  const size_t items = (size_t)nbt * t.CG * t.Z * t.Bt;
  fused_check_kernel<Msg><<<grid_for(items, threads), threads, 0, s>>>(
      static_cast<const Msg*>(v2c), static_cast<Msg*>(c2v), t, nbt, big,
      scale);
  return cudaGetLastError();
}

template <typename Msg>
cudaError_t var_launch(const void* c2v, const void* q, void* v2c, void* bits,
                       const Tables& t, int nbt, float big, int threads,
                       cudaStream_t s) {
  const size_t items = (size_t)nbt * t.VG * t.Z * t.Bt;
  const int grid = grid_for(items, threads);
  if (c2v)
    fused_var_kernel<Msg, false><<<grid, threads, 0, s>>>(
        static_cast<const Msg*>(c2v), static_cast<const Msg*>(q),
        static_cast<Msg*>(v2c), static_cast<int8_t*>(bits), t, nbt, big);
  else
    fused_var_kernel<Msg, true><<<grid, threads, 0, s>>>(
        nullptr, static_cast<const Msg*>(q), static_cast<Msg*>(v2c),
        static_cast<int8_t*>(bits), t, nbt, big);
  return cudaGetLastError();
}

template <typename Msg>
cudaError_t resident_launch(void* v2c, void* c2v, const void* q, void* post,
                            void* bits, void* iters, void* conv,
                            const Tables& t, int nbt, int max_iterations,
                            int threads, float big, float scale,
                            cudaStream_t s) {
  const size_t smem = sizeof(int) * (4 * t.Bt + 2);
  resident_flooding_kernel<Msg><<<nbt, threads, smem, s>>>(
      static_cast<Msg*>(v2c), static_cast<Msg*>(c2v),
      static_cast<const Msg*>(q), static_cast<int8_t*>(post),
      static_cast<int8_t*>(bits), static_cast<int*>(iters),
      static_cast<int*>(conv), t, max_iterations, big, scale);
  return cudaGetLastError();
}

}  // namespace

// Every entry point takes the layout's eleven int32 tables as an array of
// device pointers (chk_cs, chk_dest, chk_rot, chk_omask, var_cs, var_dest,
// var_rot, var_omask, syn_vg, syn_rot, syn_mask) and the tile shape, and
// returns the launch's cudaError_t. Messages are bf16 when msg_bf16, else
// f32; q has the messages' type.

// c2v (nbt, E, Z, Bt) from v2c (nbt, E, Z, Bt).
extern "C" int ldpc_fused_check(const void* v2c, void* c2v,
                                const void* const* tables, int nbt, int CG,
                                int VG, int E, int Z, int Bt, float big,
                                float scale, int msg_bf16, int threads,
                                void* stream) {
  const Tables t = make_tables(tables, CG, VG, E, Z, Bt);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      msg_bf16 ? check_launch<__nv_bfloat16>(v2c, c2v, t, nbt, big, scale,
                                             threads, s)
               : check_launch<float>(v2c, c2v, t, nbt, big, scale, threads, s));
}

// v2c (nbt, E, Z, Bt) and bits (nbt, VG, Z, Bt) int8 from c2v and q
// (nbt, VG, Z, Bt); c2v null runs the initialisation.
extern "C" int ldpc_fused_var(const void* c2v, const void* q, void* v2c,
                              void* bits, const void* const* tables, int nbt,
                              int CG, int VG, int E, int Z, int Bt, float big,
                              int msg_bf16, int threads, void* stream) {
  const Tables t = make_tables(tables, CG, VG, E, Z, Bt);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      msg_bf16 ? var_launch<__nv_bfloat16>(c2v, q, v2c, bits, t, nbt, big,
                                           threads, s)
               : var_launch<float>(c2v, q, v2c, bits, t, nbt, big, threads, s));
}

// flags (nbt, Bt) int32 from bits (nbt, VG, Z, Bt) int8; threads must be a
// multiple of Bt.
extern "C" int ldpc_fused_syndrome(const void* bits, void* flags,
                                   const void* const* tables, int nbt, int CG,
                                   int VG, int E, int Z, int Bt, int threads,
                                   void* stream) {
  const Tables t = make_tables(tables, CG, VG, E, Z, Bt);
  fused_syndrome_kernel<<<nbt, threads, sizeof(int) * Bt,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(bits), static_cast<int*>(flags), t);
  return static_cast<int>(cudaGetLastError());
}

// The whole decode: v2c, c2v (nbt, E, Z, Bt) and post (nbt, VG, Z, Bt) int8
// scratch; q (nbt, VG, Z, Bt); bits (nbt, VG, Z, Bt) int8 raw-channel bits
// in, decoded bits out; iters and conv (nbt, Bt) int32 out. threads must be
// a multiple of Bt and at most 512.
extern "C" int ldpc_resident_flooding_decode(
    void* v2c, void* c2v, const void* q, void* post, void* bits, void* iters,
    void* conv, const void* const* tables, int nbt, int CG, int VG, int E,
    int Z, int Bt, int max_iterations, int threads, float big, float scale,
    int msg_bf16, void* stream) {
  const Tables t = make_tables(tables, CG, VG, E, Z, Bt);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      msg_bf16 ? resident_launch<__nv_bfloat16>(v2c, c2v, q, post, bits, iters,
                                                conv, t, nbt, max_iterations,
                                                threads, big, scale, s)
               : resident_launch<float>(v2c, c2v, q, post, bits, iters, conv,
                                        t, nbt, max_iterations, threads, big,
                                        scale, s));
}

extern "C" const char* ldpc_flooding_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
