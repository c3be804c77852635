// Probes of the card's own ceilings, at the shapes of the decode kernels:
// - stream_kernel<T, PlusOne> (P1): out = src + 1 over a bf16 or f32 array;
//   replaces the Pallas TPU kernel of tools/prof_copybw.py pallas_stream (G
//   slabs of (P, Z, Bt), double-buffered DMA in and out);
// - alu_chain_kernel (P2): R x K chained rounds of one elementwise op over
//   (360, 128) f32 planes (add, fma, sel, roll); replaces
//   tools/prof_vpu_peak.py make;
// - rotated_gather_kernel (P3): out[bt, g] = sum over t < d of a rotated
//   window of plane planes[g d + t], f32 sum, bf16 out; replaces
//   tools/prof_roll.py make (modes dma, roll0, switch and dynroll);
// - stream_kernel<T, Identity> and minsum_planes_kernel (P4): P1's stream
//   as a copy, and the min-sum of d planes written in place, to scattered
//   planes, or rolled along Z and scattered; replace tools/prof_v2.py make
//   (copy, contig, scatw, scatw_roll).
// The fifth probe, the layered sweep with its parts removed
// (tools/prof_layered_variants.py), is csrc/probe_layered.cu.
//
// What bounds them on an H100: P1, P3 and P4 move every byte of their
// inputs and outputs once through device memory (3.35 TB/s on the data
// sheet); P2 keeps its planes in registers, so it is bound by the rate at
// which the SMs issue its instructions: four sub-partitions an SM, each
// issuing one warp instruction (32 lanes) a clock; roll also by the SM's
// shuffle unit, 32 results a clock.
//
// What the designs do about it: P1 and P4's copy are one template, a
// thread one 16-byte vector, blocks of 512 over the array in one launch,
// so that the blocks resident at a time sweep device memory in order. In
// turns on the card (tools/compare_forms.py --source probes) it ties
// torch's own elementwise and copy kernels, where a ring of shared-memory
// stages filled and drained by TMA bulk copies (cp.async.bulk both ways on
// mbarriers, a persistent grid of whole waves) ran 4 % slower at its best
// and a persistent grid of threads with 2 to 8 loads in flight 6 % slower
// (what counts, inferred from those times: blocks that sweep memory in
// order, not more bytes in flight). P2 runs each element's chain in a
// register, a thread an element, the rounds unrolled; enough planes to
// fill the card's 132 SMs (one plane fills about 22); roll holds a column
// in the registers of a few lanes of a warp, so a round's rotation is a
// renaming of registers inside a lane and one warp shuffle a register
// across lanes, with no shared memory and no barrier. P3 and P4's min-sum
// give a thread 8 consecutive frames (16 bytes of bf16) of one lane, so a
// warp reads and writes whole 512-byte rows; a rotation is an offset in the
// row index.
//
// Every result is bit for bit its plain version's
// (ldpc_toolbox_torch/probes/*.py); fma's too from the tool's inputs in
// [0.4, 0.6), where fmaf's one rounding and the plain version's two agree
// (ldpc_toolbox_torch/probes/vpu_peak.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

// -- P1 and P4's copy: one stream template -----------------------------------

constexpr int kStreamThreads = 512;

// What the stream does to each 16 bytes between its load and its store.
struct Identity {  // P4's copy
  static constexpr bool kTouches = false;
};
struct PlusOne {  // P1
  static constexpr bool kTouches = true;
};

// 16 bytes plus one: eight bf16 or four f32, added in f32 and rounded to
// nearest even (bf16: the exact sum's rounding, f32 holding twice bf16's
// bits and two more).
__device__ __forceinline__ uint4 plus_one(uint4 v, const __nv_bfloat16*) {
  uint32_t* w = &v.x;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float lo = __uint_as_float(w[i] << 16), hi = __uint_as_float(w[i] & 0xffff0000u);
    const uint32_t a = __bfloat16_as_ushort(__float2bfloat16_rn(__fadd_rn(lo, 1.0f)));
    const uint32_t b = __bfloat16_as_ushort(__float2bfloat16_rn(__fadd_rn(hi, 1.0f)));
    w[i] = a | b << 16;
  }
  return v;
}
__device__ __forceinline__ uint4 plus_one(uint4 v, const float*) {
  uint32_t* w = &v.x;
#pragma unroll
  for (int i = 0; i < 4; ++i) w[i] = __float_as_uint(__fadd_rn(__uint_as_float(w[i]), 1.0f));
  return v;
}

// out = Op(src) over n 16-byte vectors of T: a thread one vector, a block
// 512 consecutive ones, one block a tile of the array in one launch (no
// grid-stride loop), so the blocks the card runs at a time sweep the array
// in order. Plain loads and stores: a streaming hint on the load alone
// (ld.global.nc.L1::no_allocate, or .cs) ran 1.5 % slower.
template <typename T, typename Op>
__global__ void __launch_bounds__(kStreamThreads) stream_kernel(const uint4* __restrict__ src,
                                                                uint4* __restrict__ out,
                                                                size_t n) {
  const size_t i = blockIdx.x * (size_t)kStreamThreads + threadIdx.x;
  if (i >= n) return;
  if constexpr (Op::kTouches) {
    out[i] = plus_one(src[i], static_cast<const T*>(nullptr));
  } else {
    out[i] = src[i];
  }
}

// out = Op(src) over bytes bytes (a multiple of 16, both 16-byte aligned)
// on stream; no launch attribute to set up.
template <typename T, typename Op>
cudaError_t stream_launch(const void* src, void* out, size_t bytes, cudaStream_t stream) {
  const size_t n = bytes / 16;
  if (n == 0) return cudaSuccess;
  stream_kernel<T, Op><<<(unsigned)((n + kStreamThreads - 1) / kStreamThreads), kStreamThreads, 0,
                         stream>>>(static_cast<const uint4*>(src), static_cast<uint4*>(out), n);
  return cudaGetLastError();
}

// -- P2: the ALU chain ---------------------------------------------------------

enum ChainOp : int { kAdd = 0, kFma = 1, kSel = 2, kRoll = 3 };
constexpr int kChainThreads = 256;
constexpr int kRollShift = 37;
constexpr int kRollThreads = 128;  // four warps a block
// lanes a column at the tool's Z = 360: at 132 planes, 2 (254 registers,
// no spill) ran 7.798 ms in turns with 4 (128 registers) 11.754, 3 (128
// registers, 24 bytes of spill, 423 blocks on 132 SMs) 25.347 and the
// columns through shared memory 79.505 (tools/compare_forms.py --source
// probes, NVIDIA H100 80GB HBM3 at 700 W)
constexpr int kRollLanes360 = 2;

template <int OP>
__device__ __forceinline__ float chain_step(float x) {
  if constexpr (OP == kAdd) {
    return __fadd_rn(x, 1.0000001f);
  } else if constexpr (OP == kFma) {
    return fmaf(x, 1.0000001f, 1e-7f);
  } else {
    return x > 0.5f ? __fadd_rn(x, 1.0000001f) : __fsub_rn(x, 0.9999999f);
  }
}

// A thread an element of n: its value through rounds chained steps.
template <int OP>
__global__ void __launch_bounds__(kChainThreads) alu_chain_kernel(const float* in, float* out,
                                                                 size_t n, int rounds) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float x = in[i];
#pragma unroll 64
    for (int r = 0; r < rounds; ++r) x = chain_step<OP>(x);
    out[i] = x;
  }
}

// roll: x = roll(x, 37, axis 0) + 1.0000001 on (planes, Z, B) f32. A
// column of Z rows lies in the registers of T lanes of one warp, lane t
// its rows t b .. t b + b - 1 (b = Z / T); a warp C = 32 / T columns of
// the planes' planes x B, lane t C + c the column's part t (lanes past T C
// idle). With s = 37 mod Z = q b + m, row i of lane t takes, each round,
// register i - m of lane t - q (i >= m) or register i - m + b of lane t -
// q - 1 (i < m), lanes mod T: every register index static, the lane the
// same for a whole group. The values that cross lanes come by one shuffle
// a register, issued first; then, where q = 0, the rest move inside the
// lane from the top register down, each read before it is written, the
// add writing the register it moves to (no move instruction). No shared
// memory, no barrier. vpu_peak.roll_source is the same map in Python.
template <int Z, int T>
__global__ void __launch_bounds__(kRollThreads, 2)
    roll_chain_kernel(const float* in, float* out, int B, int cols, int rounds) {
  constexpr int b = Z / T, C = 32 / T, s = kRollShift % Z, q = s / b, m = s % b;
  static_assert(Z % T == 0 && T >= 1 && T <= 32, "T lanes must split a column evenly");
  const int lane = threadIdx.x % 32, t = lane / C, c = lane % C;
  const int col = (blockIdx.x * kRollThreads + threadIdx.x) / 32 * C + c;
  const bool live = t < T && col < cols;
  // the lanes of this column that rows i >= m and i < m read
  const int near = (t + 2 * T - q % T) % T * C + c;
  const int far = (t + 2 * T - (q + 1) % T) % T * C + c;
  const size_t base = live ? (size_t)(col / B) * Z * B + col % B + (size_t)t * b * B : 0;
  float x[b];
#pragma unroll
  for (int i = 0; i < b; ++i) x[i] = live ? in[base + (size_t)i * B] : 0.0f;
#pragma unroll 1
  for (int r = 0; r < rounds; ++r) {
    float y[b];
#pragma unroll
    for (int i = 0; i < b; ++i) {
      if (i < m) {
        y[i] = __shfl_sync(0xffffffffu, x[i - m + b], far);
      } else if (q != 0) {
        y[i] = __shfl_sync(0xffffffffu, x[i - m], near);
      }
    }
#pragma unroll
    for (int i = b - 1; i >= 0; --i)
      x[i] = __fadd_rn(i < m || q != 0 ? y[i] : x[i - m], 1.0000001f);
  }
  if (live) {
#pragma unroll
    for (int i = 0; i < b; ++i) out[base + (size_t)i * B] = x[i];
  }
}

template <int Z, int T>
cudaError_t roll_launch(const float* in, float* out, int planes, int B, int rounds,
                        cudaStream_t stream) {
  constexpr int C = 32 / T, kColsPerBlock = kRollThreads / 32 * C;
  const int cols = planes * B;
  if (cols == 0) return cudaSuccess;
  const int blocks = (cols + kColsPerBlock - 1) / kColsPerBlock;
  roll_chain_kernel<Z, T><<<blocks, kRollThreads, 0, stream>>>(in, out, B, cols, rounds);
  return cudaGetLastError();
}

template <int OP>
cudaError_t chain_launch(const float* in, float* out, size_t n, int rounds, cudaStream_t stream) {
  const size_t blocks = (n + kChainThreads - 1) / kChainThreads;
  if (blocks == 0) return cudaSuccess;
  alu_chain_kernel<OP><<<(unsigned)std::min(blocks, (size_t)1 << 20), kChainThreads, 0, stream>>>(
      in, out, n, rounds);
  return cudaGetLastError();
}

// -- P3 and P4: gathers and scattered writes of 16-byte pieces of bf16 rows --

// Eight bf16 values as f32, and back rounded to nearest even.
struct F8 {
  float v[8];
};

__device__ __forceinline__ F8 unpack8(uint4 u) {
  F8 f;
  const uint32_t* w = &u.x;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f.v[2 * i] = __uint_as_float(w[i] << 16);
    f.v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
  return f;
}

__device__ __forceinline__ uint4 pack8(const F8& f) {
  uint4 u;
  uint32_t* w = &u.x;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t a = __bfloat16_as_ushort(__float2bfloat16_rn(f.v[2 * i]));
    const uint32_t b = __bfloat16_as_ushort(__float2bfloat16_rn(f.v[2 * i + 1]));
    w[i] = a | b << 16;
  }
  return u;
}

enum GatherMode : int { kAligned = 0, kRollFive = 1, kRotated = 2 };

// out (nbt, G, Z, Bt) bf16: out[bt, g, z] = sum over t < d, in t order, in
// f32, of src (nbt, P, rows, Bt) bf16 at plane planes[e] (e = g d + t) and
// row: start + z (kRotated; start = Z - shifts[e]); hi + z (kAligned; hi
// = start rounded down to a multiple of align); hi + (z - 5 mod Z + align)
// (kRollFive: the aligned window of Z + align rows rolled by 5). A thread
// 8 frames of one output lane.
__global__ void __launch_bounds__(256) rotated_gather_kernel(
    const uint4* src, const int* planes, const int* shifts, uint4* out, int nbt, int P, int rows,
    int Z, int Bt, int G, int d, int align, int mode) {
  const int vecs = Bt / 8;
  const size_t n = (size_t)nbt * G * Z * vecs;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const int v = i % vecs;
    const size_t lane = i / vecs;
    const int z = lane % Z;
    const int g = lane / Z % G;
    const int bt = lane / ((size_t)Z * G);
    F8 acc;
    for (int t = 0; t < d; ++t) {
      const int e = g * d + t;
      const int start = Z - shifts[e];
      const int hi = start / align * align;
      int row = start + z;
      if (mode == kAligned) {
        row = hi + z;
      } else if (mode == kRollFive) {
        const int w = z - 5;
        row = hi + (w < 0 ? w + Z + align : w);
      }
      const F8 x = unpack8(src[(((size_t)bt * P + planes[e]) * rows + row) * vecs + v]);
#pragma unroll
      for (int f = 0; f < 8; ++f) acc.v[f] = t == 0 ? x.v[f] : __fadd_rn(acc.v[f], x.v[f]);
    }
    out[i] = pack8(acc);
  }
}

enum MinsumMode : int { kContig = 0, kScatter = 1, kScatterRoll = 2 };
constexpr int kMinsumMax = 8;

// The min-sum of d planes: src (nbt, G, d, Z, Bt) bf16 -> output t of
// group g, at lane z: kContig to (nbt, G, d, Z, Bt) in place of its input;
// kScatter to plane dest[g d + t] of (nbt, G d, Z, Bt) at lane z;
// kScatterRoll there at lane z + shifts[g d + t] mod Z (the plane rolled
// along Z). In f32: m1 the least |x| (the first of equal ones), m2 the
// fold min(m2, max(m1, |x|)) from 3.4e38, the parity of the signs x < 0;
// output t is m2 at the argmin, else m1, negated where the parity without
// x_t is odd. A thread 8 frames of one lane of a group.
__global__ void __launch_bounds__(256) minsum_planes_kernel(const uint4* src, const int* dest,
                                                            const int* shifts, uint4* out,
                                                            int nbt, int G, int d, int Z, int Bt,
                                                            int mode) {
  const int vecs = Bt / 8;
  const size_t n = (size_t)nbt * G * Z * vecs;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const int v = i % vecs;
    const size_t lane = i / vecs;
    const int z = lane % Z;
    const size_t grp = lane / Z;  // bt G + g
    const int g = grp % G;
    const size_t bt = grp / G;
    F8 x[kMinsumMax];
#pragma unroll
    for (int t = 0; t < kMinsumMax; ++t)
      if (t < d) x[t] = unpack8(src[((grp * d + t) * Z + z) * vecs + v]);
    float m1[8], m2[8];
    int arg[8];
    bool par[8];
#pragma unroll
    for (int f = 0; f < 8; ++f) {
      m1[f] = fabsf(x[0].v[f]);
      m2[f] = 3.4e38f;
      arg[f] = 0;
      par[f] = x[0].v[f] < 0.0f;
    }
#pragma unroll
    for (int t = 1; t < kMinsumMax; ++t) {
      if (t < d) {
#pragma unroll
        for (int f = 0; f < 8; ++f) {
          const float mk = fabsf(x[t].v[f]);
          m2[f] = fminf(m2[f], fmaxf(m1[f], mk));
          const bool take = mk < m1[f];
          m1[f] = take ? mk : m1[f];
          arg[f] = take ? t : arg[f];
          par[f] ^= x[t].v[f] < 0.0f;
        }
      }
    }
#pragma unroll
    for (int t = 0; t < kMinsumMax; ++t) {
      if (t < d) {
        F8 o;
#pragma unroll
        for (int f = 0; f < 8; ++f) {
          const float loo = arg[f] == t ? m2[f] : m1[f];
          o.v[f] = par[f] != (x[t].v[f] < 0.0f) ? -loo : loo;
        }
        size_t cell;
        if (mode == kContig) {
          cell = (grp * d + t) * Z + z;
        } else {
          const int e = g * d + t;
          int w = z;
          if (mode == kScatterRoll) {
            w = z + shifts[e];
            w = w < Z ? w : w - Z;
          }
          cell = ((bt * G * d + dest[e]) * Z + w);
        }
        out[cell * vecs + v] = pack8(o);
      }
    }
  }
}

// Blocks of 256 threads for n items: a few waves of the card's blocks at
// most, the rest taken in grid-stride loops.
unsigned grid_for(size_t n) {
  const size_t blocks = (n + 255) / 256;
  return (unsigned)std::min(blocks, (size_t)132 * 8 * 4);
}

}  // namespace

// out = src + 1 over bytes bytes (a multiple of 16; both 16-byte aligned)
// of bf16 (bf16 true) or f32. Returns the launch's cudaError_t.
extern "C" int ldpc_probe_stream(const void* src, void* out, long long bytes, int bf16,
                                 void* stream) {
  if (bytes < 0 || bytes % 16) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(bf16 ? stream_launch<__nv_bfloat16, PlusOne>(src, out, bytes, s)
                               : stream_launch<float, PlusOne>(src, out, bytes, s));
}

// rounds chained steps of op (0 add, 1 fma, 2 sel, 3 roll) on planes (n, Z,
// B) f32; roll takes Z = 24, 40 or 360 (cudaErrorInvalidValue otherwise).
extern "C" int ldpc_probe_alu_chain(const float* in, float* out, int planes, int Z, int B,
                                    int op, int rounds, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const size_t n = (size_t)planes * Z * B;
  cudaError_t err = cudaErrorInvalidValue;
  switch (op) {
    case kAdd: err = chain_launch<kAdd>(in, out, n, rounds, s); break;
    case kFma: err = chain_launch<kFma>(in, out, n, rounds, s); break;
    case kSel: err = chain_launch<kSel>(in, out, n, rounds, s); break;
    case kRoll:
      switch (Z) {  // the Z values vpu_peak.ROLL_LANES names, each with its lanes a column
        case 24: err = roll_launch<24, 4>(in, out, planes, B, rounds, s); break;
        case 40: err = roll_launch<40, 4>(in, out, planes, B, rounds, s); break;
        case 360: err = roll_launch<360, kRollLanes360>(in, out, planes, B, rounds, s); break;
      }
      break;
  }
  return static_cast<int>(err);
}

// P3 on src (nbt, P, rows, Bt) bf16, planes and shifts (G d,) int32, out
// (nbt, G, Z, Bt) bf16; mode 0 aligned, 1 roll by 5, 2 rotated. Bt a
// multiple of 8.
extern "C" int ldpc_probe_rotated_gather(const void* src, const int* planes, const int* shifts,
                                         void* out, int nbt, int P, int rows, int Z, int Bt,
                                         int G, int d, int align, int mode, void* stream) {
  if (Bt % 8 || mode < kAligned || mode > kRotated || align < 1) return cudaErrorInvalidValue;
  const size_t n = (size_t)nbt * G * Z * (Bt / 8);
  if (n == 0) return cudaSuccess;
  rotated_gather_kernel<<<grid_for(n), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(src), planes, shifts, static_cast<uint4*>(out), nbt, P, rows, Z,
      Bt, G, d, align, mode);
  return static_cast<int>(cudaGetLastError());
}

// P4's copy: bytes bytes (a multiple of 16, both 16-byte aligned).
extern "C" int ldpc_probe_copy(const void* src, void* out, long long bytes, void* stream) {
  if (bytes < 0 || bytes % 16) return cudaErrorInvalidValue;
  return static_cast<int>(
      stream_launch<uint4, Identity>(src, out, bytes, static_cast<cudaStream_t>(stream)));
}

// P4's min-sum modes on src (nbt, G, d, Z, Bt) bf16 (d at most 8, Bt a
// multiple of 8): mode 0 in place of the input's shape, 1 scattered to
// (nbt, G d, Z, Bt) by dest, 2 rolled by shifts and scattered.
extern "C" int ldpc_probe_minsum(const void* src, const int* dest, const int* shifts, void* out,
                                 int nbt, int G, int d, int Z, int Bt, int mode, void* stream) {
  if (Bt % 8 || d < 1 || d > kMinsumMax || mode < kContig || mode > kScatterRoll)
    return cudaErrorInvalidValue;
  const size_t n = (size_t)nbt * G * Z * (Bt / 8);
  if (n == 0) return cudaSuccess;
  minsum_planes_kernel<<<grid_for(n), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(src), dest, shifts, static_cast<uint4*>(out), nbt, G, d, Z, Bt,
      mode);
  return static_cast<int>(cudaGetLastError());
}

// The bytes a block of the copy stream (P1, P4's copy) takes.
extern "C" int ldpc_probe_stream_block_bytes() { return kStreamThreads * 16; }

extern "C" const char* ldpc_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
