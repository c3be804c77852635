// The int8 instances of two streaming kernels in a form of their own:
// i8_sweep_kernel, the horizontal-layered sweep (replaces the i8 path of
// ldpc_toolbox_tpu/ops/fused_layered.py fused_layered_iteration), and
// i8_check_kernel, the flooding check phase (replaces the i8 path of
// ldpc_toolbox_tpu/ops/fused_bp2.py fused_check). Both inline
// MinstarApproxI8Rule or AminstarI8Rule (fused_bp2.py) as csrc/i8.cuh does;
// csrc/fused_layered_i8.cu and csrc/flooding_i8.cu build them.
//
// What bounds them on an H100: the integer (ALU) pipe, which takes 16 lanes
// a clock a sub-partition, half the issue rate. The word check of
// csrc/i8.cuh folds a degree-7 MinstarApprox check 25 times, 22 of a fold's
// 23 SASS instructions on that pipe, while the FMA pipe, which takes IMAD,
// sits idle: the template check phase ran near that pipe's rate (PERF.md
// section 6). The sweep adds a per-frame x and Qv update an edge and waits
// on its gathers after each of a tile's group barriers.
//
// What the design does about it: the adds and subtracts of the MinstarApprox
// fold, of a slot's magnitudes and of an output's negation, and the sweep's
// x and deltas, are IMADs (mad.lo by -1, a kernel argument, I8Fma, which
// ptxas cannot turn back into an IADD3), so that a fold issues 10 of its 23
// instructions to the FMA pipe. The fold runs on a biased accumulator (a +
// 0x80 a byte), which the mux, the table and the saturation take at no
// extra cost. The sweep's right shifts are mad.hi too (shr_add); the check
// phase keeps them on the ALU, where a mad.hi, twice an IMAD's time on the
// FMA pipe, cost more than it saved (in turns on the card). A check of the
// degree bucket 8 runs a body of its exact degree (by_degree), whose folds
// need no test of d and no branch around them. The sweep gives a flagship
// check group of 360 lanes one pass (SweepUnits, 384 threads, where the
// template's 256 took two) and updates Qv from the cells it gathered.
// Aminstar keeps csrc/i8.cuh's arithmetic.
//
// Semantics: those of csrc/i8.cuh (the JAX package's folds, in its order)
// and of the kernels of csrc/streaming.cuh they replace for the i8 rules.

#pragma once

#include "i8.cuh"
#include "streaming.cuh"

#include <type_traits>

namespace ldpc {

// The constants the word steps below multiply by, passed as a kernel
// argument: ptxas cannot see their values, so it keeps each mad an IMAD on
// the FMA pipe where it would turn an add by -1 or a multiply by a power of
// two into an IADD3 or a shift on the ALU pipe.
struct I8Fma {
  uint32_t neg1;     // 0xffffffff: mad_lo(x, neg1, y) = y - x
  uint32_t pow2[7];  // 2^(25 + i): mad_hi(x, pow2[i], y) = (x >> (7 - i)) + y
};

inline I8Fma i8_fma() {
  I8Fma k{0xffffffffu, {}};
  for (int i = 0; i < 7; ++i) k.pow2[i] = 1u << (25 + i);
  return k;
}

// x * m + y and hi(x * m) + y, each one IMAD
__device__ __forceinline__ uint32_t mad_lo(uint32_t x, uint32_t m, uint32_t y) {
  uint32_t r;
  asm("mad.lo.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(x), "r"(m), "r"(y));
  return r;
}
__device__ __forceinline__ uint32_t mad_hi(uint32_t x, uint32_t m, uint32_t y) {
  uint32_t r;
  asm("mad.hi.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(x), "r"(m), "r"(y));
  return r;
}
// (x >> (7 - i)) + y, x's set bits at bit 7 of its bytes: a mad.hi where
// HI (the sweep's, whose ALU pipe the per-frame x and update keep busier),
// else a shift and an add on the ALU (the check phase's: a mad.hi takes the
// FMA pipe twice as long as an IMAD, which there costs more than it saves)
template <bool HI>
__device__ __forceinline__ uint32_t shr_add(uint32_t x, int i, uint32_t y, const I8Fma& K) {
  if constexpr (HI) {
    return mad_hi(x, K.pow2[i], y);
  } else {
    return (x >> (7 - i)) + y;
  }
}

// Steps::of with its subtracts on the FMA pipe, from dH = t - 0x80 a byte
// (word arithmetic mod 2^32): y_k = T_k * kOnes - dH = (0x80 + T_k) * kOnes
// - t, the word Steps::of starts from.
template <class S>
struct FmaSteps;
template <int... T>
struct FmaSteps<Steps<T...>> {
  static constexpr int kN = sizeof...(T);
  static_assert(kN >= 4 && kN < 8, "a count of three bits");
  template <bool HI>
  static __device__ __forceinline__ uint32_t of(uint32_t dH, const I8Fma& K) {
    const uint32_t y[kN] = {mad_lo(dH, K.neg1, T * kOnes)...};
    uint32_t x = y[3];
    uint32_t sum = shr_add<HI>(x & kHighs, 2, 0u, K);
#pragma unroll
    for (int m = 1; m << 1 <= kN; m += 2) x ^= y[(m << 1) - 1];
    sum = shr_add<HI>(x & kHighs, 1, sum, K);
#pragma unroll
    for (int m = 1; m <= kN; m += 2) x ^= y[m - 1];
    return shr_add<HI>(x & kHighs, 0, sum, K);
  }
};

// MinstarApproxI8's fold (i8.cuh minstar_approx4) on A = a + 0x80 a byte
// and b: returns max(min(a, b) - table[|a - b|], 0) + 0x80 a byte. Each
// word below is exact mod 2^32 whatever borrows its bytes pass on: r = a +
// 0x80 - b; G = a - b where a >= b, else 0; mn = min + 0x80; a ^ b ^ mn's
// bytes are max(a, b), so dH = |a - b| - 0x80 a byte.
template <bool HI>
__device__ __forceinline__ uint32_t fold_fma(uint32_t A, uint32_t b, const I8Fma& K) {
  const uint32_t r = mad_lo(b, K.neg1, A);
  const uint32_t G = (r ^ kHighs) & high_mask(r);
  const uint32_t mn = mad_lo(G, K.neg1, A);
  const uint32_t dH = mad_lo(mn, K.neg1, A ^ b ^ mn);
  const uint32_t r2 = mad_lo(FmaSteps<I8Correction>::template of<HI>(dH, K), K.neg1, mn);
  return (r2 & high_mask(r2)) | kHighs;
}

// A check of a lane's four frames under FAMILY for the two kernels below:
// I8Rule's Check (csrc/i8.cuh), with MinstarApprox's folds, the slots'
// magnitudes and sign bits and the outputs' negation in the FMA form.
template <int DMAX, int FAMILY, bool HI>
struct I8FmaCheck {
  I8Check<DMAX> in;
  bool phl;
  const I8Fma& K;

  __device__ __forceinline__ I8FmaCheck(int flags, const I8Fma& k)
      : phl(flags & kPartialHardLimit), K(k) {}

  // slot k's input word x (bytes in [-127, 127]): its magnitudes (x ^ m) +
  // (x >> 7), its sign bits
  __device__ __forceinline__ void set(int k, uint32_t x) {
    if constexpr (FAMILY == kMinstarApprox) {
      const uint32_t s = x & kHighs;
      in.mag[k] = shr_add<HI>(s, 0, x ^ high_mask(x), K);
      in.signs[k / 8] =
          k % 8 == 7 ? in.signs[k / 8] | s : shr_add<HI>(s, k % 8, in.signs[k / 8], K);
      in.par ^= s;
    } else {
      in.set(k, x);
    }
  }

  // slot k's output word from O = its magnitudes + 0x80 a byte: 0x01010100
  // - O holds 0x80 - m a byte
  __device__ __forceinline__ uint32_t out(int k, uint32_t O) const {
    if (phl) O |= high_mask(O - 100 * kOnes);  // m >= 100 -> 127
    const uint32_t neg = high_mask(in.par ^ (in.signs[k / 8] << (7 - k % 8)));
    const uint32_t v = mad_lo(O, K.neg1, 0x01010100u);
    return ((v & neg) | (O & ~neg)) ^ kHighs;
  }

  // calls emit(k, word) with slot k's output word for each slot k < d
  template <class Emit>
  __device__ __forceinline__ void outputs(int d, Emit&& emit) {
    if constexpr (FAMILY == kMinstarApprox) {
      // i8_outputs' left folds and prefix, on biased words
      const uint32_t(&mag)[DMAX] = in.mag;
      uint32_t pre = mag[0] | kHighs;
#pragma unroll
      for (int t = 0; t < DMAX; ++t) {
        if (t < d) {
          uint32_t a;
          if (t + 1 < d) {
            a = t == 0 ? mag[1] | kHighs : fold_fma<HI>(pre, mag[t + 1], K);
#pragma unroll
            for (int k = t + 2; k < DMAX; ++k)
              if (k < d) a = fold_fma<HI>(a, mag[k], K);
          } else {
            a = t == 0 ? kHighs : pre;  // a degree-1 check outputs 0
          }
          emit(t, out(t, a));
          if (t >= 1 && t + 1 < d) pre = fold_fma<HI>(pre, mag[t], K);
        }
      }
    } else {
      i8_outputs<DMAX, FAMILY>(in, d, phl, [&](int k, uint32_t om) { emit(k, in.out(k, om)); });
    }
  }
};

// x - y of two ints, one IMAD
__device__ __forceinline__ int isub(int x, int y, const I8Fma& K) {
  return static_cast<int>(mad_lo(static_cast<uint32_t>(y), K.neg1, static_cast<uint32_t>(x)));
}

// Calls body(D) with D = d as a compile-time constant
// (std::integral_constant) for a check of degree d in the degree bucket
// DMAX = 8, the flagship's: a body of exact degree, whose loops unroll with
// no test of d and no branch around each fold; body(DMAX) with d tested in
// the larger buckets, whose exact bodies would multiply the build.
template <int DMAX, class Body>
__device__ __forceinline__ void by_degree(int d, Body&& body) {
  if constexpr (DMAX == 8) {
    switch (d) {
#define LDPC_I8_DEGREE(D)                  \
  case D:                                  \
    body(std::integral_constant<int, D>{}); \
    return;
      LDPC_I8_DEGREE(1)
      LDPC_I8_DEGREE(2)
      LDPC_I8_DEGREE(3)
      LDPC_I8_DEGREE(4)
      LDPC_I8_DEGREE(5)
      LDPC_I8_DEGREE(6)
      LDPC_I8_DEGREE(7)
#undef LDPC_I8_DEGREE
      default:
        body(std::integral_constant<int, 8>{});
        return;
    }
  }
  body(std::integral_constant<int, DMAX>{});
}

// The sweep's update of check lane c of a check group whose d edges are
// e0..e0+d (csrc/message_kernels.cuh layered_check_words under
// I8Rule<FAMILY>, in the FMA form): every x = clip(Qv - Rold, +-127) from
// the layer-entry Qv, 127 at the missing lane; Rnew in place (0 at the
// missing lane); the deltas Rnew - Rold added to the Qv gathered (parked
// false: no other lane of the group touches those cells) or parked at
// park[(k * Z + c) * 4].
template <int DMAX, int FAMILY>
__device__ __forceinline__ void i8_sweep_lane(int16_t* qv, int8_t* rcv, int* park,
                                              const LaneTables& t, int e0, int d, int c,
                                              bool parked, int flags, const I8Fma& K) {
  const int Z = t.Z;
  I16x4 q[DMAX];
  uint32_t r[DMAX];
#pragma unroll
  for (int k = 0; k < DMAX; ++k) {
    if (k < d) {
      const int e = e0 + k;
      q[k] = load_raw(qv + ((size_t)t.qbase[e] + minus_mod(c, t.syn_rot[e], Z)) * kBt);
      r[k] = load_word(rcv + ((size_t)e * Z + c) * kBt);
    }
  }
  I8FmaCheck<DMAX, FAMILY, true> check(flags, K);
#pragma unroll
  for (int k = 0; k < DMAX; ++k) {
    if (k < d) {
      const I4 qk = unpack(q[k]), rold = unpack(r[k]);
      I4 x;
#pragma unroll
      for (int f = 0; f < kBt; ++f) x.v[f] = clip127(isub(qk.v[f], rold.v[f], K));
      check.set(k, c == t.syn_mask[e0 + k] ? k127s : pack_bytes(x));
    }
  }
  const auto emit = [&](int k, uint32_t o) {
    const int e = e0 + k;
    const uint32_t rn = c == t.syn_mask[e] ? 0u : o;
    const I4 rnv = unpack(rn), rold = unpack(r[k]);
    store_word(rcv + ((size_t)e * Z + c) * kBt, rn);
    if (parked) {
      I4 delta;
#pragma unroll
      for (int f = 0; f < kBt; ++f) delta.v[f] = isub(rnv.v[f], rold.v[f], K);
      store4(park + ((size_t)k * Z + c) * kBt, delta);
    } else {
      // Qv - (Rold - Rnew), wrapping as the int16 store does
      I4 qc = unpack(q[k]);
#pragma unroll
      for (int f = 0; f < kBt; ++f) qc.v[f] = isub(qc.v[f], isub(rold.v[f], rnv.v[f], K), K);
      store4(qv + ((size_t)t.qbase[e] + minus_mod(c, t.syn_rot[e], Z)) * kBt, qc);
    }
  };
  by_degree<DMAX>(d, [&](auto D) {
    constexpr int M = decltype(D)::value;
    check.outputs(M == DMAX ? d : M, emit);
  });
}

// One horizontal-layered sweep of tile blockIdx.x under I8Rule<FAMILY>, in
// place on qv (VG, Z, 4) int16 and rcv (E, Z, 4) int8, then the hard bits
// qv <= 0 (csrc/streaming.cuh fused_layered_kernel's body, a lane's four
// frames a thread at SweepUnits' block; park_all the device park, or null
// to park in shared memory after the tables).
template <int DMAX, int FAMILY>
__global__ void __launch_bounds__(I8Rule<FAMILY>::SweepUnits::kBlock, 2) i8_sweep_kernel(
    int16_t* qv_all, int8_t* rcv_all, int8_t* bits_all, int* park_all, Tables t,
    size_t park_elems, int flags, I8Fma K) {
  using U = typename I8Rule<FAMILY>::SweepUnits;
  extern __shared__ __align__(16) int smem[];
  const size_t tile = blockIdx.x;
  const size_t lanes = (size_t)t.VG * t.Z;
  const LaneTables lt = load_tables(t, smem + kCtlInts);
  int* park = lane_park(park_all, park_elems, smem, t);
  int16_t* qv = qv_all + tile * lanes * kBt;
  int8_t* rcv = rcv_all + tile * t.E * t.Z * kBt;
  int8_t* bits = bits_all + tile * lanes * kBt;
  layered_sweep4<DMAX, U>(qv, park, lt, [&](int g, int c, int, bool parked) {
    const int e0 = lt.chk_cs[g], d = lt.chk_cs[g + 1] - e0;
    i8_sweep_lane<DMAX, FAMILY>(qv, rcv, park, lt, e0, d, c, parked, flags, K);
  });
  for (size_t i = threadIdx.x; i < lanes; i += blockDim.x)
    store_word(bits + i * kBt, hard_word(qv + i * kBt));
}

// The check phase of a tile's check lanes r0, r0 + stride, ... (blockIdx.y
// the tile; a lane's four frames a thread at CheckUnits' block): check lane
// c of group g folds its d v2c (127 at the missing lane) and writes output
// k to c2v plane chk_dest[e] at variable lane c + chk_rot[e], 0 at the
// missing lane (csrc/streaming.cuh fused_check_kernel).
template <int DMAX, int FAMILY>
__global__ void __launch_bounds__(I8Rule<FAMILY>::CheckUnits::kBlock, 2) i8_check_kernel(
    const int8_t* v2c_all, int8_t* c2v_all, FloodingTables t, int flags, I8Fma K) {
  extern __shared__ __align__(16) int smem[];
  const int Z = t.Z;
  const PhaseLanes s =
      load_phase(t.chk_cs, t.CG, t.chk_dest, t.chk_rot, t.syn_mask, t.E, Z, smem);
  const size_t plane_tile = (size_t)t.E * Z * kBt;
  const int8_t* v2c = v2c_all + blockIdx.y * plane_tile;
  int8_t* c2v = c2v_all + blockIdx.y * plane_tile;
  const int n = t.CG * Z;
  for (int r = blockIdx.x * blockDim.x + threadIdx.x; r < n; r += gridDim.x * blockDim.x) {
    const int g = r / Z, c = r - g * Z;
    const int e0 = s.cs[g], d = s.cs[g + 1] - e0;
    by_degree<DMAX>(d, [&](auto D) {
      constexpr int M = decltype(D)::value;
      const int dm = M == DMAX ? d : M;
      uint32_t x[M];
#pragma unroll
      for (int k = 0; k < M; ++k)
        if (k < dm) x[k] = load_word(v2c + ((size_t)(e0 + k) * Z + c) * kBt);
      I8FmaCheck<M, FAMILY, false> check(flags, K);
#pragma unroll
      for (int k = 0; k < M; ++k)
        if (k < dm) check.set(k, c == s.mask[e0 + k] ? k127s : x[k]);
      check.outputs(dm, [&](int k, uint32_t o) {
        const int e = e0 + k;
        store_word(c2v + ((size_t)s.dz[e] + plus_mod(c, s.rot[e], Z)) * kBt,
                   c == s.mask[e] ? 0u : o);
      });
    });
  }
}

// The launches on nbt tiles (see the C entry points of
// csrc/fused_layered_i8.cu and csrc/flooding_i8.cu for the arguments): a
// block at most SweepUnits::kBlock or CheckUnits::kBlock threads.
template <int DMAX, int FAMILY>
cudaError_t i8_sweep_launch(int flags, void* qv, void* rcv, void* bits, void* park,
                            const Tables& t, int nbt, size_t park_elems, int threads,
                            cudaStream_t stream) {
  if (threads > I8Rule<FAMILY>::SweepUnits::kBlock) return cudaErrorInvalidValue;
  return launch(i8_sweep_kernel<DMAX, FAMILY>, nbt, threads,
                smem_bytes(t, park ? 0 : park_elems, sizeof(int)), stream,
                static_cast<int16_t*>(qv), static_cast<int8_t*>(rcv),
                static_cast<int8_t*>(bits), static_cast<int*>(park), t, park_elems, flags,
                i8_fma());
}

template <int DMAX, int FAMILY>
cudaError_t i8_check_launch(int flags, const void* v2c, void* c2v, const FloodingTables& t,
                            int nbt, int threads, cudaStream_t stream) {
  if (t.Bt != kBt || threads > I8Rule<FAMILY>::CheckUnits::kBlock) return cudaErrorInvalidValue;
  auto kernel = i8_check_kernel<DMAX, FAMILY>;
  const size_t smem = phase_smem(t.CG, t.E);
  dim3 grid;
  cudaError_t err = phase_grid(kernel, t.CG * t.Z, nbt, threads, smem, &grid);
  if (err != cudaSuccess) return err;
  return launch(kernel, grid, threads, smem, stream, static_cast<const int8_t*>(v2c),
                static_cast<int8_t*>(c2v), t, flags, i8_fma());
}

}  // namespace ldpc
