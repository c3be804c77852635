// The i8 rules of the reference (arithmetic.rs:585-1304) for the resident
// message kernels of csrc/message_kernels.cuh: I8Rule, their int8
// instances, built by csrc/resident_layered_i8.cu and csrc/flooding_i8.cu.
// They replace the rule code that the Pallas kernels inline through
// ldpc_toolbox_tpu/ops/fused_bp2.py rule_for: _I8RuleBase (int8 messages,
// int32 arithmetic, the clips), MinstarApproxI8Rule.check and
// AminstarI8Rule.check.
//
// A check input x is in [-127, 127]: every message is clipped to +-127 and
// the missing lane reads 127. So a lane's four inputs fit one word, a byte
// a frame, and so do their magnitudes, which leave bit 7 of each byte
// free. The check works on such words (I8Rule::kWords: the kernels hand it
// a lane's four inputs as one word and take its outputs so): every step
// is word arithmetic that serves four frames at once and never carries
// from one byte into the next. a + 0x80 - b per byte holds [a >= b] in
// bit 7 (no borrow for bytes in [0, 127]), and PRMT's sign mode spreads
// bit 7 over its byte (high_mask), so a min, a compare and a select are an
// IADD3, a PRMT and a LOP3. The byte-SIMD intrinsics (__vminu4 and kin)
// expand on Hopper into several integer instructions each: a fold with
// them executes 39 SASS instructions, in this form 23
// (tools/count_math_ops.py). The signs stay as bit masks, eight slots a
// word; an output's sign is the parity of the other slots' signs.
//
// Bit-exactness with the JAX package: the folds are its folds, in its
// order (MinstarApprox: each slot's left fold over the other slots in slot
// order, with the prefixes of the slots before it reused; Aminstar: the
// first minimum's slot, a full min* fold over the other slots from the
// first of them); the partial hard limit acts on magnitudes (it is odd in
// x); a degree-1 check outputs 0.

#pragma once

#include "message_kernels.cuh"

namespace ldpc {

// The rule families (ops/fused_bp2.py MinstarApproxI8Rule.kind and
// AminstarI8Rule.kind) and the variant's flags (_I8RuleBase.flags).
constexpr int kMinstarApprox = 0, kAminstar = 1;
constexpr int kPartialHardLimit = 1, kJones = 2, kDeg1Clip = 4;
// The largest check degree the int8 instances take (buckets 8, 16, 32).
constexpr int kI8MaxDegree = 32;

constexpr uint32_t kOnes = 0x01010101u;
constexpr uint32_t k127s = 0x7f7f7f7fu;
constexpr uint32_t kHighs = 0x80808080u;

// 0xff in each byte of w whose bit 7 is set, 0 in the others (PRMT's sign
// replication: selector nibble 8 + i copies the sign of byte i).
__device__ __forceinline__ uint32_t high_mask(uint32_t w) {
  uint32_t m;
  asm("prmt.b32 %0, %1, 0, 0xba98;" : "=r"(m) : "r"(w));
  return m;
}

// A non-increasing table of small values as its steps T: table[t] = sum_k
// [t <= T_k], for each byte t of a word (t in [0, 127]). Each indicator is
// bit 7 of 0x80 + T_k - t (no borrow). The steps are nested, so the sum
// is the count of a thermometer code, and its bit b is the parity of the
// indicators of the steps m * 2^b - 1 (0-based, m = 1, 2, ...): the parity
// words are built from the top bit down, each from the one above it.
template <int... T>
struct Steps {
  static constexpr int kN = sizeof...(T);
  static_assert(((T >= 0 && T <= 127) && ...), "a step is a byte value");

  static __device__ __forceinline__ uint32_t of(uint32_t t) {
    const uint32_t y[kN] = {((0x80u + T) * kOnes - t)...};
    constexpr int kTop = kN >= 4 ? (kN >= 8 ? 3 : 2) : (kN >= 2 ? 1 : 0);
    static_assert(kN < 16, "at most 15 steps");
    uint32_t sum = 0, x = 0;
#pragma unroll
    for (int b = kTop; b >= 0; --b) {
#pragma unroll
      for (int m = 1; m << b <= kN; m += 2) x ^= y[(m << b) - 1];
      sum += (x & kHighs) >> (7 - b);
    }
    return sum;
  }
};
// The correction table, table[t] = round(8 ln(1 + e^(-t/8))) for t in [0,
// 127] while that is positive, else 0 (arithmetic.rs:589-602), as its
// steps (ops/fused_bp2.py _i8_thresholds; tests/test_torch_layout.py reads
// them from this line and holds them to it).
using I8Correction = Steps<21, 12, 8, 4, 2, 0>;

// table[t] of each byte t of a word (bytes in [0, 127]).
__device__ __forceinline__ uint32_t tab4(uint32_t t) { return I8Correction::of(t); }

// max(a - b, 0) per byte, a and b in [0, 127].
__device__ __forceinline__ uint32_t sat_sub4(uint32_t a, uint32_t b) {
  const uint32_t r = a + kHighs - b;
  return r & high_mask(r) & k127s;
}

// min(a, b) per byte and |a - b| per byte, a and b in [0, 127].
struct MinDiff {
  uint32_t mn, diff;
};
__device__ __forceinline__ MinDiff min_diff4(uint32_t a, uint32_t b) {
  const uint32_t ge = high_mask(a + kHighs - b);  // a >= b
  const uint32_t mn = (b & ge) | (a & ~ge);
  return {mn, (a ^ b ^ mn) - mn};  // max - min
}

// MinstarApproxI8's fold, per byte: max(min(a, b) - table[|a - b|], 0).
__device__ __forceinline__ uint32_t minstar_approx4(uint32_t a, uint32_t b) {
  const MinDiff m = min_diff4(a, b);
  return sat_sub4(m.mn, tab4(m.diff));
}

// AminstarI8's full min*, per byte: max(min(a, b) - table[|a - b|] +
// table[min(a + b, 127)], 0). a + b is below 255 (no carry) and min(a + b,
// 127) is a + b with every bit set where bit 7 is, then bits 0-6. The
// second correction is added before the saturating subtract (it is not 0
// only where a + b < 22, so the byte stays below 128), since satsub(min +
// t2, t1) = max(min - t1 + t2, 0) only in that order.
__device__ __forceinline__ uint32_t minstar_full4(uint32_t a, uint32_t b) {
  const MinDiff m = min_diff4(a, b);
  const uint32_t s = a + b;
  const uint32_t t2 = tab4((s | high_mask(s)) & k127s);
  return sat_sub4(m.mn + t2, tab4(m.diff));
}

// The partial hard limit (arithmetic.rs:812-824) on magnitudes: 100 and
// above become 127 (bit 7 of m + 28 is [m >= 100]).
__device__ __forceinline__ uint32_t phl4(uint32_t m) {
  return (m | high_mask(m + 28 * kOnes)) & k127s;
}

// [a != b] per byte as 0xff, a and b bytes in [0, 127].
__device__ __forceinline__ uint32_t ne4(uint32_t a, uint32_t b) {
  return high_mask((a ^ b) + k127s);
}

__device__ __forceinline__ int clip127(int x) { return min(max(x, -127), 127); }

// A check's inputs for a lane's four frames, a byte a frame: mag[k] the
// magnitudes of slot k; signs[k / 8] bit k % 8 of byte f the sign of frame
// f (x < 0) at slot k; par bit 7 of byte f the parity of frame f's signs.
template <int DMAX>
struct I8Check {
  static_assert(DMAX <= 32, "the signs are kept in four words");
  uint32_t mag[DMAX];
  uint32_t signs[(DMAX + 7) / 8] = {};
  uint32_t par = 0;

  // slot k's input word x (bytes in [-127, 127]): |x| is x ^ 0xff + 1 in
  // the negative bytes (no carry: ~x <= 126 there)
  __device__ __forceinline__ void set(int k, uint32_t x) {
    const uint32_t s = x & kHighs;
    mag[k] = (x ^ high_mask(x)) + (s >> 7);
    signs[k / 8] |= s >> (7 - k % 8);
    par ^= s;
  }
  // slot k's output word from its magnitude bytes om (in [0, 127]): each
  // byte negated where the other slots' signs have odd parity; -m is (0x80
  // - m) ^ 0x80 (no borrow, and 0 for m = 0)
  __device__ __forceinline__ uint32_t out(int k, uint32_t om) const {
    const uint32_t neg = high_mask(par ^ (signs[k / 8] << (7 - k % 8)));
    return (((kHighs - om) ^ kHighs) & neg) | (om & ~neg);
  }
};

// Calls emit(k, om) for each slot k < d with its output magnitudes om (a
// byte a frame) under FAMILY, the partial hard limit applied when phl.
template <int DMAX, int FAMILY, class Emit>
__device__ __forceinline__ void i8_outputs(const I8Check<DMAX>& in, int d, bool phl,
                                           Emit&& emit) {
  const uint32_t(&mag)[DMAX] = in.mag;
  if constexpr (FAMILY == kMinstarApprox) {
    // pre: the left fold of slots 0..t-1 as slot t's output is made (t >=
    // 1), which continues it over slots t+1..d-1 (slot 0's starts from slot
    // 1); then pre takes slot t in for slot t + 1. One register for the
    // prefixes, not one a slot: fewer spills (in turns on the card, the
    // flagship decodes 5 % faster layered and 3 % flooding)
    uint32_t pre = mag[0];
#pragma unroll
    for (int t = 0; t < DMAX; ++t) {
      if (t < d) {
        uint32_t a;
        if (t + 1 < d) {
          a = t == 0 ? mag[1] : minstar_approx4(pre, mag[t + 1]);
#pragma unroll
          for (int k = t + 2; k < DMAX; ++k)
            if (k < d) a = minstar_approx4(a, mag[k]);
        } else {
          a = t == 0 ? 0u : pre;  // a degree-1 check outputs 0
        }
        emit(t, phl ? phl4(a) : a);
        if (t >= 1 && t + 1 < d) pre = minstar_approx4(pre, mag[t]);
      }
    }
  } else {
    // the first minimum and its slot, a byte a frame (bit 7 of m1 + 127 -
    // mag is [mag < m1])
    uint32_t m1 = mag[0], arg = 0;
#pragma unroll
    for (int k = 1; k < DMAX; ++k) {
      if (k < d) {
        const uint32_t lt = high_mask(m1 + k127s - mag[k]);
        m1 = (mag[k] & lt) | (m1 & ~lt);
        arg = (k * kOnes & lt) | (arg & ~lt);
      }
    }
    // the full min* fold over the other slots, from the first of them
    uint32_t acc = 0, started = 0;
#pragma unroll
    for (int k = 0; k < DMAX; ++k) {
      if (k < d) {
        const uint32_t elig = ne4(arg, k * kOnes);
        const uint32_t first = elig & ~started;
        const uint32_t folded = minstar_full4(acc, mag[k]);
        acc = (mag[k] & first) | (folded & elig & ~first) | (acc & ~elig);
        started |= elig;
      }
    }
    uint32_t d_min = acc, d_oth = minstar_full4(acc, m1);
    if (phl) {
      d_min = phl4(d_min);
      d_oth = phl4(d_oth);
    }
#pragma unroll
    for (int t = 0; t < DMAX; ++t) {
      if (t < d) {
        const uint32_t other = ne4(arg, t * kOnes);
        emit(t, (d_oth & other) | (d_min & ~other));
      }
    }
  }
}

// A word of four int8 values v, each as v + 128 (v ^ 0x80 as an unsigned
// byte) in a 16-bit half: frames 0 and 1 in lo, 2 and 3 in hi.
struct Halves {
  uint32_t lo, hi;
};
__device__ __forceinline__ Halves halves(uint32_t w) {
  const uint32_t u = w ^ kHighs;
  return {__byte_perm(u, 0, 0x4140), __byte_perm(u, 0, 0x4342)};
}
// min and max of each 16-bit half (Hopper's integer min and max of
// halves; every half here is below 0x8000)
__device__ __forceinline__ uint32_t min16x2(uint32_t a, uint32_t b) {
  uint32_t r;
  asm("min.s16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t max16x2(uint32_t a, uint32_t b) {
  uint32_t r;
  asm("max.s16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
// x clamped to [lo, hi], a value v in both halves as v * 0x10001
__device__ __forceinline__ Halves clamp16x2(Halves x, uint32_t lo, uint32_t hi) {
  return {min16x2(max16x2(x.lo, lo), hi), min16x2(max16x2(x.hi, lo), hi)};
}
constexpr uint32_t kHalfOnes = 0x00010001u;
// the c2v a variable unit loads first (lanes.cuh VarLoads)
constexpr int kI8VarChunk = kVarChunkOf<kBt, int8_t>;

// The i8 variable update of variable lane w (edges p0..p1) in one flooding
// tile, from its first loads v, under flags (Jones, Deg1Clip), with the
// cells of lanes.cuh var_update: see csrc/flooding_i8.cu. A lane's four
// frames in the 16-bit halves of two words, each value biased by 128 so
// that no half borrows from the next: T = q + the d c2v, each + 128, is
// tot + 128 (d + 1); the clips are clamps of T by constants of d; the hard
// decision tot <= 0 is bit 15 of 128 (d + 1) + 0x8000 - T; an output is
// clip(tot - y, +-127) + 128 d + 256 = clamp(T - Y + 256), whose low byte
// is the output's, bit 7 flipped when d is odd.
template <class Cells>
__device__ __forceinline__ void i8_var_update(const Cells& cells, int8_t* post,
                                              int p0, int p1, int w,
                                              const VarLoads<int8_t>& v,
                                              int flags) {
  const int d = p1 - p0;
  const uint32_t bias = 128 * (d + 1) * kHalfOnes;
  Halves tot = halves(v.q);
  if ((flags & kDeg1Clip) && d == 1) tot = clamp16x2(tot, 12 * kHalfOnes, 244 * kHalfOnes);
  auto add = [&](uint32_t y) {
    const Halves h = halves(y);
    tot.lo += h.lo;
    tot.hi += h.hi;
  };
#pragma unroll
  for (int j = 0; j < kI8VarChunk; ++j)
    if (p0 + j < p1) add(v.y0[j]);
  for (int c0 = p0 + kI8VarChunk; c0 < p1; c0 += kI8VarChunk) {
    uint32_t y[kI8VarChunk];
#pragma unroll
    for (int j = 0; j < kI8VarChunk; ++j)
      if (c0 + j < p1) y[j] = load_word(cells.in(c0 + j, w));
#pragma unroll
    for (int j = 0; j < kI8VarChunk; ++j)
      if (c0 + j < p1) add(y[j]);
  }
  if (flags & kJones) tot = clamp16x2(tot, bias - 127 * kHalfOnes, bias + 127 * kHalfOnes);
  const uint32_t zero = bias + 0x80008000u;
  store_word(post, __byte_perm((zero - tot.lo) >> 15 & kHalfOnes,
                               (zero - tot.hi) >> 15 & kHalfOnes, 0x6420));
  const uint32_t lo = (128 * d + 129) * kHalfOnes, hi = (128 * d + 383) * kHalfOnes;
  const uint32_t flip = d & 1 ? kHighs : 0u;
  auto output = [&](int p, uint32_t y) {
    const Halves h = halves(y);
    const Halves o = clamp16x2({tot.lo - h.lo + 256 * kHalfOnes, tot.hi - h.hi + 256 * kHalfOnes},
                               lo, hi);
    cells.out(p, w, __byte_perm(o.lo, o.hi, 0x6420) ^ flip);
  };
#pragma unroll
  for (int j = 0; j < kI8VarChunk; ++j)
    if (p0 + j < p1) output(p0 + j, v.y0[j]);
  for (int p = p0 + kI8VarChunk; p < p1; ++p) output(p, load_word(cells.in(p, w)));
}

// The i8 rule of FAMILY under flags, for csrc/message_kernels.cuh: int16
// layered posteriors, int8 messages, int32 deltas; x = clip(Qv - Rold,
// +-127) and 127 at the missing lane. A word rule (kWords): its Check takes
// and gives a lane's four int8 values as one word (bigs the missing lane's
// input word). A thread takes a lane's four frames, at more threads a
// block than the other rules (in turns on the card, against 256):
// flooding 512 (32 warps an SM at 64 registers; 12 % faster a flagship
// decode), the layered check lanes 384 (a flagship check group of 360
// lanes in one pass, 24 warps at 80 registers; 11 % faster).
template <int FAMILY>
struct I8Rule {
  using Q = int16_t;
  using Msg = int8_t;
  using P = int;
  using FloodUnits = Units<kBt, 512>;
  using LayeredUnits = Units<kBt, 384>;
  static constexpr bool kWords = true;
  static constexpr int big = 127;
  static constexpr uint32_t bigs = k127s;
  int flags;

  __device__ __forceinline__ int extrinsic(int q, int rold) const {
    return clip127(q - rold);
  }
  __device__ __forceinline__ int diff(int rn, int rold) const { return rn - rold; }

  template <int DMAX>
  struct Check {
    I8Check<DMAX> in;
    bool phl;

    __device__ __forceinline__ explicit Check(const I8Rule& r)
        : phl(r.flags & kPartialHardLimit) {}
    __device__ __forceinline__ void set(int k, uint32_t x) { in.set(k, x); }
    template <class Emit>
    __device__ __forceinline__ void outputs(int d, Emit&& emit) {
      i8_outputs<DMAX, FAMILY>(in, d, phl,
                               [&](int k, uint32_t om) { emit(k, in.out(k, om)); });
    }
  };

  template <class Cells>
  __device__ __forceinline__ void var_update(const Cells& cells, int8_t* post,
                                             int p0, int p1, int w,
                                             const VarLoads<int8_t>& v) const {
    i8_var_update(cells, post, p0, p1, w, v, flags);
  }
};

// Calls Launch<DMAX, FAMILY>::run(args...) with the least degree bucket
// (8, 16 or 32) that holds max_degree and the family kind.
template <template <int, int> class Launch, typename... Args>
cudaError_t i8_by_bucket(int max_degree, int kind, Args&&... args) {
  if (max_degree < 1 || max_degree > kI8MaxDegree) return cudaErrorInvalidValue;
  if (kind != kMinstarApprox && kind != kAminstar) return cudaErrorInvalidValue;
#define LDPC_I8_BUCKET(D)                                               \
  if (max_degree <= D)                                                  \
    return kind == kAminstar ? Launch<D, kAminstar>::run(args...)       \
                             : Launch<D, kMinstarApprox>::run(args...);
  LDPC_I8_BUCKET(8)
  LDPC_I8_BUCKET(16)
  LDPC_I8_BUCKET(32)
#undef LDPC_I8_BUCKET
  return cudaErrorInvalidValue;
}

}  // namespace ldpc
