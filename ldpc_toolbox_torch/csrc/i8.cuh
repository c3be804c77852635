// The i8 rules of the reference (arithmetic.rs:585-1304) for the resident
// message kernels of csrc/message_kernels.cuh: I8Rule, their int8
// instances, built by csrc/resident_layered_i8.cu and csrc/flooding_i8.cu.
// They replace the rule code that the Pallas kernels inline through
// ldpc_toolbox_tpu/ops/fused_bp2.py rule_for: _I8RuleBase (int8 messages,
// int32 arithmetic, the clips), MinstarApproxI8Rule.check and
// AminstarI8Rule.check.
//
// A check input x is in [-127, 127]: every message is clipped to +-127 and
// the missing lane reads 127. So a lane's four magnitudes |x| fit one word,
// a byte a frame, and the byte-SIMD intrinsics compute each frame's fold
// exactly: __vminu4, __vabsdiffu4, __vsubus4 for max(m - t, 0), __vaddus4
// then __vminu4 with 127 for min(a + b, 127), and the correction table as
// a sum of __vsetleu4 indicators. The O(d^2) exact-order fold then keeps
// one register a slot for its prefixes, not four. The signs stay per frame
// as bit masks, as in the min-sum Fold; an output's sign is the parity of
// the other slots' signs.
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

// A non-increasing table of small values as its steps T: table[t] = sum_k
// [t <= T_k], for each byte t of a word (the byte sums stay below 256, so
// the word adds carry nothing).
template <int... T>
struct Steps {
  static __device__ __forceinline__ uint32_t of(uint32_t t) {
    return (__vsetleu4(t, T * kOnes) + ...);
  }
};
// The correction table, table[t] = round(8 ln(1 + e^(-t/8))) for t in [0,
// 127] while that is positive, else 0 (arithmetic.rs:589-602), as its
// steps (ops/fused_bp2.py _i8_thresholds; tests/test_torch_layout.py reads
// them from this line and holds them to it).
using I8Correction = Steps<21, 12, 8, 4, 2, 0>;

// table[t] of each byte t of a word (bytes in [0, 127]).
__device__ __forceinline__ uint32_t tab4(uint32_t t) { return I8Correction::of(t); }

// MinstarApproxI8's fold, per byte: max(min(a, b) - table[|a - b|], 0).
__device__ __forceinline__ uint32_t minstar_approx4(uint32_t a, uint32_t b) {
  return __vsubus4(__vminu4(a, b), tab4(__vabsdiffu4(a, b)));
}

// AminstarI8's full min*, per byte: max(min(a, b) - table[|a - b|] +
// table[min(a + b, 127)], 0). The second correction is added before the
// saturating subtract (no byte passes 133, so the word add carries
// nothing), since satsub(min + t2, t1) = max(min - t1 + t2, 0) only in that
// order.
__device__ __forceinline__ uint32_t minstar_full4(uint32_t a, uint32_t b) {
  const uint32_t t2 = tab4(__vminu4(__vaddus4(a, b), k127s));
  return __vsubus4(__vminu4(a, b) + t2, tab4(__vabsdiffu4(a, b)));
}

// The partial hard limit (arithmetic.rs:812-824) on magnitudes: 100 and
// above become 127.
__device__ __forceinline__ uint32_t phl4(uint32_t m) {
  const uint32_t hi = __vcmpgeu4(m, 100 * kOnes);
  return (m & ~hi) | (k127s & hi);
}

__device__ __forceinline__ int clip127(int x) { return min(max(x, -127), 127); }

// A check's inputs for a lane's four frames: mag[k] the magnitudes of slot
// k, a byte a frame; negs[f] the signs of frame f (x < 0), bit k.
template <int DMAX>
struct I8Check {
  static_assert(DMAX <= 32, "the signs are kept in 32 bits");
  uint32_t mag[DMAX];
  uint32_t negs[kBt] = {};

  __device__ __forceinline__ void set(int k, const I4& x) {
    uint32_t m = 0;
#pragma unroll
    for (int f = 0; f < kBt; ++f) {
      m |= (uint32_t)abs(x.v[f]) << (8 * f);
      negs[f] |= (uint32_t)(x.v[f] < 0) << k;
    }
    mag[k] = m;
  }
  // slot k's output for frame f from its magnitude bytes om: the byte
  // with the parity of the other slots' signs
  __device__ __forceinline__ int out(int k, int f, uint32_t om) const {
    const int m = (om >> (8 * f)) & 0xff;
    return ((__popc(negs[f]) ^ (negs[f] >> k)) & 1) ? -m : m;
  }
};

// Calls emit(k, om) for each slot k < d with its output magnitudes om (a
// byte a frame) under FAMILY, the partial hard limit applied when phl.
template <int DMAX, int FAMILY, class Emit>
__device__ __forceinline__ void i8_outputs(const I8Check<DMAX>& in, int d, bool phl,
                                           Emit&& emit) {
  const uint32_t(&mag)[DMAX] = in.mag;
  if constexpr (FAMILY == kMinstarApprox) {
    // pre[t]: the left fold of slots 0..t-1; slot t's output continues it
    // over slots t+1..d-1 (slot 0's starts from slot 1)
    uint32_t pre[DMAX];
    uint32_t acc = mag[0];
#pragma unroll
    for (int t = 1; t < DMAX; ++t) {
      if (t < d - 1) {
        pre[t] = acc;
        acc = minstar_approx4(acc, mag[t]);
      } else if (t == d - 1) {
        pre[t] = acc;
      }
    }
#pragma unroll
    for (int t = 0; t < DMAX; ++t) {
      if (t < d) {
        uint32_t a;
        if (t + 1 < d) {
          a = t == 0 ? mag[1] : minstar_approx4(pre[t], mag[t + 1]);
#pragma unroll
          for (int k = t + 2; k < DMAX; ++k)
            if (k < d) a = minstar_approx4(a, mag[k]);
        } else {
          a = t == 0 ? 0u : pre[t];  // a degree-1 check outputs 0
        }
        emit(t, phl ? phl4(a) : a);
      }
    }
  } else {
    // the first minimum and its slot, a byte a frame
    uint32_t m1 = mag[0], arg = 0;
#pragma unroll
    for (int k = 1; k < DMAX; ++k) {
      if (k < d) {
        const uint32_t lt = __vcmpltu4(mag[k], m1);
        m1 = __vminu4(m1, mag[k]);
        arg = (arg & ~lt) | (k * kOnes & lt);
      }
    }
    // the full min* fold over the other slots, from the first of them
    uint32_t acc = 0, started = 0;
#pragma unroll
    for (int k = 0; k < DMAX; ++k) {
      if (k < d) {
        const uint32_t elig = ~__vcmpeq4(arg, k * kOnes);
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
        const uint32_t is_min = __vcmpeq4(arg, t * kOnes);
        emit(t, (d_min & is_min) | (d_oth & ~is_min));
      }
    }
  }
}

// The i8 variable update of variable lane w (edges p0..p1) in one flooding
// tile, from its first loads v, under flags (Jones, Deg1Clip), with the
// cells of lanes.cuh var_update: see csrc/flooding_i8.cu.
template <class Cells>
__device__ __forceinline__ void i8_var_update(const Cells& cells, int8_t* post,
                                              int p0, int p1, int w,
                                              const VarLoads<int8_t>& v,
                                              int flags) {
  const bool clip_q = (flags & kDeg1Clip) && p1 - p0 == 1;
  I4 tot;
#pragma unroll
  for (int f = 0; f < kBt; ++f) {
    const int q = byte_of(v.q, f);
    tot.v[f] = clip_q ? min(max(q, -116), 116) : q;
  }
  auto add = [&](uint32_t y) {
#pragma unroll
    for (int f = 0; f < kBt; ++f) tot.v[f] += byte_of(y, f);
  };
#pragma unroll
  for (int j = 0; j < kVarChunk; ++j)
    if (p0 + j < p1) add(v.y0[j]);
  for (int c0 = p0 + kVarChunk; c0 < p1; c0 += kVarChunk) {
    uint32_t y[kVarChunk];
#pragma unroll
    for (int j = 0; j < kVarChunk; ++j)
      if (c0 + j < p1) y[j] = load_word(cells.in(c0 + j, w));
#pragma unroll
    for (int j = 0; j < kVarChunk; ++j)
      if (c0 + j < p1) add(y[j]);
  }
  if (flags & kJones) {
#pragma unroll
    for (int f = 0; f < kBt; ++f) tot.v[f] = clip127(tot.v[f]);
  }
  store_word(post, hard_bits(tot));
  auto output = [&](int p, uint32_t y) {
    I4 o;
#pragma unroll
    for (int f = 0; f < kBt; ++f) o.v[f] = clip127(tot.v[f] - byte_of(y, f));
    cells.out(p, w, o);
  };
#pragma unroll
  for (int j = 0; j < kVarChunk; ++j)
    if (p0 + j < p1) output(p0 + j, v.y0[j]);
  for (int p = p0 + kVarChunk; p < p1; ++p) output(p, load_word(cells.in(p, w)));
}

// The i8 rule of FAMILY under flags, for csrc/message_kernels.cuh: int16
// layered posteriors, int8 messages, int32 deltas; x = clip(Qv - Rold,
// +-127) and 127 at the missing lane.
template <int FAMILY>
struct I8Rule {
  using Q = int16_t;
  using Msg = int8_t;
  using P = int;
  using FloodUnits = Units<>;
  using LayeredUnits = Units<>;
  static constexpr int big = 127;
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
    __device__ __forceinline__ void set(int k, const I4& x) { in.set(k, x); }
    template <class Emit>
    __device__ __forceinline__ void outputs(const I4 (&)[DMAX], int d, Emit&& emit) {
      i8_outputs<DMAX, FAMILY>(in, d, phl, [&](int k, uint32_t om) {
        I4 o;
#pragma unroll
        for (int f = 0; f < kBt; ++f) o.v[f] = in.out(k, f, om);
        emit(k, o);
      });
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
