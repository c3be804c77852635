// The reference's four float check rules (arithmetic.rs:158-580, 899-1072)
// for the message kernels of csrc/message_kernels.cuh and the streaming
// kernels of csrc/streaming.cuh: FloatRule, their float-rule instances, in
// f32 (T = float) and f64 (T = double), built by
// csrc/resident_layered_f32.cu, _f64.cu, csrc/flooding_f32.cu and _f64.cu
// (the resident kernels and the flooding phases) and
// csrc/fused_layered_f32.cu and _f64.cu (the streaming sweep), one
// precision a source, so that the parallel build keeps its length. They replace the rule code that the Pallas kernels inline
// through ldpc_toolbox_tpu/ops/fused_bp2.py rule_for: _FloatRuleBase,
// PhiRule, TanhRule, MinstarApproxRule and AminstarRule, whose check
// functions the port's ops/fused_bp2.py repeats as the plain versions.
//
// What bounds the float instances on an H100: the state lives in device
// memory as for min-sum (layered: 6 values an edge lane an iteration, 24
// bytes in f32 and 48 in f64; flooding: 4 values, 16 and 32 bytes), but
// the rules are arithmetic: Phi takes two phis (an exp and two logs each)
// an edge, MinstarApprox O(d) min* folds an edge, each an exp and a log1p,
// and the math library's f64 routines are tens of FP64 instructions each.
//
// A check lane holds its d inputs for four frames, x[k].v[f] (or a unit's
// frames, below). The rules keep O(d) values a frame (the phis, the tanh
// products, the min* prefixes, the magnitudes), so float_check folds one
// frame at a time: a rolled loop over the frames that takes frame 0 of
// every slot, writes the outputs in its place and rotates each slot's
// values by one, so that after a turn a frame every output sits where its
// input was. The body is compiled once, not four times, and every array
// index stays a constant.
//
// The f64 instances of the flooding kernels (TPU #4/#5 resident, #7 and #8
// the phases) give a thread one frame of a lane instead (FloodUnits, a
// (lane, frame) unit, lanes.cuh Units): a lane's four f64 frames (64
// registers at degree 8) with the rule's O(d) values and the math
// library's f64 routines held a thread to 128 registers, 600-750 bytes of
// stack and 16 warps an SM; a unit's d inputs and d phis take 32 registers
// at degree 8, so a block of 512 threads runs at 64 registers, two blocks
// (32 warps) an SM, the four threads of a lane reading its 32-byte cells
// together. In turns on the card (tools/compare_forms.py), a frame pair a
// unit and blocks of 384 to 768 threads ran slower. The layered f64
// instances keep a lane's four frames. What bounds the f64 instances then
// is the f64 phi itself: the flagship's check phase runs near the rate at
// which the card evaluates phi alone (tools/count_math_ops.py --rate).
//
// The f32 instances of the resident layered kernel (TPU #1) give a check
// lane's thread a frame pair (LayeredUnits): a tile's check groups run one after another, so what bounds a tile is the
// latency of a group's check lanes, each a chain of phis (56 for a lane's
// four frames at degree 7, Phi), and a lane's four frames in two passes of
// 256 threads over Z = 360 lanes left the second pass 104 threads wide. A
// frame pair halves each chain, and a group's 720 units take three passes
// of 256 threads, the last 208 wide; the two threads of a lane read its
// 16-byte cells together, and the park update, the syndrome and the hard
// decisions keep a thread per lane (csrc/lanes.cuh). The rule needs about
// 128 registers a thread: in turns on the card (tools/compare_forms.py), a
// unit of one frame at 512 threads (64 registers, 32 warps an SM) spilled
// 336 bytes a thread and ran 43 % slower than a lane's four frames, and
// every block above 256 lost too; against the pair at 256, one frame a
// thread and prefetching the next unit's loads ran slower, and a lane's
// four frames 8 % slower a decode. The streaming sweep (TPU #3) keeps a
// lane's four frames a thread, as every other rule does: there the pair
// ran 4 % slower.
//
// Bit-exactness with the plain versions on the card: every operation is
// the one of the plain version, in its order, in the type T; add_rn,
// sub_rn and mul_rn keep nvcc from contracting a product and a sum into an
// FMA; the transcendentals are the CUDA math library's expf/exp, logf/log,
// log1pf/log1p and tanhf/tanh, the functions torch's CUDA kernels call; no
// fast-math flag is set, so subnormals are kept, as torch keeps them. The
// output's sign (Phi, MinstarApprox, Aminstar) is the parity of the other
// slots' signs (x < 0), a mask and a popcount as in the min-sum Fold; Tanh
// carries its signs in the product.

#pragma once

#include "streaming.cuh"

namespace ldpc {

// The rules, by ops/fused_bp2.py's kind (tests/test_torch_layout.py reads
// these lines and holds them to the rules).
constexpr int kPhiRule = 0;
constexpr int kTanhRule = 1;
constexpr int kMinstarApproxRule = 2;
constexpr int kAminstarRule = 3;
// The largest check degree of the float instances (the signs are kept in
// 64 bits), and of MinstarApprox's, whose exact-order fold is O(d^2) and
// unrolled to the degree bucket (8, 16 or 32).
constexpr int kFloatMaxDegree = 64;
constexpr int kMinstarApproxMaxDegree = 32;

// A rule's parameters in its type: big, the missing-lane poke (the type's
// largest value); Tanh's input clamp and product clamp (the largest value
// below 1).
template <typename T>
struct FloatParams {
  T big, clamp, prod_max;
};

__device__ __forceinline__ float ex(float x) { return expf(x); }
__device__ __forceinline__ double ex(double x) { return exp(x); }
__device__ __forceinline__ float ln(float x) { return logf(x); }
__device__ __forceinline__ double ln(double x) { return log(x); }
__device__ __forceinline__ float ln1p(float x) { return log1pf(x); }
__device__ __forceinline__ double ln1p(double x) { return log1p(x); }
__device__ __forceinline__ float th(float x) { return tanhf(x); }
__device__ __forceinline__ double th(double x) { return tanh(x); }
// max and min as torch.maximum and torch.minimum on numbers (no NaN
// reaches a rule), |x| as torch.abs
template <typename T>
__device__ __forceinline__ T max_of(T a, T b) {
  return a > b ? a : b;
}
template <typename T>
__device__ __forceinline__ T min_of(T a, T b) {
  return a < b ? a : b;
}
__device__ __forceinline__ float mag(float x) { return fabsf(x); }
__device__ __forceinline__ double mag(double x) { return fabs(x); }

// phi(x) = ln(1 + e^-x) - ln(1 - e^-x) with x at least 1e-30: 1 - e^-x as
// x (1 - x / 2 + x^2 / 6) below 2^-5, ln(1 - t) as log1p(-t) for t < 1/2
// (PhiRule._phi).
template <typename T>
__device__ __forceinline__ T phi(T x) {
  x = max_of(x, T(1e-30));
  const T t = ex(-x);
  T one_minus_t;
  if (x < T(0.03125)) {
    const T poly = add_rn(sub_rn(T(1), mul_rn(T(0.5), x)),
                          mul_rn(T(1.0 / 6.0), mul_rn(x, x)));
    one_minus_t = mul_rn(x, poly);
  } else {
    one_minus_t = sub_rn(T(1), t);
  }
  T ln_1mt;
  if constexpr (std::is_same_v<T, float>) {
    // both logs, then a select: no branch that splits a warp, so the
    // compiler can overlap a check's phis (the f32 instances 2-8 % faster
    // in turns on the card, the f64 ones slower)
    const T lo = ln1p(-t), hi = ln(one_minus_t);
    ln_1mt = t < T(0.5) ? lo : hi;
  } else {
    ln_1mt = t < T(0.5) ? ln1p(-t) : ln(one_minus_t);
  }
  return sub_rn(ln1p(t), ln_1mt);
}

// MinstarApprox's fold: max(min(a, b) - log1p(exp(-|a - b|)), 0).
template <typename T>
__device__ __forceinline__ T minstar_approx(T a, T b) {
  return max_of(sub_rn(min_of(a, b), ln1p(ex(-mag(sub_rn(a, b))))), T(0));
}

// Aminstar's full min*: min(a, b) - log1p(exp(-|a - b|)) + log1p(exp(-(a +
// b))). With b = big, a + b overflows to inf or stays big: exp gives 0.
template <typename T>
__device__ __forceinline__ T minstar_full(T a, T b) {
  return add_rn(sub_rn(min_of(a, b), ln1p(ex(-mag(sub_rn(a, b))))),
                ln1p(ex(-add_rn(a, b))));
}

// Tanh's factor of one slot: tanh(clamp(x / 2, +-clamp)).
template <typename T>
__device__ __forceinline__ T tanh_half(T x, T clamp) {
  return th(min_of(max_of(mul_rn(T(0.5), x), -clamp), clamp));
}

// Tanh's output from the product p of the other slots' factors: 2 atanh(p)
// as log1p(p) - log1p(-p), p clamped to +-prod_max.
template <typename T>
__device__ __forceinline__ T atanh2(T p, T prod_max) {
  p = min_of(max_of(p, -prod_max), prod_max);
  return sub_rn(ln1p(p), ln1p(-p));
}

// The signs of a frame's d inputs as a mask (bit k: x_k < 0) and the
// output sign of slot k: the parity of the other slots' signs.
template <int DMAX>
struct Signs {
  using Mask = std::conditional_t<(DMAX > 32), uint64_t, uint32_t>;
  Mask negs = 0;
  int par = 0;

  template <typename T>
  __device__ __forceinline__ Signs(const T (&x)[DMAX], int d) {
#pragma unroll
    for (int k = 0; k < DMAX; ++k)
      if (k < d) negs |= (Mask)(x[k] < T(0)) << k;
    if constexpr (DMAX > 32) {
      par = __popcll(negs) & 1;
    } else {
      par = __popc(negs) & 1;
    }
  }
  template <typename T>
  __device__ __forceinline__ T apply(int k, T y) const {
    return ((par ^ (int)(negs >> k)) & 1) ? -y : y;
  }
};

// The rule's loops are unrolled to the degree bucket up to 16 in f32,
// where its arrays fit registers. The 32 and 64 buckets (CCSDS C2, 5G BG1,
// DVB-S2's high rates) keep them rolled: their arrays spill to local memory
// either way, and unrolled, the transcendentals of 32 or 64 slots (O(d^2)
// for MinstarApprox) multiplied the build time of the sources. f64 keeps
// them rolled at every bucket: unrolled, the math library's f64 routines
// inlined a slot at a time made the degree-8 check phase 8032 instructions
// long, and the kernels ran slower than the card's instruction caches fed
// them (rolled, 1576 instructions: the flagship's f64 check phase, the
// resident flooding and layered decodes 12-16 % faster, in turns on the
// card; tools/compare_forms.py). Rolled in f32 too, the degree-8 layered
// instances ran 8 % slower and the flooding check phase 2 % slower (in
// turns on the card): unlike f64's, the f32 routines fit the caches.
template <int DMAX, typename T>
constexpr int kRuleUnroll = DMAX <= 16 && !std::is_same_v<T, double> ? DMAX : 1;

// The check outputs of one frame under RULE, in place: x[k] (k < d) holds
// slot k's input on entry and its output on exit.
template <int DMAX, typename T, int RULE>
__device__ __forceinline__ void rule_check(T (&x)[DMAX], int d,
                                           const FloatParams<T>& p) {
  constexpr int U = kRuleUnroll<DMAX, T>;
  if constexpr (RULE == kPhiRule) {
    // the sum of the phis, each output phi(sum - own phi)
    const Signs<DMAX> s(x, d);
    T ph[DMAX];
    T tot = T(0);
#pragma unroll (U)
    for (int k = 0; k < DMAX; ++k) {
      if (k < d) {
        ph[k] = phi(mag(x[k]));
        tot = k == 0 ? ph[0] : add_rn(tot, ph[k]);
      }
    }
#pragma unroll (U)
    for (int k = 0; k < DMAX; ++k)
      if (k < d) x[k] = s.apply(k, phi(sub_rn(tot, ph[k])));
  } else if constexpr (RULE == kTanhRule) {
    // 2 atanh(pre[t] * suf[t]), the exclusive prefix and suffix products
    // of tanh(clamp(x / 2)), clamped to +-prod_max; the empty product is 1
    T tn[DMAX], suf[DMAX];
#pragma unroll (U)
    for (int k = 0; k < DMAX; ++k)
      if (k < d) tn[k] = tanh_half(x[k], p.clamp);
    T acc = T(1);
#pragma unroll (U)
    for (int k = DMAX - 1; k >= 0; --k) {
      if (k < d) {
        suf[k] = acc;  // read only when k < d - 1
        acc = k == d - 1 ? tn[k] : mul_rn(acc, tn[k]);
      }
    }
    T pre = T(1);  // read only when t > 0
#pragma unroll (U)
    for (int t = 0; t < DMAX; ++t) {
      if (t < d) {
        T prod;
        if (t == 0) {
          prod = d == 1 ? T(1) : suf[0];
        } else {
          prod = t == d - 1 ? pre : mul_rn(pre, suf[t]);
        }
        pre = t == 0 ? tn[0] : mul_rn(pre, tn[t]);
        x[t] = atanh2(prod, p.prod_max);
      }
    }
  } else if constexpr (RULE == kMinstarApproxRule) {
    // pre[t]: the left fold of slots 0..t-1; slot t's output continues it
    // over slots t+1..d-1 (slot 0's starts from slot 1); a degree-1 check
    // outputs 0
    static_assert(DMAX <= kMinstarApproxMaxDegree, "MinstarApprox takes degree 32 at most");
    const Signs<DMAX> s(x, d);
    T m[DMAX], pre[DMAX];
#pragma unroll (U)
    for (int k = 0; k < DMAX; ++k)
      if (k < d) m[k] = mag(x[k]);
    T acc = m[0];
#pragma unroll (U)
    for (int t = 1; t < DMAX; ++t) {
      if (t < d - 1) {
        pre[t] = acc;
        acc = minstar_approx(acc, m[t]);
      } else if (t == d - 1) {
        pre[t] = acc;
      }
    }
#pragma unroll (U)
    for (int t = 0; t < DMAX; ++t) {
      if (t < d) {
        T a;
        if (t + 1 < d) {
          a = t == 0 ? m[1] : minstar_approx(pre[t], m[t + 1]);
#pragma unroll (U)
          for (int k = t + 2; k < DMAX; ++k)
            if (k < d) a = minstar_approx(a, m[k]);
        } else {
          a = t == 0 ? T(0) : pre[t];
        }
        x[t] = s.apply(t, a);
      }
    }
  } else {
    // the first minimum's slot gets the min* fold of the other slots, from
    // the first of them; every other slot min*(fold, minimum)
    const Signs<DMAX> s(x, d);
    T m[DMAX];
#pragma unroll (U)
    for (int k = 0; k < DMAX; ++k)
      if (k < d) m[k] = mag(x[k]);
    T m1 = m[0];
    int arg = 0;
#pragma unroll (U)
    for (int k = 1; k < DMAX; ++k) {
      if (k < d && m[k] < m1) {
        m1 = m[k];
        arg = k;
      }
    }
    T acc = T(0);
    bool started = false;
#pragma unroll (U)
    for (int k = 0; k < DMAX; ++k) {
      if (k < d && k != arg) {
        acc = started ? minstar_full(acc, m[k]) : m[k];
        started = true;
      }
    }
    const T others = minstar_full(acc, m1);
#pragma unroll (U)
    for (int t = 0; t < DMAX; ++t)
      if (t < d) x[t] = s.apply(t, t == arg ? acc : others);
  }
}

// The check outputs of a lane's frames under RULE, in place: x[k] (k < d)
// holds slot k's F inputs (a lane's four, Four<T>, or a unit's, Frames<T,
// F>) on entry and its outputs on exit. A rolled loop over the frames (see
// the head of this file).
template <int DMAX, typename T, int RULE, class V>
__device__ __forceinline__ void float_check(V (&x)[DMAX], int d, const FloatParams<T>& p) {
  constexpr int F = sizeof(x[0].v) / sizeof(T);
#pragma unroll 1
  for (int f = 0; f < F; ++f) {
    T v[DMAX];
#pragma unroll
    for (int k = 0; k < DMAX; ++k)
      if (k < d) v[k] = x[k].v[0];
    rule_check<DMAX, T, RULE>(v, d, p);
#pragma unroll
    for (int k = 0; k < DMAX; ++k) {
      if (k < d) {
#pragma unroll
        for (int j = 0; j + 1 < F; ++j) x[k].v[j] = x[k].v[j + 1];
        x[k].v[F - 1] = v[k];
      }
    }
  }
}

// The float rule RULE in T, for csrc/message_kernels.cuh: posteriors,
// messages and deltas in T; x = Qv - Rold, one rounding; the rule's
// parameters from FloatParams; the flooding kernels' unit a lane's four
// frames in f32, one frame in f64, the resident layered kernel's check
// lanes' a frame pair in f32 and a lane's four in f64 (see the head of this
// file).
template <typename T, int RULE>
struct FloatRule : FloatParams<T> {
  using Q = T;
  using Msg = T;
  using P = T;
  using FloodUnits = std::conditional_t<std::is_same_v<T, double>, Units<1, 512>, Units<>>;
  using LayeredUnits = std::conditional_t<std::is_same_v<T, float>, Units<2>, Units<>>;

  __device__ __forceinline__ T extrinsic(T q, T rold) const { return sub_rn(q, rold); }
  __device__ __forceinline__ T diff(T rn, T rold) const { return sub_rn(rn, rold); }

  template <int DMAX>
  struct Check {
    FloatParams<T> p;

    __device__ __forceinline__ explicit Check(const FloatRule& r) : p(r) {}
    // the inputs stay in the lane's (or unit's) array, which the rule
    // folds in place
    template <class V>
    __device__ __forceinline__ void set(int, const V&) {}
    template <class V, class Emit>
    __device__ __forceinline__ void outputs(V (&x)[DMAX], int d, Emit&& emit) {
      float_check<DMAX, T, RULE>(x, d, p);
#pragma unroll
      for (int k = 0; k < DMAX; ++k)
        if (k < d) emit(k, x[k]);
    }
  };

  template <class Cells, int F>
  __device__ __forceinline__ void var_update(const Cells& cells, int8_t* post,
                                             int p0, int p1, int w,
                                             const VarLoads<T, F>& v) const {
    ldpc::var_update(cells, post, p0, p1, w, v);
  }
};

// Calls Launch<DMAX, RULE, T>::run(args...) with the least degree bucket
// (8, 16, 32 or 64; MinstarApprox 8, 16 or 32) that holds max_degree and
// the rule kind.
template <typename T, template <int, int, typename> class Launch,
          typename... Args>
cudaError_t float_by_bucket(int max_degree, int kind, Args&&... args) {
  if (max_degree < 1 || max_degree > kFloatMaxDegree) return cudaErrorInvalidValue;
  if (kind == kMinstarApproxRule && max_degree > kMinstarApproxMaxDegree)
    return cudaErrorInvalidValue;
#define LDPC_FLOAT_BUCKET(D)                                                 \
  if (max_degree <= D) {                                                     \
    switch (kind) {                                                          \
      case kPhiRule:                                                         \
        return Launch<D, kPhiRule, T>::run(args...);                         \
      case kTanhRule:                                                        \
        return Launch<D, kTanhRule, T>::run(args...);                        \
      case kAminstarRule:                                                    \
        return Launch<D, kAminstarRule, T>::run(args...);                    \
      case kMinstarApproxRule:                                               \
        if constexpr (D <= kMinstarApproxMaxDegree)                          \
          return Launch<D, kMinstarApproxRule, T>::run(args...);             \
        return cudaErrorInvalidValue;                                        \
      default:                                                               \
        return cudaErrorInvalidValue;                                        \
    }                                                                        \
  }
  LDPC_FLOAT_BUCKET(8)
  LDPC_FLOAT_BUCKET(16)
  LDPC_FLOAT_BUCKET(32)
  LDPC_FLOAT_BUCKET(64)
#undef LDPC_FLOAT_BUCKET
  return cudaErrorInvalidValue;
}

template <int DMAX, int RULE, typename T>
struct FloatLayeredLaunch {
  static cudaError_t run(void* qv, void* rcv, void* bits, void* iters,
                         void* conv, void* park, const Tables& t, int nbt,
                         size_t park_elems, int max_iterations, int threads,
                         const FloatParams<T>& p, cudaStream_t stream) {
    return layered_launch<DMAX>(FloatRule<T, RULE>{p}, qv, rcv, bits, iters,
                                conv, park, t, nbt, park_elems, max_iterations,
                                threads, stream);
  }
};

template <int DMAX, int RULE, typename T>
struct FloatFloodingLaunch {
  static cudaError_t run(void* msg, const void* q, void* post, void* bits,
                         void* iters, void* conv, const Tables& t, int nbt,
                         int max_iterations, int threads,
                         const FloatParams<T>& p, cudaStream_t stream) {
    return flooding_launch<DMAX>(FloatRule<T, RULE>{p}, msg, q, post, bits,
                                 iters, conv, t, nbt, max_iterations, threads,
                                 stream);
  }
};

// The C entry points' bodies for one precision (see
// csrc/resident_layered_f32.cu and csrc/flooding_f32.cu for the arguments).
template <typename T>
int resident_layered_float_decode(void* qv, void* rcv, void* bits, void* iters,
                                  void* conv, void* park,
                                  const void* const* tables, int nbt, int CG,
                                  int E, int VG, int Z, int Bt, int max_degree,
                                  int max_iterations, int threads, int kind,
                                  double big, double clamp, double prod_max,
                                  void* stream) {
  if (Bt != kBt) return cudaErrorInvalidValue;
  const Tables t = make_tables(tables, CG, E, VG, Z);
  const size_t park_elems = (size_t)max_degree * Z * kBt;
  const FloatParams<T> p{static_cast<T>(big), static_cast<T>(clamp),
                         static_cast<T>(prod_max)};
  return static_cast<int>(float_by_bucket<T, FloatLayeredLaunch>(
      max_degree, kind, qv, rcv, bits, iters, conv, park, t, nbt, park_elems,
      max_iterations, threads, p, static_cast<cudaStream_t>(stream)));
}

template <typename T>
int resident_flooding_float_decode(void* msg, const void* q, void* post,
                                   void* bits, void* iters, void* conv,
                                   const void* const* tables, int nbt, int CG,
                                   int E, int VG, int Z, int Bt, int max_degree,
                                   int max_iterations, int threads, int kind,
                                   double big, double clamp, double prod_max,
                                   void* stream) {
  if (Bt != kBt) return cudaErrorInvalidValue;
  const Tables t = make_tables(tables, CG, E, VG, Z);
  const FloatParams<T> p{static_cast<T>(big), static_cast<T>(clamp),
                         static_cast<T>(prod_max)};
  return static_cast<int>(float_by_bucket<T, FloatFloodingLaunch>(
      max_degree, kind, msg, q, post, bits, iters, conv, t, nbt, max_iterations,
      threads, p, static_cast<cudaStream_t>(stream)));
}

template <int DMAX, int RULE, typename T>
struct FloatCheckLaunch {
  static cudaError_t run(const void* v2c, void* c2v, const FloodingTables& t,
                         int nbt, int threads, const FloatParams<T>& p,
                         cudaStream_t stream) {
    return fused_check_launch<DMAX>(FloatRule<T, RULE>{p}, v2c, c2v, t, nbt,
                                    threads, stream);
  }
};

template <int DMAX, int RULE, typename T>
struct FloatSweepLaunch {
  static cudaError_t run(void* qv, void* rcv, void* bits, void* park,
                         const Tables& t, int nbt, size_t park_elems,
                         int threads, const FloatParams<T>& p,
                         cudaStream_t stream) {
    return fused_layered_launch<DMAX>(FloatRule<T, RULE>{p}, qv, rcv, bits,
                                      park, t, nbt, park_elems, threads, stream);
  }
};

// The streaming entry points' bodies for one precision (see
// csrc/flooding_f32.cu and csrc/fused_layered_f32.cu for the arguments).
template <typename T>
int fused_check_float(const void* v2c, void* c2v, const void* const* tables,
                      int nbt, int CG, int VG, int E, int Z, int Bt,
                      int max_degree, int threads, int kind, double big,
                      double clamp, double prod_max, void* stream) {
  const FloodingTables t = make_flooding_tables(tables, CG, VG, E, Z, Bt);
  const FloatParams<T> p{static_cast<T>(big), static_cast<T>(clamp),
                         static_cast<T>(prod_max)};
  return static_cast<int>(float_by_bucket<T, FloatCheckLaunch>(
      max_degree, kind, v2c, c2v, t, nbt, threads, p,
      static_cast<cudaStream_t>(stream)));
}

// The variable phase takes no degree bucket: one instance a rule.
template <typename T>
int fused_var_float(const void* c2v, const void* q, void* v2c, void* bits,
                    const void* const* tables, int nbt, int CG, int VG, int E,
                    int Z, int Bt, int threads, int kind, double big,
                    double clamp, double prod_max, void* stream) {
  const FloodingTables t = make_flooding_tables(tables, CG, VG, E, Z, Bt);
  const FloatParams<T> p{static_cast<T>(big), static_cast<T>(clamp),
                         static_cast<T>(prod_max)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (kind) {
    case kPhiRule:
      err = fused_var_launch(FloatRule<T, kPhiRule>{p}, c2v, q, v2c, bits, t, nbt, threads, s);
      break;
    case kTanhRule:
      err = fused_var_launch(FloatRule<T, kTanhRule>{p}, c2v, q, v2c, bits, t, nbt, threads, s);
      break;
    case kMinstarApproxRule:
      err = fused_var_launch(FloatRule<T, kMinstarApproxRule>{p}, c2v, q, v2c, bits, t, nbt,
                             threads, s);
      break;
    case kAminstarRule:
      err = fused_var_launch(FloatRule<T, kAminstarRule>{p}, c2v, q, v2c, bits, t, nbt,
                             threads, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

template <typename T>
int fused_layered_float_iteration(void* qv, void* rcv, void* bits, void* park,
                                  const void* const* tables, int nbt, int CG,
                                  int E, int VG, int Z, int Bt, int max_degree,
                                  int threads, int kind, double big,
                                  double clamp, double prod_max, void* stream) {
  if (Bt != kBt) return cudaErrorInvalidValue;
  const Tables t = make_tables(tables, CG, E, VG, Z);
  const size_t park_elems = (size_t)max_degree * Z * kBt;
  const FloatParams<T> p{static_cast<T>(big), static_cast<T>(clamp),
                         static_cast<T>(prod_max)};
  return static_cast<int>(float_by_bucket<T, FloatSweepLaunch>(
      max_degree, kind, qv, rcv, bits, park, t, nbt, park_elems, threads, p,
      static_cast<cudaStream_t>(stream)));
}

}  // namespace ldpc
