// The two resident decode kernels that hold the check state as messages,
// templated on the check rule, on the thread-per-lane machinery of
// csrc/lanes.cuh:
// - resident_layered_kernel: the whole horizontal-layered decode of a tile
//   in one launch (replaces ldpc_toolbox_tpu/ops/resident_layered.py
//   resident_layered_decode);
// - resident_flooding_kernel: the whole flooding decode of a tile in one
//   launch, one message array in check-major cells (replaces
//   ldpc_toolbox_tpu/ops/resident_flooding_dual.py
//   resident_flooding_dual_decode and resident_flooding.py
//   resident_flooding_decode).
// The Pallas kernels inline whatever rule ops/fused_bp2.py rule_for gives
// them; here a rule is a policy type, and each source instantiates the
// kernels on its rules: csrc/resident_layered.cu the layered kernel on
// MinSumRule below (f32 and bf16 messages), csrc/resident_layered_i8.cu and
// csrc/flooding_i8.cu both kernels on I8Rule (csrc/i8.cuh), and the
// *_f32.cu and *_f64.cu sources both on FloatRule (csrc/float_rules.cuh).
// So the loads, the missing lane, the deltas, the park and the stores are
// written once. The min-sum rule's resident flooding decode is a kernel of
// its own, flooding_ring_kernel (csrc/flooding_ring.cuh, built by
// csrc/flooding.cu), which feeds the same arithmetic through a ring of bulk
// copies; resident_flooding_kernel has no MinSumRule instance.
//
// A rule gives:
// - Q, Msg, P: the types of the layered posteriors, of the messages (and
//   of the flooding channel values) and of the layered park's deltas;
// - big, the missing lane's input, and extrinsic(q, rold) and diff(rn,
//   rold), one frame's layered x = Qv - Rold and delta Rnew - Rold;
// - Check<DMAX, U>, made from the rule, over the array x of the d slots'
//   inputs of a unit U (a lane's four frames or U's; the float rules'
//   loops roll by U's registers): set(k, x[k]) as slot k's input is
//   ready (k = 0, 1, ... in order; min-sum and i8 fold it at once), then
//   outputs(x, d, emit) calls emit(k, o) with slot k's four outputs for
//   k = 0 .. d - 1 in order (the float rules fold x there, in place);
// - var_update(cells, post, p0, p1, w, loads), the flooding variable update
//   of a unit of variable lane w, whose edges are p0..p1 (lanes.cuh
//   var_update for the float messages), reading its c2v and writing its v2c
//   through cells (lanes.cuh ArrayCells for the resident kernel,
//   csrc/streaming.cuh PhaseCells for the streaming variable phase);
// - or, for a word rule (kWords true: I8Rule), Check<DMAX> over words: a
//   lane's four int8 inputs as one word, set(k, word) for k = 0, 1, ...
//   in order, then outputs(d, emit) calls emit(k, word) with slot k's four
//   outputs as one word; bigs is the missing lane's input word;
// - FloodUnits, VarUnits, LayeredUnits and SweepUnits, the work unit and
//   block of the flooding kernels' check lanes, of their variable lanes, of
//   the resident layered kernel's check lanes and of the streaming sweep's
//   (csrc/streaming.cuh; lanes.cuh Units): a lane's four frames at kThreads
//   but for the float rules' flooding units (f64 and f32: their check
//   lanes; f64: their variable lanes too), the float rules' layered and
//   the f64 ones' sweep units and the i8 rules' flooding and layered
//   blocks; a Check then folds a unit's frames (outputs(x, d, emit) over
//   the unit's values).
//
// Semantics, every rule (the JAX package's jnp paths and Pallas kernels):
// layered: every x of a check group from the layer-entry Qv, big at the
// missing lane; Rnew from the rule, 0 at the missing lane, stored (rounded
// to the storage type); Qv += Rnew - Rold in edge order, with the
// unrounded Rnew and the Rold as loaded. Flooding: v2c starts as the
// channel value q at every edge; the check lane folds its d v2c (big at the
// missing lane) and writes each c2v (0 at the missing lane) to the same
// cell; the variable lane writes the hard decisions and the v2c.
//
// Design: see csrc/resident_layered.cu and csrc/flooding.cu.

#pragma once

#include <type_traits>

#include "lanes.cuh"

namespace ldpc {

// The min-sum rule (normalized by scale when it is not 1) with f32 or
// bf16 messages and f32 layered posteriors.
template <typename MsgT>
struct MinSumRule {
  using Q = float;
  using Msg = MsgT;
  using P = float;
  using FloodUnits = Units<>;
  using VarUnits = Units<>;
  using LayeredUnits = Units<>;
  using SweepUnits = Units<>;
  float big, scale;

  __device__ __forceinline__ float extrinsic(float q, float rold) const {
    return __fsub_rn(q, rold);
  }
  __device__ __forceinline__ float diff(float rn, float rold) const {
    return __fsub_rn(rn, rold);
  }

  template <int DMAX, class U = Units<>>
  struct Check {
    Fold<DMAX> fold;
    float scale;

    __device__ __forceinline__ explicit Check(const MinSumRule& r) : scale(r.scale) {
#pragma unroll
      for (int f = 0; f < kBt; ++f) fold.m2[f] = r.big;
    }
    __device__ __forceinline__ void set(int k, const F4& x) {
#pragma unroll
      for (int f = 0; f < kBt; ++f) fold.add(k, f, x.v[f]);
    }
    template <class Emit>
    __device__ __forceinline__ void outputs(const F4 (&)[DMAX], int d, Emit&& emit) {
      fold.scale_by(scale);
#pragma unroll
      for (int k = 0; k < DMAX; ++k) {
        if (k < d) {
          F4 o;
#pragma unroll
          for (int f = 0; f < kBt; ++f) o.v[f] = fold.out(k, f);
          emit(k, o);
        }
      }
    }
  };

  template <class Cells>
  __device__ __forceinline__ void var_update(const Cells& cells, int8_t* post,
                                             int p0, int p1, int w,
                                             const VarLoads<Msg>& v) const {
    ldpc::var_update(cells, post, p0, p1, w, v);
  }
};

// Whether a rule is a word rule (see above: Rule::kWords).
template <class Rule, class = void>
struct WordRule : std::false_type {};
template <class Rule>
struct WordRule<Rule, std::void_t<decltype(Rule::kWords)>>
    : std::bool_constant<Rule::kWords> {};

// What a layered check lane gathers of Qv: f32 and f64 as their four
// values, int16 as loaded, widened when used (in turns on the flagship,
// tools/compare_forms.py, the faster forms of each type).
__device__ __forceinline__ F4 gather(const float* p) { return load4(p); }
__device__ __forceinline__ D4 gather(const double* p) { return load4(p); }
__device__ __forceinline__ I16x4 gather(const int16_t* p) { return load_raw(p); }

// The array a check lane computes its slots' inputs in: the gathered one
// itself where it already holds four values (f32 and f64 Qv, f64
// messages), else a second one. In turns on the flagship
// (tools/compare_forms.py), the float rules' layered instances ran 10-13 %
// slower with a second array, and the other forms were as fast either way.
template <typename G, typename V, int N>
__device__ __forceinline__ auto& input_array(G (&gathered)[N], V (&own)[N]) {
  if constexpr (std::is_same_v<G, V>) {
    return gathered;
  } else {
    return own;
  }
}

// A lane's four values of type T, and T itself.
template <typename T>
using Vec4 = decltype(load4(static_cast<const T*>(nullptr)));
template <typename T>
using Elem = std::decay_t<decltype(Vec4<T>{}.v[0])>;

// What a layered check unit of F frames gathers of Qv: a lane's four as
// gather gives them, or the unit's frames.
template <int F, typename T>
__device__ __forceinline__ auto gather_unit(const T* p) {
  if constexpr (F == kBt) {
    return gather(p);
  } else {
    return load_unit<F>(p);
  }
}

// layered_check_lane under a word rule, for a lane's four frames of check
// lane c, whose d edges are e0..e0+d: each x computed per frame as the
// rule's extrinsic, the four as one word for the rule's Check; each output
// word (0 at the missing lane) stored as it is, its deltas per frame.
template <int DMAX, class Rule>
__device__ __forceinline__ void layered_check_words(
    typename Rule::Q* qv, typename Rule::Msg* rcv, typename Rule::P* park,
    const LaneTables& t, int c, int e0, int d, bool parked, const Rule& rule) {
  using Q = typename Rule::Q;
  const int Z = t.Z;
  decltype(gather(qv)) q[DMAX];
  uint32_t r[DMAX];
#pragma unroll
  for (int k = 0; k < DMAX; ++k) {
    if (k < d) {
      const int e = e0 + k;
      q[k] = gather(qv + ((size_t)t.qbase[e] + minus_mod(c, t.syn_rot[e], Z)) * kBt);
      r[k] = load_word(rcv + ((size_t)e * Z + c) * kBt);
    }
  }
  typename Rule::template Check<DMAX> check(rule);
#pragma unroll
  for (int k = 0; k < DMAX; ++k) {
    if (k < d) {
      const I4 qk = unpack(q[k]), rold = unpack(r[k]);
      I4 x;
#pragma unroll
      for (int f = 0; f < kBt; ++f) x.v[f] = rule.extrinsic(qk.v[f], rold.v[f]);
      check.set(k, c == t.syn_mask[e0 + k] ? Rule::bigs : pack_bytes(x));
    }
  }
  check.outputs(d, [&](int k, uint32_t o) {
    const int e = e0 + k;
    const uint32_t rn = c == t.syn_mask[e] ? 0u : o;
    const I4 rnv = unpack(rn), rold = unpack(r[k]);
    I4 delta;
#pragma unroll
    for (int f = 0; f < kBt; ++f) delta.v[f] = rule.diff(rnv.v[f], rold.v[f]);
    store_word(rcv + ((size_t)e * Z + c) * kBt, rn);
    if (parked) {
      store4(park + ((size_t)k * Z + c) * kBt, delta);
    } else {
      Q* cell = qv + ((size_t)t.qbase[e] + minus_mod(c, t.syn_rot[e], Z)) * kBt;
      I4 qc = load4(cell);
      add4(qc, delta);
      store4(cell, qc);
    }
  });
}

// Check update of a unit of check lane c of group g in one layered tile
// (U: F frames, a lane's four or a frame pair; qv, rcv and park those
// of the unit's first frame): every x from the layer-entry
// Qv (big at the missing lane), Rnew in place (0 at the missing lane), and
// the deltas Rnew - Rold either added to Qv (parked false; no other lane
// touches those cells in this group) or parked at park[(k * Z + c) * 4].
// The edge loops are unrolled to the degree bucket, so a check's d Qv
// gathers and d Rcv loads go out before its rule; Rold stays in registers
// as loaded (bf16 packed) through its outputs. PARTS (lanes.cuh
// SweepParts, the whole sweep in every decode) takes a part away for the
// probe of csrc/probe_layered.cu.
template <int DMAX, class U, int PARTS = kSweepWhole, class Rule>
__device__ __forceinline__ void layered_check_lane(
    typename Rule::Q* qv, typename Rule::Msg* rcv, typename Rule::P* park,
    const LaneTables& t, int g, int c, bool parked, const Rule& rule) {
  using Q = typename Rule::Q;
  constexpr int F = U::kFrames;
  using V = std::conditional_t<F == kBt, Vec4<Q>, Frames<Q, F>>;
  const int Z = t.Z;
  const int e0 = t.chk_cs[g], d = t.chk_cs[g + 1] - e0;
  // the variable lane that check lane c of edge e reads and updates
  const auto var_lane = [&](int e) {
    return PARTS == kSweepNoRoll ? c : minus_mod(c, t.syn_rot[e], Z);
  };
  if constexpr (WordRule<Rule>::value) {
    static_assert(PARTS == kSweepWhole, "the word rules run the whole sweep");
    layered_check_words<DMAX>(qv, rcv, park, t, c, e0, d, parked, rule);
  } else {
    decltype(gather_unit<F>(qv)) q[DMAX];
    UnitRaw<typename Rule::Msg, F> r[DMAX];
#pragma unroll
    for (int k = 0; k < DMAX; ++k) {
      if (k < d) {
        const int e = e0 + k;
        q[k] = gather_unit<F>(qv + ((size_t)t.qbase[e] + var_lane(e)) * kBt);
        r[k] = load_unit<F>(rcv + ((size_t)e * Z + c) * kBt);
      }
    }
    typename Rule::template Check<DMAX, U> check(rule);
    V own[DMAX];
    auto& x = input_array(q, own);
#pragma unroll
    for (int k = 0; k < DMAX; ++k) {
      if (k < d) {
        const bool missing = c == t.syn_mask[e0 + k];
        const V qk = unpack(q[k]), rold = unpack(r[k]);
#pragma unroll
        for (int f = 0; f < F; ++f)
          x[k].v[f] = missing ? rule.big : rule.extrinsic(qk.v[f], rold.v[f]);
        if constexpr (PARTS != kSweepNoRule) check.set(k, x[k]);
      }
    }
    const auto emit = [&](int k, const V& o) {
      const int e = e0 + k;
      const bool missing = c == t.syn_mask[e];
      const V rold = unpack(r[k]);
      V rn, delta;
#pragma unroll
      for (int f = 0; f < F; ++f) {
        rn.v[f] = missing ? Elem<Q>(0) : o.v[f];
        delta.v[f] = rule.diff(rn.v[f], rold.v[f]);
      }
      store_unit(rcv + ((size_t)e * Z + c) * kBt, rn);
      if constexpr (PARTS != kSweepNoQvWrite) {
        if (parked) {
          store_unit(park + ((size_t)k * Z + c) * kBt, delta);
        } else {
          Q* cell = qv + ((size_t)t.qbase[e] + var_lane(e)) * kBt;
          V qc = unpack(load_unit<F>(cell));
          add4(qc, delta);
          store_unit(cell, qc);
        }
      }
    };
    if constexpr (PARTS == kSweepNoRule) {
#pragma unroll
      for (int k = 0; k < DMAX; ++k)
        if (k < d) emit(k, x[k]);
    } else {
      check.outputs(x, d, emit);
    }
  }
}

// The whole layered decode of one tile per block under a rule: qv (VG, Z,
// 4) the working posteriors (the channel values on entry), rcv (E, Z, 4)
// the messages (zero on entry), bits the raw-channel bits on entry and the
// decoded bits on exit; park_all the device park, or null to park in
// shared memory after the tables. The check lanes give a thread a unit of
// Rule::LayeredUnits (lanes.cuh Units).
template <int DMAX, class Rule>
__global__ void __launch_bounds__(Rule::LayeredUnits::kBlock, 2) resident_layered_kernel(
    typename Rule::Q* qv_all, typename Rule::Msg* rcv_all, int8_t* bits_all,
    int* iters_out, int* conv_out, typename Rule::P* park_all, Tables t,
    size_t park_elems, int max_iterations, Rule rule) {
  extern __shared__ __align__(16) int smem[];
  const size_t tile = blockIdx.x;
  const size_t lanes = (size_t)t.VG * t.Z;
  const LaneTables lt = load_tables(t, smem + kCtlInts);
  auto* park = lane_park(park_all, park_elems, smem, t);
  auto* qv = qv_all + tile * lanes * kBt;
  auto* rcv = rcv_all + tile * t.E * t.Z * kBt;
  int8_t* bits = bits_all + tile * lanes * kBt;
  decode_tile4<DMAX>(qv, bits, iters_out, conv_out, lt, max_iterations, smem,
                     [&](int, int* bad) {
                       using U = typename Rule::LayeredUnits;
                       layered_sweep4<DMAX, U>(
                           qv, park, lt, [&](int g, int c, int f0, bool parked) {
                             layered_check_lane<DMAX, U>(qv + f0, rcv + f0, park + f0, lt,
                                                         g, c, parked, rule);
                           });
                       syndrome4<DMAX>(qv, lt, bad);
                     });
}

// Launches resident_layered_kernel<DMAX, Rule> on nbt tiles (see the C
// entry points of csrc/resident_layered.cu for the arguments), at most
// Rule::LayeredUnits::kBlock threads a block.
template <int DMAX, class Rule>
cudaError_t layered_launch(const Rule& rule, void* qv, void* rcv, void* bits,
                           void* iters, void* conv, void* park, const Tables& t,
                           int nbt, size_t park_elems, int max_iterations,
                           int threads, cudaStream_t stream) {
  using P = typename Rule::P;
  if (threads > Rule::LayeredUnits::kBlock) return cudaErrorInvalidValue;
  return launch(resident_layered_kernel<DMAX, Rule>, nbt, threads,
                smem_bytes(t, park ? 0 : park_elems, sizeof(P)), stream,
                static_cast<typename Rule::Q*>(qv),
                static_cast<typename Rule::Msg*>(rcv), static_cast<int8_t*>(bits),
                static_cast<int*>(iters), static_cast<int*>(conv),
                static_cast<P*>(park), t, park_elems, max_iterations, rule);
}

// Check update of a unit of check lane c of a flooding check group whose d
// edges are e0..e0+d (Rule::FloodUnits: F frames from v2c's first, a
// lane's four, an f32 frame pair or one f64 frame): folds its d v2c, read
// from its cells (e, c) of v2c (check-major, check lane coordinates; big
// at the missing lane syn_mask[e], whatever the cell holds), and calls
// out(e, o) with each edge's F c2v, 0 at the missing lane. The resident
// kernel writes them back to the same cells, the streaming check phase
// (csrc/streaming.cuh) to the var-major c2v planes.
template <int DMAX, class Rule, class Out>
__device__ __forceinline__ void flooding_check(const typename Rule::Msg* v2c,
                                               const int* syn_mask, int Z,
                                               int e0, int d, int c,
                                               const Rule& rule, Out&& out) {
  using Msg = typename Rule::Msg;
  constexpr int F = Rule::FloodUnits::kFrames;
  using V = decltype(unpack(load_unit<F>(v2c)));
  if constexpr (WordRule<Rule>::value) {
    // a lane's four inputs and outputs as words (bigs and 0 at the missing
    // lane)
    uint32_t x[DMAX];
#pragma unroll
    for (int k = 0; k < DMAX; ++k)
      if (k < d) x[k] = load_word(v2c + ((size_t)(e0 + k) * Z + c) * kBt);
    typename Rule::template Check<DMAX> check(rule);
#pragma unroll
    for (int k = 0; k < DMAX; ++k)
      if (k < d) check.set(k, c == syn_mask[e0 + k] ? Rule::bigs : x[k]);
    check.outputs(d, [&](int k, uint32_t o) {
      const int e = e0 + k;
      out(e, c == syn_mask[e] ? 0u : o);
    });
  } else {
    UnitRaw<Msg, F> raw[DMAX];
#pragma unroll
    for (int k = 0; k < DMAX; ++k)
      if (k < d) raw[k] = load_unit<F>(v2c + ((size_t)(e0 + k) * Z + c) * kBt);
    typename Rule::template Check<DMAX, typename Rule::FloodUnits> check(rule);
    V own[DMAX];
    auto& x = input_array(raw, own);
#pragma unroll
    for (int k = 0; k < DMAX; ++k) {
      if (k < d) {
        const bool missing = c == syn_mask[e0 + k];
        const V v = unpack(raw[k]);
#pragma unroll
        for (int f = 0; f < F; ++f) x[k].v[f] = missing ? rule.big : v.v[f];
        check.set(k, x[k]);
      }
    }
    check.outputs(x, d, [&](int k, const V& o) {
      const int e = e0 + k;
      const bool missing = c == syn_mask[e];
      V ok;
#pragma unroll
      for (int f = 0; f < F; ++f) ok.v[f] = missing ? Elem<Msg>(0) : o.v[f];
      out(e, ok);
    });
  }
}

// Check update of a unit of check lane c of group g in one resident
// flooding tile (msg that of the unit's first frame): its d c2v go back to
// the cells (e, c) its v2c came from.
template <int DMAX, class Rule>
__device__ __forceinline__ void flooding_check_lane(typename Rule::Msg* msg,
                                                    const LaneTables& t, int g,
                                                    int c, const Rule& rule) {
  const int Z = t.Z;
  const int e0 = t.chk_cs[g], d = t.chk_cs[g + 1] - e0;
  flooding_check<DMAX>(msg, t.syn_mask, Z, e0, d, c, rule, [&](int e, const auto& o) {
    store_unit(msg + ((size_t)e * Z + c) * kBt, o);
  });
}

// The whole flooding decode of one tile per block under a rule. msg (E, Z,
// 4) holds each edge's message in check-major cells, in check lane
// coordinates: v2c after a variable phase, c2v after a check phase (the
// aliased single array of resident_flooding.py's TPU kernel); q (VG, Z, 4)
// the channel values; post (VG, Z, 4) int8 the posterior hard decisions;
// bits the raw-channel bits on entry and the decoded bits on exit. The
// check phase gives a thread a unit of Rule::FloodUnits, the variable
// phase one of Rule::VarUnits, at the FloodUnits' block (lanes.cuh Units).
template <int DMAX, class Rule>
__global__ void __launch_bounds__(Rule::FloodUnits::kBlock, 2) resident_flooding_kernel(
    typename Rule::Msg* msg_all, const typename Rule::Msg* q_all,
    int8_t* post_all, int8_t* bits_all, int* iters_out, int* conv_out,
    Tables t, int max_iterations, Rule rule) {
  using Msg = typename Rule::Msg;
  using U = typename Rule::FloodUnits;
  extern __shared__ __align__(16) int smem[];
  const size_t tile = blockIdx.x;
  const int Z = t.Z, cn = t.CG * Z, vn = t.VG * Z;
  const LaneTables lt = load_tables(t, smem + kCtlInts);
  Msg* msg = msg_all + tile * t.E * Z * kBt;
  const Msg* q = q_all + tile * vn * kBt;
  int8_t* post = post_all + tile * vn * kBt;
  int8_t* bits = bits_all + tile * vn * kBt;
  // v2c = q at every edge
  for (int r = threadIdx.x; r < vn; r += blockDim.x) {
    const int vg = r / Z, w = r % Z;
    const auto qr = load4(q + (size_t)r * kBt);
    for (int p = lt.var_cs[vg]; p < lt.var_cs[vg + 1]; ++p)
      store4(var_cell(msg, lt, p, w), qr);
  }
  // each iteration: the check phase, the variable phase, then the
  // syndrome of the hard decisions the variable phase wrote
  decode_tile4<DMAX>(
      post, bits, iters_out, conv_out, lt, max_iterations, smem,
      [&](int, int* bad) {
        for (int r = threadIdx.x; r < cn * U::kPerLane; r += blockDim.x) {
          const int lane = r / U::kPerLane;
          flooding_check_lane<DMAX>(msg + r % U::kPerLane * U::kFrames, lt, lane / Z,
                                    lane % Z, rule);
        }
        __syncthreads();
        const ArrayCells<Msg> cells{msg, lt};
        var_phase<Rule::VarUnits::kFrames, U::kBlock>(
            cells, q, lt.var_cs, vn, Z, threadIdx.x, blockDim.x,
            [&](int vg, int w, int f0, const auto& v) {
              rule.var_update(cells.at(f0), post + ((size_t)vg * Z + w) * kBt + f0,
                              lt.var_cs[vg], lt.var_cs[vg + 1], w, v);
            });
        __syncthreads();
        syndrome4<DMAX>(post, lt, bad);
      });
}

// Launches resident_flooding_kernel<DMAX, Rule> on nbt tiles (see the C
// entry points of csrc/flooding.cu for the arguments).
template <int DMAX, class Rule>
cudaError_t flooding_launch(const Rule& rule, void* msg, const void* q,
                            void* post, void* bits, void* iters, void* conv,
                            const Tables& t, int nbt, int max_iterations,
                            int threads, cudaStream_t stream) {
  using Msg = typename Rule::Msg;
  if (threads > Rule::FloodUnits::kBlock) return cudaErrorInvalidValue;
  return launch(resident_flooding_kernel<DMAX, Rule>, nbt, threads,
                smem_bytes(t, 0), stream, static_cast<Msg*>(msg),
                static_cast<const Msg*>(q), static_cast<int8_t*>(post),
                static_cast<int8_t*>(bits), static_cast<int*>(iters),
                static_cast<int*>(conv), t, max_iterations, rule);
}

}  // namespace ldpc
