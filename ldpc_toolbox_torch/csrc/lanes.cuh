// Device code shared by the kernels that give a thread one lane of a
// tile's four frames (csrc/compressed.cu's, the resident message kernels of
// csrc/message_kernels.cuh and the streaming kernels of csrc/streaming.cuh):
// the four-frame vectors and words, the layout tables in shared memory, the
// min-sum fold, the layered sweep with its park, the flooding variable
// phase, the syndrome, the whole-decode loop and the launch by check-degree
// bucket.
//
// A tile is kBt = 4 frames, frames innermost: planes are (P, Z, 4), and a
// thread handles all four frames of a lane, so a lane's f32 values move as
// one 16-byte vector, its bf16 values as one 8-byte vector and its int8
// values (signs, argmin slots, hard bits) as one 4-byte word; each table
// load and each mod-Z index is done once a lane, not once a frame. Edge
// loops run to a compile-time bound DMAX (the degree bucket: 8, 16, 32 or
// 64), so a check's loads are all issued before its arithmetic starts.
//
// Bit-exactness: every f32 operation stays per frame and is the one of the
// plain versions, with __fadd_rn, __fsub_rn and __fmul_rn (no FMA
// contraction; add_rn, sub_rn and mul_rn below pick them, or the f64 ones,
// by type); bf16 unpacks by shifts (exact) and packs through
// __float2bfloat16_rn (round to nearest even). The int8 instances
// (csrc/i8.cuh) keep layered posteriors as int16, four frames in one
// 8-byte vector, and park int32 deltas; their sums wrap as int16 sums do.
// The f64 instances of the float rules (csrc/float_rules.cuh) move a
// lane's four doubles as two 16-byte vectors (32 bytes; a thread loads at
// most 16 at once) and park f64 deltas.
//
// A rule may give a thread less than a lane's four frames (Units): the f64
// float rules in the flooding kernels, the f32 float rules in the resident
// layered kernel. The layered sweep then walks (lane, unit) pairs of a check group
// with a lane's units on neighbouring threads, each unit loading and
// storing its frames of the lane's cells; the park update, the syndrome and
// the hard decisions keep a thread per lane.

#pragma once

#include <type_traits>

#include "layered.cuh"

namespace ldpc {

// Frames a tile, and threads a block: two blocks an SM (a flagship batch
// of 256 tiles is resident at once) at up to 128 registers a thread; at
// 384 threads (80 registers) the compressed kernels spilled and ran slower.
constexpr int kBt = 4;
constexpr int kThreads = 256;

// Four frames of one lane.
template <typename T>
struct Four {
  T v[kBt];
};
using F4 = Four<float>;
using D4 = Four<double>;

// How a kernel gives its threads work under a rule: the flooding kernels
// (csrc/message_kernels.cuh resident_flooding_kernel, csrc/streaming.cuh
// fused_check_kernel and fused_var_kernel) by the rule's FloodUnits, the
// resident layered kernel's check lanes (layered_sweep4 in
// resident_layered_kernel) by its LayeredUnits: a thread per unit of F of a
// lane's four frames, kPerLane units a lane, the units of a lane on
// neighbouring threads (frames innermost, so they read its cells
// together), Threads threads a block and two blocks an SM (the launch
// bounds: 65536 / (2 * Threads) registers a thread). Every rule takes a
// lane's four frames at kThreads (128 registers) but the f64 float rules'
// flooding units and the f32 float rules' layered units (csrc/float_rules.cuh);
// the streaming sweep gives every rule a lane's four frames.
template <int F = kBt, int Threads = kThreads>
struct Units {
  static_assert(kBt % F == 0, "a unit is a whole share of a lane's frames");
  static constexpr int kFrames = F, kPerLane = kBt / F, kBlock = Threads;
};

// F < kBt frames of one lane: a unit's values.
template <typename T, int F>
struct Frames {
  T v[F];
};

// One IEEE operation, rounded to nearest, never contracted into an FMA.
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

// A lane's four values as loaded, before they are unpacked: bf16 stays
// packed in two registers until its values are used.
__device__ __forceinline__ float4 load_raw(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ uint2 load_raw(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint2*>(p);
}
// The four int8 of one lane (sigma, argm, bits, i8 messages) as one word.
__device__ __forceinline__ uint32_t load_word(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ uint32_t load_raw(const int8_t* p) { return load_word(p); }
// four doubles as two 16-byte loads
__device__ __forceinline__ D4 load_raw(const double* p) {
  const double2 a = reinterpret_cast<const double2*>(p)[0];
  const double2 b = reinterpret_cast<const double2*>(p)[1];
  return D4{{a.x, a.y, b.x, b.y}};
}
// four int16 (8 bytes)
struct I16x4 {
  uint2 u;
};
__device__ __forceinline__ I16x4 load_raw(const int16_t* p) {
  return I16x4{*reinterpret_cast<const uint2*>(p)};
}
template <typename Msg>
using Raw = decltype(load_raw(static_cast<const Msg*>(nullptr)));

// Four frames of one lane as ints: int8 messages and int16 posteriors
// widened, int32 deltas.
struct I4 {
  int v[kBt];
};
__device__ __forceinline__ int byte_of(uint32_t w, int f) {
  return static_cast<int8_t>(w >> (8 * f));
}
__device__ __forceinline__ uint32_t byte_at(int v, int f) {
  return static_cast<uint32_t>(static_cast<uint8_t>(v)) << (8 * f);
}

__device__ __forceinline__ F4 unpack(float4 a) { return F4{{a.x, a.y, a.z, a.w}}; }
__device__ __forceinline__ F4 unpack(uint2 u) {
  return F4{{__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
             __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u)}};
}
template <typename T>
__device__ __forceinline__ Four<T> unpack(const Four<T>& a) {
  return a;
}
template <typename T, int F>
__device__ __forceinline__ Frames<T, F> unpack(const Frames<T, F>& a) {
  return a;
}
__device__ __forceinline__ I4 unpack(uint32_t w) {
  return I4{{byte_of(w, 0), byte_of(w, 1), byte_of(w, 2), byte_of(w, 3)}};
}
__device__ __forceinline__ I4 unpack(I16x4 a) {
  return I4{{static_cast<int16_t>(a.u.x), static_cast<int16_t>(a.u.x >> 16),
             static_cast<int16_t>(a.u.y), static_cast<int16_t>(a.u.y >> 16)}};
}
template <typename Msg>
__device__ __forceinline__ auto load4(const Msg* p) -> decltype(unpack(load_raw(p))) {
  return unpack(load_raw(p));
}
__device__ __forceinline__ void store4(float* p, const F4& a) {
  *reinterpret_cast<float4*>(p) = make_float4(a.v[0], a.v[1], a.v[2], a.v[3]);
}
__device__ __forceinline__ void store4(double* p, const D4& a) {
  reinterpret_cast<double2*>(p)[0] = make_double2(a.v[0], a.v[1]);
  reinterpret_cast<double2*>(p)[1] = make_double2(a.v[2], a.v[3]);
}
__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const F4& a) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(bf16_bits(a.v[0]) | bf16_bits(a.v[1]) << 16,
                 bf16_bits(a.v[2]) | bf16_bits(a.v[3]) << 16);
}
__device__ __forceinline__ void store_word(int8_t* p, uint32_t w) {
  *reinterpret_cast<uint32_t*>(p) = w;
}
// four int8 (each value in [-128, 127]) as one word
__device__ __forceinline__ void store4(int8_t* p, const I4& a) {
  store_word(p, byte_at(a.v[0], 0) | byte_at(a.v[1], 1) | byte_at(a.v[2], 2) |
                    byte_at(a.v[3], 3));
}
// a word of four int8 as it is
__device__ __forceinline__ void store4(int8_t* p, uint32_t w) { store_word(p, w); }
// four ints in [-128, 127] as the bytes of one word (three PRMTs)
__device__ __forceinline__ uint32_t pack_bytes(const I4& a) {
  return __byte_perm(__byte_perm(a.v[0], a.v[1], 0x40), __byte_perm(a.v[2], a.v[3], 0x40),
                     0x5410);
}

// stored as int16: each value wraps, as an int16 sum does
__device__ __forceinline__ void store4(int16_t* p, const I4& a) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2((a.v[0] & 0xffff) | (uint32_t)a.v[1] << 16,
                 (a.v[2] & 0xffff) | (uint32_t)a.v[3] << 16);
}
__device__ __forceinline__ I4 load4(const int* p) {
  const int4 u = *reinterpret_cast<const int4*>(p);
  return I4{{u.x, u.y, u.z, u.w}};
}
__device__ __forceinline__ void store4(int* p, const I4& a) {
  *reinterpret_cast<int4*>(p) = make_int4(a.v[0], a.v[1], a.v[2], a.v[3]);
}

// A unit's F frames of a lane at p (see Units): the lane's four as loaded
// (load_raw) and stored (store4), an f32 frame pair (8 bytes) or one f64
// frame.
template <int F, typename Msg>
__device__ __forceinline__ auto load_unit(const Msg* p) {
  if constexpr (F == kBt) {
    return load_raw(p);
  } else if constexpr (std::is_same_v<Msg, float>) {
    static_assert(F == 2, "an f32 unit of fewer frames than a lane's is a frame pair");
    const float2 a = *reinterpret_cast<const float2*>(p);
    return Frames<float, 2>{{a.x, a.y}};
  } else {
    static_assert(std::is_same_v<Msg, double> && F == 1,
                  "an f64 unit of fewer frames than a lane's is one frame");
    return Frames<double, 1>{{*p}};
  }
}
template <typename Msg, int F>
using UnitRaw = decltype(load_unit<F>(static_cast<const Msg*>(nullptr)));

template <typename T, class V>
__device__ __forceinline__ void store_unit(T* p, const V& a) {
  store4(p, a);
}
__device__ __forceinline__ void store_unit(float* p, const Frames<float, 2>& a) {
  *reinterpret_cast<float2*>(p) = make_float2(a.v[0], a.v[1]);
}
__device__ __forceinline__ void store_unit(double* p, const Frames<double, 1>& a) {
  *p = a.v[0];
}

// v plus a parked delta d, per frame: one f32 or f64 rounding, or an int
// add
template <typename T>
__device__ __forceinline__ void add4(Four<T>& v, const Four<T>& d) {
#pragma unroll
  for (int f = 0; f < kBt; ++f) v.v[f] = add_rn(v.v[f], d.v[f]);
}
__device__ __forceinline__ void add4(I4& v, const I4& d) {
#pragma unroll
  for (int f = 0; f < kBt; ++f) v.v[f] += d.v[f];
}
template <typename T, int F>
__device__ __forceinline__ void add4(Frames<T, F>& v, const Frames<T, F>& d) {
#pragma unroll
  for (int f = 0; f < F; ++f) v.v[f] = add_rn(v.v[f], d.v[f]);
}

// A lane's four hard decisions as a word of 0/1 bytes: from posteriors
// (post <= 0; f32, f64 or int16) or from stored bits (nonzero).
template <typename T>
__device__ __forceinline__ uint32_t hard_bits(const Four<T>& a) {
  return (a.v[0] <= T(0)) | (a.v[1] <= T(0)) << 8 | (a.v[2] <= T(0)) << 16 |
         (a.v[3] <= T(0)) << 24;
}
__device__ __forceinline__ uint32_t hard_bits(const I4& a) {
  return (a.v[0] <= 0) | (a.v[1] <= 0) << 8 | (a.v[2] <= 0) << 16 |
         (a.v[3] <= 0) << 24;
}
// A flooding unit's hard decisions (tot <= 0) to its bytes of the lane's
// word at p: the whole word for a lane's four frames.
template <class V>
__device__ __forceinline__ void store_hard(int8_t* p, const V& tot) {
  store_word(p, hard_bits(tot));
}
template <typename T, int F>
__device__ __forceinline__ void store_hard(int8_t* p, const Frames<T, F>& tot) {
#pragma unroll
  for (int f = 0; f < F; ++f) p[f] = tot.v[f] <= T(0);
}
__device__ __forceinline__ uint32_t hard_word(const float* p) {
  return hard_bits(load4(p));
}
__device__ __forceinline__ uint32_t hard_word(const double* p) {
  return hard_bits(load4(p));
}
__device__ __forceinline__ uint32_t hard_word(const int16_t* p) {
  return hard_bits(load4(p));
}
__device__ __forceinline__ uint32_t hard_word(const int8_t* p) {
  return __vcmpne4(load_word(p), 0u) & 0x01010101u;
}

// The layout tables in shared memory, with the products the phases use
// precomputed: qbase = syn_vg * Z, rec_pz = rec_plane * Z, rec_gz =
// rec_group * Z; chk_cs and var_cs end with E; repeat[g] is 1 when check
// group g reaches a variable group twice.
struct LaneTables {
  const int* chk_cs;
  const int* qbase;
  const int* syn_rot;
  const int* chk_rot;
  const int* syn_mask;
  const int* repeat;
  const int* var_cs;
  const int* rec_pz;
  const int* rec_gz;
  const int* rec_slot;
  const int* rec_rot;
  int CG, E, VG, Z;
};

// Shared-memory ints of the tables, rounded up to whole 16-byte rows.
__host__ __device__ constexpr int table_ints(int CG, int E, int VG) {
  return (2 * CG + VG + 2 + 8 * E + 3) / 4 * 4;
}
// Shared-memory ints of the decode loop's control words.
constexpr int kCtlInts = 8;

__device__ inline LaneTables load_tables(const Tables& t, int* sm) {
  int* chk_cs = sm;
  int* repeat = chk_cs + t.CG + 1;
  int* var_cs = repeat + t.CG;
  int* qbase = var_cs + t.VG + 1;
  int* syn_rot = qbase + t.E;
  int* chk_rot = syn_rot + t.E;
  int* syn_mask = chk_rot + t.E;
  int* rec_pz = syn_mask + t.E;
  int* rec_gz = rec_pz + t.E;
  int* rec_slot = rec_gz + t.E;
  int* rec_rot = rec_slot + t.E;
  for (int i = threadIdx.x; i <= t.CG; i += blockDim.x)
    chk_cs[i] = i < t.CG ? t.chk_cs[i] : t.E;
  for (int i = threadIdx.x; i <= t.VG; i += blockDim.x)
    var_cs[i] = i < t.VG ? t.var_cs[i] : t.E;
  for (int e = threadIdx.x; e < t.E; e += blockDim.x) {
    qbase[e] = t.syn_vg[e] * t.Z;
    syn_rot[e] = t.syn_rot[e];
    chk_rot[e] = t.chk_rot[e];
    syn_mask[e] = t.syn_mask[e];
    rec_pz[e] = t.rec_plane[e] * t.Z;
    rec_gz[e] = t.rec_group[e] * t.Z;
    rec_slot[e] = t.rec_slot[e];
    rec_rot[e] = t.rec_rot[e];
  }
  __syncthreads();
  for (int g = threadIdx.x; g < t.CG; g += blockDim.x) {
    int rep = 0;
    for (int a = chk_cs[g]; a < chk_cs[g + 1]; ++a)
      for (int b = chk_cs[g]; b < a; ++b) rep |= qbase[a] == qbase[b];
    repeat[g] = rep;
  }
  __syncthreads();
  return LaneTables{chk_cs, qbase,  syn_rot, chk_rot,  syn_mask, repeat,
                    var_cs, rec_pz, rec_gz,  rec_slot, rec_rot,  t.CG,
                    t.E,    t.VG,   t.Z};
}

// Lane r of a check group's plane reads variable lane r - rot, mod Z.
__device__ __forceinline__ int minus_mod(int r, int rot, int Z) {
  const int w = r - rot;
  return w < 0 ? w + Z : w;
}

// Edges of a flooding variable unit of F frames whose loads go out
// together: 8 for a lane's four frames; 4 for an f64 unit of fewer, whose
// next unit's prefetch then fits 64 registers (in turns on the card, the
// flagship's f64 variable phase 25 % faster than with 8, which spilled),
// and 4 for int8 messages, whose kernels run 512 threads at 64 registers
// too (the flagship's i8 decode 11 % faster than with 8, which spilled).
constexpr int kVarChunk = 8;
template <int F, typename Msg = float>
constexpr int kVarChunkOf = F == kBt && !std::is_same_v<Msg, int8_t> ? kVarChunk : 4;

// The resident flooding kernels keep one message array in check-major
// cells. The cell of var-major edge p at variable lane w: its message lives
// in check-major plane rec_plane at check lane w - rec_rot.
template <typename Msg>
__device__ __forceinline__ Msg* var_cell(Msg* msg, const LaneTables& t, int p,
                                         int w) {
  return msg + ((size_t)t.rec_pz[p] + minus_mod(w, t.rec_rot[p], t.Z)) * kBt;
}

// Where a flooding variable lane reads the c2v of var-major edge p
// (in(p, w)) and writes its v2c (out(p, w, o), o a unit's values), and the
// cells of a unit whose first frame is f0 (at(f0)). The resident kernels'
// cells: one message array, each edge's message in its check-major cell
// var_cell, read and written in place. (The streaming variable phase's
// cells are in csrc/streaming.cuh.)
template <typename Msg>
struct ArrayCells {
  Msg* msg;
  const LaneTables& t;

  __device__ __forceinline__ ArrayCells at(int f0) const { return {msg + f0, t}; }
  __device__ __forceinline__ const Msg* in(int p, int w) const {
    return var_cell(msg, t, p, w);
  }
  template <class V>
  __device__ __forceinline__ void out(int p, int w, const V& o) const {
    store_unit(var_cell(msg, t, p, w), o);
  }
};

// What a flooding variable unit of F frames loads first: q and the c2v of
// its first kVarChunkOf<F> edges.
template <typename Msg, int F = kBt>
struct VarLoads {
  UnitRaw<Msg, F> q;
  UnitRaw<Msg, F> y0[kVarChunkOf<F, Msg>];
};

// The first loads of variable lane w of group vg, whose edges are p0..p1
// (cells and q those of the unit's first frame).
template <int F, typename Msg, class Cells>
__device__ __forceinline__ void var_load(const Cells& cells, const Msg* q, int Z,
                                         int vg, int w, int p0, int p1,
                                         VarLoads<Msg, F>& v) {
  v.q = load_unit<F>(q + ((size_t)vg * Z + w) * kBt);
#pragma unroll
  for (int j = 0; j < kVarChunkOf<F, Msg>; ++j)
    if (p0 + j < p1) v.y0[j] = load_unit<F>(cells.in(p0 + j, w));
}

// A flooding variable phase over the units r0, r0 + stride, ... of a tile's
// vn variable lanes, F frames a unit (Units; var_cs ends with E), each
// thread issuing its next unit's loads before this unit's stores (in a
// phase each cell belongs to one lane, so no load can miss a store):
// update(vg, w, f0, loads) updates the unit of lane w of group vg whose
// first frame is f0.
template <int F, typename Msg, class Cells, class Update>
__device__ __forceinline__ void var_phase(const Cells& cells, const Msg* q,
                                          const int* var_cs, int vn, int Z,
                                          int r0, int stride, Update&& update) {
  constexpr int U = kBt / F;
  const int n = vn * U;
  auto load = [&](int r, VarLoads<Msg, F>& v) {
    const int lane = r / U, f0 = r % U * F, vg = lane / Z;
    var_load<F>(cells.at(f0), q + f0, Z, vg, lane % Z, var_cs[vg], var_cs[vg + 1], v);
  };
  VarLoads<Msg, F> v;
  int r = r0;
  if (r < n) load(r, v);
  for (; r < n; r += stride) {
    VarLoads<Msg, F> next;
    const int rn = r + stride;
    if (rn < n) load(rn, next);
    const int lane = r / U;
    update(lane / Z, lane % Z, r % U * F, v);
    v = next;
  }
}

// Variable update of a unit of variable lane w (edges p0..p1) in one
// flooding tile, from its first loads v (cells and post those of the
// unit's first frame): tot = q plus the lane's c2v in var-major slot order
// (add_rn); output k = store(tot - y_k) (sub_rn) goes to the cells as v2c,
// and the hard decisions tot <= 0 to the unit's bytes of the lane's word
// at post. The first chunk's c2v stay in registers through the outputs; a
// lane of more than kVarChunkOf<F> edges reads its later chunks again. Computed
// in f32 for f32 and bf16 messages, in f64 for f64 ones.
template <typename Msg, int F, class Cells>
__device__ __forceinline__ void var_update(const Cells& cells, int8_t* post,
                                           int p0, int p1, int w,
                                           const VarLoads<Msg, F>& v) {
  constexpr int kChunk = kVarChunkOf<F>;
  auto tot = unpack(v.q);
#pragma unroll
  for (int j = 0; j < kChunk; ++j) {
    if (p0 + j < p1) {
      const auto y = unpack(v.y0[j]);
#pragma unroll
      for (int f = 0; f < F; ++f) tot.v[f] = add_rn(tot.v[f], y.v[f]);
    }
  }
  for (int c0 = p0 + kChunk; c0 < p1; c0 += kChunk) {
    UnitRaw<Msg, F> y[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j)
      if (c0 + j < p1) y[j] = load_unit<F>(cells.in(c0 + j, w));
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      if (c0 + j < p1) {
        const auto yj = unpack(y[j]);
#pragma unroll
        for (int f = 0; f < F; ++f) tot.v[f] = add_rn(tot.v[f], yj.v[f]);
      }
    }
  }
  store_hard(post, tot);
  auto output = [&](int p, const UnitRaw<Msg, F>& yr) {
    const auto y = unpack(yr);
    decltype(tot) o;
#pragma unroll
    for (int f = 0; f < F; ++f) o.v[f] = sub_rn(tot.v[f], y.v[f]);
    cells.out(p, w, o);
  };
#pragma unroll
  for (int j = 0; j < kChunk; ++j)
    if (p0 + j < p1) output(p0 + j, v.y0[j]);
  for (int p = p0 + kChunk; p < p1; ++p) output(p, load_unit<F>(cells.in(p, w)));
}

// The min-sum fold of a check's d inputs, in edge order, for each frame f:
// m1 the least |x| (first minimum), m2 the second, arg its slot, negs the
// signs (x < 0) by slot; their parity is popc(negs) & 1.
template <int DMAX>
struct Fold {
  using Mask = std::conditional_t<(DMAX > 32), uint64_t, uint32_t>;
  float m1[kBt] = {}, m2[kBt];
  int arg[kBt] = {};
  Mask negs[kBt] = {};

  __device__ __forceinline__ void add(int k, int f, float x) {
    const float mk = fabsf(x);
    const Mask neg = x < 0.f;
    if (k == 0) {
      m1[f] = mk;
      negs[f] = neg;
    } else {
      m2[f] = fminf(m2[f], fmaxf(m1[f], mk));
      if (mk < m1[f]) {
        m1[f] = mk;
        arg[f] = k;
      }
      negs[f] |= neg << k;
    }
  }
  __device__ __forceinline__ void scale_by(float scale) {
    if (scale != 1.f) {
#pragma unroll
      for (int f = 0; f < kBt; ++f) {
        m1[f] = __fmul_rn(m1[f], scale);
        m2[f] = __fmul_rn(m2[f], scale);
      }
    }
  }
  // the output sign of slot k (-1 or 1): the parity of the other signs
  __device__ __forceinline__ int sign(int k, int f) const {
    int par;
    if constexpr (DMAX > 32) {
      par = __popcll(negs[f]);
    } else {
      par = __popc(negs[f]);
    }
    return ((par ^ (int)(negs[f] >> k)) & 1) ? -1 : 1;
  }
  // the min-sum output of slot k for frame f: the other inputs' least
  // magnitude with the parity of their signs
  __device__ __forceinline__ float out(int k, int f) const {
    const float loo = arg[f] == k ? m2[f] : m1[f];
    return sign(k, f) < 0 ? -loo : loo;
  }
};

// The parked group's Qv update at variable lane w: each edge's Qv cell
// gathered once, the parked deltas added in edge order (an edge into a
// variable group an earlier edge reached continues from that edge's sum),
// stored. Qv f32 with f32 deltas, or int16 with int32 deltas.
template <int DMAX, typename Q, typename P>
__device__ __forceinline__ void layered_update_lane(Q* qv, const P* park,
                                                    const LaneTables& t, int g,
                                                    int w) {
  const int Z = t.Z;
  const int e0 = t.chk_cs[g], d = t.chk_cs[g + 1] - e0;
  decltype(load4(qv)) v[DMAX];
#pragma unroll
  for (int k = 0; k < DMAX; ++k) {
    if (k < d) {
      const int e = e0 + k;
      v[k] = load4(qv + ((size_t)t.qbase[e] + w) * kBt);
    }
  }
#pragma unroll
  for (int k = 0; k < DMAX; ++k) {
    if (k < d) {
#pragma unroll
      for (int j = 0; j < k; ++j)
        if (t.qbase[e0 + j] == t.qbase[e0 + k]) v[k] = v[j];
      add4(v[k], load4(park + ((size_t)k * Z + minus_mod(w, t.chk_rot[e0 + k], Z)) * kBt));
    }
  }
#pragma unroll
  for (int k = 0; k < DMAX; ++k)
    if (k < d) store4(qv + ((size_t)t.qbase[e0 + k] + w) * kBt, v[k]);
}

// One layered sweep of one tile over all check groups, a unit of U (a
// lane's four frames, or F of them) a thread. check_lane(g, c, f0, parked)
// updates the unit of check lane c of group g whose first frame is f0 and
// either adds its deltas to Qv itself (parked false: the group reaches no
// variable group twice, so no other lane touches those cells) or parks them
// at park[(k * Z + c) * 4 + f0]; a parked group's variable lanes then add
// them in edge order, a lane a thread.
template <int DMAX, class U = Units<>, typename Q, typename P, class CheckLane>
__device__ void layered_sweep4(Q* qv, const P* park, const LaneTables& t,
                               CheckLane&& check_lane) {
  for (int g = 0; g < t.CG; ++g) {
    const bool parked = t.repeat[g];
    for (int r = threadIdx.x; r < t.Z * U::kPerLane; r += blockDim.x)
      check_lane(g, r / U::kPerLane, r % U::kPerLane * U::kFrames, parked);
    __syncthreads();
    if (parked) {
      for (int w = threadIdx.x; w < t.Z; w += blockDim.x)
        layered_update_lane<DMAX>(qv, park, t, g, w);
      __syncthreads();
    }
  }
}

// ORs a warp's frames with an unsatisfied check (bit f) into *bad.
__device__ __forceinline__ void report_odd(uint32_t odd, int* bad) {
  odd = __reduce_or_sync(0xffffffffu, odd);
  if (odd && (threadIdx.x & 31) == 0) atomicOr(bad, (int)odd);
}

// ORs into *bad the frames (bit f) of the tile with an unsatisfied check
// on the hard decisions of post ((VG, Z, 4) f32 or int16 posteriors, or
// int8 bits).
template <int DMAX, typename P>
__device__ void syndrome4(const P* post, const LaneTables& t, int* bad) {
  const int Z = t.Z;
  uint32_t odd = 0;
  for (int r = threadIdx.x; r < t.CG * Z; r += blockDim.x) {
    const int g = r / Z, c = r - g * Z;
    const int e0 = t.chk_cs[g], d = t.chk_cs[g + 1] - e0;
    uint32_t h[DMAX];
#pragma unroll
    for (int k = 0; k < DMAX; ++k) {
      if (k < d) {
        const int e = e0 + k;
        h[k] = hard_word(post + ((size_t)t.qbase[e] + minus_mod(c, t.syn_rot[e], Z)) * kBt);
      }
    }
    uint32_t par = 0;
#pragma unroll
    for (int k = 0; k < DMAX; ++k)
      if (k < d && c != t.syn_mask[e0 + k]) par ^= h[k];
    odd |= (par & 1u) | (par >> 7 & 2u) | (par >> 14 & 4u) | (par >> 21 & 8u);
  }
  report_odd(odd, bad);
}

// The bytes of a 4-bit frame mask, 0xff where set.
__device__ __forceinline__ uint32_t frame_bytes(int mask) {
  return (mask & 1 ? 0xffu : 0u) | (mask & 2 ? 0xff00u : 0u) |
         (mask & 4 ? 0xff0000u : 0u) | (mask & 8 ? 0xff000000u : 0u);
}

// Sets the bits of the frames in mask to post's hard decisions at every lane.
template <typename P>
__device__ void hard_decide(const P* post, int8_t* bits, int lanes, int mask) {
  if (!mask) return;
  const uint32_t keep = ~frame_bytes(mask);
  for (int i = threadIdx.x; i < lanes; i += blockDim.x) {
    const uint32_t hw = hard_word(post + (size_t)i * kBt);
    int8_t* b = bits + (size_t)i * kBt;
    store_word(b, (load_word(b) & keep) | (hw & ~keep));
  }
}

// The whole decode of one tile: post (VG, Z, 4) holds the posteriors (f32
// or int16) or their hard decisions (int8) whose syndrome decides, bits
// the raw-channel bits on entry and the decoded bits on exit. Iteration 0
// tests the raw bits; iterate(it, bad) runs iteration it and ORs into *bad
// the frames whose posteriors then fail a check; a frame's bits and count
// freeze at its first passing iteration; the tile stops once all its
// frames passed; a frame that never passes gets max_iterations and post's
// last hard decisions, or keeps the raw bits if no iteration ran (an i8
// posterior's sign is not the raw bit: a tiny positive LLR quantizes to
// 0). ctl is kCtlInts ints of shared memory.
template <int DMAX, typename P, class Iterate>
__device__ void decode_tile4(const P* post, int8_t* bits, int* iters_out,
                             int* conv_out, const LaneTables& t,
                             int max_iterations, int* ctl, Iterate&& iterate) {
  constexpr int kAll = (1 << kBt) - 1;
  int* bad = ctl;  // frames with an unsatisfied check, bit f
  int* conv = ctl + 1;
  int* newly = ctl + 2;
  int* done = ctl + 3;
  int* iters = ctl + 4;  // kBt of them
  const size_t tile = blockIdx.x;
  const int lanes = t.VG * t.Z;

  if (threadIdx.x == 0) {
    *bad = 0;
    for (int f = 0; f < kBt; ++f) iters[f] = 0;
  }
  __syncthreads();
  syndrome4<DMAX>(static_cast<const int8_t*>(bits), t, bad);
  __syncthreads();
  if (threadIdx.x == 0) {
    *conv = ~*bad & kAll;
    *bad = 0;
    *done = *conv == kAll;
  }
  __syncthreads();

  for (int it = 1; it <= max_iterations && !*done; ++it) {
    iterate(it, bad);
    __syncthreads();
    if (threadIdx.x == 0) {
      const int ok = ~*bad & kAll;
      *newly = ok & ~*conv;
      for (int f = 0; f < kBt; ++f)
        if (*newly >> f & 1) iters[f] = it;
      *conv |= ok;
      *bad = 0;
      *done = *conv == kAll;
    }
    __syncthreads();
    // freeze the bits of frames that converged in this iteration
    if (*newly) {
      hard_decide(post, bits, lanes, *newly);
      __syncthreads();
    }
  }

  // frames that never converged keep their final hard decisions (the raw
  // bits when no iteration ran)
  if (max_iterations > 0) hard_decide(post, bits, lanes, ~*conv & kAll);
  if (threadIdx.x < kBt) {
    const int f = threadIdx.x, ok = *conv >> f & 1;
    iters_out[tile * kBt + f] = ok ? iters[f] : max_iterations;
    conv_out[tile * kBt + f] = ok;
  }
}

// Dynamic shared memory of a launch: the control ints, the tables and,
// for a layered kernel, the park when it lives there (park_elems deltas of
// park_elem_bytes: 4 for f32 or int32, 8 for f64).
inline size_t smem_bytes(const Tables& t, size_t park_elems,
                         size_t park_elem_bytes = sizeof(float)) {
  return sizeof(int) * (kCtlInts + table_ints(t.CG, t.E, t.VG)) +
         park_elem_bytes * park_elems;
}

// The block's park: its slice of the device park (nbt, park_elems), or,
// when park_all is null, the shared memory after the tables (whole 16-byte
// rows, so an f64 park is aligned too).
template <typename P>
__device__ __forceinline__ P* lane_park(P* park_all, size_t park_elems,
                                        int* smem, const Tables& t) {
  static_assert(sizeof(P) == 4 || sizeof(P) == 8, "a park holds 4- or 8-byte deltas");
  return park_all ? park_all + blockIdx.x * park_elems
                  : reinterpret_cast<P*>(smem + kCtlInts +
                                         table_ints(t.CG, t.E, t.VG));
}

// Launches kernel on a grid (nbt blocks: a block a tile) with smem bytes of
// dynamic shared memory; returns the launch's error.
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, dim3 grid, int threads, size_t smem,
                   cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// Calls Launch<DMAX, Msg>::run(args...) with the least degree bucket that
// holds max_degree and the storage type (bf16 when msg_bf16, else f32).
template <template <int, typename> class Launch, typename... Args>
cudaError_t by_bucket(int max_degree, int msg_bf16, Args&&... args) {
  if (max_degree < 1 || max_degree > 64) return cudaErrorInvalidValue;
#define LDPC_BUCKET(D)                                                  \
  if (max_degree <= D)                                                  \
    return msg_bf16 ? Launch<D, __nv_bfloat16>::run(args...)            \
                    : Launch<D, float>::run(args...);
  LDPC_BUCKET(8)
  LDPC_BUCKET(16)
  LDPC_BUCKET(32)
  LDPC_BUCKET(64)
#undef LDPC_BUCKET
  return cudaErrorInvalidValue;
}

}  // namespace ldpc
