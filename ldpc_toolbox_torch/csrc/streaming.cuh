// The three streaming kernels (one launch an iteration, or a phase of
// one), templated on the check rule like the resident kernels of
// csrc/message_kernels.cuh and built on the same rule policies and lane
// code:
// - fused_check_kernel: the flooding check phase, v2c -> c2v (replaces
//   ldpc_toolbox_tpu/ops/fused_bp2.py fused_check);
// - fused_var_kernel: the flooding variable phase, c2v and q -> v2c and the
//   hard bits, or the initialisation v2c = q (replaces fused_bp2.py
//   fused_var);
// - fused_layered_kernel: one horizontal-layered sweep and the hard bits
//   (replaces ldpc_toolbox_tpu/ops/fused_layered.py fused_layered_iteration).
// Each source instantiates them on its rules: csrc/flooding.cu (the phases)
// and csrc/fused_layered.cu (the sweep) on MinSumRule, csrc/flooding_i8.cu
// and csrc/fused_layered_i8.cu on I8Rule (csrc/i8.cuh), the *_f32.cu and
// *_f64.cu sources of both on FloatRule (csrc/float_rules.cuh).
//
// Layout (the JAX package's and the plain versions' of ops/fused_bp2.py
// and ops/fused_layered.py): a tile is 4 frames, frames innermost. v2c
// planes (nbt, E, Z, 4) are check-major in check lane coordinates, c2v
// planes (nbt, E, Z, 4) var-major in variable lane coordinates, q and the
// hard bits (nbt, VG, Z, 4) per variable group; the layered Qv (nbt, VG,
// Z, 4) and Rcv (nbt, E, Z, 4) are those of the resident layered kernel.
// Moving a message between the sides is a mod-Z lane shift by the edge's
// lift shift; each output cell has exactly one writer.
//
// What bounds them on an H100: memory traffic. A phase reads and writes
// every message of the batch once (the flagship, DVB-S2 n = 64800 rate 1/2
// at B = 1024: 226,800 edge lanes a frame, 464 MB of bf16 messages each
// way, 1.9 GB in f64) and the rules do a few to some hundred operations a
// message; the sweep moves a tile's Qv and Rcv through device memory as the
// resident layered kernel does an iteration.
//
// What the design does about it (the form of the resident kernels, on
// csrc/lanes.cuh): a thread per lane of a tile's four frames, so a lane's
// values move as one 4- to 32-byte vector and each table load and mod-Z
// index is done once a lane (the f64 float rules' phases a thread per
// (lane, frame), whose rule is their cost: csrc/float_rules.cuh); the
// check lane's loads unrolled to the degree bucket, all issued before its
// rule; the variable lane issuing its next
// lane's loads before this lane's stores; the tables in shared memory. The
// phases have no sequential dependence inside a tile, so a tile is spread
// over several blocks (blockIdx.y the tile, blockIdx.x a slice of its
// lanes), as many as fill the card; the sweep walks its check groups in
// turn, one block a tile, as the resident layered kernel does.

#pragma once

#include <algorithm>

#include "message_kernels.cuh"

namespace ldpc {

// The eleven int32 tables of the flooding phase kernels, in the order of
// the wrappers' pointer array (ldpc_toolbox_torch/ops/fused_bp2.py
// _TABLES), and the tile shape.
struct FloodingTables {
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

inline FloodingTables make_flooding_tables(const void* const* tab, int CG,
                                           int VG, int E, int Z, int Bt) {
  const int* const* p = reinterpret_cast<const int* const*>(tab);
  return FloodingTables{p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7],
                        p[8], p[9], p[10], CG, VG, E, Z, Bt};
}

// One side's tables of a phase in shared memory: cs the first edge of each
// of its G groups (ending with E), dz an edge's destination plane times Z,
// rot its lane shift to the other side, mask its missing lane.
struct PhaseLanes {
  const int* cs;
  const int* dz;
  const int* rot;
  const int* mask;
};

// Shared-memory ints of one side's tables, rounded up to whole 16-byte rows.
inline size_t phase_smem(int G, int E) {
  return sizeof(int) * ((G + 1 + 3 * (size_t)E + 3) / 4 * 4);
}

__device__ inline PhaseLanes load_phase(const int* cs, int G, const int* dest,
                                        const int* rot, const int* mask, int E,
                                        int Z, int* sm) {
  int* s_cs = sm;
  int* s_dz = s_cs + G + 1;
  int* s_rot = s_dz + E;
  int* s_mask = s_rot + E;
  for (int i = threadIdx.x; i <= G; i += blockDim.x) s_cs[i] = i < G ? cs[i] : E;
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    s_dz[e] = dest[e] * Z;
    s_rot[e] = rot[e];
    s_mask[e] = mask[e];
  }
  __syncthreads();
  return PhaseLanes{s_cs, s_dz, s_rot, s_mask};
}

// The lane shift of a phase's output: lane + rot, mod Z.
__device__ __forceinline__ int plus_mod(int lane, int rot, int Z) {
  const int w = lane + rot;
  return w < Z ? w : w - Z;
}

// The streaming variable phase's cells (see lanes.cuh ArrayCells): c2v of
// var-major edge p at variable lane w in its own plane; the v2c out to
// check-major plane var_dest[p] at check lane w + var_rot[p], big at its
// missing lane.
template <typename Msg>
struct PhaseCells {
  const Msg* c2v;
  Msg* v2c;
  const PhaseLanes& s;
  int Z;
  Elem<Msg> big;

  __device__ __forceinline__ PhaseCells at(int f0) const {
    return {c2v + f0, v2c + f0, s, Z, big};
  }
  __device__ __forceinline__ const Msg* in(int p, int w) const {
    return c2v + ((size_t)p * Z + w) * kBt;
  }
  template <class V>
  __device__ __forceinline__ void out(int p, int w, V o) const {
    const int c = plus_mod(w, s.rot[p], Z);
    if (c == s.mask[p]) {
#pragma unroll
      for (auto& x : o.v) x = big;
    }
    store_unit(v2c + ((size_t)s.dz[p] + c) * kBt, o);
  }
  // a lane's four int8 values as one word (the i8 rules' variable update)
  __device__ __forceinline__ void out(int p, int w, uint32_t o) const {
    const int c = plus_mod(w, s.rot[p], Z);
    store_word(v2c + ((size_t)s.dz[p] + c) * kBt,
               c == s.mask[p] ? static_cast<uint8_t>(big) * 0x01010101u : o);
  }
};

// Check phase of a tile's check units r0, r0 + stride, ... (blockIdx.y the
// tile; Rule::FloodUnits): a unit of check lane c of group g folds its d
// v2c (big at the missing lane) under the rule (message_kernels.cuh
// flooding_check) and writes output k to c2v plane chk_dest[e] at variable
// lane c + chk_rot[e], 0 at the missing lane.
template <int DMAX, class Rule>
__global__ void __launch_bounds__(Rule::FloodUnits::kBlock, 2) fused_check_kernel(
    const typename Rule::Msg* v2c_all, typename Rule::Msg* c2v_all,
    FloodingTables t, Rule rule) {
  using U = typename Rule::FloodUnits;
  extern __shared__ __align__(16) int smem[];
  const int Z = t.Z;
  const PhaseLanes s =
      load_phase(t.chk_cs, t.CG, t.chk_dest, t.chk_rot, t.syn_mask, t.E, Z, smem);
  const size_t plane_tile = (size_t)t.E * Z * kBt;
  const auto* v2c = v2c_all + blockIdx.y * plane_tile;
  auto* c2v = c2v_all + blockIdx.y * plane_tile;
  const int n = t.CG * Z * U::kPerLane;
  for (int r = blockIdx.x * blockDim.x + threadIdx.x; r < n; r += gridDim.x * blockDim.x) {
    const int lane = r / U::kPerLane, f0 = r % U::kPerLane * U::kFrames;
    const int g = lane / Z, c = lane - g * Z;
    const int e0 = s.cs[g];
    flooding_check<DMAX>(v2c + f0, s.mask, Z, e0, s.cs[g + 1] - e0, c, rule,
                         [&](int e, const auto& o) {
                           store_unit(c2v + f0 + ((size_t)s.dz[e] + plus_mod(c, s.rot[e], Z)) * kBt,
                                      o);
                         });
  }
}

// Variable phase of a tile's variable lanes (blockIdx.y the tile), a unit
// of Rule::FloodUnits a thread: the rule's variable update (lanes.cuh
// var_update, i8.cuh i8_var_update) through PhaseCells, the hard bits tot
// <= 0 to bits. c2v_all null runs the initialisation, a lane a thread:
// every output is q (no rule clips), the hard bits q <= 0.
template <class Rule>
__global__ void __launch_bounds__(Rule::FloodUnits::kBlock, 2) fused_var_kernel(
    const typename Rule::Msg* c2v_all, const typename Rule::Msg* q_all,
    typename Rule::Msg* v2c_all, int8_t* bits_all, FloodingTables t, Rule rule) {
  using Msg = typename Rule::Msg;
  extern __shared__ __align__(16) int smem[];
  const int Z = t.Z, vn = t.VG * Z;
  const PhaseLanes s =
      load_phase(t.var_cs, t.VG, t.var_dest, t.var_rot, t.var_omask, t.E, Z, smem);
  const size_t plane_tile = (size_t)t.E * Z * kBt, lane_tile = (size_t)vn * kBt;
  const Msg* q = q_all + blockIdx.y * lane_tile;
  int8_t* bits = bits_all + blockIdx.y * lane_tile;
  const PhaseCells<Msg> cells{c2v_all ? c2v_all + blockIdx.y * plane_tile : nullptr,
                              v2c_all + blockIdx.y * plane_tile, s, Z,
                              static_cast<Elem<Msg>>(rule.big)};
  const int r0 = blockIdx.x * blockDim.x + threadIdx.x, stride = gridDim.x * blockDim.x;
  if (c2v_all == nullptr) {
    for (int r = r0; r < vn; r += stride) {
      const int vg = r / Z, w = r - vg * Z;
      const auto qr = load4(q + (size_t)r * kBt);
      store_word(bits + (size_t)r * kBt, hard_bits(qr));
      for (int p = s.cs[vg]; p < s.cs[vg + 1]; ++p) cells.out(p, w, qr);
    }
    return;
  }
  var_phase<Rule::FloodUnits::kFrames>(
      cells, q, s.cs, vn, Z, r0, stride, [&](int vg, int w, int f0, const auto& v) {
        rule.var_update(cells.at(f0), bits + ((size_t)vg * Z + w) * kBt + f0, s.cs[vg],
                        s.cs[vg + 1], w, v);
      });
}

// One horizontal-layered sweep of one tile per block under a rule, in place
// on qv (VG, Z, 4) and rcv (E, Z, 4), then the hard bits qv <= 0: one
// iteration of resident_layered_kernel without the syndrome and the freeze
// (the same layered_sweep4 over layered_check_lane, but a lane's four
// frames a thread under every rule: the f32 float rules' frame pair of the
// resident kernel ran 4 % slower here, csrc/float_rules.cuh; park_all the
// device park, or null to park in shared memory after the tables).
template <int DMAX, class Rule>
__global__ void __launch_bounds__(kThreads, 2) fused_layered_kernel(
    typename Rule::Q* qv_all, typename Rule::Msg* rcv_all, int8_t* bits_all,
    typename Rule::P* park_all, Tables t, size_t park_elems, Rule rule) {
  extern __shared__ __align__(16) int smem[];
  const size_t tile = blockIdx.x;
  const size_t lanes = (size_t)t.VG * t.Z;
  const LaneTables lt = load_tables(t, smem + kCtlInts);
  auto* park = lane_park(park_all, park_elems, smem, t);
  auto* qv = qv_all + tile * lanes * kBt;
  auto* rcv = rcv_all + tile * t.E * t.Z * kBt;
  int8_t* bits = bits_all + tile * lanes * kBt;
  layered_sweep4<DMAX>(qv, park, lt, [&](int g, int c, int, bool parked) {
    layered_check_lane<DMAX, Units<>>(qv, rcv, park, lt, g, c, parked, rule);
  });
  for (size_t i = threadIdx.x; i < lanes; i += blockDim.x)
    store_word(bits + i * kBt, hard_word(qv + i * kBt));
}

// Blocks a tile of a phase kernel: enough for every SM to hold as many
// blocks as it can, and at most one for each kMinLanes units (lanes) of the
// tile a thread, so that small batches do not spread a tile thinner.
constexpr int kMinLanes = 8;

template <typename Kernel>
cudaError_t phase_grid(Kernel kernel, int units, int nbt, int threads,
                       size_t smem, dim3* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  const int fill = (sms * per_sm + nbt - 1) / nbt;
  const int most = (units + threads * kMinLanes - 1) / (threads * kMinLanes);
  *grid = dim3(std::max(1, std::min(fill, most)), nbt);
  return cudaSuccess;
}

// The launches of the three kernels on nbt tiles (see the C entry points
// of csrc/flooding.cu and csrc/fused_layered.cu for the arguments). A tile
// is 4 frames and a block at most the rule's FloodUnits::kBlock threads (a
// phase's; its grid counts units) or kThreads (the sweep's).
template <int DMAX, class Rule>
cudaError_t fused_check_launch(const Rule& rule, const void* v2c, void* c2v,
                               const FloodingTables& t, int nbt, int threads,
                               cudaStream_t stream) {
  using Msg = typename Rule::Msg;
  using U = typename Rule::FloodUnits;
  if (t.Bt != kBt || threads > U::kBlock) return cudaErrorInvalidValue;
  auto kernel = fused_check_kernel<DMAX, Rule>;
  const size_t smem = phase_smem(t.CG, t.E);
  dim3 grid;
  cudaError_t err = phase_grid(kernel, t.CG * t.Z * U::kPerLane, nbt, threads, smem, &grid);
  if (err != cudaSuccess) return err;
  return launch(kernel, grid, threads, smem, stream, static_cast<const Msg*>(v2c),
                static_cast<Msg*>(c2v), t, rule);
}

template <class Rule>
cudaError_t fused_var_launch(const Rule& rule, const void* c2v, const void* q,
                             void* v2c, void* bits, const FloodingTables& t,
                             int nbt, int threads, cudaStream_t stream) {
  using Msg = typename Rule::Msg;
  using U = typename Rule::FloodUnits;
  if (t.Bt != kBt || threads > U::kBlock) return cudaErrorInvalidValue;
  auto kernel = fused_var_kernel<Rule>;
  const size_t smem = phase_smem(t.VG, t.E);
  dim3 grid;
  cudaError_t err = phase_grid(kernel, t.VG * t.Z * U::kPerLane, nbt, threads, smem, &grid);
  if (err != cudaSuccess) return err;
  return launch(kernel, grid, threads, smem, stream, static_cast<const Msg*>(c2v),
                static_cast<const Msg*>(q), static_cast<Msg*>(v2c),
                static_cast<int8_t*>(bits), t, rule);
}

template <int DMAX, class Rule>
cudaError_t fused_layered_launch(const Rule& rule, void* qv, void* rcv,
                                 void* bits, void* park, const Tables& t,
                                 int nbt, size_t park_elems, int threads,
                                 cudaStream_t stream) {
  using P = typename Rule::P;
  if (threads > kThreads) return cudaErrorInvalidValue;
  return launch(fused_layered_kernel<DMAX, Rule>, nbt, threads,
                smem_bytes(t, park ? 0 : park_elems, sizeof(P)), stream,
                static_cast<typename Rule::Q*>(qv),
                static_cast<typename Rule::Msg*>(rcv), static_cast<int8_t*>(bits),
                static_cast<P*>(park), t, park_elems, rule);
}

}  // namespace ldpc
