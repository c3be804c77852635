// Flooding min-sum decode of frame tiles: the three streaming phase kernels
// (check, variable, syndrome) and the whole decode in one launch.
//
// Replaces these Pallas TPU kernels of ldpc_toolbox_tpu/ops/:
// - fused_bp2.py fused_check       -> fused_check_kernel (csrc/streaming.cuh)
// - fused_bp2.py fused_var         -> fused_var_kernel (csrc/streaming.cuh;
//   the initialisation when c2v is null)
// - fused_bp2.py fused_syndrome_bits -> fused_syndrome_kernel, which also
//   holds the streaming loop's freeze of the frames that pass and its count
//   of those left (ldpc_toolbox_tpu/decoder/compaction.py, the body of
//   staged_while_decode's while loop)
// - resident_flooding_dual.py resident_flooding_dual_decode and
//   resident_flooding.py resident_flooding_decode -> resident_flooding_kernel.
//   The two TPU kernels compute the same function and differ only in how
//   the state fits the TPU's vector memory (two message arrays, or one
//   aliased array). Here the state lives in device memory either way; the
//   kernel keeps one array, which serves both.
// The check, variable and resident kernels are the templates of
// csrc/streaming.cuh and csrc/message_kernels.cuh on MinSumRule (f32 and
// bf16 messages); csrc/flooding_i8.cu, _f32.cu and _f64.cu hold their
// instances on the other rules.
//
// Layout of the phase kernels (as the JAX package's): a tile is Bt frames,
// frames innermost. v2c planes (nbt, E, Z, Bt) are check-major in check
// lane coordinates; c2v planes (nbt, E, Z, Bt) are variable-major in
// variable lane coordinates; q and the hard bits (nbt, VG, Z, Bt) are per
// variable group. Moving a message between the sides is a mod-Z lane shift
// by the edge's lift shift; lanes are indexed mod Z directly (no padded
// plane height). Each plane has exactly one writer: chk_dest and var_dest
// are permutations of the edges, so no atomics touch a float.
//
// What bounds them on an H100: memory traffic, and for the resident kernel
// the latency of a tile's dependent loads. The flagship code (DVB-S2
// n = 64800, rate 1/2) has 226,800 edge lanes and 64,800 variable lanes a
// frame. A bf16 iteration at B = 1024 reads and writes every message once
// in each phase (4 x 464 MB), reads q (133 MB), writes the hard bits
// (66 MB) and reads them once per edge in the syndrome (232 MB): about
// 2.3 GB, 0.7 ms at 3.35 TB/s, about 10 bytes an edge lane. The state of
// one tile (1.8 MB of bf16 messages at Bt = 4) does not fit an SM's 227 KB
// of shared memory, and the batch's (0.5 GB) does not fit the 50 MB L2, so
// it streams through device memory every iteration. Min-sum does a few
// compares per byte, far below the compute roof.
//
// What the resident kernel's design does about it (the form of
// csrc/compressed.cu's kernels, on csrc/lanes.cuh):
// - one thread per lane of a tile, all four frames at once: messages and q
//   move as one 8-byte (bf16) or 16-byte (f32) vector, the hard bits as one
//   4-byte word, and each table load and mod-Z index is done once a lane;
// - one message array, check-major in check lane coordinates: the check
//   lane reads its d v2c from its own cells and writes its d c2v back to
//   them, and the variable lane reads each c2v from its cell (through the
//   rec_* tables) and writes its v2c back to the same cell;
// - the check lane's loop is unrolled to the check-degree bucket (8, 16, 32
//   or 64), so its d loads go out before its fold; the variable lane loads
//   its c2v eight at a time and keeps the first eight in registers for its
//   outputs;
// - a thread issues its next variable lane's loads (q and the first eight
//   c2v) before this lane's arithmetic and stores, so a lane of degree 2
//   or 3 (most of them) does not wait alone; the same for the check phase
//   gained nothing in bf16 and spilled in f32;
// - the syndrome is a pass of its own over the variable phase's hard-bit
//   words (4 bytes a lane): taking it with the next iteration's check
//   phase, as the compressed flooding kernel does with s, measured slower
//   here (the check lane's gathers of the bit words cost more than the
//   pass they save);
// - the layout tables are copied into shared memory once a launch.
// The phase kernels share the lane code (the check lane and the variable
// lane are the resident kernel's, reading and writing the phase's planes).
//
// The syndrome kernel reads a tile's bits once per edge: 907 KB a tile on
// the flagship, 232 MB a launch, from a tile's 259 KB of bits, which L2
// holds many times over; its bound is the 66 MB of bits read once (0.020
// ms), less where frames fail (one failing check a frame settles it).
// Its design: a thread a check lane of a tile's four frames, one int32 bit
// word an edge, its d loads issued before the xor (unrolled to the degree
// bucket); a tile spread over several blocks, as the phases' (blockIdx.y
// the tile), as many as one wave of the card holds; the tables in shared
// memory, an edge's as one 16-byte entry; the lane's group stepped without
// a division; a warp's odd frames or-ed together after each pass over its
// lanes, and a warp whose four frames are all odd stops (its other checks
// can change nothing); one atomicOr a warp into the tile's word. The
// tile's last block (a ticket a tile, after __threadfence) finishes it in
// the same launch: the flags, or the streaming loop's freeze and count, so
// an iteration makes one syndrome launch and one host read; the scratch
// words are left zero for the next launch (no memset launch).
//
// Bit-exactness with the JAX package (min-sum, f32 or bf16 storage):
// - the check fold is the one of csrc/lanes.cuh: sign x < 0, first minimum
//   wins, m2 folds as min(m2, max(m1, mk)) from big, the scale multiplies
//   the magnitude (__fmul_rn) before the sign;
// - the variable rule sums in slot order, tot = q, then tot = tot + y_t
//   for each slot (__fadd_rn), and emits tot - y_t (__fsub_rn); the hard
//   bit is tot <= 0; the _rn intrinsics keep nvcc from forming an FMA;
// - storage is rounded to nearest even (__float2bfloat16_rn);
// - missing lanes: the check update sees big there and emits 0 there (the
//   phase kernels: big into v2c at var_omask in check coordinates, 0 into
//   c2v at chk_omask in variable coordinates), and the syndrome skips
//   syn_mask.

#include "streaming.cuh"

using ldpc::FloodingTables;

namespace ldpc {
namespace {

// Threads a block of the syndrome kernel: a check lane's four frames a
// thread, as the phases give their lanes.
constexpr int kSyndromeThreads = 256;

// What a syndrome launch writes besides its scratch. flags null: the
// streaming loop's freeze (fused_syndrome_freeze); else the (nbt, 4) flags
// alone (fused_syndrome_bits).
struct SyndromeOut {
  int* flags;      // (nbt, 4) int32: 1 where the frame has an unsatisfied check
  int8_t* frozen;  // (nbt, VG, Z, 4) the bits frozen at each frame's first pass
  uint8_t* conv;   // (nbt * 4,) bool: the frame has passed
  int* iters;      // (nbt * 4,) int32: the iteration of its first pass
  int* count;      // [0] the unconverged frames after this launch
  int it;          // this iteration's number
};

// The launch's scratch (nbt * 2 + 2 ints, zero before every launch, and
// zero again when it ends, so launches that share it must not overlap:
// the caller keeps one a stream): per tile the frames with an unsatisfied check
// (bit f), or-ed by the tile's blocks, and the tile's blocks done; then the
// tiles finished and their unconverged frames.
struct SyndromeScratch {
  int* bad;
  unsigned* tickets;
  unsigned* tiles;
};

// An edge of the syndrome's table in shared memory: the variable lane of
// check lane c is c - rot, mod Z, so its bit word is at lane base + c,
// plus Z where c < rot (base = the edge's variable group times Z, less
// rot); mask its missing check lane, -1 none.
struct __align__(16) SyndromeEdge {
  int base, rot, mask;
};

// The table of the tile's check groups: cs (CG + 1 ints, the first edge of
// each, then E), then the E edges (16-byte aligned).
struct SyndromeTable {
  const int* cs;
  const SyndromeEdge* edges;
};

inline size_t syndrome_smem(int CG, int E) {
  return sizeof(int) * ((CG + 1 + 3) / 4 * 4) + sizeof(SyndromeEdge) * (size_t)E;
}

__device__ inline SyndromeTable load_syndrome_table(const FloodingTables& t, int* sm) {
  int* cs = sm;
  SyndromeEdge* edges = reinterpret_cast<SyndromeEdge*>(sm + (t.CG + 1 + 3) / 4 * 4);
  for (int i = threadIdx.x; i <= t.CG; i += blockDim.x) cs[i] = i < t.CG ? t.chk_cs[i] : t.E;
  for (int e = threadIdx.x; e < t.E; e += blockDim.x)
    edges[e] = SyndromeEdge{t.syn_vg[e] * t.Z - t.syn_rot[e], t.syn_rot[e], t.syn_mask[e]};
  __syncthreads();
  return SyndromeTable{cs, edges};
}

// The parity bytes of check lane c of group g, a lane's four frames at
// once: the xor of its d bit words (one int32 an edge; none at the
// missing lane), its d loads issued before the fold. Bit 0 of byte f is
// frame f's parity.
template <int DMAX>
__device__ __forceinline__ uint32_t check_parity(const uint32_t* words, const SyndromeTable& s,
                                                 int Z, int g, int c) {
  const int e0 = s.cs[g], d = s.cs[g + 1] - e0;
  uint32_t w[DMAX];
#pragma unroll
  for (int k = 0; k < DMAX; ++k) {
    w[k] = 0u;
    if (k < d) {
      const SyndromeEdge e = s.edges[e0 + k];
      if (c != e.mask) w[k] = words[e.base + c + (c < e.rot ? Z : 0)];
    }
  }
  uint32_t par = 0;
#pragma unroll
  for (int k = 0; k < DMAX; ++k) par ^= w[k];
  return par;
}

// The frames (bit f) whose byte of a parity word has bit 0 set.
__device__ __forceinline__ int odd_frames(uint32_t par) {
  return (par & 1u) | (par >> 7 & 2u) | (par >> 14 & 4u) | (par >> 21 & 8u);
}

// Copies the bytes of the frames in newly (bit f) of a tile's bits to
// frozen, sixteen bytes a load where both tiles are 16-byte aligned.
__device__ void freeze_frames(const int8_t* bits, int8_t* frozen, int lanes, int newly) {
  const uint32_t take = frame_bytes(newly);
  const auto pick = [take](uint32_t from, uint32_t to) { return (from & take) | (to & ~take); };
  if ((reinterpret_cast<uintptr_t>(bits) | reinterpret_cast<uintptr_t>(frozen)) % 16 == 0 &&
      lanes % 4 == 0) {
    const uint4* src = reinterpret_cast<const uint4*>(bits);
    uint4* dst = reinterpret_cast<uint4*>(frozen);
    for (int i = threadIdx.x; i < lanes / 4; i += blockDim.x) {
      const uint4 a = src[i];
      const uint4 b = take == ~0u ? a : dst[i];
      dst[i] = make_uint4(pick(a.x, b.x), pick(a.y, b.y), pick(a.z, b.z), pick(a.w, b.w));
    }
  } else {
    for (int i = threadIdx.x; i < lanes; i += blockDim.x) {
      int8_t* to = frozen + (size_t)i * kBt;
      store_word(to, pick(load_word(bits + (size_t)i * kBt), load_word(to)));
    }
  }
}

// The syndrome of the hard bits of nbt tiles, and for the streaming loop
// the freeze of the frames that pass. blockIdx.y is the tile and
// blockIdx.x a slice of its check lanes, a thread a check lane's four
// frames (check_parity); a warp ors its odd frames together after each
// pass, stops once all four are odd, and makes one atomicOr into the
// tile's scratch word. The tile's last block to finish
// (a ticket a tile, after __threadfence) takes the word and: writes the
// flags; or, for the freeze, sets iters = it and conv of the frames that
// pass for the first time, copies their bytes of bits to frozen
// (freeze_frames: only a tile with such a frame writes), and adds the
// tile's unconverged frames to the launch's count, which the last tile
// to finish writes to count. Every scratch word it used is left zero.
template <int DMAX>
__global__ void __launch_bounds__(kSyndromeThreads) fused_syndrome_kernel(
    const int8_t* bits_all, FloodingTables t, SyndromeOut o, SyndromeScratch scratch) {
  extern __shared__ __align__(16) int smem[];
  __shared__ int ctl[3];  // this block is the tile's last; the tile's odd frames; newly
  const int Z = t.Z;
  const SyndromeTable s = load_syndrome_table(t, smem);
  const size_t tile = blockIdx.y;
  const int lanes = t.VG * Z;
  const int8_t* bits = bits_all + tile * lanes * kBt;
  const uint32_t* words = reinterpret_cast<const uint32_t*>(bits);
  // check lane r = g * Z + c, r += stride, with (g, c) stepped without a
  // division; a warp stops once its frames are all odd: its other checks
  // can change nothing
  const int stride = gridDim.x * blockDim.x, n = t.CG * Z;
  const int dg = stride / Z, dc = stride - dg * Z;
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  int g = r / Z, c = r - g * Z;
  int odd = 0;
  for (int base = r - threadIdx.x % 32; base < n; base += stride) {
    if (r < n) odd |= odd_frames(check_parity<DMAX>(words, s, Z, g, c));
    odd = __reduce_or_sync(0xffffffffu, odd);
    if (odd == (1 << kBt) - 1) break;
    r += stride;
    g += dg;
    c += dc;
    if (c >= Z) {
      c -= Z;
      ++g;
    }
  }
  if ((threadIdx.x & 31) == 0 && odd) {
    atomicOr(scratch.bad + tile, odd);
    __threadfence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    ctl[0] = atomicAdd(scratch.tickets + tile, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!ctl[0]) return;
  if (threadIdx.x == 0) {
    ctl[1] = atomicExch(scratch.bad + tile, 0);
    scratch.tickets[tile] = 0;
  }
  __syncthreads();
  const int bad = ctl[1];
  if (o.flags) {
    if (threadIdx.x < kBt) o.flags[tile * kBt + threadIdx.x] = bad >> threadIdx.x & 1;
    return;
  }
  if (threadIdx.x == 0) {
    int newly = 0;
    unsigned left = 0;
    for (int f = 0; f < kBt; ++f) {
      const size_t i = tile * kBt + f;
      const bool was = o.conv[i], ok = !(bad >> f & 1);
      if (ok && !was) {
        newly |= 1 << f;
        o.iters[i] = o.it;
        o.conv[i] = 1;
      }
      left += !(was || ok);
    }
    ctl[2] = newly;
    if (left) atomicAdd(scratch.tiles + 1, left);
    __threadfence();
    if (atomicAdd(scratch.tiles, 1u) == gridDim.y - 1) {
      *o.count = static_cast<int>(atomicExch(scratch.tiles + 1, 0u));
      scratch.tiles[0] = 0;
    }
  }
  __syncthreads();
  if (ctl[2]) freeze_frames(bits, o.frozen + tile * lanes * kBt, lanes, ctl[2]);
}

// The syndrome launch by check-degree bucket (8, 16, 32 or 64). A tile is
// spread over as many blocks as let the launch's blocks all be resident at
// once (one wave), at least one, and at most one for each kMinLanes check
// lanes a thread; the card's block slots are asked once a device and
// table size by each host thread (the cache is the thread's own).
template <int DMAX>
cudaError_t syndrome_launch(const void* bits, const FloodingTables& t, const SyndromeOut& o,
                            const SyndromeScratch& scratch, int nbt, cudaStream_t stream) {
  auto kernel = fused_syndrome_kernel<DMAX>;
  const size_t smem = syndrome_smem(t.CG, t.E);
  static thread_local int cached_dev = -1, slots = 0;
  static thread_local size_t cached_smem = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && (dev != cached_dev || smem != cached_smem)) {
    int sms = 0, per_sm = 0;
    if (smem > 48 * 1024)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kSyndromeThreads, smem);
    if (err != cudaSuccess) return err;
    cached_dev = dev;
    cached_smem = smem;
    slots = sms * per_sm;
  }
  if (err != cudaSuccess) return err;
  const int lanes = t.CG * t.Z, per_block = kSyndromeThreads * kMinLanes;
  const dim3 grid(std::max(1, std::min(slots / nbt, (lanes + per_block - 1) / per_block)), nbt);
  kernel<<<grid, kSyndromeThreads, smem, stream>>>(static_cast<const int8_t*>(bits), t, o,
                                                   scratch);
  return cudaGetLastError();
}

}  // namespace
}  // namespace ldpc

// The resident decode and the check phase by degree bucket: the templates
// of csrc/message_kernels.cuh and csrc/streaming.cuh on the min-sum rule.
namespace ldpc {
namespace {

template <int DMAX, typename Msg>
struct ResidentLaunch {
  static cudaError_t run(void* msg, const void* q, void* post, void* bits,
                         void* iters, void* conv, const Tables& t, int nbt,
                         int max_iterations, int threads, float big,
                         float scale, cudaStream_t stream) {
    return flooding_launch<DMAX>(MinSumRule<Msg>{big, scale}, msg, q, post,
                                 bits, iters, conv, t, nbt, max_iterations,
                                 threads, stream);
  }
};

template <int DMAX, typename Msg>
struct CheckLaunch {
  static cudaError_t run(const void* v2c, void* c2v, const FloodingTables& t,
                         int nbt, int threads, float big, float scale,
                         cudaStream_t stream) {
    return fused_check_launch<DMAX>(MinSumRule<Msg>{big, scale}, v2c, c2v, t,
                                    nbt, threads, stream);
  }
};

}  // namespace
}  // namespace ldpc

// The phase entry points take the layout's eleven int32 tables as an array
// of device pointers (chk_cs, chk_dest, chk_rot, chk_omask, var_cs,
// var_dest, var_rot, var_omask, syn_vg, syn_rot, syn_mask) and the tile
// shape, and return the launch's cudaError_t. Messages are bf16 when
// msg_bf16, else f32; q has the messages' type. The check and variable
// phases take tiles of 4 frames (Bt) and at most 256 threads a block.

// c2v (nbt, E, Z, Bt) from v2c (nbt, E, Z, Bt); max_degree the largest
// check degree (at most 64).
extern "C" int ldpc_fused_check(const void* v2c, void* c2v,
                                const void* const* tables, int nbt, int CG,
                                int VG, int E, int Z, int Bt, int max_degree,
                                float big, float scale, int msg_bf16,
                                int threads, void* stream) {
  const FloodingTables t = ldpc::make_flooding_tables(tables, CG, VG, E, Z, Bt);
  return static_cast<int>(ldpc::by_bucket<ldpc::CheckLaunch>(
      max_degree, msg_bf16, v2c, c2v, t, nbt, threads, big, scale,
      static_cast<cudaStream_t>(stream)));
}

// v2c (nbt, E, Z, Bt) and bits (nbt, VG, Z, Bt) int8 from c2v and q
// (nbt, VG, Z, Bt); c2v null runs the initialisation.
extern "C" int ldpc_fused_var(const void* c2v, const void* q, void* v2c,
                              void* bits, const void* const* tables, int nbt,
                              int CG, int VG, int E, int Z, int Bt, float big,
                              int msg_bf16, int threads, void* stream) {
  const FloodingTables t = ldpc::make_flooding_tables(tables, CG, VG, E, Z, Bt);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      msg_bf16 ? ldpc::fused_var_launch(ldpc::MinSumRule<__nv_bfloat16>{big, 1.f}, c2v,
                                        q, v2c, bits, t, nbt, threads, s)
               : ldpc::fused_var_launch(ldpc::MinSumRule<float>{big, 1.f}, c2v, q,
                                        v2c, bits, t, nbt, threads, s));
}

// The syndrome of bits (nbt, VG, Z, 4) int8 (the tile width must be 4;
// max_degree at most 64), with scratch (nbt * 2 + 2 int32, zero, and left
// zero; no other launch may use it until this one ends). flags non-null: flags (nbt, 4) int32 out, 1 where the frame has an
// unsatisfied check, and the rest unused. flags null: the freeze of
// iteration it, in place: a frame that passes for the first time gets
// iters = it, conv = 1 (conv (nbt * 4,) bool, iters (nbt * 4,) int32) and its
// bytes of bits copied to frozen (nbt, VG, Z, 4); count[0] = the frames
// with conv 0 after it.
extern "C" int ldpc_fused_syndrome(const void* bits, void* flags, void* frozen, void* conv,
                                   void* iters, void* count, int it, void* scratch,
                                   const void* const* tables, int nbt, int CG, int VG,
                                   int E, int Z, int Bt, int max_degree, void* stream) {
  if (Bt != ldpc::kBt) return cudaErrorInvalidValue;
  const FloodingTables t = ldpc::make_flooding_tables(tables, CG, VG, E, Z, Bt);
  int* words = static_cast<int*>(scratch);
  const ldpc::SyndromeScratch s{words, reinterpret_cast<unsigned*>(words + nbt),
                                reinterpret_cast<unsigned*>(words + 2 * nbt)};
  const ldpc::SyndromeOut o{static_cast<int*>(flags), static_cast<int8_t*>(frozen),
                            static_cast<uint8_t*>(conv), static_cast<int*>(iters),
                            static_cast<int*>(count), it};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (max_degree < 1 || max_degree > 64) return cudaErrorInvalidValue;
  if (max_degree <= 8) return static_cast<int>(ldpc::syndrome_launch<8>(bits, t, o, s, nbt, st));
  if (max_degree <= 16) return static_cast<int>(ldpc::syndrome_launch<16>(bits, t, o, s, nbt, st));
  if (max_degree <= 32) return static_cast<int>(ldpc::syndrome_launch<32>(bits, t, o, s, nbt, st));
  return static_cast<int>(ldpc::syndrome_launch<64>(bits, t, o, s, nbt, st));
}

// The whole decode. It takes the ten layered tables instead (see Tables in
// layered.cuh), the tile shape (Bt must be 4) and the largest check degree
// (at most 64); threads is at most 256. msg (nbt, E, Z, 4) and post (nbt,
// VG, Z, 4) int8 scratch; q (nbt, VG, Z, 4) channel planes; bits (nbt, VG,
// Z, 4) int8 raw-channel bits in, decoded bits out; iters and conv (nbt, 4)
// int32 out.
extern "C" int ldpc_resident_flooding_decode(
    void* msg, const void* q, void* post, void* bits, void* iters, void* conv,
    const void* const* tables, int nbt, int CG, int E, int VG, int Z, int Bt,
    int max_degree, int max_iterations, int threads, float big, float scale,
    int msg_bf16, void* stream) {
  if (Bt != ldpc::kBt || threads > ldpc::kThreads) return cudaErrorInvalidValue;
  const ldpc::Tables t = ldpc::make_tables(tables, CG, E, VG, Z);
  return static_cast<int>(ldpc::by_bucket<ldpc::ResidentLaunch>(
      max_degree, msg_bf16, msg, q, post, bits, iters, conv, t, nbt,
      max_iterations, threads, big, scale, static_cast<cudaStream_t>(stream)));
}

extern "C" const char* ldpc_flooding_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
