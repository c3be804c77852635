// The resident flooding decode of the min-sum rule (f32 and bf16 messages)
// fed by a ring of bulk asynchronous copies: flooding_ring_kernel.
//
// Replaces, for the min-sum names, ldpc_toolbox_tpu/ops/
// resident_flooding_dual.py resident_flooding_dual_decode and
// resident_flooding.py resident_flooding_decode, as
// resident_flooding_kernel of csrc/message_kernels.cuh did; that template
// stays for the i8 and float rules. It computes what that kernel computes,
// bit for bit: one block a tile of four frames, all iterations in one
// launch, one message array in check-major cells; each iteration the check
// pass, the variable pass and the syndrome of the hard bits, in that order,
// with the fold, the slot-order sum, the rounding, the missing lanes, the
// freeze and the iteration count of csrc/lanes.cuh.
//
// What bounds it on an H100: the state's traffic (about 10 bytes an edge
// lane an iteration, csrc/flooding.cu), and how much of it a block keeps in
// flight. The thread-per-lane form kept a lane's loads in its registers: at
// two blocks of 256 threads an SM (128 registers a thread), 16 warps hold
// 22-45 KB of loads in flight, and each of a thread's lanes waits a round
// trip. Cut by pass at DVB-S2 rate 3/5 (B = 1024, bucket 16), the check
// pass moved 2.2 TB/s, the variable pass 2.6 and the syndrome 0.5 (its
// 4-byte gathers, a fifth of the bytes, took a third of the time).
//
// What the ring does about it: every operand a pass reads comes into
// shared memory by cp.async.bulk, whole rows of cells at a time, completed
// on an mbarrier, one copy a row's window and no register held; two stages,
// the next item's copies in flight while the block computes this one from
// shared memory. An item is a run of whole groups or a chunk of one
// group's lanes:
// - the check pass: the d message rows of a check group (contiguous:
//   check-major cells, one window), or a chunk of its lanes across its d
//   rows;
// - the variable pass: the q row of a variable group and its message rows,
//   a whole row as it lies, or a chunk's window from the rotation's start
//   (two copies where it wraps at Z);
// - the syndrome: the hard-bit rows of a check group's variable groups,
//   the same way.
// A stage's size comes from the launch (ops/resident_flooding.py
// ring_stage_bytes: the largest whole group, at least 32 KB, within the
// shared memory two blocks an SM leave beside their tables), and each pass
// cuts its groups to it: runs of whole groups while they fit, else chunks
// of lanes. A bulk copy takes 16-byte aligned addresses and sizes, so a
// window is copied as the 16-byte rows that hold it; a lane's cell lies at
// its offset in them. The cells a copy takes besides its window are never
// read, so the message array and the hard bits carry 16 bytes of slack at
// their end. Results go back by plain stores, which hold no register once
// issued: each cell has one writer in a pass, so no copy of the same pass
// reads a cell another item writes, and each pass's stores are fenced to
// the copies' proxy (fence.proxy.async) before the next pass's first copy.
// Warp 0 issues the copies, a lane a row.
//
// What bounds it now (DVB-S2 rate 3/5, B = 1024, bucket 16, an H100): each
// pass's arithmetic, not its bytes. Without its copies (the stage left as
// it was) a pass ran only 7 % (check), 20 % (variable) and 22 % (syndrome)
// faster; without its arithmetic the syndrome's copies took 31 % of its
// time. The variable pass moves 3.0 TB/s; the check pass's fold alone is
// some 60 SASS instructions an edge of a lane. Forms that lost in turns
// on the card: warps running ahead of each other between stages (empty
// barriers, +9 %), three smaller stages (+64 %), the check lanes in runs of
// whole rounds of the block's threads (+10 %: the runs' offsets cost more
// than the imbalance they remove) and two lanes a thread interleaved
// (+19-35 %: the second lane's predicated work issues too).

#pragma once

#include "message_kernels.cuh"

namespace ldpc {
namespace ring {

// Stages of the ring, and the bytes before them: their mbarriers.
constexpr int kStages = 2;
constexpr int kHeadBytes = 128;

__host__ __device__ constexpr int round16(int b) { return (b + 15) / 16 * 16; }
__host__ __device__ constexpr int floor16(int b) { return b / 16 * 16; }
// The stage bytes a window of n lanes of lb bytes takes: its 16-byte rows,
// at most one more than n lanes fill; a window that wraps at Z is two.
__host__ __device__ constexpr int window_bytes(int n, int lb) { return round16(n * lb) + 16; }
__host__ __device__ constexpr int wrapped_bytes(int n, int lb) { return round16(n * lb) + 48; }
// A rotated row's slot: the whole row as it lies (n = Z), or a chunk of n
// lanes from the rotation's start, which may wrap.
__host__ __device__ constexpr int row_bytes(int n, int Z, int lb) {
  return n == Z ? window_bytes(Z, lb) : wrapped_bytes(n, lb);
}
// The low 32 bits of an address: enough for its 16-byte shift.
__device__ __forceinline__ uint32_t low_bits(const void* p) {
  return static_cast<uint32_t>(reinterpret_cast<uintptr_t>(p));
}
// The stage offset of lane c of a whole row whose address's low bits are
// row and whose slot is at slot.
__device__ __forceinline__ uint32_t in_row(uint32_t slot, uint32_t row, int c, int lb) {
  return slot + (row & 15u) + c * lb;
}

__device__ __forceinline__ uint32_t shared_address(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void barrier_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(shared_address(bar))
               : "memory");
}
__device__ __forceinline__ void barrier_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}
// The producer's arrival, with the bytes the stage's copies bring.
__device__ __forceinline__ void barrier_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   shared_address(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void barrier_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred ready;\n"
      "RING_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 ready, [%0], %1;\n"
      "@!ready bra RING_WAIT;\n"
      "}\n" ::"r"(shared_address(bar)),
      "r"(parity)
      : "memory");
}
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];" ::"r"(shared_address(dst)),
      "l"(src), "r"(bytes), "r"(shared_address(bar))
      : "memory");
}
// Orders this thread's stores to device memory before later bulk copies.
__device__ __forceinline__ void fence_stores_for_copies() {
  asm volatile("fence.proxy.async.global;" ::: "memory");
}

__device__ __forceinline__ uintptr_t down16(uintptr_t a) { return a & ~uintptr_t(15); }
__device__ __forceinline__ uintptr_t up16(uintptr_t a) { return (a + 15) & ~uintptr_t(15); }

// Lanes [a, a + n) mod Z of a row of Z lanes of lb bytes (row: its lane
// 0): [a, a + n1) with n1 = min(n, Z - a), then [0, n - n1), each copied as
// the 16-byte rows that hold it, the second right after the first in the
// row's slot. at(i, lb) is lane a + i's (mod Z) offset in the slot.
struct Window {
  uintptr_t src1, src2;
  uint32_t len1, len2, sh1, sh2;
  int n1;

  __device__ __forceinline__ Window(const void* row, int Z, int lb, int a, int n) {
    const uintptr_t base = reinterpret_cast<uintptr_t>(row);
    const uintptr_t x1 = base + (size_t)a * lb;
    n1 = min(n, Z - a);
    src1 = down16(x1);
    len1 = static_cast<uint32_t>(up16(x1 + (size_t)n1 * lb) - src1);
    sh1 = static_cast<uint32_t>(x1 - src1);
    src2 = down16(base);
    len2 = n1 < n ? static_cast<uint32_t>(up16(base + (size_t)(n - n1) * lb) - src2) : 0u;
    sh2 = len1 + static_cast<uint32_t>(base - src2);
  }
  __device__ __forceinline__ uint32_t at(int i, int lb) const {
    return i < n1 ? sh1 + i * lb : sh2 + (i - n1) * lb;
  }
  __device__ __forceinline__ uint32_t bytes() const { return len1 + len2; }
  __device__ __forceinline__ void load(char* slot, uint64_t* bar) const {
    bulk_load(slot, reinterpret_cast<const void*>(src1), len1, bar);
    if (len2) bulk_load(slot + len1, reinterpret_cast<const void*>(src2), len2, bar);
  }
};

// An item of a pass: the groups [a, b), lanes [l0, l0 + n) of each; n = Z
// for a run of whole groups (b = a + 1 otherwise).
struct Item {
  int a, b, l0, n;
};

// Walks a pass's items over groups whose edges are cs[g] .. cs[g + 1]
// (cs[G] the end): whole(a, b) is the stage bytes of the run [a, b) of
// whole groups, lanes(d) the most lanes a chunk of a group of d edges
// takes in a stage of stage bytes (less than Z where the group does not
// fit whole).
template <class Whole, class Lanes>
struct Cursor {
  const int* cs;
  int G, Z, stage;
  Whole whole;
  Lanes lanes;
  int g = 0, l0 = 0;

  __device__ __forceinline__ bool next(Item& it) {
    if (g >= G) return false;
    if (l0 == 0 && whole(g, g + 1) <= stage) {
      int b = g + 1;
      while (b < G && whole(g, b + 1) <= stage) ++b;
      it = Item{g, b, 0, Z};
      g = b;
    } else {
      const int n = min(lanes(cs[g + 1] - cs[g]), Z - l0);
      it = Item{g, g + 1, l0, n};
      l0 += n;
      if (l0 >= Z) {
        ++g;
        l0 = 0;
      }
    }
    return true;
  }
};

template <class Whole, class Lanes>
__device__ __forceinline__ Cursor<Whole, Lanes> cursor(const int* cs, int G, int Z,
                                                       int stage, Whole whole, Lanes lanes) {
  return Cursor<Whole, Lanes>{cs, G, Z, stage, whole, lanes};
}

// A row of an item: its window and its slot's offset in the stage.
struct Row {
  Window win;
  uint32_t slot;
};

// Warp 0 loads an item's nrows rows into a stage (row(k): row k, a Row);
// the stage's barrier expects their bytes before any copy is issued.
template <class Rows>
__device__ __forceinline__ void load_rows(char* stage, uint64_t* bar, int nrows, Rows row) {
  const int lane = threadIdx.x & 31;
  uint32_t bytes = 0;
  for (int k = lane; k < nrows; k += 32) bytes += row(k).win.bytes();
  bytes = __reduce_add_sync(0xffffffffu, bytes);
  if (lane == 0) barrier_expect(bar, bytes);
  __syncwarp();
  for (int k = lane; k < nrows; k += 32) {
    const Row r = row(k);
    r.win.load(stage + r.slot, bar);
  }
}


// One pass over a cursor's items through the ring. seq numbers the ring's
// items since the launch: item s fills stage s % kStages, whose barrier it
// completes for the (s / kStages)-th time. Warp 0 loads the first
// kStages items, then each later one into the stage the block has just
// finished (load(item, stage, bar)); every thread waits for an item's
// stage, computes it (compute(item, stage)), and passes a block barrier
// before the stage is refilled. The pass ends with its stores fenced
// and a block barrier, so the next pass's copies see them.
template <class Cur, class Load, class Compute>
__device__ __forceinline__ void ring_pass(char* stages, uint64_t* bars, int stage_bytes,
                                          uint32_t& seq, Cur cur, Load&& load,
                                          Compute&& compute) {
  const bool producer = threadIdx.x < 32;
  Cur ahead = cur;
  Item it;
  if (producer) {
    for (int s = 0; s < kStages && ahead.next(it); ++s) {
      const uint32_t k = (seq + s) % kStages;
      load(it, stages + k * stage_bytes, bars + k);
    }
  }
  for (; cur.next(it); ++seq) {
    const uint32_t k = seq % kStages;
    barrier_wait(bars + k, (seq / kStages) & 1u);
    compute(it, stages + k * stage_bytes);
    __syncthreads();
    Item later;
    if (producer && ahead.next(later)) load(later, stages + k * stage_bytes, bars + k);
  }
  fence_stores_for_copies();
  __syncthreads();
}

// A stage's cell of type T at byte offset off.
template <typename T>
__device__ __forceinline__ auto cell(const char* stage, uint32_t off) {
  return load_raw(reinterpret_cast<const T*>(stage + off));
}

// A lane's four values stored as its cell: bf16 two at a time (one
// rounding to nearest even each, as store4's).
__device__ __forceinline__ void store_cell(float* p, const F4& a) { store4(p, a); }
__device__ __forceinline__ void store_cell(__nv_bfloat16* p, const F4& a) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a.v[0], a.v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(a.v[2], a.v[3]);
  *reinterpret_cast<uint2*>(p) = make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                                            *reinterpret_cast<const uint32_t*>(&hi));
}

}  // namespace ring

// The whole flooding decode of one tile per block under the min-sum rule
// (messages of type Msg: f32 or bf16): the contract of
// resident_flooding_kernel (csrc/message_kernels.cuh), with a thread a
// lane's four frames and a stage of stage_bytes (a multiple of 16) in
// each of the ring's stages, after the tables.
template <int DMAX, typename Msg>
__global__ void __launch_bounds__(kThreads, 2) flooding_ring_kernel(
    Msg* msg_all, const Msg* q_all, int8_t* post_all, int8_t* bits_all, int* iters_out,
    int* conv_out, Tables t, int max_iterations, MinSumRule<Msg> rule, int stage_bytes) {
  using namespace ring;
  constexpr int LB = kBt * sizeof(Msg);  // a lane's cell
  constexpr int HB = kBt;                // a lane's hard-bit word
  extern __shared__ __align__(16) int smem[];
  const size_t tile = blockIdx.x;
  const int Z = t.Z, vn = t.VG * Z;
  const LaneTables lt = load_tables(t, smem + kCtlInts);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + kCtlInts + table_ints(t.CG, t.E, t.VG));
  char* stages = reinterpret_cast<char*>(bars) + kHeadBytes;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) barrier_init(bars + s);
    barrier_init_fence();
  }
  Msg* msg = msg_all + tile * t.E * Z * kBt;
  const Msg* q = q_all + tile * vn * kBt;
  int8_t* post = post_all + tile * vn * kBt;
  int8_t* bits = bits_all + tile * vn * kBt;
  const uint32_t mlo = low_bits(msg), plo = low_bits(post);
  // v2c = q at every edge
  for (int r = threadIdx.x; r < vn; r += blockDim.x) {
    const int vg = r / Z, w = r % Z;
    const auto qr = load4(q + (size_t)r * kBt);
    for (int p = lt.var_cs[vg]; p < lt.var_cs[vg + 1]; ++p)
      store4(var_cell(msg, lt, p, w), qr);
  }
  fence_stores_for_copies();
  const int* ccs = lt.chk_cs;
  const int* vcs = lt.var_cs;
  const int S = stage_bytes;
  // the items of each pass (Cursor)
  const auto chk_items = cursor(
      ccs, t.CG, Z, S, [=](int a, int b) { return window_bytes((ccs[b] - ccs[a]) * Z, LB); },
      [=](int d) { return max(1, floor16(S / d - 16) / LB); });
  const auto var_items = cursor(
      vcs, t.VG, Z, S,
      [=](int a, int b) {
        return window_bytes((b - a) * Z, LB) + (vcs[b] - vcs[a]) * window_bytes(Z, LB);
      },
      [=](int d) { return max(1, floor16((S - 16 - 48 * d) / (1 + d)) / LB); });
  const auto syn_items = cursor(
      ccs, t.CG, Z, S, [=](int a, int b) { return (ccs[b] - ccs[a]) * window_bytes(Z, HB); },
      [=](int d) { return max(1, floor16(S / d - 48) / HB); });
  uint32_t seq = 0;
  // lane r of an item's (b - a) n lanes: group a + r / n, lane l0 + r % n
  // (stepped without a division)
  const auto each_lane = [](const Item& it, auto&& fn) {
    const int lanes = (it.b - it.a) * it.n, step = blockDim.x;
    int r = threadIdx.x, j = r / it.n, i = r - j * it.n;
    for (; r < lanes; r += step) {
      fn(it.a + j, it.l0 + i);
      for (i += step; i >= it.n; i -= it.n) ++j;
    }
  };

  decode_tile4<DMAX>(
      post, bits, iters_out, conv_out, lt, max_iterations, smem, [&](int, int* bad) {
        // check pass: a run of whole groups is one window over their rows;
        // a chunk's row k is its own window, in slot k
        ring_pass(
            stages, bars, S, seq, chk_items,
            [&](const Item& it, char* stage, uint64_t* bar) {
              const bool whole = it.n == Z;
              const int lanes = (ccs[it.b] - ccs[it.a]) * Z;
              load_rows(stage, bar, whole ? 1 : ccs[it.b] - ccs[it.a], [&](int k) {
                const int e = ccs[it.a] + k;
                return whole ? Row{
                                   Window(msg + (size_t)e * Z * kBt, lanes, LB, 0, lanes), 0u}
                             : Row{
                                   Window(msg + (size_t)e * Z * kBt, Z, LB, it.l0, it.n),
                                   static_cast<uint32_t>(k * window_bytes(it.n, LB))};
              });
            },
            [&](const Item& it, const char* stage) {
              const bool whole = it.n == Z;
              const int first = ccs[it.a], lanes = (ccs[it.b] - first) * Z;
              const Window all(msg + (size_t)first * Z * kBt, lanes, LB, 0, lanes);
              const uint32_t wb = window_bytes(it.n, LB);
              each_lane(it, [&](int g, int c) {
                const int e0 = ccs[g], d = ccs[g + 1] - e0;
                // the stage offset of the cell (e0 + k, c): in a run of whole
                // groups the rows follow each other in one window; a chunk's
                // row k is its own, in slot k
                const uint32_t whole0 = all.sh1 + ((e0 - first) * Z + c) * LB;
                const auto at = [&](int k) -> uint32_t {
                  if (whole) return whole0 + k * Z * LB;
                  const uint32_t x = mlo + ((e0 + k) * Z + it.l0) * LB;
                  return k * wb + (x & 15u) + (c - it.l0) * LB;
                };
                typename MinSumRule<Msg>::template Check<DMAX> check(rule);
                typename Fold<DMAX>::Mask missing = 0;  // bit k: slot k is the missing lane
#pragma unroll
                for (int k = 0; k < DMAX; ++k) {
                  if (k < d) {
                    const F4 v = unpack(cell<Msg>(stage, at(k)));
                    const bool miss = c == lt.syn_mask[e0 + k];
                    missing |= static_cast<typename Fold<DMAX>::Mask>(miss) << k;
                    F4 x;
#pragma unroll
                    for (int f = 0; f < kBt; ++f) x.v[f] = miss ? rule.big : v.v[f];
                    check.set(k, x);
                  }
                }
                F4 inputs[DMAX];  // the min-sum outputs come from the fold alone
                Msg* out0 = msg + ((size_t)e0 * Z + c) * kBt;
                check.outputs(inputs, d, [&](int k, const F4& o) {
                  const bool miss = missing >> k & 1;
                  F4 out;
#pragma unroll
                  for (int f = 0; f < kBt; ++f) out.v[f] = miss ? 0.f : o.v[f];
                  store_cell(out0 + (size_t)k * Z * kBt, out);
                });
              });
            });
        // variable pass: the q window of the item's groups, then the
        // message rows of their edges in var-major order: a whole row as it
        // lies, or a chunk from the rotation's start
        ring_pass(
            stages, bars, S, seq, var_items,
            [&](const Item& it, char* stage, uint64_t* bar) {
              const int nq = (it.b - it.a) * it.n;
              const uint32_t qb = window_bytes(nq, LB), rb = row_bytes(it.n, Z, LB);
              load_rows(stage, bar, 1 + vcs[it.b] - vcs[it.a], [&](int k) {
                if (k == 0)
                  return Row{
                      Window(q + (size_t)it.a * Z * kBt, it.n == Z ? nq : Z, LB, it.l0, nq), 0u};
                const int p = vcs[it.a] + k - 1;
                return Row{
                    Window(msg + (size_t)lt.rec_pz[p] * kBt, Z, LB,
                           it.n == Z ? 0 : minus_mod(it.l0, lt.rec_rot[p], Z), it.n),
                    qb + (k - 1) * rb};
              });
            },
            [&](const Item& it, const char* stage) {
              const int nq = (it.b - it.a) * it.n;
              const uint32_t qb = window_bytes(nq, LB), rb = row_bytes(it.n, Z, LB);
              const Window qw(q + (size_t)it.a * Z * kBt, it.n == Z ? nq : Z, LB, it.l0, nq);
              each_lane(it, [&](int vg, int w) {
                const int i = w - it.l0;
                // the stage offset of var-major edge p's cell at lane w
                const auto at = [&](int p) {
                  const uint32_t slot = qb + (p - vcs[it.a]) * rb;
                  if (it.n == Z)
                    return in_row(slot, mlo + lt.rec_pz[p] * LB, minus_mod(w, lt.rec_rot[p], Z),
                                  LB);
                  const Window win(msg + (size_t)lt.rec_pz[p] * kBt, Z, LB,
                                   minus_mod(it.l0, lt.rec_rot[p], Z), it.n);
                  return slot + win.at(i, LB);
                };
                const int p0 = vcs[vg], p1 = vcs[vg + 1];
                F4 tot = unpack(cell<Msg>(stage, qw.at((vg - it.a) * it.n + i, LB)));
                for (int p = p0; p < p1; ++p) {
                  const F4 y = unpack(cell<Msg>(stage, at(p)));
#pragma unroll
                  for (int f = 0; f < kBt; ++f) tot.v[f] = add_rn(tot.v[f], y.v[f]);
                }
                store_hard(post + ((size_t)vg * Z + w) * kBt, tot);
                for (int p = p0; p < p1; ++p) {
                  const F4 y = unpack(cell<Msg>(stage, at(p)));
                  F4 o;
#pragma unroll
                  for (int f = 0; f < kBt; ++f) o.v[f] = sub_rn(tot.v[f], y.v[f]);
                  store_cell(var_cell(msg, lt, p, w), o);
                }
              });
            });
        // syndrome: the hard-bit rows of each check edge's variable group,
        // whole as they lie or a chunk from its lift shift's start
        uint32_t odd = 0;
        ring_pass(
            stages, bars, S, seq, syn_items,
            [&](const Item& it, char* stage, uint64_t* bar) {
              load_rows(stage, bar, ccs[it.b] - ccs[it.a], [&](int k) {
                const int e = ccs[it.a] + k;
                return Row{
                    Window(post + (size_t)lt.qbase[e] * kBt, Z, HB,
                           it.n == Z ? 0 : minus_mod(it.l0, lt.syn_rot[e], Z), it.n),
                    static_cast<uint32_t>(k * row_bytes(it.n, Z, HB))};
              });
            },
            [&](const Item& it, const char* stage) {
              const uint32_t rb = row_bytes(it.n, Z, HB);
              each_lane(it, [&](int g, int c) {
                const int e0 = ccs[g], d = ccs[g + 1] - e0;
                uint32_t h[DMAX];
#pragma unroll
                for (int k = 0; k < DMAX; ++k) {
                  if (k < d) {
                    const int e = e0 + k;
                    const uint32_t slot = (e - ccs[it.a]) * rb;
                    const uint32_t off =
                        it.n == Z
                            ? in_row(slot, plo + lt.qbase[e] * HB, minus_mod(c, lt.syn_rot[e], Z),
                                     HB)
                            : slot + Window(post + (size_t)lt.qbase[e] * kBt, Z, HB,
                                            minus_mod(it.l0, lt.syn_rot[e], Z), it.n)
                                         .at(c - it.l0, HB);
                    h[k] = __vcmpne4(*reinterpret_cast<const uint32_t*>(stage + off), 0u) &
                           0x01010101u;
                  }
                }
                uint32_t par = 0;
#pragma unroll
                for (int k = 0; k < DMAX; ++k)
                  if (k < d && c != lt.syn_mask[e0 + k]) par ^= h[k];
                odd |= (par & 1u) | (par >> 7 & 2u) | (par >> 14 & 4u) | (par >> 21 & 8u);
              });
            });
        report_odd(odd, bad);
      });
}

// Launches flooding_ring_kernel<DMAX, Msg> on nbt tiles (see the C entry
// ldpc_resident_flooding_decode of csrc/flooding.cu), whole warps a block,
// at most kThreads, stage_bytes a stage.
template <int DMAX, typename Msg>
cudaError_t flooding_ring_launch(const MinSumRule<Msg>& rule, void* msg, const void* q,
                                 void* post, void* bits, void* iters, void* conv,
                                 const Tables& t, int nbt, int max_iterations, int threads,
                                 int stage_bytes, cudaStream_t stream) {
  if (threads > kThreads || threads < 32 || threads % 32 || stage_bytes <= 0 || stage_bytes % 16)
    return cudaErrorInvalidValue;
  auto kernel = flooding_ring_kernel<DMAX, Msg>;
  // all the SM's shared memory for its blocks (the rest is L1)
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  return launch(kernel, nbt, threads,
                smem_bytes(t, 0) + ring::kHeadBytes + (size_t)ring::kStages * stage_bytes,
                stream, static_cast<Msg*>(msg), static_cast<const Msg*>(q),
                static_cast<int8_t*>(post), static_cast<int8_t*>(bits),
                static_cast<int*>(iters), static_cast<int*>(conv), t, max_iterations, rule,
                stage_bytes);
}

}  // namespace ldpc
