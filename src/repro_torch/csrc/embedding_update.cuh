// Fused sparse backward + row update on the sorted lookup stream: for each run
// of equal rows, acc = sum(wgt * dY[bag]) in sorted order, then one step of
// the row's optimizer on that row only, in place.  Eight kinds share one walk
// and differ only in their step (the epilogue): the split pair hi (bf16 bits)
// / lo (low 16 bits) or an fp32 W, stepped w = fmaf(-lr, acc, w); or an fp32
// W with one state slab S (momentum, Adagrad, row-wise Adagrad, the
// frequency-adaptive step, and momentum and Adagrad with a bf16 S written
// back with the seeded stochastic rounding).  dY is bf16 (the row-mode wire)
// or fp32 (the reference's own input), a template argument of the walk.
//
// Replaces repro/kernels/embedding_update.py::_kernel_split :82,
// _kernel_fp32 :114, _kernel_momentum :151, _kernel_adagrad :169,
// _make_kernel_adagrad_rowwise :190, _kernel_freq :219,
// _kernel_momentum_bf16 :243 and _kernel_adagrad_bf16 :268.
//
// What bounds it on an H100.  Bitwise parity with the reference fixes the
// order of each run's sum, so a run's adds are one dependent fp32 chain, one
// add a lookup (two chains a lane, columns c and c + 1).  On a skewed stream
// that chain is the bound: zipf(1.05) sends about half of a table's lookups
// to its row 0, 212,152 lookups at dlrm-small's batch, 4 cycles each.
// Otherwise it is the bytes of the touched rows (read and written once) and
// of the cotangent rows.
//
// The walk has two schedules, picked per run with no host sync:
//
//  - Long runs (kLongRun = 512 positions or more).  list_long_runs_kernel
//    writes (start, row) of each into a device list (an atomic counter,
//    capacity L / kLongRun + 1; the wrapper allocates the size the library
//    returns); long_run_kernel gives a block to each of the list's slots,
//    and a block past the count exits at once.  In such a block one consumer warp does
//    the run's adds, two chains a lane (columns c and c + 1), from a ring of
//    stages in shared memory guarded by mbarriers.  A stage is one segment
//    (32 positions): the positions' cotangent rows, 64 columns (4 KB bf16,
//    8 KB fp32), their weights and masks.  The ring's 8 stages cover a
//    global round trip several times over at the consumer's pace.  Seven
//    producer warps fill the stages, segment j by warp j % 7, with cp.async
//    only (16-byte chunks where the rows allow; on the narrow instances the
//    aligned 4-byte words of each position's row span, and the positions'
//    bags, from which the consumer finds where in a word each row starts):
//    no thread waits for a copy,
//    each lane's arrival on the stage's full barrier fires when its copies
//    land, and a producer executes no release, which would wait for the
//    bags it keeps in flight for its next four rounds.  The consumer
//    multiplies and adds; it reads the next stage while it adds the current one, and
//    asks whether the stage after that is full before its adds and reads the
//    answer after them.
//  - Short runs: short_run_kernel, one warp a window of 32 positions, as
//    before: it finds the runs that start in the window with one ballot,
//    skips the long ones by the same test (rows[s + kLongRun - 1] ==
//    rows[s]) and walks each other run to its end, one segment in registers
//    ahead.
//    Within a segment, consecutive lookups of one bag with one weight form a
//    group; a segment of at most kFew groups loads one cotangent row and
//    rounds one product a group, and adds it once a lookup: the same adds
//    with the same operands as one a position.  It runs on a second stream
//    beside long_run_kernel, forked from the caller's and joined back.
//
// The row's old values are loaded before its sums and written once at the
// run's end.  What now bounds the long schedule (tools/ablate_row_update.py,
// PERF.md): the consumer, at over 500 cycles a segment against its two
// chains' 128: without its adds the row-0 run takes half the time; without
// the producers' cotangent copies, or with twice the stages, about the same.
// The design note is in repro_torch/kernels/embedding_update.py.
//
// This header holds the kernels and their launch; the extern "C" launchers
// are split over four sources that include it, two row kinds a source, so
// that kernels/build.py compiles the four at once: embedding_update.cu
// (split, fp32, and the schedule's sizes), embedding_update_state.cu
// (momentum, adagrad), embedding_update_rowwise.cu (adagrad_rowwise, freq)
// and embedding_update_bf16.cu (momentum_bf16, adagrad_bf16).
#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

#include "hopper.cuh"

namespace {

constexpr int kWarps = 8;  // a block: in a long run's block, warp 0 consumes, 1-7 produce
constexpr int kSeg = 32;  // positions of a run read at once, one per lane
constexpr unsigned kFull = 0xffffffffu;
constexpr int kFew = 4;  // a segment of at most this many groups is summed group by group
constexpr int kStages = 8;  // the long-run ring's depth
// Producer warps: fewer than the stages, so that no two producers ever wait
// on one stage's empty barrier for rounds of the same parity
constexpr int kProducers = kWarps - 1 < kStages - 1 ? kWarps - 1 : kStages - 1;
constexpr int kLongBlocks = 1024;  // at most this many blocks take the long runs' list
// Runs of this many positions or more take the long schedule (256-4096 were
// within 1 % of one another on dlrm-small's zipf stream: PERF.md)
constexpr int kLongRun = 512;

// ------------------------------------------------------------- the cotangent --

// dY's type: a lane's two columns c, c + 1 of a row as one load (a 32-bit
// word of two bf16, or a float2), decoded to fp32 exactly
template <class TY>
struct Cot;

template <>
struct Cot<uint16_t> {
  using Pair = uint32_t;
  static __device__ __forceinline__ Pair load(const uint16_t* __restrict__ dY, int64_t i) {
    return __ldg(reinterpret_cast<const unsigned int*>(dY + i));
  }
  static __device__ __forceinline__ Pair zero() { return 0u; }
  static __device__ __forceinline__ float first(Pair v) { return __uint_as_float(v << 16); }
  static __device__ __forceinline__ float second(Pair v) {
    return __uint_as_float(v & 0xffff0000u);
  }
};

template <>
struct Cot<float> {
  using Pair = float2;
  static __device__ __forceinline__ Pair load(const float* __restrict__ dY, int64_t i) {
    return __ldg(reinterpret_cast<const float2*>(dY + i));
  }
  static __device__ __forceinline__ Pair zero() { return make_float2(0.f, 0.f); }
  static __device__ __forceinline__ float first(Pair v) { return v.x; }
  static __device__ __forceinline__ float second(Pair v) { return v.y; }
};

// wgt * dY for the lane's two columns, each product rounded once
template <class TY>
__device__ __forceinline__ float2 product(typename Cot<TY>::Pair v, float w) {
  return make_float2(__fmul_rn(Cot<TY>::first(v), w), __fmul_rn(Cot<TY>::second(v), w));
}

// The lane's pair of columns c, c + 1 of dY at flat offset i: one load, or
// with kNarrow (an odd E, or a pointer off the pair's alignment) one load a
// column, the second only where `two` (column c + 1 lies in the row), +0
// past it
template <class TY, bool kNarrow>
__device__ __forceinline__ typename Cot<TY>::Pair load_pair(const TY* __restrict__ dY, int64_t i,
                                                            bool two) {
  if constexpr (!kNarrow) {
    return Cot<TY>::load(dY, i);
  } else if constexpr (sizeof(TY) == 2) {
    const uint32_t x0 = __ldg(reinterpret_cast<const unsigned short*>(dY) + i);
    const uint32_t x1 = two ? __ldg(reinterpret_cast<const unsigned short*>(dY) + i + 1) : 0u;
    return x0 | (x1 << 16);
  } else {
    return make_float2(__ldg(dY + i), two ? __ldg(dY + i + 1) : 0.f);
  }
}

// ----------------------------------------------------------------- the stream --

struct Stream {
  const int32_t* __restrict__ rows;
  const int32_t* __restrict__ bags;
  const int32_t* __restrict__ msk;
  const float* __restrict__ wgt;
  int64_t L;
};

// Lane l holds position q of the stream; row -1, bag -1 and weight 0 at or
// past lim.  A masked lookup keeps bag -1 and weight 0: it loads nothing and
// adds +0.  A long run's producers know the run's extent and skip the rows.
struct Seg {
  int32_t row, bag;
  float wgt;
};

template <bool kRow>
__device__ __forceinline__ Seg load_seg(const Stream& sm, int64_t q, int64_t lim) {
  Seg s{-1, -1, 0.f};
  if (q < lim) {
    if (kRow) s.row = __ldg(sm.rows + q);
    const int32_t m = __ldg(sm.msk + q), b = __ldg(sm.bags + q);  // all loads in flight at once
    const float w = __ldg(sm.wgt + q);
    s.bag = m ? b : -1;
    s.wgt = m ? w : 0.f;
  }
  return s;
}

// Whether a run of row r starting at p is long: kLongRun positions or more.
// The list and the short-run walk decide by this one test (the walk inlines
// it).
__device__ __forceinline__ bool long_run(const int32_t* __restrict__ rows, int64_t p, int32_t r,
                                         int64_t L) {
  return p + kLongRun - 1 < L && __ldg(rows + p + kLongRun - 1) == r;
}

// The long runs' list for a stream of L positions: its slots (runs of
// kLongRun positions are disjoint, so at most L / kLongRun of them) and its
// size in int64 words, the count and then (start, row) a slot.  The one place
// its capacity is decided: the wrapper allocates what
// embedding_update_list_words returns.
__host__ __device__ constexpr int64_t list_slots(int64_t L) { return L / kLongRun + 1; }
__host__ __device__ constexpr int64_t list_words(int64_t L) { return 1 + 2 * list_slots(L); }

// What a segment's sums need: n, the positions of the run in it (a prefix:
// the stream is sorted and the segment starts inside the run), and which of
// them start a group of equal (bag, weight).
struct Plan {
  int n;
  unsigned groups;
  bool few;  // at most kFew groups: summed group by group
};

__device__ __forceinline__ Plan plan_seg(const Seg& s, int n) {
  const int lane = threadIdx.x & 31;
  const int32_t pb = __shfl_up_sync(kFull, s.bag, 1);
  const float pw = __shfl_up_sync(kFull, s.wgt, 1);
  const unsigned g = __ballot_sync(kFull, lane < n && (lane == 0 || s.bag != pb || s.wgt != pw));
  return Plan{n, g, __popc(g) <= kFew};
}

// ------------------------------------------------------ short runs: registers --

// Issue the loads of a segment's cotangent rows (this lane's columns c,
// c + 1): one a group, into v[0..3], or one a position, into v[0..31].
// Masked positions (bag -1) load nothing.
template <class TY, bool kNarrow>
__device__ __forceinline__ void load_rows(typename Cot<TY>::Pair (&v)[kSeg], const Seg& s,
                                          const Plan& p, const TY* __restrict__ dY, int E, int c,
                                          bool active) {
  const bool two = c + 1 < E;
  if (p.few) {
    unsigned g = p.groups;
#pragma unroll
    for (int j = 0; j < kFew; ++j) {
      const int32_t bag = __shfl_sync(kFull, s.bag, g ? __ffs(g) - 1 : 0);
      v[j] = (g && active && bag >= 0)
                 ? load_pair<TY, kNarrow>(dY, static_cast<int64_t>(bag) * E + c, two)
                 : Cot<TY>::zero();
      g &= g - 1;
    }
    return;
  }
  const int32_t mine = (threadIdx.x & 31) < p.n ? s.bag : -1;
  int32_t bg[kSeg];
#pragma unroll
  for (int u = 0; u < kSeg; ++u) bg[u] = __shfl_sync(kFull, mine, u);
#pragma unroll
  for (int u = 0; u < kSeg; ++u)
    v[u] = (active && bg[u] >= 0)
               ? load_pair<TY, kNarrow>(dY, static_cast<int64_t>(bg[u]) * E + c, two)
               : Cot<TY>::zero();
}

// acc += product, cnt times, in order: one group's lookups
__device__ __forceinline__ void add_repeated(float& a0, float& a1, float2 g, int cnt) {
  for (; cnt >= 4; cnt -= 4) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a0 = __fadd_rn(a0, g.x);
      a1 = __fadd_rn(a1, g.y);
    }
  }
  for (; cnt > 0; --cnt) {
    a0 = __fadd_rn(a0, g.x);
    a1 = __fadd_rn(a1, g.y);
  }
}

// acc += (msk ? wgt * dY : 0) over the segment's positions, in order,
// unfused: the product and the sum each round once, as the plain version's
// do.  Masked positions and those past n add +0 (v = 0, w = 0).
template <class TY>
__device__ __forceinline__ void add_rows(float& a0, float& a1,
                                         const typename Cot<TY>::Pair (&v)[kSeg], const Seg& s,
                                         const Plan& p) {
  if (p.few) {
    unsigned g = p.groups;
#pragma unroll
    for (int j = 0; j < kFew; ++j) {
      if (!g) break;  // warp-uniform
      const int u = __ffs(g) - 1;
      g &= g - 1;
      const int end = g ? __ffs(g) - 1 : p.n;
      add_repeated(a0, a1, product<TY>(v[j], __shfl_sync(kFull, s.wgt, u)), end - u);
    }
    return;
  }
  const float mine = (threadIdx.x & 31) < p.n ? s.wgt : 0.f;
  float w[kSeg];
#pragma unroll
  for (int u = 0; u < kSeg; ++u) w[u] = __shfl_sync(kFull, mine, u);
#pragma unroll
  for (int u = 0; u < kSeg; ++u) {
    const float2 g = product<TY>(v[u], w[u]);
    a0 = __fadd_rn(a0, g.x);
    a1 = __fadd_rn(a1, g.y);
  }
}

// The short schedule: one warp adds the run of `row` that starts at s,
// columns c and c + 1, to (a0, a1) in sorted order, onto the values they
// hold.  The next segment's stream and cotangent rows are loaded before
// this segment's are summed.  Returns whether any lookup of the run is valid
// (msk != 0): a ballot over the run's positions in each segment, so a run of
// the masked tail alone is dead, and the last row's run, which holds its
// valid lookups and then the masked tail, is live.
template <class TY, bool kNarrow>
__device__ __forceinline__ bool sum_short(const Stream& sm, const TY* __restrict__ dY, int64_t s,
                                          int32_t row, int E, int c, bool active, float& a0,
                                          float& a1) {
  using Pair = typename Cot<TY>::Pair;
  const int lane = threadIdx.x & 31;
  const int64_t L = sm.L;
  bool live = false;
  int64_t base = s;
  Seg sa = load_seg<true>(sm, base + lane, L);
  Plan pa = plan_seg(sa, __popc(__ballot_sync(kFull, sa.row == row)));
  Pair va[kSeg];
  load_rows<TY, kNarrow>(va, sa, pa, dY, E, c, active);
  Seg sb = pa.n == kSeg ? load_seg<true>(sm, base + kSeg + lane, L) : Seg{-1, -1, 0.f};
  while (pa.n > 0) {
    const Plan pb = pa.n == kSeg ? plan_seg(sb, __popc(__ballot_sync(kFull, sb.row == row)))
                                 : Plan{0, 0u, true};
    Pair vb[kSeg];
    load_rows<TY, kNarrow>(vb, sb, pb, dY, E, c, active);
    const Seg sc = pb.n == kSeg ? load_seg<true>(sm, base + 2 * kSeg + lane, L) : Seg{-1, -1, 0.f};
    live = live || __any_sync(kFull, lane < pa.n && sa.bag >= 0);
    add_rows<TY>(a0, a1, va, sa, pa);
#pragma unroll
    for (int u = 0; u < kSeg; ++u) va[u] = vb[u];
    sa = sb;
    pa = pb;
    sb = sc;
    base += kSeg;
  }
  return live;
}

// ------------------------------------------------------ long runs: the ring --

// A stage: one segment (32 positions) of cotangent rows, this lane's two
// columns of position u at [u][lane] (4 bytes bf16, 8 fp32), and the
// positions' weights and masks, all copied there by cp.async; slots past the
// run's end are not written.  kStages stages: 32 KB of bf16 rows, 64 KB of
// fp32 ones (16 bf16 stages were no faster).  kNarrow with a bf16 dY: the
// aligned 4-byte words of each position's row span (64 columns that start
// off a word's start span 33), word w at [u][lane w][0] and again at
// [u][lane w - 1][1], so that lane l reads the words l and l + 1 that hold
// its pair with one 8-byte read (64 KB of stages, as fp32's), and the
// positions' bags, from which the consumer finds each row's start parity.
template <class TY, bool kNarrow>
struct Shape {
  static constexpr bool kWords = kNarrow && sizeof(TY) == 2;
  static constexpr int kStageWords =
      kWords ? kSeg * 64 : kSeg * 32 * sizeof(typename Cot<TY>::Pair) / 4;
  static constexpr size_t kSmemBytes =
      kStages * (kStageWords * 4 + (kNarrow ? 3 : 2) * kSeg * 4 + 2 * sizeof(uint64_t));
};

struct Ring {
  uint32_t* rows;  // [stages][Shape::kStageWords]
  float* wgt;      // [stages][kSeg]
  int32_t* msk;    // [stages][kSeg]
  int32_t* bag;    // [stages][kSeg], kNarrow only
  uint32_t full;   // shared address of full[0]; full[i] at + 8 i
  uint32_t empty;  // likewise
};

template <class TY, bool kNarrow>
__device__ __forceinline__ Ring ring_of(unsigned char* smem) {
  using S = Shape<TY, kNarrow>;
  Ring R;
  R.rows = reinterpret_cast<uint32_t*>(smem);
  R.wgt = reinterpret_cast<float*>(R.rows + kStages * S::kStageWords);
  R.msk = reinterpret_cast<int32_t*>(R.wgt + kStages * kSeg);
  R.bag = R.msk + kStages * kSeg;
  R.full = hopper::smem_u32(R.bag + (kNarrow ? kStages * kSeg : 0));
  R.empty = R.full + 8 * kStages;
  return R;
}

// Position u of a stage, this lane's two columns
template <class TY>
__device__ __forceinline__ typename Cot<TY>::Pair* stage_slot(const Ring& R, uint32_t st, int u) {
  return reinterpret_cast<typename Cot<TY>::Pair*>(R.rows + st * Shape<TY, false>::kStageWords) +
         u * 32 + (threadIdx.x & 31);
}

// What a narrow walk's consumer needs to read its columns c, c + 1 of a
// stage (kNarrow): E, the walk's first column cb, the place of dY's first
// value in its 4-byte word (par0), and the bits of the pair it keeps
// (column c + 1 dropped past the row: +0)
struct NarrowAt {
  int E, cb, par0;
  uint32_t keep;
};

template <class TY>
__device__ __forceinline__ NarrowAt narrow_at(const TY* dY, int E, int c) {
  const int cb = c - 2 * static_cast<int>(threadIdx.x & 31);
  const bool two = c + 1 < E;
  return NarrowAt{E, cb, static_cast<int>((reinterpret_cast<uintptr_t>(dY) >> 1) & 1),
                  sizeof(TY) == 2 ? (two ? 0xffffffffu : 0xffffu) : (two ? 1u : 0u)};
}

// Bit u: whether position u's row of a narrow bf16 stage starts on a word's
// second half, (bag * E + cb + par0) & 1: one read of the stage's bags a
// lane and a ballot, once a stage
template <class TY, bool kNarrow>
__device__ __forceinline__ unsigned odd_rows(const Ring& R, uint32_t st, const NarrowAt& na) {
  if constexpr (!kNarrow || sizeof(TY) != 2) {
    return 0u;
  } else {
    const uint32_t bag = static_cast<uint32_t>(R.bag[st * kSeg + (threadIdx.x & 31)]);
    return __ballot_sync(kFull, (bag * static_cast<uint32_t>(na.E) + na.cb + na.par0) & 1u);
  }
}

// This lane's two columns of position u of a stage.  kNarrow, bf16: the
// words l and l + 1 of the position's span, one 8-byte read, the pair
// shifted out of them by the row's start parity (bit u of odd); fp32: the
// slot, its second value +0 past the row (the copy wrote no such value).
template <class TY, bool kNarrow>
__device__ __forceinline__ typename Cot<TY>::Pair read_slot(const Ring& R, uint32_t st, int u,
                                                           const NarrowAt& na, unsigned odd) {
  if constexpr (!kNarrow) {
    return *stage_slot<TY>(R, st, u);
  } else if constexpr (sizeof(TY) == 2) {
    const uint2 w = reinterpret_cast<const uint2*>(R.rows + st * Shape<TY, true>::kStageWords)
        [u * 32 + (threadIdx.x & 31)];
    return __funnelshift_r(w.x, w.y, ((odd >> u) & 1u) << 4) & na.keep;
  } else {
    const float2 v = *stage_slot<TY>(R, st, u);
    return make_float2(v.x, na.keep ? v.y : 0.f);
  }
}

// The end (one past the last position) of the run of `row` that holds
// [s, s + kLongRun): each round the 32 lanes probe 32 evenly spaced positions of
// the range left, so five rounds find it in a stream of millions.
__device__ __forceinline__ int64_t run_end(const int32_t* __restrict__ rows, int64_t s, int32_t row,
                                           int64_t L) {
  const int lane = threadIdx.x & 31;
  int64_t lo = s + kLongRun - 1, hi = L;  // rows[lo] == row; the end is in (lo, hi]
  while (hi - lo > 1) {
    const int64_t step = (hi - lo + kSeg - 1) / kSeg;
    const int64_t q = lo + (lane + 1) * step;
    const int k = __popc(__ballot_sync(kFull, q < hi && __ldg(rows + q) == row));
    hi = lo + (k + 1) * step < hi ? lo + (k + 1) * step : hi;
    lo += k * step;
  }
  return hi;
}

// What a consumer needs to know of a stage before its adds: which positions
// are valid lookups of the run (bit u: position u; masked, or past the first
// n, clear)
struct Look {
  unsigned valid;
};

__device__ __forceinline__ Look look(const Ring& R, uint32_t st, int n) {
  const int lane = threadIdx.x & 31;
  const int32_t msk = R.msk[st * kSeg + lane];  // past n stale, unused
  return Look{__ballot_sync(kFull, lane < n && msk != 0)};
}

// One segment's adds, in order, a position at a time, two chains a lane
// (columns c and c + 1): each product rounded once, then added; a masked
// position adds +0, one past the run's end nothing.  kPath 1: every
// position valid; 2: any.  The next
// stage's rows (nxt) and look are read in the same straight-line block, so
// that the compiler can issue those reads between the dependent adds.
// (Summed group by group instead, a loop a group as in the short walk, the
// adds took some 740 cycles a segment more on an H100.)
template <class TY, bool kNarrow, int kPath>
__device__ __forceinline__ void add_stage(const Ring& R, uint32_t st,
                                          const typename Cot<TY>::Pair (&cur)[kSeg],
                                          const Look& lc, int n, uint32_t st_next, int n_next,
                                          typename Cot<TY>::Pair (&nxt)[kSeg], Look& ln,
                                          float& a0, float& a1, const NarrowAt& na) {
  const float4* w4 = reinterpret_cast<const float4*>(R.wgt + st * kSeg);
  const unsigned odd = odd_rows<TY, kNarrow>(R, st_next, na);
#pragma unroll
  for (int u = 0; u < kSeg; ++u) nxt[u] = read_slot<TY, kNarrow>(R, st_next, u, na, odd);
  ln = look(R, st_next, n_next);
#pragma unroll
  for (int u = 0; u < kSeg; ++u) {
    const float x0 = Cot<TY>::first(cur[u]), x1 = Cot<TY>::second(cur[u]);
    const float4 q = w4[u / 4];
    const float w = u % 4 == 0 ? q.x : u % 4 == 1 ? q.y : u % 4 == 2 ? q.z : q.w;
    const float p0 = __fmul_rn(x0, w), p1 = __fmul_rn(x1, w);
    if (kPath == 1) {
      a0 = __fadd_rn(a0, p0);
      a1 = __fadd_rn(a1, p1);
    } else if (u < n) {
      const bool v = (lc.valid >> u) & 1;
      a0 = __fadd_rn(a0, v ? p0 : 0.f);
      a1 = __fadd_rn(a1, v ? p1 : 0.f);
    }
  }
}

// The long schedule's sum: one walk's nseg segments (the last holding
// last_n positions of the run), from segment g of the block's sequence on,
// added to (a0, a1).  Segment g + 1 is known full before segment g's adds,
// which read it; whether g + 2 is full is asked before them too and read
// only after them (a wait follows if it is not), so the barrier's latency
// lies under the adds.  Past the walk's last segment the reads touch a stage
// not waited for, and use none of it.  Two register buffers take turns (the
// loop body twice), so nothing is copied.  Returns the run's liveness.
template <class TY, bool kNarrow>
__device__ __forceinline__ bool sum_ring(const Ring& R, uint32_t& g, uint32_t nseg, int last_n,
                                         float& a0, float& a1, const NarrowAt& na) {
  using Pair = typename Cot<TY>::Pair;
  auto full = [&](uint32_t j) { return R.full + 8 * (j % kStages); };
  auto parity = [&](uint32_t j) { return (j / kStages) & 1; };
  auto n_of = [&](uint32_t k) { return k + 1 < nseg ? kSeg : last_n; };
  unsigned live = 0;
  uint32_t k = 0;
  Pair a[kSeg], b[kSeg];
  Look la, lb;
  hopper::mbar_wait(full(g), parity(g));
  if (nseg > 1) hopper::mbar_wait(full(g + 1), parity(g + 1));
  const unsigned odd0 = odd_rows<TY, kNarrow>(R, g % kStages, na);
#pragma unroll
  for (int u = 0; u < kSeg; ++u) a[u] = read_slot<TY, kNarrow>(R, g % kStages, u, na, odd0);
  la = look(R, g % kStages, n_of(0));
  auto step = [&](const Pair (&cur)[kSeg], const Look& lc, Pair (&nxt)[kSeg], Look& ln) {
    const bool ahead = k + 2 < nseg;
    const bool ready = !ahead || hopper::mbar_test(full(g + 2), parity(g + 2));
    const uint32_t st = g % kStages, st_next = (g + 1) % kStages;
    live |= lc.valid;
    if (lc.valid == kFull) {
      add_stage<TY, kNarrow, 1>(R, st, cur, lc, n_of(k), st_next, n_of(k + 1), nxt, ln, a0, a1,
                                na);
    } else {  // the last segment of a walk, or masked lookups (the sorted tail)
      add_stage<TY, kNarrow, 2>(R, st, cur, lc, n_of(k), st_next, n_of(k + 1), nxt, ln, a0, a1,
                                na);
    }
    __syncwarp();  // every lane has read the stage: one arrival
    if ((threadIdx.x & 31) == 0) hopper::mbar_arrive(R.empty + 8 * st);
    if (!ready) hopper::mbar_wait(full(g + 2), parity(g + 2));
    ++k;
    ++g;
  };
  while (k + 1 < nseg) {
    step(a, la, b, lb);
    step(b, lb, a, la);
  }
  if (k < nseg) step(a, la, b, lb);
  return live != 0;
}

// ---------------------------------------------------------------- the steps --

// The row's step.  Every operation rounds where the plain version
// (repro_torch/kernels/ref.py) rounds, which is where jitted JAX rounds: an
// FMA where it contracts one (w - lr*acc, s + acc*acc, w - lr*m), every other
// product, quotient, root and sum on its own.  No fast math.  Momentum's new
// m is the run's lookups added in order onto beta*m (rounded once), not
// beta*m + acc: jitted XLA folds beta*m + segment_sum into a scatter-add
// that starts from beta*m.  The bf16 kinds decode their state exactly, step
// in fp32 as above, and round only what they store.
enum class Op { kSplit, kFp32, kMomentum, kAdagrad, kRowwise, kFreq, kMomentumBf16, kAdagradBf16 };

// The store: W (fp32 [M, E], or the split pair's hi [M, E] 16-bit) and S
// (the split pair's lo; a state slab: mom or acc [M, E] fp32 or bf16, the
// row-wise acc [M] fp32, cnt [M] int32; unused by kFp32).  hp is beta
// (momentum) or eps (the Adagrad kinds).  seed points at the stochastic
// rounding's int32 seed on the device (the bf16 kinds; read there, so the
// host never waits for it).
struct Store {
  void* W;
  void* S;
  float lr, hp;
  const int32_t* seed;
};

// The stochastic rounding of repro_torch/optim/stochastic.py: lowbias32 in
// uint32 arithmetic (wrapping, as the reference's), keyed on the seed, the
// row and the column of each value.
constexpr uint32_t kMix1 = 0x7FEB352Du, kMix2 = 0x846CA68Bu;
constexpr uint32_t kGold = 0x9E3779B1u, kRowC = 0x85EBCA6Bu;

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x = (x ^ (x >> 16)) * kMix1;
  x = (x ^ (x >> 15)) * kMix2;
  return x ^ (x >> 16);
}

// The hash of a row under the seed: mix32((seed * GOLD) ^ (row * ROWC)).
__device__ __forceinline__ uint32_t row_hash(const int32_t* seed, int32_t row) {
  return mix32(static_cast<uint32_t>(__ldg(seed)) * kGold ^ static_cast<uint32_t>(row) * kRowC);
}

// The bf16 bits of v rounded with the dither of column c of the row whose
// hash is base: the low 16 bits of the noise added to v's bits (the carry may
// run into the exponent), the upper half kept.
__device__ __forceinline__ uint32_t sr_bf16(float v, uint32_t base, int c) {
  const uint32_t noise = mix32(base ^ (static_cast<uint32_t>(c) * kGold + 1u));
  return (__float_as_uint(v) + (noise & 0xffffu)) >> 16;
}

// Adagrad's weight step: w - (lr * acc) / d, unfused.
__device__ __forceinline__ float scaled_step(float w, float a, float lr, float d) {
  return __fsub_rn(w, __fdiv_rn(__fmul_rn(lr, a), d));
}

template <Op kOp>
constexpr bool kMomentumOp = kOp == Op::kMomentum || kOp == Op::kMomentumBf16;
template <Op kOp>
constexpr bool kBf16State = kOp == Op::kMomentumBf16 || kOp == Op::kAdagradBf16;

// Columns c, c + 1 of a slab at flat offset off: a pair of 16-bit values as
// one 32-bit word (column c in the low half) or a float2, with one access;
// with kNarrow one access a column, column c + 1 only where `two` (+0 past
// the row)
template <bool kNarrow>
__device__ __forceinline__ uint32_t ld16x2(const void* base, int64_t off, bool two) {
  const uint16_t* p = static_cast<const uint16_t*>(base) + off;
  if constexpr (!kNarrow) {
    return *reinterpret_cast<const uint32_t*>(p);
  } else {
    return static_cast<uint32_t>(p[0]) | (two ? static_cast<uint32_t>(p[1]) << 16 : 0u);
  }
}

template <bool kNarrow>
__device__ __forceinline__ void st16x2(void* base, int64_t off, uint32_t v, bool two) {
  uint16_t* p = static_cast<uint16_t*>(base) + off;
  if constexpr (!kNarrow) {
    *reinterpret_cast<uint32_t*>(p) = v;
  } else {
    p[0] = static_cast<uint16_t>(v & 0xffffu);
    if (two) p[1] = static_cast<uint16_t>(v >> 16);
  }
}

template <bool kNarrow>
__device__ __forceinline__ float2 ld32x2(const void* base, int64_t off, bool two) {
  const float* p = static_cast<const float*>(base) + off;
  if constexpr (!kNarrow) {
    return *reinterpret_cast<const float2*>(p);
  } else {
    return make_float2(p[0], two ? p[1] : 0.f);
  }
}

template <bool kNarrow>
__device__ __forceinline__ void st32x2(void* base, int64_t off, float2 v, bool two) {
  float* p = static_cast<float*>(base) + off;
  if constexpr (!kNarrow) {
    *reinterpret_cast<float2*>(p) = v;
  } else {
    p[0] = v.x;
    if (two) p[1] = v.y;
  }
}

// The values of columns c, c + 1 that the step reads (w and, for an [M, E]
// slab, the state), loaded before the sums
struct Old {
  float2 w, m;
};

template <Op kOp, bool kNarrow>
__device__ __forceinline__ Old load_old(const Store& st, int64_t off, bool two) {
  Old o{make_float2(0.f, 0.f), make_float2(0.f, 0.f)};
  if constexpr (kOp == Op::kSplit) {  // w = (hi << 16) | lo, two columns a word each
    const uint32_t h = ld16x2<kNarrow>(st.W, off, two);
    const uint32_t l = ld16x2<kNarrow>(st.S, off, two);
    o.w = make_float2(__uint_as_float((h << 16) | (l & 0xffffu)),
                      __uint_as_float((h & 0xffff0000u) | (l >> 16)));
  } else {
    o.w = ld32x2<kNarrow>(st.W, off, two);
    if constexpr (kBf16State<kOp>) {  // two bf16 values, decoded exactly
      const uint32_t v = ld16x2<kNarrow>(st.S, off, two);
      o.m = make_float2(__uint_as_float(v << 16), __uint_as_float(v & 0xffff0000u));
    } else if constexpr (kOp == Op::kMomentum || kOp == Op::kAdagrad) {
      o.m = ld32x2<kNarrow>(st.S, off, two);
    }
  }
  return o;
}

template <Op kOp, bool kNarrow>
__device__ __forceinline__ void step(const Store& st, int32_t row, int64_t off, int c, const Old& o,
                                     float a0, float a1, bool two) {
  const float lr = st.lr;
  float* W = static_cast<float*>(st.W);
  if constexpr (kOp == Op::kSplit) {
    const uint32_t b0 = __float_as_uint(__fmaf_rn(-lr, a0, o.w.x));
    const uint32_t b1 = __float_as_uint(__fmaf_rn(-lr, a1, o.w.y));
    st16x2<kNarrow>(st.W, off, (b0 >> 16) | (b1 & 0xffff0000u), two);
    st16x2<kNarrow>(st.S, off, (b0 & 0xffffu) | (b1 << 16), two);
  } else if constexpr (kOp == Op::kFp32) {
    st32x2<kNarrow>(W, off, make_float2(__fmaf_rn(-lr, a0, o.w.x), __fmaf_rn(-lr, a1, o.w.y)),
                    two);
  } else if constexpr (kMomentumOp<kOp>) {  // m = beta*m + the run's lookups; w = w - lr*m
    if constexpr (kBf16State<kOp>) {
      const uint32_t base = row_hash(st.seed, row);
      st16x2<kNarrow>(st.S, off, sr_bf16(a0, base, c) | (sr_bf16(a1, base, c + 1) << 16),
                      two);
    } else {
      st32x2<kNarrow>(st.S, off, make_float2(a0, a1), two);
    }
    st32x2<kNarrow>(W, off, make_float2(__fmaf_rn(-lr, a0, o.w.x), __fmaf_rn(-lr, a1, o.w.y)),
                    two);
  } else if constexpr (kOp == Op::kAdagrad || kOp == Op::kAdagradBf16) {
    // s = s + acc*acc; w = w - lr*acc/(sqrt(s)+eps)
    const float2 m = make_float2(__fmaf_rn(a0, a0, o.m.x), __fmaf_rn(a1, a1, o.m.y));
    if constexpr (kBf16State<kOp>) {  // the step below reads the unrounded s
      const uint32_t base = row_hash(st.seed, row);
      st16x2<kNarrow>(st.S, off, sr_bf16(m.x, base, c) | (sr_bf16(m.y, base, c + 1) << 16),
                      two);
    } else {
      st32x2<kNarrow>(st.S, off, m, two);
    }
    st32x2<kNarrow>(W, off,
                    make_float2(scaled_step(o.w.x, a0, lr, __fadd_rn(__fsqrt_rn(m.x), st.hp)),
                                scaled_step(o.w.y, a1, lr, __fadd_rn(__fsqrt_rn(m.y), st.hp))),
                    two);
  } else {  // kFreq: w = w - lr*acc/(sqrt(max(cnt, 1))+eps), the count already bumped
    const float d = __fadd_rn(
        __fsqrt_rn(fmaxf(__int2float_rn(static_cast<const int32_t*>(st.S)[row]), 1.f)), st.hp);
    st32x2<kNarrow>(W, off,
                    make_float2(scaled_step(o.w.x, a0, lr, d), scaled_step(o.w.y, a1, lr, d)),
                    two);
  }
}

// How many times a kind walks a run (once a block of 64 columns; row-wise
// Adagrad walks the blocks before the last twice), and the first column of
// walk w.  The producers of a long run follow this sequence, and update_run
// calls its sum in the same order.
template <Op kOp>
__device__ __forceinline__ uint32_t walks(int E) {
  const uint32_t nb = (E + 63) / 64;
  return kOp == Op::kRowwise && nb ? 2 * nb - 1 : nb;
}

template <Op kOp>
__device__ __forceinline__ int walk_column(uint32_t w, int E) {
  const uint32_t nb = (E + 63) / 64;
  return 64 * static_cast<int>(kOp == Op::kRowwise && w >= nb ? 2 * nb - 2 - w : w);
}

// The one walk: steps the run's row as kOp does, with sum(c, active, a0, a1)
// adding the run's lookups of columns c, c + 1 onto (a0, a1) and returning
// its liveness, by either schedule.  A stateful kind writes nothing for a
// dead run: beta * m is no no-op, nor is a rewrite of the accumulator (the
// split and fp32 steps of a dead run rewrite the row unchanged, as the plain
// versions do).  Row-wise Adagrad needs the whole row's sum of acc^2 before
// it writes any column: pass one walks each block of 64 columns and adds this
// lane's two squares to q, block after block (each product and each add
// rounded on its own); a butterfly of __shfl_xor_sync (16, 8, 4, 2, 1) then
// leaves the same sum in every lane; s += sum / E.  Pass two steps the
// columns from the last block back, walking the run again for every block
// but the last, whose sums are still held: the same walk gives the same
// bits.  It walks a dead run too, so a long run's producers need not know.
// kNarrow moves each value on its own (ld16x2 and the others): an odd E
// leaves the last lane's column c + 1 past the row, where it reads +0 and
// writes nothing.
template <Op kOp, bool kNarrow, class Sum>
__device__ __forceinline__ void update_run(int32_t row, int E, const Store& st, Sum&& sum) {
  const int lane = threadIdx.x & 31;
  if constexpr (kOp == Op::kRowwise) {
    float* acc = static_cast<float*>(st.S);
    float* W = static_cast<float*>(st.W);
    const float s_old = acc[row];
    float q = 0.f, a0 = 0.f, a1 = 0.f;
    bool live = false;
    const int nb = (E + 63) / 64;
    for (int b = 0; b < nb; ++b) {
      const int c = 64 * b + 2 * lane;
      a0 = a1 = 0.f;
      live = sum(c, c < E, a0, a1);
      if (c < E) {
        q = __fadd_rn(q, __fmul_rn(a0, a0));
        q = __fadd_rn(q, __fmul_rn(a1, a1));
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) q = __fadd_rn(q, __shfl_xor_sync(kFull, q, off));
    const float s_new = __fadd_rn(s_old, __fdiv_rn(q, static_cast<float>(E)));
    const float d = __fadd_rn(__fsqrt_rn(s_new), st.hp);
    for (int b = nb - 1; b >= 0; --b) {
      const int c = 64 * b + 2 * lane;
      if (b != nb - 1) {
        a0 = a1 = 0.f;
        sum(c, c < E, a0, a1);
      }
      if (live && c < E) {
        const int64_t off = static_cast<int64_t>(row) * E + c;
        const bool two = c + 1 < E;
        const float2 old = ld32x2<kNarrow>(W, off, two);
        st32x2<kNarrow>(W, off,
                        make_float2(scaled_step(old.x, a0, st.lr, d),
                                    scaled_step(old.y, a1, st.lr, d)),
                        two);
      }
    }
    if (live && lane == 0) acc[row] = s_new;
  } else {
    constexpr bool kAlways = kOp == Op::kSplit || kOp == Op::kFp32;
    for (int cb = 0; cb < E; cb += 64) {
      const int c = cb + 2 * lane;
      const bool active = c < E;
      const int64_t off = static_cast<int64_t>(row) * E + c;  // int64: 8M rows x E overflow int32
      const bool two = c + 1 < E;
      const Old o = active ? load_old<kOp, kNarrow>(st, off, two)
                           : Old{make_float2(0.f, 0.f), make_float2(0.f, 0.f)};
      // the sums start from +0; momentum's from beta*m
      float a0 = kMomentumOp<kOp> ? __fmul_rn(st.hp, o.m.x) : 0.f;
      float a1 = kMomentumOp<kOp> ? __fmul_rn(st.hp, o.m.y) : 0.f;
      const bool live = sum(c, active, a0, a1);
      if (active && (kAlways || live)) step<kOp, kNarrow>(st, row, off, c, o, a0, a1, two);
    }
  }
}

// Where a producer is in the block's sequence of the current run's
// segments: segment kk of walk w, advanced without a division
struct Cursor {
  uint32_t w, kk;
  __device__ __forceinline__ void advance(uint32_t by, uint32_t nseg) {
    for (kk += by; kk >= nseg; kk -= nseg) ++w;
  }
};

// A long run's producer warp pw (0 .. kProducers - 1): segment j of the
// block's sequence (its runs one after another, each walked walks<kOp>(E)
// times) is this warp's when j % kProducers == pw.  For each, once the
// consumer has released the stage, cp.async copies of the segment's
// cotangent rows (16-byte chunks where the rows allow, else this lane's two
// columns of each) and of the positions' weights and masks, then each
// lane's arrival, triggered when its copies land.  A producer never waits
// for a copy, and it stores and releases nothing itself, so the bags it
// loads into registers for its next rounds stay in flight (an arrival with
// release semantics would wait for them): each lane holds the bag of its
// position in the warp's next four rounds.  Shared addresses are formed
// once: converting a pointer a copy cost more than the copy.  kNarrow (an
// odd E, or a slab off its pairs' alignment) copies the same way: a bf16 dY
// as the aligned 4-byte words that hold each position's columns of the walk
// (a row starts on a 2-byte boundary; every word holds a byte of the row, so
// no copy reads past dY), each word twice (the first of its lane's pair of
// words and the second of the lane before's), lane l taking words l, l + 32,
// ... of the segment's spans laid end to end, and the positions' bags beside
// their weights and masks; an fp32 dY as this lane's two columns, a 4-byte
// copy each.
template <Op kOp, class TY, bool kNarrow>
__device__ void produce(const Ring& R, int pw, const int64_t* __restrict__ runs, int64_t count,
                        int64_t slots, const Stream& sm, const TY* __restrict__ dY, int E) {
  using S = Shape<TY, kNarrow>;
  constexpr uint32_t P = kProducers;
  constexpr int kPer = 16 / sizeof(TY);  // values a 16-byte chunk
  constexpr int kChunks = 64 / kPer;     // chunks a row of 64 columns
  constexpr uint32_t kRowBytes = 64 * sizeof(TY), kStageBytes = S::kStageWords * 4;
  constexpr int kPair = sizeof(typename Cot<TY>::Pair);
  const int lane = threadIdx.x & 31;
  // rows of whole 16-byte chunks, 16-byte aligned: copied a chunk at a time
  const bool wide = !kNarrow && E % kPer == 0 && reinterpret_cast<uintptr_t>(dY) % 16 == 0;
  const uint32_t rows_s = hopper::smem_u32(R.rows), wgt_s = hopper::smem_u32(R.wgt),
                 msk_s = hopper::smem_u32(R.msk), bag_s = hopper::smem_u32(R.bag);
  // kNarrow, bf16: dY as aligned words, and the place of its first value in the first
  const uint32_t* dYw = reinterpret_cast<const uint32_t*>(
      reinterpret_cast<uintptr_t>(dY) & ~static_cast<uintptr_t>(3));
  const int par0 = static_cast<int>((reinterpret_cast<uintptr_t>(dY) >> 1) & 1);
  const uint32_t nw = walks<kOp>(E);
  uint32_t g0 = 0;  // segments of the block's earlier runs
  for (int64_t i = blockIdx.x; i < count; i += slots) {
    const int64_t s = runs[1 + 2 * i];
    const int32_t row = static_cast<int32_t>(runs[2 + 2 * i]);
    const int64_t end = run_end(sm.rows, s, row, sm.L);
    const uint32_t nseg = static_cast<uint32_t>((end - s + kSeg - 1) / kSeg);
    const uint32_t J = nw * nseg;
    // this lane's bag in segment j at cursor c (-1 past the run's end)
    auto bag = [&](const Cursor& c, uint32_t j) -> int32_t {
      const int64_t q = s + kSeg * static_cast<int64_t>(c.kk) + lane;
      return j < J && q < end ? __ldg(sm.bags + q) : -1;
    };
    const uint32_t k0 = (pw + P - g0 % P) % P;
    Cursor at{k0 / nseg, k0 % nseg}, ahead = at;
    int32_t b[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      b[r] = bag(ahead, k0 + r * P);
      ahead.advance(P, nseg);
    }
    for (uint32_t k = k0; k < J; k += 4 * P) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const uint32_t j = k + r * P;
        if (j >= J) break;  // warp-uniform
        const uint32_t g = g0 + j, st = g % kStages;
        const int64_t q = s + kSeg * static_cast<int64_t>(at.kk) + lane;
        const int cb = walk_column<kOp>(at.w, E);
        const uint32_t stage = rows_s + st * kStageBytes;
        if (g >= kStages) hopper::mbar_wait(R.empty + 8 * st, ((g / kStages) & 1) ^ 1);
        if (wide) {  // lane l takes chunks l, l + 32, ... of the segment's rows
#pragma unroll
          for (int x = lane; x < kSeg * kChunks; x += 32) {
            const int u = x / kChunks, part = x % kChunks;
            const int32_t bu = __shfl_sync(kFull, b[r], u);
            if (cb + part * kPer < E && bu >= 0)
              hopper::cp_async<16>(stage + u * kRowBytes + 16 * part,
                                   dY + static_cast<int64_t>(bu) * E + cb + part * kPer);
          }
        } else if (S::kWords) {  // lane l takes words l, l + 32, ... of the segment's spans
          const int ncols = E - cb < 64 ? E - cb : 64;
          const int span = (ncols + 2) >> 1;  // the most words a row's columns span
          const int du = 32 / span, dw = 32 % span;
          int u = lane / span, w = lane % span;
          for (int x = 0; x < span; ++x) {  // 32 * span words: span rounds of 32
            const int32_t bu = __shfl_sync(kFull, b[r], u);
            const int64_t a0 = static_cast<int64_t>(bu) * E + cb + par0;  // the span's first value
            if (bu >= 0 && w < ((static_cast<int>(a0 & 1) + ncols + 1) >> 1)) {
              const uint32_t at = stage + 4 * (u * 64 + 2 * w);  // lane w's first word
              if (w < 32) hopper::cp_async<4>(at, dYw + (a0 >> 1) + w);
              if (w > 0) hopper::cp_async<4>(at - 4, dYw + (a0 >> 1) + w);  // lane w - 1's second
            }
            u += du;
            w += dw;
            if (w >= span) {
              w -= span;
              ++u;
            }
          }
        } else {  // this lane's two columns of each position's row
          const int c = cb + 2 * lane;
#pragma unroll
          for (int u = 0; u < kSeg; ++u) {
            const int32_t bu = __shfl_sync(kFull, b[r], u);
            if (c < E && bu >= 0) {
              const TY* src = dY + static_cast<int64_t>(bu) * E + c;
              if (kNarrow) {  // fp32, 4-byte aligned: a copy a column
                hopper::cp_async<4>(stage + u * kRowBytes + lane * kPair, src);
                if (c + 1 < E)
                  hopper::cp_async<4>(stage + u * kRowBytes + lane * kPair + 4, src + 1);
              } else {
                hopper::cp_async<kPair>(stage + u * kRowBytes + lane * kPair, src);
              }
            }
          }
        }
        if (q < end) {
          hopper::cp_async<4>(wgt_s + 4 * (st * kSeg + lane), sm.wgt + q);
          hopper::cp_async<4>(msk_s + 4 * (st * kSeg + lane), sm.msk + q);
          if (kNarrow) hopper::cp_async<4>(bag_s + 4 * (st * kSeg + lane), sm.bags + q);
        }
        hopper::cp_async_arrive(R.full + 8 * st);
        b[r] = bag(ahead, j + 4 * P);  // this lane's bag four rounds on
        at.advance(P, nseg);
        ahead.advance(P, nseg);
      }
    }
    g0 += J;
  }
}

// The long runs' consumer warp: each of the block's runs, its row stepped
// as kOp does, its sums read from the ring.
template <Op kOp, class TY, bool kNarrow>
__device__ void consume(const Ring& R, const int64_t* __restrict__ runs, int64_t count,
                        int64_t slots, const Stream& sm, const TY* __restrict__ dY, const Store& st,
                        int E) {
  uint32_t g = 0;
  for (int64_t i = blockIdx.x; i < count; i += slots) {
    const int64_t s = runs[1 + 2 * i];
    const int32_t row = static_cast<int32_t>(runs[2 + 2 * i]);
    const int64_t len = run_end(sm.rows, s, row, sm.L) - s;
    const uint32_t nseg = static_cast<uint32_t>((len + kSeg - 1) / kSeg);
    const int last_n = static_cast<int>(len - kSeg * static_cast<int64_t>(nseg - 1));
    update_run<kOp, kNarrow>(row, E, st, [&](int c, bool, float& a0, float& a1) {
      return sum_ring<TY, kNarrow>(R, g, nseg, last_n, a0, a1, narrow_at(dY, E, c));
    });
  }
}

// Each run of kLongRun positions or more: (start, row) into runs[1 + 2 i],
// runs[2 + 2 i], i counted by runs[0], which the launcher zeroes first
// (list_words(L) words).
__global__ void list_long_runs_kernel(const int32_t* __restrict__ rows, int64_t L,
                                      int64_t* __restrict__ runs) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= L) return;
  const int32_t r = __ldg(rows + p);
  if ((p == 0 || __ldg(rows + p - 1) != r) && long_run(rows, p, r, L)) {
    const int64_t i =
        static_cast<int64_t>(atomicAdd(reinterpret_cast<unsigned long long*>(runs), 1ull));
    runs[1 + 2 * i] = p;
    runs[2 + 2 * i] = r;
  }
}

// The long runs: block b takes the runs of the list's slots b, b + slots,
// ... (a block past the list's count exits at once).
template <Op kOp, class TY, bool kNarrow>
__global__ void __launch_bounds__(kWarps * 32, 1)
    long_run_kernel(Stream sm, const TY* __restrict__ dY, Store st,
                    const int64_t* __restrict__ runs, int64_t slots, int E) {
  const int warp = threadIdx.x >> 5;
  const int64_t count = runs[0];
  if (blockIdx.x >= count) return;  // the whole block leaves together
  extern __shared__ __align__(16) unsigned char smem[];
  const Ring R = ring_of<TY, kNarrow>(smem);
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      hopper::mbar_init(R.full + 8 * i, 32);  // a producer's lanes, once their copies land
      hopper::mbar_init(R.empty + 8 * i, 1);  // the consumer warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  if (warp == 0) {
    consume<kOp, TY, kNarrow>(R, runs, count, slots, sm, dY, st, E);
  } else if (warp <= kProducers) {
    produce<kOp, TY, kNarrow>(R, warp - 1, runs, count, slots, sm, dY, E);
  }
}

// Blocks an SM for the short runs' kernel: three (80 registers) where the
// kind's walk fits them, two (128) for the kinds with an fp32 [M, E] state
// and row-wise Adagrad, which spilled at 80 and ran 6-60 % slower on a
// uniform stream, where the others ran 9-18 % faster than at two (the walk
// is latency-bound).
template <Op kOp>
constexpr int kShortBlocks =
    kOp == Op::kMomentum || kOp == Op::kAdagrad || kOp == Op::kRowwise ? 2 : 3;

// The short runs: each warp takes a window of 32 positions and walks the
// runs that start in it and are not long, each to its end.
template <Op kOp, class TY, bool kNarrow>
__global__ void __launch_bounds__(kWarps * 32, kShortBlocks<kOp>)
    short_run_kernel(Stream sm, const TY* __restrict__ dY, Store st, int E) {
  const int lane = threadIdx.x & 31;
  const int64_t L = sm.L;
  const int64_t w0 = (static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5)) * kSeg;
  if (w0 >= L) return;  // the whole warp leaves together
  const int64_t p = w0 + lane;
  const int32_t r = p < L ? __ldg(sm.rows + p) : -1;
  const int32_t prev = (p < L && p > 0) ? __ldg(sm.rows + p - 1) : -1;
  // long_run's test, its load issued with the other two
  const int32_t far = p + kLongRun - 1 < L ? __ldg(sm.rows + p + kLongRun - 1) : -1;
  unsigned starts = __ballot_sync(kFull, p < L && (p == 0 || r != prev) && far != r);
  while (starts) {
    const int k = __ffs(starts) - 1;
    starts &= starts - 1;
    const int64_t s = w0 + k;
    const int32_t row = __shfl_sync(kFull, r, k);
    update_run<kOp, kNarrow>(row, E, st, [&](int c, bool active, float& a0, float& a1) {
      return sum_short<TY, kNarrow>(sm, dY, s, row, E, c, active, a0, a1);
    });
  }
}

// A second stream a device and two events, made at the first launch, on
// which the short runs' kernel runs beside the long runs' one: forked from
// the caller's stream and joined back to it before the launcher returns, so
// that what follows on the caller's stream waits for both, with no host
// sync (and in a CUDA graph, two branches).  The side stream and its events
// are shared by every caller of a device, so a launch holds side_lock from
// the fork to the join: a stream waits on an event's latest record at the
// time of the wait, so no caller's side work can wait on another caller's
// fork, and setting a device's side up happens once.
struct Side {
  cudaStream_t stream = nullptr;
  cudaEvent_t fork = nullptr, join = nullptr;
};

std::mutex side_lock;

// The current device's side stream; call with side_lock held
cudaError_t side_stream(Side*& out) {
  static Side sides[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  Side& sd = sides[dev];
  if (sd.join == nullptr) {  // the last of the three made: a failed setup is redone
    if (sd.stream == nullptr) err = cudaStreamCreateWithFlags(&sd.stream, cudaStreamNonBlocking);
    if (err == cudaSuccess && sd.fork == nullptr)
      err = cudaEventCreateWithFlags(&sd.fork, cudaEventDisableTiming);
    if (err == cudaSuccess) err = cudaEventCreateWithFlags(&sd.join, cudaEventDisableTiming);
    if (err != cudaSuccess) return err;
  }
  out = &sd;
  return cudaSuccess;
}

// On the caller's stream: zero the list's count, list the long runs, walk
// them; on the side stream, forked after the zeroing: walk the short runs.
template <Op kOp, class TY, bool kNarrow>
int launch_typed(const void* rows, const void* bags, const void* msk, const void* wgt,
                 const void* dY, Store st, void* runs, int64_t L, int E, cudaStream_t stream) {
  const std::lock_guard<std::mutex> hold(side_lock);
  Side* side = nullptr;
  cudaError_t err = side_stream(side);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(long_run_kernel<kOp, TY, kNarrow>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(Shape<TY, kNarrow>::kSmemBytes));
  if (err == cudaSuccess) err = cudaMemsetAsync(runs, 0, sizeof(int64_t), stream);
  if (err == cudaSuccess) err = cudaEventRecord(side->fork, stream);
  if (err == cudaSuccess) err = cudaStreamWaitEvent(side->stream, side->fork, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Stream sm{static_cast<const int32_t*>(rows), static_cast<const int32_t*>(bags),
                  static_cast<const int32_t*>(msk), static_cast<const float*>(wgt), L};
  const auto* y = static_cast<const TY*>(dY);
  const int64_t windows = (L + kSeg - 1) / kSeg;
  short_run_kernel<kOp, TY, kNarrow><<<static_cast<unsigned>((windows + kWarps - 1) / kWarps),
                                       kWarps * 32, 0, side->stream>>>(sm, y, st, E);
  err = cudaGetLastError();
  if (err == cudaSuccess) err = cudaEventRecord(side->join, side->stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  list_long_runs_kernel<<<static_cast<unsigned>((L + 255) / 256), 256, 0, stream>>>(
      sm.rows, L, static_cast<int64_t*>(runs));
  const int64_t slots = list_slots(L) < kLongBlocks ? list_slots(L) : kLongBlocks;
  long_run_kernel<kOp, TY, kNarrow><<<static_cast<unsigned>(slots), kWarps * 32,
                                      Shape<TY, kNarrow>::kSmemBytes, stream>>>(
      sm, y, st, static_cast<const int64_t*>(runs), slots, E);
  err = cudaGetLastError();
  if (err == cudaSuccess) err = cudaStreamWaitEvent(stream, side->join, 0);
  return static_cast<int>(err);
}

// Whether a launch takes the narrow path: an odd E, or a slab whose column
// pairs are off the alignment of one access (4 bytes for a pair of 16-bit
// values, 8 for a float2): dY, W (the split pair's hi), and an [M, E] state
// slab S (the split pair's lo)
template <Op kOp>
bool narrow(const void* dY, int dy_f32, const Store& st, int E) {
  auto off = [](const void* p, int align) { return reinterpret_cast<uintptr_t>(p) % align != 0; };
  constexpr bool kSplit = kOp == Op::kSplit;
  constexpr int kStateAlign = kSplit || kBf16State<kOp> ? 4
                              : kOp == Op::kMomentum || kOp == Op::kAdagrad ? 8 : 0;
  return E % 2 != 0 || off(dY, dy_f32 ? 8 : 4) || off(st.W, kSplit ? 4 : 8) ||
         (kStateAlign && off(st.S, kStateAlign));
}

// dY fp32 when dy_f32, else bf16; runs: the long runs' list, int64
// [list_words(L)] scratch on the device
template <Op kOp>
int launch(const void* rows, const void* bags, const void* msk, const void* wgt, const void* dY,
           int dy_f32, Store st, void* runs, int64_t L, int E, void* stream) {
  if (L == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  if (narrow<kOp>(dY, dy_f32, st, E))
    return dy_f32 ? launch_typed<kOp, float, true>(rows, bags, msk, wgt, dY, st, runs, L, E, s)
                  : launch_typed<kOp, uint16_t, true>(rows, bags, msk, wgt, dY, st, runs, L, E, s);
  return dy_f32 ? launch_typed<kOp, float, false>(rows, bags, msk, wgt, dY, st, runs, L, E, s)
                : launch_typed<kOp, uint16_t, false>(rows, bags, msk, wgt, dY, st, runs, L, E, s);
}

}  // namespace

// The stateful kinds: W [M, E] fp32 and the state slab S, both in place; hp
// is beta (momentum) or eps (the others).  S is mom [M, E] fp32 (momentum),
// acc [M, E] fp32 (adagrad), acc [M] fp32 (adagrad_rowwise) or cnt [M] int32,
// already bumped, read only (freq).
#define STATEFUL_LAUNCHER(name, op)                                                             \
  extern "C" int name(const void* rows, const void* bags, const void* msk, const void* wgt,    \
                      const void* dY, int dy_f32, void* W, void* S, void* runs, int64_t L,     \
                      int E, float lr, float hp, void* stream) {                               \
    return launch<op>(rows, bags, msk, wgt, dY, dy_f32, Store{W, S, lr, hp, nullptr}, runs, L, \
                      E, stream);                                                              \
  }

// The compressed-state kinds: S is mom or acc [M, E] bf16; seed points at the
// int32 seed of the stochastic rounding on the device.
#define STATEFUL_SR_LAUNCHER(name, op)                                                         \
  extern "C" int name(const void* rows, const void* bags, const void* msk, const void* wgt,   \
                      const void* dY, int dy_f32, void* W, void* S, const void* seed,         \
                      void* runs, int64_t L, int E, float lr, float hp, void* stream) {       \
    return launch<op>(rows, bags, msk, wgt, dY, dy_f32,                                       \
                      Store{W, S, lr, hp, static_cast<const int32_t*>(seed)}, runs, L, E,     \
                      stream);                                                                \
  }
