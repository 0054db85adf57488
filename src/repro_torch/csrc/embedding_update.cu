// Fused sparse backward + row update on the sorted lookup stream: for each run
// of equal rows, acc = sum(wgt * dY[bag]) in sorted order, then one step of
// the row's optimizer on that row only, in place.  The stores: the split pair
// hi (bf16 bits) / lo (low 16 bits) or an fp32 W, stepped w = fmaf(-lr, acc, w);
// or an fp32 W with one state slab S (momentum, Adagrad, row-wise Adagrad,
// the frequency-adaptive step, and momentum and Adagrad with a bf16 S written
// back with the seeded stochastic rounding).  The design note is in
// repro_torch/kernels/embedding_update.py.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kSeg = 32;  // positions of a run read at once, one per lane
constexpr unsigned kFull = 0xffffffffu;
constexpr int kFew = 4;  // a segment of at most this many groups is summed group by group

// Lane l holds position base + l of the stream; row -1 past its end.  A
// masked lookup keeps bag -1 and weight 0: it loads nothing and adds +0.
struct Seg {
  int32_t row, bag;
  float wgt;
};

__device__ __forceinline__ Seg load_seg(const int32_t* __restrict__ rows,
                                        const int32_t* __restrict__ bags,
                                        const int32_t* __restrict__ msk,
                                        const float* __restrict__ wgt, int64_t q, int64_t L) {
  Seg s{-1, -1, 0.f};
  if (q < L) {
    s.row = __ldg(rows + q);
    const int32_t m = __ldg(msk + q), b = __ldg(bags + q);  // all four loads in flight at once
    const float w = __ldg(wgt + q);
    s.bag = m ? b : -1;
    s.wgt = m ? w : 0.f;
  }
  return s;
}

// What a segment's sums need: n, the positions of the run in it (a prefix:
// the stream is sorted and the segment starts inside the run), and which of
// them start a group of equal (bag, weight).  Consecutive lookups of one row
// in one bag carry the same cotangent row and weight (zipf's hot rows: some
// 26 lookups of row 0 a bag), so a group loads one row and rounds one
// product; its adds stay one a lookup, in order, with the same operands as
// one add a position would have.
struct Plan {
  int n;
  unsigned groups;
  bool few;  // at most kFew groups: summed group by group
};

__device__ __forceinline__ Plan plan_seg(const Seg& s, int32_t row) {
  const int lane = threadIdx.x & 31;
  const int n = __popc(__ballot_sync(kFull, s.row == row));
  const int32_t pb = __shfl_up_sync(kFull, s.bag, 1);
  const float pw = __shfl_up_sync(kFull, s.wgt, 1);
  const unsigned g = __ballot_sync(kFull, lane < n && (lane == 0 || s.bag != pb || s.wgt != pw));
  return Plan{n, g, __popc(g) <= kFew};
}

// Issue the loads of a segment's cotangent rows (this lane's two bf16
// columns c, c + 1 of each, as one 32-bit word): one a group, into v[0..3],
// or one a position, into v[0..31].  Masked positions (bag -1) load nothing.
__device__ __forceinline__ void load_rows(uint32_t (&v)[kSeg], const Seg& s, const Plan& p,
                                          const uint16_t* __restrict__ dY, int E, int c,
                                          bool active) {
  if (p.few) {
    unsigned g = p.groups;
#pragma unroll
    for (int j = 0; j < kFew; ++j) {
      const int32_t bag = __shfl_sync(kFull, s.bag, g ? __ffs(g) - 1 : 0);
      v[j] = (g && active && bag >= 0)
                 ? __ldg(reinterpret_cast<const unsigned int*>(dY + static_cast<int64_t>(bag) * E + c))
                 : 0u;
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
               ? __ldg(reinterpret_cast<const unsigned int*>(dY + static_cast<int64_t>(bg[u]) * E + c))
               : 0u;
}

// acc += (msk ? wgt * dY : 0) over the segment's positions, in order,
// unfused: the product and the sum each round once, as the plain version's
// do.  Masked positions and those past n add +0 (v = 0, w = 0), which
// leaves the sum as it is (it starts at +0 and so is never -0).
__device__ __forceinline__ void add_rows(float& a0, float& a1, const uint32_t (&v)[kSeg],
                                         const Seg& s, const Plan& p) {
  if (p.few) {
    unsigned g = p.groups;
#pragma unroll
    for (int j = 0; j < kFew; ++j) {
      if (!g) break;  // warp-uniform
      const int u = __ffs(g) - 1;
      g &= g - 1;
      const int end = g ? __ffs(g) - 1 : p.n;
      const float w = __shfl_sync(kFull, s.wgt, u);
      const float g0 = __fmul_rn(__uint_as_float(v[j] << 16), w);
      const float g1 = __fmul_rn(__uint_as_float(v[j] & 0xffff0000u), w);
      for (int i = u; i < end; ++i) {
        a0 = __fadd_rn(a0, g0);
        a1 = __fadd_rn(a1, g1);
      }
    }
    return;
  }
  const float mine = (threadIdx.x & 31) < p.n ? s.wgt : 0.f;
  float w[kSeg];
#pragma unroll
  for (int u = 0; u < kSeg; ++u) w[u] = __shfl_sync(kFull, mine, u);
#pragma unroll
  for (int u = 0; u < kSeg; ++u) {
    a0 = __fadd_rn(a0, __fmul_rn(__uint_as_float(v[u] << 16), w[u]));
    a1 = __fadd_rn(a1, __fmul_rn(__uint_as_float(v[u] & 0xffff0000u), w[u]));
  }
}

// One warp walks the run that starts at s to its end, 64 columns at a time.
// The next segment's stream and cotangent rows are loaded before this
// segment's are summed.
template <bool kSplit>
__device__ void update_run(int64_t s, int32_t row, const int32_t* __restrict__ rows,
                           const int32_t* __restrict__ bags, const int32_t* __restrict__ msk,
                           const float* __restrict__ wgt, const uint16_t* __restrict__ dY,
                           uint16_t* hi, uint16_t* lo, float* W, int64_t L, int E, float lr) {
  const int lane = threadIdx.x & 31;
  for (int cb = 0; cb < E; cb += 64) {
    const int c = cb + 2 * lane;
    const bool active = c < E;
    const int64_t off = static_cast<int64_t>(row) * E + c;  // int64: 8M rows x E overflow int32
    uint32_t h = 0u, l = 0u;
    float2 w = make_float2(0.f, 0.f);
    if (active) {  // the old row, loaded while the sums run
      if (kSplit) {
        h = *reinterpret_cast<const uint32_t*>(hi + off);
        l = *reinterpret_cast<const uint32_t*>(lo + off);
      } else {
        w = *reinterpret_cast<const float2*>(W + off);
      }
    }
    float a0 = 0.f, a1 = 0.f;
    int64_t base = s;
    Seg sa = load_seg(rows, bags, msk, wgt, base + lane, L);
    Plan pa = plan_seg(sa, row);
    uint32_t va[kSeg];
    load_rows(va, sa, pa, dY, E, c, active);
    Seg sb = pa.n == kSeg ? load_seg(rows, bags, msk, wgt, base + kSeg + lane, L) : Seg{-1, -1, 0.f};
    while (pa.n > 0) {
      const Plan pb = pa.n == kSeg ? plan_seg(sb, row) : Plan{0, 0u, true};
      uint32_t vb[kSeg];
      load_rows(vb, sb, pb, dY, E, c, active);
      const Seg sc = pb.n == kSeg ? load_seg(rows, bags, msk, wgt, base + 2 * kSeg + lane, L)
                                  : Seg{-1, -1, 0.f};
      add_rows(a0, a1, va, sa, pa);
#pragma unroll
      for (int u = 0; u < kSeg; ++u) va[u] = vb[u];
      sa = sb;
      pa = pb;
      sb = sc;
      base += kSeg;
    }
    if (!active) continue;
    if (kSplit) {
      const float w0 = __uint_as_float((h << 16) | (l & 0xffffu));
      const float w1 = __uint_as_float((h & 0xffff0000u) | (l >> 16));
      const uint32_t b0 = __float_as_uint(__fmaf_rn(-lr, a0, w0));
      const uint32_t b1 = __float_as_uint(__fmaf_rn(-lr, a1, w1));
      *reinterpret_cast<uint32_t*>(hi + off) = (b0 >> 16) | (b1 & 0xffff0000u);
      *reinterpret_cast<uint32_t*>(lo + off) = (b0 & 0xffffu) | (b1 << 16);
    } else {
      *reinterpret_cast<float2*>(W + off) =
          make_float2(__fmaf_rn(-lr, a0, w.x), __fmaf_rn(-lr, a1, w.y));
    }
  }
}

// Each warp looks at a window of 32 positions, finds the runs that start in it
// (rows[i] != rows[i - 1]) with one ballot, and walks each of them to its end.
template <bool kSplit>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    row_update_kernel(const int32_t* __restrict__ rows, const int32_t* __restrict__ bags,
                      const int32_t* __restrict__ msk, const float* __restrict__ wgt,
                      const uint16_t* __restrict__ dY, uint16_t* hi, uint16_t* lo, float* W,
                      int64_t L, int E, float lr) {
  const int lane = threadIdx.x & 31;
  const int64_t w0 = (static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5)) * kSeg;
  if (w0 >= L) return;  // the whole warp leaves together
  const int64_t p = w0 + lane;
  const int32_t r = p < L ? __ldg(rows + p) : -1;
  const int32_t prev = (p < L && p > 0) ? __ldg(rows + p - 1) : -1;
  unsigned starts = __ballot_sync(kFull, p < L && (p == 0 || r != prev));
  while (starts) {
    const int k = __ffs(starts) - 1;
    starts &= starts - 1;
    update_run<kSplit>(w0 + k, __shfl_sync(kFull, r, k), rows, bags, msk, wgt, dY, hi, lo, W, L, E,
                       lr);
  }
}

template <bool kSplit>
int launch(const void* rows, const void* bags, const void* msk, const void* wgt, const void* dY,
           void* hi, void* lo, void* W, int64_t L, int E, float lr, void* stream) {
  if (L == 0) return 0;
  const int64_t warps = (L + kSeg - 1) / kSeg;
  const int64_t blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  row_update_kernel<kSplit><<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(rows), static_cast<const int32_t*>(bags),
      static_cast<const int32_t*>(msk), static_cast<const float*>(wgt),
      static_cast<const uint16_t*>(dY), static_cast<uint16_t*>(hi), static_cast<uint16_t*>(lo),
      static_cast<float*>(W), L, E, lr);
  return static_cast<int>(cudaGetLastError());
}

// The stateful kinds' walk: update_run's steps, as a function of their own.
// One warp adds the run that starts at s, columns c and c + 1 (two a lane),
// to (a0, a1) in sorted order, onto the values they hold (+0 for a sum).
// With kLive, returns whether any lookup of the run is valid (msk != 0): a
// ballot over the run's positions in each segment, so a run of the masked
// tail alone is dead, and the last row's run, which holds its valid lookups
// and then the masked tail, is live.  The split and fp32 kinds keep their
// own copy of the walk above: run through this one, they compiled to other
// code that was slower on a skewed stream.
template <bool kLive>
__device__ __forceinline__ bool sum_run(int64_t s, int32_t row, const int32_t* __restrict__ rows,
                                        const int32_t* __restrict__ bags,
                                        const int32_t* __restrict__ msk,
                                        const float* __restrict__ wgt,
                                        const uint16_t* __restrict__ dY, int64_t L, int E, int c,
                                        bool active, float& a0, float& a1) {
  const int lane = threadIdx.x & 31;
  bool live = false;
  int64_t base = s;
  Seg sa = load_seg(rows, bags, msk, wgt, base + lane, L);
  Plan pa = plan_seg(sa, row);
  uint32_t va[kSeg];
  load_rows(va, sa, pa, dY, E, c, active);
  Seg sb = pa.n == kSeg ? load_seg(rows, bags, msk, wgt, base + kSeg + lane, L) : Seg{-1, -1, 0.f};
  while (pa.n > 0) {
    const Plan pb = pa.n == kSeg ? plan_seg(sb, row) : Plan{0, 0u, true};
    uint32_t vb[kSeg];
    load_rows(vb, sb, pb, dY, E, c, active);
    const Seg sc = pb.n == kSeg ? load_seg(rows, bags, msk, wgt, base + 2 * kSeg + lane, L)
                                : Seg{-1, -1, 0.f};
    if (kLive) live = live || __any_sync(kFull, lane < pa.n && sa.bag >= 0);
    add_rows(a0, a1, va, sa, pa);
#pragma unroll
    for (int u = 0; u < kSeg; ++u) va[u] = vb[u];
    sa = sb;
    pa = pb;
    sb = sc;
    base += kSeg;
  }
  return live;
}

// The row's step.  Every operation rounds where the plain version
// (repro_torch/kernels/ref.py) rounds, which is where jitted JAX rounds: an
// FMA where it contracts one (w - lr*acc, s + acc*acc, w - lr*m), every other
// product, quotient, root and sum on its own.  No fast math.  Momentum's new
// m is the run's lookups added in order onto beta*m (rounded once), not
// beta*m + acc: jitted XLA folds beta*m + segment_sum into a scatter-add
// that starts from beta*m.  The bf16 kinds decode their state exactly, step in
// fp32 as above, and round only what they store.
enum class Op { kMomentum, kAdagrad, kRowwise, kFreq, kMomentumBf16, kAdagradBf16 };

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

// The store of a stateful kind: W and the state slab S, [M, E] fp32 (mom,
// acc), [M, E] bf16 (the compressed mom, acc), [M] fp32 (the row-wise acc) or
// [M] int32 (cnt).  hp is beta (momentum) or eps (the Adagrad kinds).  seed
// points at the stochastic rounding's int32 seed on the device (the bf16
// kinds; read there, so the host never waits for it).
struct Store {
  float* W;
  void* S;
  float lr, hp;
  const int32_t* seed;
};

// Row-wise Adagrad needs the whole row's sum of acc^2 before it writes any
// column.  Pass one walks each block of 64 columns and adds this lane's two
// squares to q, block after block (each product and each add rounded on its
// own); a butterfly of __shfl_xor_sync (16, 8, 4, 2, 1) then leaves the same
// sum in every lane; s += sum / E.  Pass two steps the columns from the last
// block back, walking the run again for every block but the last, whose sums
// are still held: the same walk gives the same bits.
__device__ void update_rowwise(int64_t s, int32_t row, const int32_t* __restrict__ rows,
                               const int32_t* __restrict__ bags, const int32_t* __restrict__ msk,
                               const float* __restrict__ wgt, const uint16_t* __restrict__ dY,
                               const Store& st, int64_t L, int E) {
  const int lane = threadIdx.x & 31;
  float* acc = static_cast<float*>(st.S);
  const float s_old = acc[row];
  float q = 0.f, a0 = 0.f, a1 = 0.f;
  bool live = false;
  for (int cb = 0; cb < E; cb += 64) {
    const int c = cb + 2 * lane;
    a0 = a1 = 0.f;
    live = sum_run<true>(s, row, rows, bags, msk, wgt, dY, L, E, c, c < E, a0, a1);
    if (c < E) {
      q = __fadd_rn(q, __fmul_rn(a0, a0));
      q = __fadd_rn(q, __fmul_rn(a1, a1));
    }
  }
  if (!live) return;  // warp-uniform
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) q = __fadd_rn(q, __shfl_xor_sync(kFull, q, off));
  const float s_new = __fadd_rn(s_old, __fdiv_rn(q, static_cast<float>(E)));
  const float d = __fadd_rn(__fsqrt_rn(s_new), st.hp);
  const int last = (E - 1) / 64 * 64;
  for (int cb = last; cb >= 0; cb -= 64) {
    const int c = cb + 2 * lane;
    if (cb != last) {
      a0 = a1 = 0.f;
      sum_run<false>(s, row, rows, bags, msk, wgt, dY, L, E, c, c < E, a0, a1);
    }
    if (c < E) {
      float2* w = reinterpret_cast<float2*>(st.W + static_cast<int64_t>(row) * E + c);
      const float2 old = *w;
      *w = make_float2(scaled_step(old.x, a0, st.lr, d), scaled_step(old.y, a1, st.lr, d));
    }
  }
  if (lane == 0) acc[row] = s_new;
}

// One warp walks the run that starts at s to its end, 64 columns at a time,
// and steps its row as the kind does.  A stateful kind writes nothing for a
// dead run: beta * m is no no-op, nor is a rewrite of the accumulator.  What
// only the step needs (the count's denominator, the row's hash) is computed
// after the walk: a value held live across it slowed the walk of a long run.
template <Op kOp>
__device__ void update_run_state(int64_t s, int32_t row, const int32_t* __restrict__ rows,
                                 const int32_t* __restrict__ bags, const int32_t* __restrict__ msk,
                                 const float* __restrict__ wgt, const uint16_t* __restrict__ dY,
                                 const Store& st, int64_t L, int E) {
  if constexpr (kOp == Op::kRowwise) {
    update_rowwise(s, row, rows, bags, msk, wgt, dY, st, L, E);
  } else {
    constexpr bool kBf16 = kOp == Op::kMomentumBf16 || kOp == Op::kAdagradBf16;
    constexpr bool kMom = kOp == Op::kMomentum || kOp == Op::kMomentumBf16;
    constexpr bool kState = kOp != Op::kFreq;  // an [M, E] slab
    const int lane = threadIdx.x & 31;
    const float lr = st.lr;
    for (int cb = 0; cb < E; cb += 64) {
      const int c = cb + 2 * lane;
      const bool active = c < E;
      const int64_t off = static_cast<int64_t>(row) * E + c;
      float2 w = make_float2(0.f, 0.f), m = make_float2(0.f, 0.f);
      if (active) {  // the old row and its state, loaded while the sums run
        w = *reinterpret_cast<const float2*>(st.W + off);
        if (kBf16) {  // two bf16 values, decoded exactly
          const uint32_t v = *reinterpret_cast<const uint32_t*>(static_cast<const uint16_t*>(st.S) + off);
          m = make_float2(__uint_as_float(v << 16), __uint_as_float(v & 0xffff0000u));
        } else if (kState) {
          m = *reinterpret_cast<const float2*>(static_cast<const float*>(st.S) + off);
        }
      }
      // the sums start from +0; momentum's from beta*m
      float a0 = kMom ? __fmul_rn(st.hp, m.x) : 0.f;
      float a1 = kMom ? __fmul_rn(st.hp, m.y) : 0.f;
      const bool live = sum_run<true>(s, row, rows, bags, msk, wgt, dY, L, E, c, active, a0, a1);
      if (!active || !live) continue;
      if constexpr (kMom) {  // m = beta*m + the run's lookups; w = w - lr*m
        if constexpr (kBf16) {
          const uint32_t base = row_hash(st.seed, row);
          *reinterpret_cast<uint32_t*>(static_cast<uint16_t*>(st.S) + off) =
              sr_bf16(a0, base, c) | (sr_bf16(a1, base, c + 1) << 16);
        } else {
          *reinterpret_cast<float2*>(static_cast<float*>(st.S) + off) = make_float2(a0, a1);
        }
        *reinterpret_cast<float2*>(st.W + off) =
            make_float2(__fmaf_rn(-lr, a0, w.x), __fmaf_rn(-lr, a1, w.y));
      } else if constexpr (kState) {  // s = s + acc*acc; w = w - lr*acc/(sqrt(s)+eps)
        m = make_float2(__fmaf_rn(a0, a0, m.x), __fmaf_rn(a1, a1, m.y));
        if constexpr (kBf16) {  // the step below reads the unrounded s
          const uint32_t base = row_hash(st.seed, row);
          *reinterpret_cast<uint32_t*>(static_cast<uint16_t*>(st.S) + off) =
              sr_bf16(m.x, base, c) | (sr_bf16(m.y, base, c + 1) << 16);
        } else {
          *reinterpret_cast<float2*>(static_cast<float*>(st.S) + off) = m;
        }
        *reinterpret_cast<float2*>(st.W + off) =
            make_float2(scaled_step(w.x, a0, lr, __fadd_rn(__fsqrt_rn(m.x), st.hp)),
                        scaled_step(w.y, a1, lr, __fadd_rn(__fsqrt_rn(m.y), st.hp)));
      } else {  // kFreq: w = w - lr*acc/(sqrt(max(cnt, 1))+eps), the count already bumped
        const float d_freq = __fadd_rn(
            __fsqrt_rn(fmaxf(__int2float_rn(static_cast<const int32_t*>(st.S)[row]), 1.f)), st.hp);
        *reinterpret_cast<float2*>(st.W + off) =
            make_float2(scaled_step(w.x, a0, lr, d_freq), scaled_step(w.y, a1, lr, d_freq));
      }
    }
  }
}

// row_update_kernel's search for the runs, for the stateful kinds: each warp
// looks at a window of 32 positions and walks the runs that start in it.
template <Op kOp>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    state_update_kernel(const int32_t* __restrict__ rows, const int32_t* __restrict__ bags,
                        const int32_t* __restrict__ msk, const float* __restrict__ wgt,
                        const uint16_t* __restrict__ dY, Store st, int64_t L, int E) {
  const int lane = threadIdx.x & 31;
  const int64_t w0 = (static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5)) * kSeg;
  if (w0 >= L) return;
  const int64_t p = w0 + lane;
  const int32_t r = p < L ? __ldg(rows + p) : -1;
  const int32_t prev = (p < L && p > 0) ? __ldg(rows + p - 1) : -1;
  unsigned starts = __ballot_sync(kFull, p < L && (p == 0 || r != prev));
  while (starts) {
    const int k = __ffs(starts) - 1;
    starts &= starts - 1;
    update_run_state<kOp>(w0 + k, __shfl_sync(kFull, r, k), rows, bags, msk, wgt, dY, st, L, E);
  }
}

template <Op kOp>
int launch_state(const void* rows, const void* bags, const void* msk, const void* wgt,
                 const void* dY, Store st, int64_t L, int E, void* stream) {
  if (L == 0) return 0;
  const int64_t warps = (L + kSeg - 1) / kSeg;
  const int64_t blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  state_update_kernel<kOp><<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(rows), static_cast<const int32_t*>(bags),
      static_cast<const int32_t*>(msk), static_cast<const float*>(wgt),
      static_cast<const uint16_t*>(dY), st, L, E);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Sorted stream rows/bags/msk [L] int32, wgt [L] fp32; dY [bags, E] bf16;
// hi/lo [M, E] 16-bit (split) or W [M, E] fp32, updated in place.  E even.
// Returns the CUDA error of the launch (0 = none).
extern "C" int embedding_update_split(const void* rows, const void* bags, const void* msk,
                                      const void* wgt, const void* dY, void* hi, void* lo,
                                      int64_t L, int E, float lr, void* stream) {
  return launch<true>(rows, bags, msk, wgt, dY, hi, lo, nullptr, L, E, lr, stream);
}

extern "C" int embedding_update_fp32(const void* rows, const void* bags, const void* msk,
                                     const void* wgt, const void* dY, void* W, int64_t L, int E,
                                     float lr, void* stream) {
  return launch<false>(rows, bags, msk, wgt, dY, nullptr, nullptr, W, L, E, lr, stream);
}

// The stateful kinds: W [M, E] fp32 and the state slab S, both in place; hp
// is beta (momentum) or eps (the others).  S is mom [M, E] fp32 (momentum),
// acc [M, E] fp32 (adagrad), acc [M] fp32 (adagrad_rowwise) or cnt [M] int32,
// already bumped, read only (freq).
#define STATEFUL_LAUNCHER(name, op)                                                            \
  extern "C" int name(const void* rows, const void* bags, const void* msk, const void* wgt,   \
                      const void* dY, void* W, void* S, int64_t L, int E, float lr, float hp, \
                      void* stream) {                                                          \
    return launch_state<op>(rows, bags, msk, wgt, dY,                                          \
                            Store{static_cast<float*>(W), S, lr, hp, nullptr}, L, E, stream);  \
  }

STATEFUL_LAUNCHER(embedding_update_momentum, Op::kMomentum)
STATEFUL_LAUNCHER(embedding_update_adagrad, Op::kAdagrad)
STATEFUL_LAUNCHER(embedding_update_adagrad_rowwise, Op::kRowwise)
STATEFUL_LAUNCHER(embedding_update_freq, Op::kFreq)

// The compressed-state kinds: S is mom or acc [M, E] bf16; seed points at the
// int32 seed of the stochastic rounding on the device.
#define STATEFUL_SR_LAUNCHER(name, op)                                                         \
  extern "C" int name(const void* rows, const void* bags, const void* msk, const void* wgt,   \
                      const void* dY, void* W, void* S, const void* seed, int64_t L, int E,   \
                      float lr, float hp, void* stream) {                                      \
    return launch_state<op>(                                                                   \
        rows, bags, msk, wgt, dY,                                                              \
        Store{static_cast<float*>(W), S, lr, hp, static_cast<const int32_t*>(seed)}, L, E,    \
        stream);                                                                               \
  }

STATEFUL_SR_LAUNCHER(embedding_update_momentum_bf16, Op::kMomentumBf16)
STATEFUL_SR_LAUNCHER(embedding_update_adagrad_bf16, Op::kAdagradBf16)
