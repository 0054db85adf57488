// Fused sparse backward + row update on the sorted lookup stream: for each run
// of equal rows, acc = sum(wgt * dY[bag]) in sorted order, then
// w = fmaf(-lr, acc, w) on that row only, in place.  The store is the split
// pair hi (bf16 bits) / lo (low 16 bits) or an fp32 W.  The design note is in
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
