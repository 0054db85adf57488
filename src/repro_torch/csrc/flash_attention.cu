// Flash attention forward: o = softmax(mask(softcap(scale * q k^T))) v, with
// q [B, H, Lq, D] and k, v [B, Hkv, Lk, D] bf16, row-major, o in q's layout.
// Warp-specialised for Hopper: one block per (128 queries, head, batch) of
// three warpgroups.  The producer warpgroup gives up its registers and one
// of its threads streams the block's Q tile and its visible K and V tiles of
// 128 keys by TMA into rings of shared memory, with full and empty mbarriers;
// the two consumer warpgroups, 64 query rows each, compute S = Q K^T with
// wgmma from shared memory, the online softmax on the accumulator in
// registers, and O += bf16(P) V with wgmma from registers, taking turns on
// the tensor cores so that one's softmax runs under the other's products.
// TMA zero-fills rows past Lq and Lk; the masks do the rest, so the caller
// pads nothing.  The design note is in repro_torch/kernels/flash_attention.py.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BQ = 128;   // queries a block: two consumer warpgroups of 64 rows
constexpr int BK = 128;   // keys a tile: where the running max is updated, as the TPU kernel's bk
constexpr int STAGES = 2;  // K and V tiles in flight
constexpr int kThreads = 384;
constexpr int kConsumerThreads = 256;
constexpr float kNegInf = -1e30f;  // a masked score (the TPU kernel's NEG_INF)
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBarTurn = 1;  // named barriers 1 and 2: consumer 0's and consumer 1's turn

template <int D>
constexpr int smem_bytes() {
  return 1024 + BQ * D * 2 + 2 * STAGES * BK * D * 2;  // 1024 for the alignment
}

// 2^x on the multi-function unit (ex2.approx.ftz: a result below 2^-126,
// which no bf16 sum of p feels, flushes to 0)
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// one warpgroup's online softmax over a 64 x 128 score tile on the wgmma
// accumulator layout: a thread holds rows gid and gid + 8 of its warp's 16,
// columns 8j + 2 tig and 8j + 2 tig + 1 of tile j (s[4j + e], e's bit 1 the
// row); a row's 128 values lie on the 4 threads of a quad.  kCapped (the
// soft-cap) is a template argument and the masking a second one, so that a
// tile pays for neither where it has none
template <bool kCapped>
struct Softmax {
  float cf, cap_in, cap_out;
  int Lk, causal, window, tig;
  int pa[2];     // the thread's two query positions
  int wa0, wa1;  // the warpgroup's first and last query positions

  // whether the tile at key k0 can hold a masked pair for a query of this
  // warpgroup
  __device__ __forceinline__ bool edge(int k0) const {
    return k0 + BK > Lk || (causal && k0 + BK - 1 > wa0) || (window > 0 && k0 <= wa1 - window);
  }

  // soft-cap, mask, running max m, s := p, running sum l; alpha the factor
  // for the output accumulated so far
  template <bool kEdge>
  __device__ __forceinline__ void step(float (&s)[64], float (&m)[2], float (&l)[2],
                                       float (&alpha)[2], int k0) const {
    uint64_t live = ~0ull;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[4 * j + e];
        if constexpr (kCapped) x = cap_out * tanhf(x * cap_in);
        if constexpr (kEdge) {
          const int kp = k0 + j * 8 + tig * 2 + (e & 1);
          const int qp = pa[e >> 1];
          const bool ok = kp < Lk && (!causal || kp <= qp) && (window <= 0 || kp > qp - window);
          if (!ok) {
            x = kNegInf;
            live &= ~(1ull << (j * 4 + e));
          }
        }
        s[4 * j + e] = x;
      }
    }
    float mc[2];
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int j = 0; j < 16; ++j) mx = fmaxf(mx, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      alpha[r] = exp2_fast((m[r] - mx) * cf);
      m[r] = mx;
      mc[r] = mx * cf;
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2_fast(fmaf(s[4 * j + e], cf, -mc[e >> 1]));
        if constexpr (kEdge) p = (live >> (j * 4 + e)) & 1ull ? p : 0.f;
        s[4 * j + e] = p;
        sum[e >> 1] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l[r] = __fadd_rn(__fmul_rn(l[r], alpha[r]), sum[r]);
    }
  }

  __device__ __forceinline__ void operator()(float (&s)[64], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], int k0) const {
    if (edge(k0)) {
      step<true>(s, m, l, alpha, k0);
    } else {
      step<false>(s, m, l, alpha, k0);
    }
  }
};

// S = Q K^T for one warpgroup: D/16 wgmma m64n128k16, both operands K-major
// in shared memory (Q's 64 rows at sq, the K tile at sk, each a stack of
// 64-column boxes), in one asm statement
template <int D>
__device__ __forceinline__ void issue_s(float (&s)[64], uint32_t sq, uint32_t sk) {
  fence_regs(s);
  if constexpr (D == 128) {
    wgmma_qk_d128(s, desc_kmajor(sq), desc_kmajor(sk));
  } else {
    wgmma_qk_d64(s, desc_kmajor(sq), desc_kmajor(sk));
  }
}

// O += bf16(P) V: 8 wgmma m64nDk16 with P's A fragments in registers and
// the V tile [keys, D] at sv an MN-major operand, in one asm statement
template <int D>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2], uint32_t (&p)[8][4], uint32_t sv) {
  fence_regs(acc);
#pragma unroll
  for (int kc = 0; kc < 8; ++kc) fence_regs(p[kc]);
  if constexpr (D == 128) {
    wgmma_pv_d128(acc, p, desc_mnmajor(sv, BK * 128));
  } else {
    wgmma_pv_d64(acc, p, desc_mnmajor(sv, BK * 128));
  }
}

template <int D>
__device__ __forceinline__ void rescale(float (&acc)[D / 2], const float (&alpha)[2]) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    acc[4 * j] *= alpha[0];
    acc[4 * j + 1] *= alpha[0];
    acc[4 * j + 2] *= alpha[1];
    acc[4 * j + 3] *= alpha[1];
  }
}

// the score tiles 2kc and 2kc + 1 are the A fragment of k16 step kc
__device__ __forceinline__ void pack_p(const float (&s)[64], uint32_t (&p)[8][4]) {
#pragma unroll
  for (int kc = 0; kc < 8; ++kc) {
    p[kc][0] = pack_bf16(s[8 * kc], s[8 * kc + 1]);
    p[kc][1] = pack_bf16(s[8 * kc + 2], s[8 * kc + 3]);
    p[kc][2] = pack_bf16(s[8 * kc + 4], s[8 * kc + 5]);
    p[kc][3] = pack_bf16(s[8 * kc + 6], s[8 * kc + 7]);
  }
}

// lane 0 of each consumer warp arrives once the warp is done with a stage
__device__ __forceinline__ void release(uint32_t empty_bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(empty_bar);
}

template <int D, bool kCapped>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o,
                           int H, int Hkv, int Lq, int Lk, float scale, int causal, float softcap,
                           int window) {
  constexpr int kBoxes = D / 64;       // 64-column TMA boxes across the head dim
  constexpr int kBoxQ = BQ * 128;      // bytes of one Q box
  constexpr int kBoxKV = BK * 128;     // bytes of one K or V box
  constexpr int kTile = kBoxes * kBoxKV;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 4 * STAGES];

  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sK = sQ + kBoxes * kBoxQ;
  const uint32_t sV = sK + STAGES * kTile;
  const uint32_t q_full = smem_u32(bars);
  const auto k_full = [&](int s) { return q_full + 8 * (1 + s); };
  const auto k_empty = [&](int s) { return q_full + 8 * (1 + STAGES + s); };
  const auto v_full = [&](int s) { return q_full + 8 * (1 + 2 * STAGES + s); };
  const auto v_empty = [&](int s) { return q_full + 8 * (1 + 3 * STAGES + s); };

  const int qt = gridDim.x - 1 - blockIdx.x;  // causal: the tiles with the most keys start first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);  // GQA: jnp.repeat's order
  const int q0 = qt * BQ;
  const int shift = Lk - Lq;  // right-aligned: query i sits at key position Lk - Lq + i

  // the key tiles any query of this block can see (the TPU kernel's `needed`)
  const int qa0 = q0 + shift;
  const int qa1 = min(q0 + BQ, Lq) - 1 + shift;
  const int kfirst = window > 0 ? max(0, qa0 - window + 1) : 0;
  const int klast = causal ? min(Lk - 1, qa1) : Lk - 1;
  const int t0 = kfirst / BK;
  const int n = klast >= kfirst ? klast / BK - t0 + 1 : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), kConsumerThreads / 32);  // lane 0 of every consumer warp
      mbar_init(v_empty(s), kConsumerThreads / 32);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer: one thread issues every TMA load of the block
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0 && n > 0) {
      const int qrow = b * H + h;
      const int kvrow = b * Hkv + hk;
      mbar_expect_tx(q_full, kBoxes * kBoxQ);
      for (int x = 0; x < kBoxes; ++x) tma_load_3d(sQ + x * kBoxQ, &tm_q, q_full, x * 64, q0, qrow);
      for (int i = 0; i < n; ++i) {
        const int s = i % STAGES;
        const uint32_t released = ((i / STAGES) & 1) ^ 1;  // parity of tile i - STAGES's release
        const int k0 = (t0 + i) * BK;
        if (i >= STAGES) mbar_wait(k_empty(s), released);
        mbar_expect_tx(k_full(s), kTile);
        for (int x = 0; x < kBoxes; ++x)
          tma_load_3d(sK + s * kTile + x * kBoxKV, &tm_k, k_full(s), x * 64, k0, kvrow);
        if (i >= STAGES) mbar_wait(v_empty(s), released);
        mbar_expect_tx(v_full(s), kTile);
        for (int x = 0; x < kBoxes; ++x)
          tma_load_3d(sV + s * kTile + x * kBoxKV, &tm_v, v_full(s), x * 64, k0, kvrow);
      }
    }
  } else {
    // ---- consumers: warpgroup c owns query rows 64c .. 64c + 63 of the block
    setmaxnreg_inc<240>();
    const int c = threadIdx.x / 128 - 1;
    const int lane = threadIdx.x & 31;
    const int warp = (threadIdx.x >> 5) & 3;
    const int gid = lane >> 2;  // accumulator row (and column group)
    const int tig = lane & 3;   // thread in group
    const int r0 = q0 + 64 * c + warp * 16 + gid;  // this thread's rows r0 and r0 + 8
    const int pa[2] = {r0 + shift, r0 + 8 + shift};
    const int wa0 = q0 + 64 * c + shift;  // the warpgroup's first and last query positions
    const int wa1 = wa0 + 63;

    float acc[D / 2];  // O: D/8 column tiles of 4
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m[2] = {kNegInf, kNegInf};  // running max of the values below
    float l[2] = {0.f, 0.f};

    if (n > 0) {
      // the softmax works in log2 units: a score's value v (q.k, or with the
      // soft-cap already softcap * log2e * tanh(scale * q.k / softcap)), and
      // p = 2^(v * cf - m * cf), the scale folded into one FMA
      Softmax<kCapped> sm;
      sm.cf = kCapped ? 1.f : scale * kLog2e;
      sm.cap_in = kCapped ? scale / softcap : 0.f;
      sm.cap_out = softcap * kLog2e;
      sm.Lk = Lk;
      sm.causal = causal;
      sm.window = window;
      sm.tig = tig;
      sm.pa[0] = pa[0];
      sm.pa[1] = pa[1];
      sm.wa0 = wa0;
      sm.wa1 = wa1;
      const int me = kBarTurn + c;
      const int other = kBarTurn + 1 - c;
      const uint32_t sQc = sQ + c * 64 * 128;  // this warpgroup's 64 rows of each Q box
      uint32_t p[8][4];  // bf16(P) as the A fragments of the 8 k16 steps of the PV product
      float alpha[2];
      mbar_wait(q_full, 0);
      if (c == 1) bar_arrive(kBarTurn, kConsumerThreads);  // consumer 0 takes the first turn

      // tile 0: its score product alone.  S (16 column tiles of 4, 128 keys)
      // is declared afresh for each tile: carried across the loop, its
      // registers would be copied between the wgmma instructions that chain
      // on them, and ptxas would serialize those
      {
        float s[64];
        mbar_wait(k_full(0), 0);
        bar_sync(me, kConsumerThreads);
        issue_s<D>(s, sQc, sK);
        if (!(c == 1 && n == 1)) bar_arrive(other, kConsumerThreads);
        wgmma_wait<0>();
        fence_regs(s);
        release(k_empty(0), lane);
        sm(s, m, l, alpha, t0 * BK);
        pack_p(s, p);
      }

      // tiles 1 .. n-1: one turn issues tile i's score product and tile
      // i-1's PV product; tile i's softmax runs while the other consumer
      // has its turn and this one's PV product is in flight
      for (int i = 1; i < n; ++i) {
        float s[64];
        const int ss = i % STAGES;
        const int sv = (i - 1) % STAGES;
        mbar_wait(k_full(ss), (i / STAGES) & 1);
        bar_sync(me, kConsumerThreads);
        rescale<D>(acc, alpha);
        issue_s<D>(s, sQc, sK + ss * kTile);
        mbar_wait(v_full(sv), ((i - 1) / STAGES) & 1);
        issue_pv<D>(acc, p, sV + sv * kTile);
        if (!(c == 1 && i == n - 1)) bar_arrive(other, kConsumerThreads);
        wgmma_wait<1>();
        fence_regs(s);
        release(k_empty(ss), lane);
        sm(s, m, l, alpha, (t0 + i) * BK);
        wgmma_wait<0>();
        fence_regs(acc);
#pragma unroll
        for (int kc = 0; kc < 8; ++kc) fence_regs(p[kc]);
        release(v_empty(sv), lane);
        pack_p(s, p);
      }

      // the last tile's PV product
      const int sv = (n - 1) % STAGES;
      rescale<D>(acc, alpha);
      mbar_wait(v_full(sv), ((n - 1) / STAGES) & 1);
      issue_pv<D>(acc, p, sV + sv * kTile);
      wgmma_wait<0>();
      fence_regs(acc);
    }

    // o = acc / l, with l == 0 (a row that saw no key) read as 1
    __nv_bfloat16* ob = o + (static_cast<int64_t>(b) * H + h) * Lq * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r;
      if (row >= Lq) continue;
      const float li = l[r] == 0.f ? 1.f : l[r];
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const __nv_bfloat162 val =
            __floats2bfloat162_rn(acc[4 * j + 2 * r] / li, acc[4 * j + 2 * r + 1] / li);
        *reinterpret_cast<__nv_bfloat162*>(ob + static_cast<int64_t>(row) * D + j * 8 + tig * 2) =
            val;
      }
    }
  }
}

template <int D, bool kCapped>
int launch_kernel(const CUtensorMap& tm_q, const CUtensorMap& tm_k, const CUtensorMap& tm_v,
                  void* o, int H, int Hkv, int Lq, int Lk, float scale, int causal, float softcap,
                  int window, dim3 grid, int smem, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_attention_kernel<D, kCapped>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  flash_attention_kernel<D, kCapped><<<grid, kThreads, smem, stream>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(o), H, Hkv, Lq, Lk, scale, causal, softcap,
      window);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H, int Hkv, int Lq,
           int Lk, float scale, int causal, float softcap, int window, cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v;
  // [B*H, Lq, D] and [B*Hkv, Lk, D], innermost first; boxes of 64 columns x 128 rows
  const uint64_t qdims[3] = {static_cast<uint64_t>(D), static_cast<uint64_t>(Lq),
                             static_cast<uint64_t>(B) * H};
  const uint64_t qstrides[2] = {static_cast<uint64_t>(D) * 2, static_cast<uint64_t>(Lq) * D * 2};
  const uint64_t kdims[3] = {static_cast<uint64_t>(D), static_cast<uint64_t>(Lk),
                             static_cast<uint64_t>(B) * Hkv};
  const uint64_t kstrides[2] = {static_cast<uint64_t>(D) * 2, static_cast<uint64_t>(Lk) * D * 2};
  const uint32_t qbox[3] = {64, BQ, 1};
  const uint32_t kbox[3] = {64, BK, 1};
  int err = make_map_bf16(&tm_q, q, 3, qdims, qstrides, qbox);
  if (!err) err = make_map_bf16(&tm_k, k, 3, kdims, kstrides, kbox);
  if (!err) err = make_map_bf16(&tm_v, v, 3, kdims, kstrides, kbox);
  if (err) return err;
  constexpr int smem = smem_bytes<D>();
  const dim3 grid((Lq + BQ - 1) / BQ, H, B);
  if (softcap > 0.f) return launch_kernel<D, true>(tm_q, tm_k, tm_v, o, H, Hkv, Lq, Lk, scale,
                                                   causal, softcap, window, grid, smem, stream);
  return launch_kernel<D, false>(tm_q, tm_k, tm_v, o, H, Hkv, Lq, Lk, scale, causal, softcap,
                                 window, grid, smem, stream);
}

}  // namespace

// q [B, H, Lq, D], k and v [B, Hkv, Lk, D] bf16 contiguous and 16-byte
// aligned, o [B, H, Lq, D] bf16; D 64 or 128, H % Hkv == 0; window 0 =
// global, softcap 0 = none.  Returns the CUDA error of the launch (0 = none;
// -1 = an unsupported D).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int B,
                                   int H, int Hkv, int Lq, int Lk, int D, float scale, int causal,
                                   float softcap, int window, void* stream) {
  if (B == 0 || H == 0 || Lq == 0) return 0;
  if (D != 64 && D != 128) return -1;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Lk == 0) {  // no key: every query gives 0
    return static_cast<int>(
        cudaMemsetAsync(o, 0, static_cast<size_t>(B) * H * Lq * D * 2, s));
  }
  if (D == 128) return launch<128>(q, k, v, o, B, H, Hkv, Lq, Lk, scale, causal, softcap, window, s);
  return launch<64>(q, k, v, o, B, H, Hkv, Lq, Lk, scale, causal, softcap, window, s);
}
