// One MLP layer: out = act(x @ w + b) with x [M, K] and w [K, N] bf16,
// row-major, b [N] bf16 or fp32, fp32 accumulation on the tensor cores, and
// the bias, the activation and the output cast in the epilogue.  Two kernels:
//  - fused_mlp_wgmma_kernel (fused_mlp_wgmma_fwd), for K % 8 == 0 and
//    N % 8 == 0, the strides a TMA tensor map takes: warp-specialised, a
//    producer warp streams 64-deep K slices of x and w by TMA into a 4-stage
//    ring with full and empty mbarriers, two consumer warpgroups (64 rows
//    each of a 128 x 256 output tile, or 128 x 128 where the grid would
//    leave SMs idle) run wgmma m64n256k16 or m64n128k16 from shared memory;
//  - fused_mlp_simt_kernel (fused_mlp_fwd), every other shape: mma.sync
//    m16n8k16 from shared memory filled by plain loads.
// Ragged M, N and K are masked (or zero-filled by TMA), so the caller pads
// nothing.  The design note is in repro_torch/kernels/fused_mlp.py.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int PAD = 8;  // keeps 16-byte row alignment and staggers the banks
constexpr int kThreads = 256;  // 8 warps as 2 (M) x 4 (N), each a 64 x 32 sub-tile

enum Activation { kNone = 0, kRelu = 1, kSigmoid = 2 };

// the epilogue of both kernels: bias in fp32, activation, cast
__device__ __forceinline__ float bias_at(const void* bias, int bias_bf16, int c) {
  return bias_bf16 ? __uint_as_float(static_cast<uint32_t>(static_cast<const uint16_t*>(bias)[c])
                                     << 16)
                   : static_cast<const float*>(bias)[c];
}

__device__ __forceinline__ float activate(float y, int act) {
  if (act == kRelu) return fmaxf(y, 0.f);
  if (act == kSigmoid) return 1.f / (1.f + expf(-y));
  return y;
}

__device__ __forceinline__ void store_out(void* out, int out_bf16, int64_t o, float y) {
  if (out_bf16) {
    static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16(y);
  } else {
    static_cast<float*>(out)[o] = y;
  }
}

__device__ __forceinline__ uint32_t pack2(uint16_t lo, uint16_t hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Copies a rows x cols tile at (r0, c0) of a row-major [R, C] bf16 matrix into
// shared memory with row stride ld, zero-filling outside the matrix.  16-byte
// loads where the row stride allows them (C % 8 == 0), single values elsewhere.
template <int ROWS, int COLS>
__device__ __forceinline__ void load_tile(uint16_t* dst, int ld, const uint16_t* __restrict__ src,
                                          int R, int C, int r0, int c0) {
  const bool vec = (C % 8) == 0;
  for (int ch = threadIdx.x; ch < ROWS * (COLS / 8); ch += kThreads) {
    const int r = ch / (COLS / 8);
    const int c = (ch % (COLS / 8)) * 8;
    const int gr = r0 + r;
    const int gc = c0 + c;
    uint16_t* d = dst + r * ld + c;
    const uint16_t* s = src + static_cast<int64_t>(gr) * C + gc;
    if (vec && gr < R && gc + 8 <= C) {
      *reinterpret_cast<uint4*>(d) = __ldg(reinterpret_cast<const uint4*>(s));
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) d[i] = (gr < R && gc + i < C) ? s[i] : uint16_t{0};
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    fused_mlp_simt_kernel(const uint16_t* __restrict__ x, const uint16_t* __restrict__ w,
                          const void* __restrict__ bias, void* __restrict__ out, int M, int N, int K,
                          int bias_bf16, int out_bf16, int act) {
  __shared__ __align__(16) uint16_t As[BM][BK + PAD];
  __shared__ __align__(16) uint16_t Bs[BK][BN + PAD];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wm = warp >> 2;
  const int wn = warp & 3;
  const int gid = lane >> 2;  // mma fragment row / column group
  const int tig = lane & 3;   // thread in group
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    load_tile<BM, BK>(&As[0][0], BK + PAD, x, M, K, m0, k0);
    load_tile<BK, BN>(&Bs[0][0], BN + PAD, w, K, N, k0, n0);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[4][4];
      uint32_t b[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int r = wm * 64 + mi * 16 + gid;
        const int k = kk + tig * 2;
        a[mi][0] = *reinterpret_cast<const uint32_t*>(&As[r][k]);
        a[mi][1] = *reinterpret_cast<const uint32_t*>(&As[r + 8][k]);
        a[mi][2] = *reinterpret_cast<const uint32_t*>(&As[r][k + 8]);
        a[mi][3] = *reinterpret_cast<const uint32_t*>(&As[r + 8][k + 8]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int c = wn * 32 + ni * 8 + gid;
        const int k = kk + tig * 2;
        b[ni][0] = pack2(Bs[k][c], Bs[k + 1][c]);
        b[ni][1] = pack2(Bs[k + 8][c], Bs[k + 9][c]);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_16816(acc[mi][ni], a[mi], b[ni]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = m0 + wm * 64 + mi * 16 + gid + (q >> 1) * 8;
        const int c = n0 + wn * 32 + ni * 8 + tig * 2 + (q & 1);
        if (r >= M || c >= N) continue;
        store_out(out, out_bf16, static_cast<int64_t>(r) * N + c,
                  activate(acc[mi][ni][q] + bias_at(bias, bias_bf16, c), act));
      }
    }
  }
}

// ------------------------------------------------------------ wgmma route --

namespace wg {

using namespace hopper;

constexpr int TM = 128;  // output tile rows: two consumer warpgroups of 64
constexpr int TK = 64;   // K slice a stage: one 128-byte swizzle row of x
constexpr int STAGES = 4;
constexpr int kThreads = 384;  // producer warpgroup (one thread works) + 2 consumer warpgroups
constexpr int kConsumerWarps = 8;
constexpr int kABytes = TM * TK * 2;  // x slice [TM, TK], one box
constexpr int kBBox = TK * 64 * 2;    // w slice [TK, 64], one box of 64 columns

template <int TN>
__host__ __device__ constexpr int stage_bytes() {
  return kABytes + (TN / 64) * kBBox;
}

template <int TN>
constexpr int smem_bytes() {
  return 1024 + STAGES * stage_bytes<TN>();  // 1024 for the alignment
}

// one k16 step of a consumer's 64 x TN tile
template <int TN>
__device__ __forceinline__ void mma_k16(float (&acc)[TN / 2], uint64_t da, uint64_t db) {
  if constexpr (TN == 256) {
    wgmma_m64n256k16_ss<1>(acc, da, db, 1);
  } else {
    wgmma_m64n128k16_ss<1>(acc, da, db, 1);
  }
}

template <int TN>
__global__ void __launch_bounds__(kThreads, 1)
    fused_mlp_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                           const __grid_constant__ CUtensorMap tm_w, const void* __restrict__ bias,
                           void* __restrict__ out, int M, int N, int K, int bias_bf16, int out_bf16,
                           int act) {
  constexpr int kStage = stage_bytes<TN>();
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * STAGES];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const auto sa = [&](int s) { return base + s * kStage; };
  const auto sb = [&](int s) { return base + s * kStage + kABytes; };
  const auto full = [&](int s) { return smem_u32(bars) + 8 * s; };
  const auto empty = [&](int s) { return smem_u32(bars) + 8 * (STAGES + s); };
  const int m0 = blockIdx.y * TM;
  const int n0 = blockIdx.x * TN;
  const int nk = (K + TK - 1) / TK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumerWarps);  // lane 0 of every consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer: one thread keeps STAGES slices of x and w in flight
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      for (int i = 0; i < nk; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) mbar_wait(empty(s), ((i / STAGES) & 1) ^ 1);
        mbar_expect_tx(full(s), kStage);
        tma_load_2d(sa(s), &tm_x, full(s), i * TK, m0);
        for (int x = 0; x < TN / 64; ++x)
          tma_load_2d(sb(s) + x * kBBox, &tm_w, full(s), n0 + 64 * x, i * TK);
      }
    }
  } else {
    // ---- consumers: warpgroup c owns rows 64c .. 64c + 63 of the tile
    setmaxnreg_inc<232>();
    const int c = threadIdx.x / 128 - 1;
    const int lane = threadIdx.x & 31;
    const int warp = (threadIdx.x >> 5) & 3;
    float acc[TN / 2];
#pragma unroll
    for (int i = 0; i < TN / 2; ++i) acc[i] = 0.f;
    fence_regs(acc);
    // one slice's products in flight while the next slice's are issued; a
    // stage is released once the products that read it are done
    for (int i = 0; i < nk; ++i) {
      const int s = i % STAGES;
      mbar_wait(full(s), (i / STAGES) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk)
        mma_k16<TN>(acc, desc_kmajor(sa(s) + c * 64 * 128 + kk * 32),
                    desc_mnmajor(sb(s) + kk * 16 * 128, kBBox));
      wgmma_commit();
      wgmma_wait<1>();
      if (i > 0 && lane == 0) mbar_arrive(empty((i - 1) % STAGES));
    }
    wgmma_wait<0>();
    fence_regs(acc);

    // accumulator tile j of 8 columns: rows gid and gid + 8 of this warp's
    // 16, columns 2 tig and 2 tig + 1; N % 8 == 0, so a pair is all in or out
    const int gid = lane >> 2;
    const int tig = lane & 3;
    const int r0 = m0 + 64 * c + warp * 16 + gid;
#pragma unroll
    for (int j = 0; j < TN / 8; ++j) {
      const int col = n0 + j * 8 + tig * 2;
      if (col >= N) continue;
      const float b0 = bias_at(bias, bias_bf16, col);
      const float b1 = bias_at(bias, bias_bf16, col + 1);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r0 + 8 * r;
        if (row >= M) continue;
        const float y0 = activate(acc[4 * j + 2 * r] + b0, act);
        const float y1 = activate(acc[4 * j + 2 * r + 1] + b1, act);
        const int64_t o = static_cast<int64_t>(row) * N + col;
        if (out_bf16) {
          *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) + o) =
              __floats2bfloat162_rn(y0, y1);
        } else {
          *reinterpret_cast<float2*>(static_cast<float*>(out) + o) = make_float2(y0, y1);
        }
      }
    }
  }
}

}  // namespace wg

}  // namespace

// x [M, K], w [K, N] bf16; bias [N] (bf16 when bias_bf16, else fp32); out [M, N]
// (bf16 when out_bf16, else fp32); act: 0 none, 1 relu, 2 sigmoid.  Each
// launcher returns the CUDA error of its launch (0 = none).

// The mma.sync route: any shape.
extern "C" int fused_mlp_fwd(const void* x, const void* w, const void* bias, void* out, int M, int N,
                             int K, int bias_bf16, int out_bf16, int act, void* stream) {
  if (M == 0 || N == 0) return 0;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  fused_mlp_simt_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(w), bias, out, M, N, K, bias_bf16,
      out_bf16, act);
  return static_cast<int>(cudaGetLastError());
}

namespace {

// the output tile's width: 256 columns (a wgmma m64n256k16 a consumer, half
// the x traffic of 128 a flop) where the grid still has a tile for about
// every SM, else 128
int tile_n(int M, int N) {
  const int tiles256 = ((M + wg::TM - 1) / wg::TM) * ((N + 255) / 256);
  return N >= 256 && tiles256 >= 96 ? 256 : 128;
}

template <int TN>
int launch_wgmma(const CUtensorMap& tm_x, const CUtensorMap& tm_w, const void* bias, void* out,
                 int M, int N, int K, int bias_bf16, int out_bf16, int act, cudaStream_t stream) {
  constexpr int smem = wg::smem_bytes<TN>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      wg::fused_mlp_wgmma_kernel<TN>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((N + TN - 1) / TN, (M + wg::TM - 1) / wg::TM);
  wg::fused_mlp_wgmma_kernel<TN><<<grid, wg::kThreads, smem, stream>>>(
      tm_x, tm_w, bias, out, M, N, K, bias_bf16, out_bf16, act);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The wgmma route: x and w contiguous and 16-byte aligned, K > 0, K % 8 == 0
// and N % 8 == 0 (a tensor map's row stride is a multiple of 16 bytes);
// returns -1 for any other shape.
extern "C" int fused_mlp_wgmma_fwd(const void* x, const void* w, const void* bias, void* out, int M,
                                   int N, int K, int bias_bf16, int out_bf16, int act,
                                   void* stream) {
  if (M == 0 || N == 0) return 0;
  if (K <= 0 || K % 8 || N % 8) return -1;
  CUtensorMap tm_x, tm_w;
  // x [M, K] as K-major boxes of [128 rows, 64 k]; w [K, N] as boxes of [64 k, 64 n]
  const uint64_t xdims[2] = {static_cast<uint64_t>(K), static_cast<uint64_t>(M)};
  const uint64_t xstrides[1] = {static_cast<uint64_t>(K) * 2};
  const uint32_t xbox[2] = {wg::TK, wg::TM};
  const uint64_t wdims[2] = {static_cast<uint64_t>(N), static_cast<uint64_t>(K)};
  const uint64_t wstrides[1] = {static_cast<uint64_t>(N) * 2};
  const uint32_t wbox[2] = {64, wg::TK};
  int err = hopper::make_map_bf16(&tm_x, x, 2, xdims, xstrides, xbox);
  if (!err) err = hopper::make_map_bf16(&tm_w, w, 2, wdims, wstrides, wbox);
  if (err) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile_n(M, N) == 256)
    return launch_wgmma<256>(tm_x, tm_w, bias, out, M, N, K, bias_bf16, out_bf16, act, s);
  return launch_wgmma<128>(tm_x, tm_w, bias, out, M, N, K, bias_bf16, out_bf16, act, s);
}
