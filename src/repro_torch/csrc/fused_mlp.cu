// One MLP layer: out = act(x @ w + b) with x [M, K] and w [K, N] bf16,
// row-major, b [N] bf16 or fp32, fp32 accumulation on the tensor cores
// (mma.sync m16n8k16), and the bias, the activation and the output cast in the
// epilogue.  Ragged M, N and K are masked here, so the caller pads nothing.
// The design note is in repro_torch/kernels/fused_mlp.py.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int PAD = 8;  // keeps 16-byte row alignment and staggers the banks
constexpr int kThreads = 256;  // 8 warps as 2 (M) x 4 (N), each a 64 x 32 sub-tile

enum Activation { kNone = 0, kRelu = 1, kSigmoid = 2 };

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
    fused_mlp_kernel(const uint16_t* __restrict__ x, const uint16_t* __restrict__ w,
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
        const float bc = bias_bf16
                             ? __uint_as_float(static_cast<uint32_t>(
                                                   static_cast<const uint16_t*>(bias)[c])
                                               << 16)
                             : static_cast<const float*>(bias)[c];
        float y = acc[mi][ni][q] + bc;
        if (act == kRelu) {
          y = fmaxf(y, 0.f);
        } else if (act == kSigmoid) {
          y = 1.f / (1.f + expf(-y));
        }
        const int64_t o = static_cast<int64_t>(r) * N + c;
        if (out_bf16) {
          static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16(y);
        } else {
          static_cast<float*>(out)[o] = y;
        }
      }
    }
  }
}

}  // namespace

// x [M, K], w [K, N] bf16; bias [N] (bf16 when bias_bf16, else fp32); out [M, N]
// (bf16 when out_bf16, else fp32); act: 0 none, 1 relu, 2 sigmoid.  Returns the
// CUDA error of the launch (0 = none).
extern "C" int fused_mlp_fwd(const void* x, const void* w, const void* bias, void* out, int M, int N,
                             int K, int bias_bf16, int out_bf16, int act, void* stream) {
  if (M == 0 || N == 0) return 0;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  fused_mlp_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(w), bias, out, M, N, K, bias_bf16,
      out_bf16, act);
  return static_cast<int>(cudaGetLastError());
}
