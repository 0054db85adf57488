// Flat Split-SGD step, in place: w = (hi << 16) | lo; with momentum
// m = fmaf(beta, m, g) first and the step by m; w = fmaf(-lr, g, w);
// hi, lo = the halves of w.  g is fp32 or bf16.  The design note is in
// repro_torch/kernels/split_sgd.py.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 16;  // a grid-stride loop past that

// One pair of neighbouring elements: h and l hold (hi, lo) of elements 2k
// (low half of the word) and 2k + 1 (high half).
__device__ __forceinline__ void step_pair(uint32_t& h, uint32_t& l, float g0, float g1,
                                          float neg_lr) {
  const float w0 = __uint_as_float((h << 16) | (l & 0xffffu));
  const float w1 = __uint_as_float((h & 0xffff0000u) | (l >> 16));
  const uint32_t b0 = __float_as_uint(__fmaf_rn(neg_lr, g0, w0));
  const uint32_t b1 = __float_as_uint(__fmaf_rn(neg_lr, g1, w1));
  h = (b0 >> 16) | (b1 & 0xffff0000u);
  l = (b0 & 0xffffu) | (b1 << 16);
}

// Eight gradients from 16- or 32-byte loads.
template <bool kBf16G>
__device__ __forceinline__ void load8(const void* __restrict__ g, int64_t i, float (&out)[8]) {
  if constexpr (kBf16G) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(g) + i);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      out[2 * k] = __uint_as_float(w[k] << 16);
      out[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  } else {
    const float4* g4 = reinterpret_cast<const float4*>(g);
    const float4 a = __ldg(g4 + 2 * i), b = __ldg(g4 + 2 * i + 1);
    out[0] = a.x, out[1] = a.y, out[2] = a.z, out[3] = a.w;
    out[4] = b.x, out[5] = b.y, out[6] = b.z, out[7] = b.w;
  }
}

template <bool kBf16G>
__device__ __forceinline__ float load1(const void* __restrict__ g, int64_t t) {
  if constexpr (kBf16G) {
    return __uint_as_float(static_cast<uint32_t>(reinterpret_cast<const uint16_t*>(g)[t]) << 16);
  } else {
    return reinterpret_cast<const float*>(g)[t];
  }
}

// Eight elements a thread per step: 16-byte loads of hi and lo, of a bf16 g
// and of the momentum, two of an fp32 g.  The last n % 8 elements go one a
// thread.  With kMom the gradient of the step is m = fmaf(beta, m, g).
template <bool kBf16G, bool kMom>
__global__ void __launch_bounds__(kThreads)
    split_sgd_kernel(uint16_t* __restrict__ hi, uint16_t* __restrict__ lo,
                     const void* __restrict__ g, float* __restrict__ mom, int64_t n,
                     float neg_lr, float beta) {
  const int64_t n8 = n / 8;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  uint4* h8 = reinterpret_cast<uint4*>(hi);
  uint4* l8 = reinterpret_cast<uint4*>(lo);
  float4* m4 = reinterpret_cast<float4*>(mom);
  for (int64_t i = tid; i < n8; i += stride) {
    uint4 h = h8[i], l = l8[i];
    float s[8];
    load8<kBf16G>(g, i, s);
    if constexpr (kMom) {
      float4 ma = m4[2 * i], mb = m4[2 * i + 1];
      ma.x = __fmaf_rn(beta, ma.x, s[0]), ma.y = __fmaf_rn(beta, ma.y, s[1]);
      ma.z = __fmaf_rn(beta, ma.z, s[2]), ma.w = __fmaf_rn(beta, ma.w, s[3]);
      mb.x = __fmaf_rn(beta, mb.x, s[4]), mb.y = __fmaf_rn(beta, mb.y, s[5]);
      mb.z = __fmaf_rn(beta, mb.z, s[6]), mb.w = __fmaf_rn(beta, mb.w, s[7]);
      m4[2 * i] = ma, m4[2 * i + 1] = mb;
      s[0] = ma.x, s[1] = ma.y, s[2] = ma.z, s[3] = ma.w;
      s[4] = mb.x, s[5] = mb.y, s[6] = mb.z, s[7] = mb.w;
    }
    step_pair(h.x, l.x, s[0], s[1], neg_lr);
    step_pair(h.y, l.y, s[2], s[3], neg_lr);
    step_pair(h.z, l.z, s[4], s[5], neg_lr);
    step_pair(h.w, l.w, s[6], s[7], neg_lr);
    h8[i] = h;
    l8[i] = l;
  }
  const int64_t t = n8 * 8 + tid;
  if (t < n) {
    float s = load1<kBf16G>(g, t);
    if constexpr (kMom) {
      s = __fmaf_rn(beta, mom[t], s);
      mom[t] = s;
    }
    const float w = __uint_as_float((static_cast<uint32_t>(hi[t]) << 16) | lo[t]);
    const uint32_t b = __float_as_uint(__fmaf_rn(neg_lr, s, w));
    hi[t] = static_cast<uint16_t>(b >> 16);
    lo[t] = static_cast<uint16_t>(b & 0xffffu);
  }
}

template <bool kBf16G, bool kMom>
void launch(void* hi, void* lo, const void* g, void* mom, int64_t n, float lr, float beta,
            cudaStream_t stream) {
  const int64_t work = n / 8 > 0 ? n / 8 : 1;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  split_sgd_kernel<kBf16G, kMom><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<uint16_t*>(hi), static_cast<uint16_t*>(lo), g, static_cast<float*>(mom), n,
      -lr, beta);
}

}  // namespace

// hi [n] bf16 bits, lo [n] low halves, g [n] fp32 (g_bf16 = 0) or bf16
// (g_bf16 = 1), mom [n] fp32 or null (no momentum), all 16-byte aligned; hi,
// lo and mom are updated in place.  Returns the CUDA error of the launch.
extern "C" int split_sgd_run(void* hi, void* lo, const void* g, int g_bf16, void* mom, int64_t n,
                             float lr, float beta, void* stream) {
  if (n == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  if (g_bf16) {
    if (mom) launch<true, true>(hi, lo, g, mom, n, lr, beta, s);
    else launch<true, false>(hi, lo, g, mom, n, lr, beta, s);
  } else {
    if (mom) launch<false, true>(hi, lo, g, mom, n, lr, beta, s);
    else launch<false, false>(hi, lo, g, mom, n, lr, beta, s);
  }
  return static_cast<int>(cudaGetLastError());
}
