// Flat Split-SGD step, in place: w = (hi << 16) | lo; w = fmaf(-lr, g, w);
// hi, lo = the halves of w.  The design note is in
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

// Eight elements a thread per step: 16-byte loads of hi and lo, two of g.
// The last n % 8 elements go one a thread.
__global__ void __launch_bounds__(kThreads)
    split_sgd_kernel(uint16_t* __restrict__ hi, uint16_t* __restrict__ lo,
                     const float* __restrict__ g, int64_t n, float neg_lr) {
  const int64_t n8 = n / 8;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  uint4* h8 = reinterpret_cast<uint4*>(hi);
  uint4* l8 = reinterpret_cast<uint4*>(lo);
  const float4* g4 = reinterpret_cast<const float4*>(g);
  for (int64_t i = tid; i < n8; i += stride) {
    uint4 h = h8[i], l = l8[i];
    const float4 ga = __ldg(g4 + 2 * i), gb = __ldg(g4 + 2 * i + 1);
    step_pair(h.x, l.x, ga.x, ga.y, neg_lr);
    step_pair(h.y, l.y, ga.z, ga.w, neg_lr);
    step_pair(h.z, l.z, gb.x, gb.y, neg_lr);
    step_pair(h.w, l.w, gb.z, gb.w, neg_lr);
    h8[i] = h;
    l8[i] = l;
  }
  const int64_t t = n8 * 8 + tid;
  if (t < n) {
    const float w = __uint_as_float((static_cast<uint32_t>(hi[t]) << 16) | lo[t]);
    const uint32_t b = __float_as_uint(__fmaf_rn(neg_lr, g[t], w));
    hi[t] = static_cast<uint16_t>(b >> 16);
    lo[t] = static_cast<uint16_t>(b & 0xffffu);
  }
}

}  // namespace

// hi [n] bf16 bits, lo [n] low halves, g [n] fp32, all 16-byte aligned;
// hi and lo are updated in place.  Returns the CUDA error of the launch.
extern "C" int split_sgd_step(void* hi, void* lo, const void* g, int64_t n, float lr,
                              void* stream) {
  if (n == 0) return 0;
  const int64_t work = n / 8 > 0 ? n / 8 : 1;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  split_sgd_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint16_t*>(hi), static_cast<uint16_t*>(lo), static_cast<const float*>(g), n, -lr);
  return static_cast<int>(cudaGetLastError());
}
