// DLRM dot interaction: out[b] = [dense[b], tril(Z Z^T, -1)] with
// Z = [dense[b]; emb[b, 0..S-1]] (F = S + 1 rows of E), all fp32.  The pairs
// follow np.tril_indices(F, -1).  The design note is in
// repro_torch/kernels/interaction.py.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__global__ void dot_interaction_kernel(const float* __restrict__ dense,
                                       const float* __restrict__ emb, float* __restrict__ out,
                                       int64_t B, int S, int E, int warps_per_block) {
  extern __shared__ float smem[];
  const int F = S + 1;
  const int ld = E + 1;  // odd row stride: lanes reading one column of different rows
                         // land in different banks
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t b = static_cast<int64_t>(blockIdx.x) * warps_per_block + warp;
  if (b >= B) return;  // warp-private work, no block barrier below
  float* z = smem + static_cast<int64_t>(warp) * F * ld;
  const int npairs = F * (F - 1) / 2;
  float* o = out + b * (E + npairs);
  const float* d = dense + b * E;
  for (int e = lane; e < E; e += 32) {
    const float v = d[e];
    z[e] = v;
    o[e] = v;
  }
  const float* em = emb + b * S * E;
  for (int t = lane; t < S * E; t += 32) z[(1 + t / E) * ld + t % E] = em[t];
  __syncwarp();
  for (int t = lane; t < npairs; t += 32) {
    // the t-th pair (i, j), i > j, in row-major order: t = i (i - 1) / 2 + j
    int i = static_cast<int>((1.f + sqrtf(1.f + 8.f * t)) * 0.5f);
    while (i * (i - 1) / 2 > t) --i;
    while ((i + 1) * i / 2 <= t) ++i;
    const int j = t - i * (i - 1) / 2;
    const float* zi = z + i * ld;
    const float* zj = z + j * ld;
    float s = 0.f;
    for (int e = 0; e < E; ++e) s = fmaf(zi[e], zj[e], s);
    o[E + t] = s;
  }
}

}  // namespace

// dense [B, E], emb [B, S, E], out [B, E + F(F-1)/2], fp32.  Returns the CUDA
// error of the launch (0 = none).
extern "C" int dot_interaction_fwd(const void* dense, const void* emb, void* out, int64_t B, int S,
                                   int E, void* stream) {
  if (B == 0) return 0;
  const int64_t per_warp = static_cast<int64_t>(S + 1) * (E + 1) * sizeof(float);
  int warps = 8;
  while (warps > 1 && warps * per_warp > 48 * 1024) warps /= 2;
  const int64_t smem = warps * per_warp;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        dot_interaction_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t blocks = (B + warps - 1) / warps;
  dot_interaction_kernel<<<static_cast<unsigned>(blocks), warps * 32, static_cast<size_t>(smem),
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dense), static_cast<const float*>(emb), static_cast<float*>(out), B,
      S, E, warps);
  return static_cast<int>(cudaGetLastError());
}
