// DLRM dot interaction: out[b] = [dense[b], tril(Z Z^T, -1)] with
// Z = [dense[b]; emb[b, 0..S-1]] (F = S + 1 rows of E), all fp32.  The pairs
// follow np.tril_indices(F, -1).  The design note is in
// repro_torch/kernels/interaction.py.
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int64_t kSmemBlock = 232448;  // the shared memory a block may take (227 KB)
constexpr int64_t kSmemSm = 233472;     // an SM's (228 KB), 1 KB of it reserved a block

// Z's row stride in shared memory, in floats: E rounded up to a float4 and
// then to an odd number of float4s, so that the 8 lanes of a quarter warp
// reading one float4 column of 8 consecutive rows hit 8 different 16-byte
// bank groups.
__host__ __device__ constexpr int row_stride(int E) {
  return (E + 3) / 4 % 2 ? (E + 3) / 4 * 4 : (E + 3) / 4 * 4 + 4;
}

// The stages' mbarriers (16 bytes), the ring (stages x T samples x F rows of
// row_stride(E) floats), the output tile [T, E + F(F-1)/2] and the pair
// table, in bytes.
__host__ __device__ constexpr int64_t smem_bytes(int T, int S, int E, int stages) {
  return 16 + 4 * (static_cast<int64_t>(stages) * T * (S + 1) * row_stride(E) +
                   static_cast<int64_t>(T) * (E + (S + 1) * S / 2) + (S + 1) * S / 2);
}

// A launch's tiles of T samples, the ring's stages and the blocks an SM.
struct Plan {
  int T, stages, per_sm;
};

// For a batch of B samples on `sms` SMs: two stages of the largest T in 32,
// 16, ..., 1 that leaves room for two blocks an SM and is no larger than
// B / sms rounded up (a small batch gets tiles of one sample on many SMs);
// else two stages of the largest T that fits a block; else one stage.  T = 0
// where one sample's Z does not fit.
Plan plan(int64_t B, int S, int E, int sms) {
  const int64_t cap = (B + sms - 1) / sms;
  const Plan tries[] = {{0, 2, 2}, {0, 2, 1}, {0, 1, 1}};
  for (Plan p : tries) {
    const int64_t budget = p.per_sm == 2 ? kSmemSm / 2 - 1024 : kSmemBlock;
    for (p.T = 32; p.T >= 1; p.T /= 2)
      if (p.T <= cap && smem_bytes(p.T, S, E, p.stages) <= budget) return p;
  }
  return {0, 0, 0};
}

// Tile `tile`'s nT samples (the dense row, then the S bag rows, each) into
// the ring stage `z` at row stride ld.  kBulk: one TMA bulk copy a row, each
// issued by its own thread, completing on `bar` (thread 0 announces the
// bytes); else plain loads and stores by the whole block (rows that are not
// 16-byte multiples, or unaligned inputs).
template <bool kBulk>
__device__ __forceinline__ void stage_tile(float* z, uint32_t bar, const float* dense,
                                           const float* emb, int64_t tile, int T, int nT, int S,
                                           int E, int ld) {
  const int F = S + 1;
  const float* d = dense + tile * T * E;
  const float* em = emb + tile * T * S * E;
  if constexpr (kBulk) {
    if (threadIdx.x == 0) hopper::mbar_expect_tx(bar, static_cast<uint32_t>(nT * F * E * 4));
    for (int r = threadIdx.x; r < nT * F; r += kThreads) {
      const int t = r / F, i = r - t * F;
      const float* src = i ? em + static_cast<int64_t>(t * S + i - 1) * E : d + static_cast<int64_t>(t) * E;
      hopper::bulk_load(hopper::smem_u32(z + r * ld), src, static_cast<uint32_t>(E * 4), bar);
    }
  } else {
    for (int q = threadIdx.x; q < nT * F * E; q += kThreads) {
      const int r = q / E, e = q - r * E, t = r / F, i = r - t * F;
      z[r * ld + e] = i ? em[static_cast<int64_t>(t * S + i - 1) * E + e] : d[static_cast<int64_t>(t) * E + e];
    }
  }
}

// A block walks the tiles of T samples blockIdx.x, blockIdx.x + gridDim.x,
// ...; with kStages = 2 the next tile's copies land in one stage while this
// tile's products read the other (kBulk only: the plain loads of a tile run
// at its turn, into one stage).  The T x F(F-1)/2 pairs of a tile are
// spread over the threads in output order; each is four fp32 FMA chains
// over E (one a float4 lane, read from shared memory), added at the end.
// The output tile is gathered in shared memory and written with 16-byte
// stores.
template <bool kBulk, int kStages>
__global__ void __launch_bounds__(kThreads, 2)
    dot_interaction_kernel(const float* __restrict__ dense, const float* __restrict__ emb,
                           float* __restrict__ out, int64_t B, int S, int E, int T) {
  extern __shared__ __align__(16) float smem[];
  const int F = S + 1, np = F * (F - 1) / 2, W = E + np, ld = row_stride(E), E4 = (E + 3) / 4;
  const int64_t ntiles = (B + T - 1) / T;
  if (static_cast<int64_t>(blockIdx.x) >= ntiles) return;  // the whole block leaves together
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* ring = smem + 4;
  const int stage_floats = T * F * ld;
  float* so = ring + kStages * stage_floats;                  // the output tile [T, W]
  uint32_t* pairs = reinterpret_cast<uint32_t*>(so + T * W);  // (i << 16) | j, output order
  for (int i = 1 + threadIdx.x; i < F; i += kThreads)
    for (int j = 0; j < i; ++j) pairs[i * (i - 1) / 2 + j] = (static_cast<uint32_t>(i) << 16) | j;
  for (int r = threadIdx.x; r < kStages * T * F; r += kThreads)
    for (int e = E; e < 4 * E4; ++e) ring[r * ld + e] = 0.f;  // the float4 reads' tail past E
  if (kBulk && threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) hopper::mbar_init(hopper::smem_u32(bars + st), 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();
  auto rows_in = [&](int64_t t) { return B - t * T < T ? static_cast<int>(B - t * T) : T; };
  auto stage = [&](int st) { return ring + st * stage_floats; };
  if constexpr (kBulk) {
    for (int st = 0; st < kStages; ++st) {
      const int64_t t = blockIdx.x + static_cast<int64_t>(st) * gridDim.x;
      if (t < ntiles)
        stage_tile<true>(stage(st), hopper::smem_u32(bars + st), dense, emb, t, T, rows_in(t), S, E, ld);
    }
  }
  int k = 0;
  for (int64_t tile = blockIdx.x; tile < ntiles; tile += gridDim.x, ++k) {
    const int st = k % kStages;
    const float* z = stage(st);
    if constexpr (kBulk) {
      hopper::mbar_wait(hopper::smem_u32(bars + st), (k / kStages) & 1);
    } else {
      stage_tile<false>(stage(st), 0, dense, emb, tile, T, rows_in(tile), S, E, ld);
      __syncthreads();
    }
    const int nT = rows_in(tile);
    for (int q = threadIdx.x; q < nT * np; q += kThreads) {
      const int t = q / np, p = q - t * np;
      const uint32_t ij = pairs[p];
      const float4* zi = reinterpret_cast<const float4*>(z + (t * F + (ij >> 16)) * ld);
      const float4* zj = reinterpret_cast<const float4*>(z + (t * F + (ij & 0xffff)) * ld);
      float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll 4
      for (int e4 = 0; e4 < E4; ++e4) {
        const float4 a = zi[e4], b = zj[e4];
        s0 = fmaf(a.x, b.x, s0);
        s1 = fmaf(a.y, b.y, s1);
        s2 = fmaf(a.z, b.z, s2);
        s3 = fmaf(a.w, b.w, s3);
      }
      so[t * W + E + p] = (s0 + s1) + (s2 + s3);
    }
    for (int q = threadIdx.x; q < nT * E; q += kThreads) {
      const int t = q / E, e = q - t * E;
      so[t * W + e] = z[t * F * ld + e];  // the dense pass-through
    }
    __syncthreads();  // the stage is read and `so` is whole
    if constexpr (kBulk) {
      const int64_t refill = tile + static_cast<int64_t>(kStages) * gridDim.x;
      if (refill < ntiles)
        stage_tile<true>(stage(st), hopper::smem_u32(bars + st), dense, emb, refill, T,
                         rows_in(refill), S, E, ld);
    }
    float* o = out + tile * T * W;
    const int n = nT * W;
    int done = 0;
    if ((T * W) % 4 == 0) {  // every tile starts 16-byte aligned
      for (int q = threadIdx.x; q < n / 4; q += kThreads)
        reinterpret_cast<float4*>(o)[q] = reinterpret_cast<const float4*>(so)[q];
      done = n / 4 * 4;
    }
    for (int q = done + threadIdx.x; q < n; q += kThreads) o[q] = so[q];
    __syncthreads();  // `so` is read before the next tile's products write it
  }
}

// Launches a resident grid of the plan's blocks an SM.  The kernel's opt-in
// to a block's whole shared memory is made once a device.
template <bool kBulk, int kStages>
int launch(const float* dense, const float* emb, float* out, int64_t B, int S, int E, Plan p,
           int dev, int sms, cudaStream_t stream) {
  static std::atomic<bool> ready[hopper::kMaxDevices];
  auto kernel = dot_interaction_kernel<kBulk, kStages>;
  if (dev >= hopper::kMaxDevices || !ready[dev].load(std::memory_order_relaxed)) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSmemBlock));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < hopper::kMaxDevices) ready[dev].store(true, std::memory_order_relaxed);
  }
  const int64_t ntiles = (B + p.T - 1) / p.T, resident = static_cast<int64_t>(p.per_sm) * sms;
  const int64_t blocks = ntiles < resident ? ntiles : resident;
  kernel<<<static_cast<unsigned>(blocks), kThreads,
           static_cast<size_t>(smem_bytes(p.T, S, E, kStages)), stream>>>(dense, emb, out, B, S,
                                                                          E, p.T);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dense [B, E], emb [B, S, E], out [B, E + F(F-1)/2], fp32.  Returns the
// CUDA error of the launch (0 = none).
extern "C" int dot_interaction_fwd(const void* dense, const void* emb, void* out, int64_t B, int S,
                                   int E, void* stream) {
  if (B == 0) return 0;
  int dev = 0, sms = 0;
  const cudaError_t err = hopper::device_sms(&dev, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Plan p = plan(B, S, E, sms);
  if (p.T == 0) return static_cast<int>(cudaErrorInvalidValue);  // one sample's Z does not fit
  const auto d = static_cast<const float*>(dense);
  const auto e = static_cast<const float*>(emb);
  const auto o = static_cast<float*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  // TMA bulk copies where every row is a 16-byte multiple at a 16-byte boundary
  const bool bulk = E % 4 == 0 && reinterpret_cast<uintptr_t>(dense) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(emb) % 16 == 0;
  if (!bulk) return launch<false, 1>(d, e, o, B, S, E, p, dev, sms, st);  // loads at the tile's turn
  return p.stages == 2 ? launch<true, 2>(d, e, o, B, S, E, p, dev, sms, st)
                       : launch<true, 1>(d, e, o, B, S, E, p, dev, sms, st);
}
