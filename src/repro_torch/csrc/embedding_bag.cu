// EmbeddingBag-sum forward: out[bag] = sum_p W[gidx[bag, p]] in fp32, where a
// row id outside [0, rows) adds nothing.  The design note is in
// repro_torch/kernels/embedding_bag.py.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kUnroll = 4;  // row loads each lane keeps in flight
constexpr unsigned kFull = 0xffffffffu;

// One 16-byte chunk of a row, widened to fp32 and added to acc.
__device__ __forceinline__ void add_chunk(float* acc, uint4 v, uint16_t) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc[2 * i] += __uint_as_float(w[i] << 16);
    acc[2 * i + 1] += __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void add_chunk(float* acc, uint4 v, float) {
  acc[0] += __uint_as_float(v.x);
  acc[1] += __uint_as_float(v.y);
  acc[2] += __uint_as_float(v.z);
  acc[3] += __uint_as_float(v.w);
}

// T is uint16_t for a bf16 table (the bits of each value) or float.
// One warp owns one bag.  A row is E / V chunks of 16 bytes; `chunks` neighbouring
// lanes read one row, so the warp reads G = 32 / chunks rows at a time: group g
// adds lookups p = g, g + G, ... in order, and the groups are summed in order.
template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    embedding_bag_kernel(const T* __restrict__ W, const int32_t* __restrict__ gidx,
                         float* __restrict__ out, int64_t n_bags, int P, int E, int64_t rows) {
  constexpr int V = 16 / sizeof(T);  // values per chunk
  const int lane = threadIdx.x & 31;
  const int64_t bag = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (bag >= n_bags) return;  // the whole warp leaves together
  const int32_t* idx = gidx + bag * P;
  const int row_chunks = E / V;
  for (int c0 = 0; c0 < row_chunks; c0 += 32) {
    const int chunks = min(row_chunks - c0, 32);
    const int G = 32 / chunks;
    const int group = lane / chunks;  // lanes with group >= G idle
    const int c = c0 + lane % chunks;
    float acc[V];
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = 0.f;
    for (int p0 = 0; p0 < P; p0 += 32) {
      const int np = min(P - p0, 32);
      const int32_t mine = lane < np ? __ldg(idx + p0 + lane) : -1;
      for (int j = 0; j < np; j += G * kUnroll) {
        uint4 v[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int src = j + u * G + group;
          const int32_t row = __shfl_sync(kFull, mine, src & 31);
          const bool ok = group < G && src < np && row >= 0 && row < rows;
          // int64 from the start: Criteo-sized tables overflow 32-bit offsets
          v[u] = ok ? __ldg(reinterpret_cast<const uint4*>(W + static_cast<int64_t>(row) * E) + c)
                    : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) add_chunk(acc, v[u], T{});
      }
    }
    for (int g = 1; g < G; ++g) {
      const int from = lane % chunks + g * chunks;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float other = __shfl_sync(kFull, acc[i], from);
        if (group == 0) acc[i] += other;
      }
    }
    if (group == 0) {
      float4* o = reinterpret_cast<float4*>(out + bag * E + static_cast<int64_t>(c) * V);
#pragma unroll
      for (int i = 0; i < V / 4; ++i)
        o[i] = make_float4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2], acc[4 * i + 3]);
    }
  }
}

template <typename T>
int launch(const void* W, const void* gidx, void* out, int64_t n_bags, int P, int E, int64_t rows,
           void* stream) {
  const int64_t blocks = (n_bags + kWarpsPerBlock - 1) / kWarpsPerBlock;
  embedding_bag_kernel<T><<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(W), static_cast<const int32_t*>(gidx), static_cast<float*>(out), n_bags,
      P, E, rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// W [rows_total, E] (bf16 when table_bf16, else fp32), gidx [n_bags, P] int32,
// out [n_bags, E] fp32.  Returns the CUDA error of the launch (0 = none).
extern "C" int embedding_bag_fwd(const void* W, const void* gidx, void* out, int64_t n_bags, int P,
                                 int E, int64_t rows, int table_bf16, void* stream) {
  if (n_bags == 0) return 0;
  return table_bf16 ? launch<uint16_t>(W, gidx, out, n_bags, P, E, rows, stream)
                    : launch<float>(W, gidx, out, n_bags, P, E, rows, stream);
}
