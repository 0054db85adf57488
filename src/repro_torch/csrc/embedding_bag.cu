// EmbeddingBag-sum forward: out[bag] = sum_p W[gidx[bag, p]] in fp32, or with
// per-lookup weights sum_p wgt[bag, p] * W[gidx[bag, p]], where a row id
// outside [0, rows) adds nothing.  The design note is in
// repro_torch/kernels/embedding_bag.py.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kUnroll = 4;  // row loads each lane keeps in flight
constexpr unsigned kFull = 0xffffffffu;

// acc += x, or acc += wt * x with the product and the sum rounded apart, as the
// reference's rows * weights and then .sum round (nvcc would contract
// acc += wt * x into one FMA).  wt == 1 multiplies exactly, so all-ones
// weights give the unweighted bits.
template <bool kWeighted>
__device__ __forceinline__ void add_value(float& acc, float x, float wt) {
  acc = kWeighted ? __fadd_rn(acc, __fmul_rn(wt, x)) : acc + x;
}

// One 16-byte chunk of a row, widened to fp32 and added to acc.
template <bool kWeighted>
__device__ __forceinline__ void add_chunk(float* acc, uint4 v, float wt, uint16_t) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    add_value<kWeighted>(acc[2 * i], __uint_as_float(w[i] << 16), wt);
    add_value<kWeighted>(acc[2 * i + 1], __uint_as_float(w[i] & 0xffff0000u), wt);
  }
}

template <bool kWeighted>
__device__ __forceinline__ void add_chunk(float* acc, uint4 v, float wt, float) {
  add_value<kWeighted>(acc[0], __uint_as_float(v.x), wt);
  add_value<kWeighted>(acc[1], __uint_as_float(v.y), wt);
  add_value<kWeighted>(acc[2], __uint_as_float(v.z), wt);
  add_value<kWeighted>(acc[3], __uint_as_float(v.w), wt);
}

// T is uint16_t for a bf16 table (the bits of each value) or float.
// One warp owns one bag.  A row is E / V chunks of 16 bytes; `chunks` neighbouring
// lanes read one row, so the warp reads G = 32 / chunks rows at a time: group g
// adds lookups p = g, g + G, ... in order, and the groups are summed in order.
// kWeighted: each lookup's weight comes with its row id (a lookup that reads
// nothing weighs 0, so it adds +0 whatever its weight).
template <typename T, bool kWeighted>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    embedding_bag_kernel(const T* __restrict__ W, const int32_t* __restrict__ gidx,
                         const float* __restrict__ wgt, float* __restrict__ out, int64_t n_bags,
                         int P, int E, int64_t rows) {
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
      const float mine_w = kWeighted && lane < np ? __ldg(wgt + bag * P + p0 + lane) : 0.f;
      for (int j = 0; j < np; j += G * kUnroll) {
        uint4 v[kUnroll];
        float wt[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int src = j + u * G + group;
          const int32_t row = __shfl_sync(kFull, mine, src & 31);
          const float w = kWeighted ? __shfl_sync(kFull, mine_w, src & 31) : 1.f;
          const bool ok = group < G && src < np && row >= 0 && row < rows;
          // int64 from the start: Criteo-sized tables overflow 32-bit offsets
          v[u] = ok ? __ldg(reinterpret_cast<const uint4*>(W + static_cast<int64_t>(row) * E) + c)
                    : make_uint4(0u, 0u, 0u, 0u);
          wt[u] = ok ? w : 0.f;
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) add_chunk<kWeighted>(acc, v[u], wt[u], T{});
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

template <typename T, bool kWeighted>
int launch(const void* W, const void* gidx, const void* wgt, void* out, int64_t n_bags, int P,
           int E, int64_t rows, void* stream) {
  const int64_t blocks = (n_bags + kWarpsPerBlock - 1) / kWarpsPerBlock;
  embedding_bag_kernel<T, kWeighted><<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32, 0,
                                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(W), static_cast<const int32_t*>(gidx), static_cast<const float*>(wgt),
      static_cast<float*>(out), n_bags, P, E, rows);
  return static_cast<int>(cudaGetLastError());
}

template <bool kWeighted>
int launch_table(const void* W, const void* gidx, const void* wgt, void* out, int64_t n_bags,
                 int P, int E, int64_t rows, int table_bf16, void* stream) {
  if (n_bags == 0) return 0;
  return table_bf16 ? launch<uint16_t, kWeighted>(W, gidx, wgt, out, n_bags, P, E, rows, stream)
                    : launch<float, kWeighted>(W, gidx, wgt, out, n_bags, P, E, rows, stream);
}

}  // namespace

// W [rows_total, E] (bf16 when table_bf16, else fp32), gidx [n_bags, P] int32,
// out [n_bags, E] fp32.  Returns the CUDA error of the launch (0 = none).
extern "C" int embedding_bag_fwd(const void* W, const void* gidx, void* out, int64_t n_bags, int P,
                                 int E, int64_t rows, int table_bf16, void* stream) {
  return launch_table<false>(W, gidx, nullptr, out, n_bags, P, E, rows, table_bf16, stream);
}

// The weighted bag: wgt [n_bags, P] fp32, one weight a lookup.
extern "C" int embedding_bag_weighted_fwd(const void* W, const void* gidx, const void* wgt,
                                          void* out, int64_t n_bags, int P, int E, int64_t rows,
                                          int table_bf16, void* stream) {
  return launch_table<true>(W, gidx, wgt, out, n_bags, P, E, rows, table_bf16, stream);
}
