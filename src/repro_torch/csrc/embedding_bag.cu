// EmbeddingBag-sum forward: out[b, s] = sum_p W[g] over the bag's lookups
// g = idx[b, s, p] (+ offsets[s] when given), in fp32, or with per-lookup
// weights sum_p wgt[b, s, p] * W[g], where a row id outside [0, rows) adds
// nothing; with round_bf16 each sum is rounded to bf16 (to nearest even) and
// stored as fp32.  The design note is in repro_torch/kernels/embedding_bag.py.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int kMaxWarps = 8;  // a block's warps
constexpr int kMaxBags = 4;   // bags a warp sums at once, one a group of lanes
constexpr int kUnroll = 4;    // row loads each lane keeps in flight
constexpr int kList = 64;     // lookups of a bag listed at a time: two 32-id words
constexpr unsigned kFull = 0xffffffffu;

// The lanes that read a row of `row_chunks` 16-byte chunks: the chunks
// rounded up to a power of two, at least 32 / kMaxBags (a warp has at most
// kMaxBags groups of lanes) and at most 32.
__host__ __device__ constexpr int row_lanes(int row_chunks) {
  int rl = 32 / kMaxBags;
  while (rl < row_chunks && rl < 32) rl <<= 1;
  return rl;
}

// A warp's lists, one a bag: entry (row, bits of the coefficient), read with
// one 8-byte load; and a word's weights, read back as float4s.
struct Lists {
  int2 entry[kMaxBags][kList];
  float4 wgt[8];
};

// acc += c * x for each value of one 16-byte chunk of a row, one FMA each.
__device__ __forceinline__ void add_chunk(float* acc, uint4 v, float c, uint16_t) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc[2 * i] = fmaf(c, __uint_as_float(w[i] << 16), acc[2 * i]);
    acc[2 * i + 1] = fmaf(c, __uint_as_float(w[i] & 0xffff0000u), acc[2 * i + 1]);
  }
}

__device__ __forceinline__ void add_chunk(float* acc, uint4 v, float c, float) {
  acc[0] = fmaf(c, __uint_as_float(v.x), acc[0]);
  acc[1] = fmaf(c, __uint_as_float(v.y), acc[1]);
  acc[2] = fmaf(c, __uint_as_float(v.z), acc[2]);
  acc[3] = fmaf(c, __uint_as_float(v.w), acc[3]);
}

// Lists the distinct valid rows of np <= kList lookups of one bag, word by
// word, into `entry` and returns their number: ids[h] and w[h] are the
// lane's lookup of word h (table-local; `off` is the slot's row offset).
// In each word, __match_any_sync finds the equal ids; the lowest lane of
// each set enters its row once with the set's size, or the sum of its
// weights in lane order, as coefficient (all-ones weights sum to exactly
// the counts, so the two kernels' bits agree).  A row in both words enters
// twice.  A lookup outside [0, rows) never enters, whatever its weight.
template <bool kWeighted>
__device__ __forceinline__ int list_bag(int2* entry, float4* wbuf, const int32_t (&ids)[2],
                                        const float (&w)[2], int np, int32_t off, int64_t rows,
                                        int lane) {
  int n = 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (h * 32 >= np) continue;  // warp-uniform
    // the offset add wraps as int32 arithmetic does
    const int32_t g = static_cast<int32_t>(static_cast<uint32_t>(ids[h]) + static_cast<uint32_t>(off));
    const int32_t key = h * 32 + lane < np && g >= 0 && g < rows ? g : -1;
    const unsigned same = __match_any_sync(kFull, key);
    const bool lead = key >= 0 && __ffs(same) - 1 == lane;
    float c;
    if constexpr (kWeighted) {
      reinterpret_cast<float*>(wbuf)[lane] = w[h];
      __syncwarp();
      c = 0.f;
#pragma unroll
      for (int q = 0; q < 8; ++q) {  // every lane reads the word's 32 weights
        const float4 x = wbuf[q];
        const unsigned bits = same >> (4 * q);
        if (bits & 1) c += x.x;
        if (bits & 2) c += x.y;
        if (bits & 4) c += x.z;
        if (bits & 8) c += x.w;
      }
      __syncwarp();
    } else {
      c = static_cast<float>(__popc(same));
    }
    const unsigned fresh = __ballot_sync(kFull, lead);
    if (lead) entry[n + __popc(fresh & ((1u << lane) - 1))] = make_int2(key, __float_as_int(c));
    n += __popc(fresh);
  }
  return n;
}

// T is uint16_t for a bf16 table (the bits of each value) or float.  Bags
// go in slot-major order (bag j is sample j % B of slot j / B), so the warps
// at work at one time read one table.  A row is E / V chunks of 16 bytes,
// read by rl = row_lanes(E / V) lanes, so a warp has 32 / rl <= kMaxBags
// groups of lanes (lanes past a narrow row's chunks idle).  It sums G consecutive bags, one a
// group (G = 32 / rl): it lists each bag's rows (all lanes), then each group
// reads its bag's listed rows once, kUnroll rows in flight a lane, and adds
// coef * row with one FMA a value; no sum crosses lanes.  kSpread (a small
// batch: the shortest chain): one bag a warp, group r of the R = 32 / rl
// reading the entries r, r + R, ..., and the groups' sums meeting in a
// butterfly.  A row wider than 32 chunks takes passes of 32 (G = R = 1).
template <typename T, bool kWeighted, bool kSpread>
__global__ void __launch_bounds__(kMaxWarps * 32)
    embedding_bag_kernel(const T* __restrict__ W, const int32_t* __restrict__ idx,
                         const int32_t* __restrict__ offsets, const float* __restrict__ wgt,
                         float* __restrict__ out, int64_t B, int S, int P, int E, int64_t rows,
                         int round_bf16) {
  constexpr int V = 16 / sizeof(T);  // values per chunk
  __shared__ Lists lists[kMaxWarps];
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row_chunks = E / V, rl = row_lanes(row_chunks);
  const int G = kSpread ? 1 : 32 / rl, R = kSpread ? 32 / rl : 1;  // bags a warp, groups a bag
  const int group = kSpread ? 0 : lane / rl, sub = kSpread ? lane / rl : 0, gl = lane % rl;
  const uint32_t n_bags = static_cast<uint32_t>(B * S), Bu = static_cast<uint32_t>(B);
  const uint32_t j0 = (blockIdx.x * warps + warp) * G;  // the warp's first bag
  if (j0 >= n_bags) return;  // the whole warp leaves together
  Lists& L = lists[warp];
  int32_t bags[kMaxBags];  // the warp's bags in [B, S] order (-1: past the last)
  int32_t off[kMaxBags];
#pragma unroll
  for (int g = 0; g < kMaxBags; ++g) {
    const uint32_t j = j0 + g, s = j / Bu;
    const bool in = g < G && j < n_bags;
    bags[g] = in ? static_cast<int32_t>((j - s * Bu) * S + s) : -1;
    off[g] = in && offsets ? __ldg(offsets + s) : 0;
  }
  int32_t mine = bags[0];
#pragma unroll
  for (int g = 1; g < kMaxBags; ++g) mine = group == g ? bags[g] : mine;
  for (int c0 = 0; c0 < row_chunks; c0 += rl) {
    const int chunks = min(row_chunks - c0, rl);
    const bool active = mine >= 0 && gl < chunks;
    const int c = c0 + gl;
    float acc[V];
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = 0.f;
    for (int p0 = 0; p0 < P; p0 += kList) {
      const int np = min(P - p0, kList);
      int32_t ids[kMaxBags][2];  // every bag's lookups, loaded before any is listed
      float w[kMaxBags][2];
#pragma unroll
      for (int g = 0; g < kMaxBags; ++g) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = h * 32 + lane;
          const bool in = bags[g] >= 0 && p < np;
          const int64_t at = static_cast<int64_t>(bags[g]) * P + p0 + p;
          ids[g][h] = in ? __ldg(idx + at) : 0;
          w[g][h] = kWeighted && in ? __ldg(wgt + at) : 0.f;
        }
      }
      __syncwarp();  // the previous lists' readers are done
      int n = 0, n_max = 0;
#pragma unroll
      for (int g = 0; g < kMaxBags; ++g) {
        if (bags[g] < 0) continue;  // warp-uniform
        const int ng = list_bag<kWeighted>(L.entry[g], L.wgt, ids[g], w[g], np, off[g], rows, lane);
        n = group == g ? ng : n;
        n_max = max(n_max, ng);
      }
      __syncwarp();
      for (int k0 = 0; k0 < n_max; k0 += R * kUnroll) {
        uint4 v[kUnroll];
        float cf[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int k = k0 + u * R + sub;
          const bool ok = active && k < n;
          int2 e = make_int2(0, 0);  // an unlisted slot adds 0 * 0
          if (ok) e = L.entry[group][k];
          cf[u] = __int_as_float(e.y);
          // int64 from the start: Criteo-sized tables overflow 32-bit offsets
          v[u] = ok ? __ldg(reinterpret_cast<const uint4*>(W + static_cast<int64_t>(e.x) * E) + c)
                    : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) add_chunk(acc, v[u], cf[u], T{});
      }
    }
    for (int m = rl; m < rl * R; m <<= 1) {  // the bag's groups, R a power of two
#pragma unroll
      for (int i = 0; i < V; ++i) acc[i] += __shfl_xor_sync(kFull, acc[i], m);
    }
    if (active && sub == 0) {
      if (round_bf16) {
#pragma unroll
        for (int i = 0; i < V; ++i) acc[i] = __bfloat162float(__float2bfloat16_rn(acc[i]));
      }
      float4* o = reinterpret_cast<float4*>(out + static_cast<int64_t>(mine) * E + c * V);
#pragma unroll
      for (int i = 0; i < V / 4; ++i)
        o[i] = make_float4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2], acc[4 * i + 3]);
    }
  }
}

// The narrow path, for a row that is no whole number of 16-byte chunks (an
// E that is no multiple of 8 bf16 or 4 fp32 values) or a table off a 16-byte
// boundary: one thread a value of the output, out[j, c] for bag j (in [B, S]
// order) and column c, so that consecutive threads read consecutive values
// of a row and write consecutive outputs.  It adds the bag's lookups in
// order, the first as it is and each next one with one fp32 add, a lookup
// outside [0, rows) adding +0 and a weighted lookup its rounded product
// w * x: the plain version's operations, so that a bag of one lookup (the
// recsys archetypes' P = 1) gives its bits.
template <typename T, bool kWeighted>
__global__ void __launch_bounds__(256)
    embedding_bag_narrow_kernel(const T* __restrict__ W, const int32_t* __restrict__ idx,
                                const int32_t* __restrict__ offsets, const float* __restrict__ wgt,
                                float* __restrict__ out, int64_t n, int S, int P, int E,
                                int64_t rows, int round_bf16) {
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; t < n;
       t += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t j = t / E;
    const int c = static_cast<int>(t - j * E);
    const int32_t off = offsets ? __ldg(offsets + j % S) : 0;
    float acc = 0.f;
    for (int p = 0; p < P; ++p) {
      const int64_t at = j * P + p;
      // the offset add wraps as int32 arithmetic does
      const int32_t g =
          static_cast<int32_t>(static_cast<uint32_t>(__ldg(idx + at)) + static_cast<uint32_t>(off));
      float x = 0.f;
      if (g >= 0 && g < rows) {
        const int64_t e = static_cast<int64_t>(g) * E + c;
        if constexpr (sizeof(T) == 2) {
          const unsigned short bits = __ldg(reinterpret_cast<const unsigned short*>(W) + e);
          x = __uint_as_float(static_cast<uint32_t>(bits) << 16);
        } else {
          x = __ldg(reinterpret_cast<const float*>(W) + e);
        }
        if constexpr (kWeighted) x = __fmul_rn(__ldg(wgt + at), x);
      }
      acc = p == 0 ? x : __fadd_rn(acc, x);
    }
    if (round_bf16) acc = __bfloat162float(__float2bfloat16_rn(acc));
    out[t] = acc;
  }
}

template <typename T, bool kWeighted>
int launch_narrow(const void* W, const void* idx, const void* offsets, const void* wgt, void* out,
                  int64_t B, int S, int P, int E, int64_t rows, int round_bf16, void* stream) {
  int dev = 0, sms = 0;
  const cudaError_t err = hopper::device_sms(&dev, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n = B * S * E;
  const int64_t blocks = std::min<int64_t>((n + 255) / 256, static_cast<int64_t>(sms) * 32);
  embedding_bag_narrow_kernel<T, kWeighted>
      <<<static_cast<unsigned>(blocks), 256, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(W), static_cast<const int32_t*>(idx),
          static_cast<const int32_t*>(offsets), static_cast<const float*>(wgt),
          static_cast<float*>(out), n, S, P, E, rows, round_bf16);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kWeighted, bool kSpread>
int launch(const void* W, const void* idx, const void* offsets, const void* wgt, void* out,
           int64_t B, int S, int P, int E, int64_t rows, int round_bf16, int sms, int G,
           cudaStream_t stream) {
  const int64_t warps_needed = (B * S + G - 1) / G;
  // fewer warps a block where the warps would not reach every SM
  int warps = kMaxWarps;
  while (warps > 1 && (warps_needed + warps - 1) / warps < sms) warps /= 2;
  const int64_t blocks = (warps_needed + warps - 1) / warps;
  auto kernel = embedding_bag_kernel<T, kWeighted, kSpread>;
  kernel<<<static_cast<unsigned>(blocks), warps * 32, 0, stream>>>(
      static_cast<const T*>(W), static_cast<const int32_t*>(idx),
      static_cast<const int32_t*>(offsets), static_cast<const float*>(wgt),
      static_cast<float*>(out), B, S, P, E, rows, round_bf16);
  return static_cast<int>(cudaGetLastError());
}

// Picks the layout (bags a warp: one a group of lanes where a launch of
// layout_bags bags still leaves 32 warps an SM; else one, spread over the
// groups) and launches.
template <typename T, bool kWeighted>
int launch_layout(const void* W, const void* idx, const void* offsets, const void* wgt, void* out,
                  int64_t B, int S, int P, int E, int64_t rows, int round_bf16,
                  int64_t layout_bags, void* stream) {
  int dev = 0, sms = 0;
  const cudaError_t err = hopper::device_sms(&dev, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int groups = 32 / row_lanes(E / static_cast<int>(16 / sizeof(T)));
  const auto st = static_cast<cudaStream_t>(stream);
  if (groups > 1 && layout_bags < static_cast<int64_t>(groups) * 32 * sms)
    return launch<T, kWeighted, true>(W, idx, offsets, wgt, out, B, S, P, E, rows, round_bf16,
                                      sms, 1, st);
  return launch<T, kWeighted, false>(W, idx, offsets, wgt, out, B, S, P, E, rows, round_bf16, sms,
                                     groups, st);
}

}  // namespace

// W [rows_total, E] (bf16 when table_bf16, else fp32); idx [B, S, P] int32
// row ids, global, or table-local when offsets [S] int32 is given (the row
// is idx + offsets[s]); wgt [B, S, P] fp32 or null; out [B, S, E] fp32, each
// sum rounded to bf16 when round_bf16.  layout_bags: sum in the layout a
// launch of that many bags takes (a bag's rows are added in another order in
// each), so that these bags are that launch's bit for bit; 0 = B * S.  Any
// E: a row that is no whole number of 16-byte chunks, or a W off a 16-byte
// boundary, takes the narrow path (one layout).  Returns the CUDA error of
// the launch (0 = none).
extern "C" int embedding_bag_fwd(const void* W, const void* idx, const void* offsets,
                                 const void* wgt, void* out, int64_t B, int S, int P, int E,
                                 int64_t rows, int table_bf16, int round_bf16, int64_t layout_bags,
                                 void* stream) {
  if (B == 0 || S == 0) return 0;
  if (B * S >= (int64_t{1} << 31)) return static_cast<int>(cudaErrorInvalidValue);  // bags index as uint32
  if (layout_bags <= 0) layout_bags = B * S;
  const int vec = table_bf16 ? 8 : 4;
  if (E % vec != 0 || reinterpret_cast<uintptr_t>(W) % 16 != 0) {
    if (table_bf16)
      return wgt ? launch_narrow<uint16_t, true>(W, idx, offsets, wgt, out, B, S, P, E, rows, round_bf16, stream)
                 : launch_narrow<uint16_t, false>(W, idx, offsets, wgt, out, B, S, P, E, rows, round_bf16, stream);
    return wgt ? launch_narrow<float, true>(W, idx, offsets, wgt, out, B, S, P, E, rows, round_bf16, stream)
               : launch_narrow<float, false>(W, idx, offsets, wgt, out, B, S, P, E, rows, round_bf16, stream);
  }
  if (table_bf16)
    return wgt ? launch_layout<uint16_t, true>(W, idx, offsets, wgt, out, B, S, P, E, rows, round_bf16, layout_bags, stream)
               : launch_layout<uint16_t, false>(W, idx, offsets, wgt, out, B, S, P, E, rows, round_bf16, layout_bags, stream);
  return wgt ? launch_layout<float, true>(W, idx, offsets, wgt, out, B, S, P, E, rows, round_bf16, layout_bags, stream)
             : launch_layout<float, false>(W, idx, offsets, wgt, out, B, S, P, E, rows, round_bf16, layout_bags, stream);
}
