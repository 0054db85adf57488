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
// boundary.  A warp takes 32 consecutive bags (in [B, S] order), lane t
// loading bag t's ids, weights and slot offset (one 32-bit j % S a bag) and
// handing them to the lanes that read its rows by shuffle.  A lane holds V
// values of the output (V = 2 bf16, 1 fp32; a unit), so a row of E values is
// U = ceil(E / V) units, read by a group of rl lanes (U rounded up to a power
// of two, at most 32; a row of more than 32 units takes passes of 32), and a
// warp reads G = 32 / rl bags at once, one a group (at E = 11 bf16: four bags
// of six lanes out of eight), in rl rounds over its 32 bags, kNarrowRounds
// rounds' loads in flight.  A bf16 row starts on a 2-byte boundary: the lane
// of units c, c + 1 reads the aligned 4-byte word that holds value c and,
// where the row's start is odd, the next one, which holds value c + 1 (both
// hold bytes of the row, so no read leaves the table), and takes the pair
// out of them with one funnel shift.  It adds the bag's lookups in order,
// the first as it is and each next one with one fp32 add, a lookup outside
// [0, rows) adding +0 and a weighted lookup its rounded product w * x: the
// plain version's operations, so that a bag of one lookup (the recsys
// archetypes' P = 1) gives its bits.  Each lane writes its own V values, so
// that the lanes of a round write its G bags' one run of G * E floats, a
// group's consecutive lanes on consecutive pairs (handing the values round
// by shuffle so that each store covered 32 consecutive floats took 1.34
// times as long at E = 11: the shuffles, not the bytes, were the cost).  No
// division a value; index arithmetic in 32 bits but the row address.
constexpr int kNarrowWarps = 8;
constexpr int kNarrowRounds = 4;

struct NarrowMap {
  int rl_log2;  // the lanes of a group: 1 << rl_log2
  int passes;   // of 32 units, over a row wider than 32 units
};

// Five blocks an SM: 1-3 % faster than no register cap, where six blocks'
// tighter cap took 1.3 to 1.5 times as long (tools/ablate_bag.py --only narrow).
template <typename T, bool kWeighted>
__global__ void __launch_bounds__(kNarrowWarps * 32, 5)
    embedding_bag_narrow_kernel(const T* __restrict__ W, const int32_t* __restrict__ idx,
                                const int32_t* __restrict__ offsets, const float* __restrict__ wgt,
                                float* __restrict__ out, uint32_t n_bags, int S, int P, int E,
                                int64_t rows, int round_bf16, NarrowMap map) {
  constexpr int V = sizeof(T) == 2 ? 2 : 1;  // values a lane holds
  const int lane = threadIdx.x & 31;
  const uint32_t j0 = (blockIdx.x * kNarrowWarps + (threadIdx.x >> 5)) * 32u;
  if (j0 >= n_bags) return;  // the whole warp leaves together
  const int rl = 1 << map.rl_log2, G = 32 >> map.rl_log2;
  const int grp = lane >> map.rl_log2, gl = lane & (rl - 1);
  // the bag this lane loads for the warp
  const uint32_t jl = j0 + lane;
  const bool bag_in = jl < n_bags;
  const int32_t off = bag_in && offsets ? __ldg(offsets + jl % static_cast<uint32_t>(S)) : 0;
  // a bf16 table as aligned 4-byte words; its first value's place in the first word
  const uint32_t* __restrict__ Ww = reinterpret_cast<const uint32_t*>(
      reinterpret_cast<uintptr_t>(W) & ~static_cast<uintptr_t>(3));
  const int64_t par0 = (reinterpret_cast<uintptr_t>(W) >> 1) & 1;
  // lookup p of this lane's bag: its row (-1 outside [0, rows)) and weight
  auto lookup = [&](int p, int32_t& key, float& w) {
    const int64_t at = static_cast<int64_t>(jl) * P + p;
    // the offset add wraps as int32 arithmetic does
    const int32_t g = bag_in ? static_cast<int32_t>(static_cast<uint32_t>(__ldg(idx + at)) +
                                                    static_cast<uint32_t>(off))
                             : -1;
    key = g >= 0 && g < rows ? g : -1;
    w = kWeighted && bag_in ? __ldg(wgt + at) : 0.f;
  };
  // the first lookup's, loaded once a warp (the archetypes' P = 1: the only
  // one); loading it again each rounds' pass, as the later ones are, took
  // up to 10 % longer under the five-block register cap
  int32_t key0 = -1;
  float w0 = 0.f;
  if (P > 0) lookup(0, key0, w0);
  for (int r0 = 0; r0 < rl; r0 += kNarrowRounds) {
    for (int pass = 0; pass < map.passes; ++pass) {
      const int cbase = pass * 32 * V;
      const int c = cbase + V * gl;  // this lane's first column
      float acc[kNarrowRounds][V] = {};
      for (int p = 0; p < P; ++p) {
        int32_t key_l = key0;
        float w_l = w0;
        if (p > 0) lookup(p, key_l, w_l);
        // every round's words in flight before any is used
        uint32_t lo[kNarrowRounds], hi[kNarrowRounds], sh[kNarrowRounds];
        int32_t key[kNarrowRounds];
#pragma unroll
        for (int u = 0; u < kNarrowRounds; ++u) {
          key[u] = __shfl_sync(kFull, key_l, ((r0 + u) * G + grp) & 31);
          lo[u] = hi[u] = sh[u] = 0u;
          if (key[u] >= 0 && c < E && r0 + u < rl) {
            if constexpr (V == 2) {
              const int64_t a = static_cast<int64_t>(key[u]) * E + c + par0;  // value c's place
              sh[u] = static_cast<uint32_t>(a & 1) * 16u;
              lo[u] = __ldg(Ww + (a >> 1));
              if (sh[u] && c + 1 < E) hi[u] = __ldg(Ww + (a >> 1) + 1);
            } else {
              lo[u] = __float_as_uint(__ldg(reinterpret_cast<const float*>(W) +
                                            static_cast<int64_t>(key[u]) * E + c));
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kNarrowRounds; ++u) {
          float w = 0.f;
          if constexpr (kWeighted) w = __shfl_sync(kFull, w_l, ((r0 + u) * G + grp) & 31);
          float x[V];
          if constexpr (V == 2) {
            const uint32_t pair = __funnelshift_r(lo[u], hi[u], sh[u]);  // values c, c + 1
            x[0] = __uint_as_float(pair << 16);
            x[1] = __uint_as_float(pair & 0xffff0000u);
          } else {
            x[0] = __uint_as_float(lo[u]);
          }
#pragma unroll
          for (int v = 0; v < V; ++v) {
            float xv = 0.f;
            if (key[u] >= 0) xv = kWeighted ? __fmul_rn(w, x[v]) : x[v];
            acc[u][v] = p == 0 ? xv : __fadd_rn(acc[u][v], xv);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kNarrowRounds; ++u) {
        if (r0 + u >= rl) break;  // warp-uniform
        if (round_bf16) {
#pragma unroll
          for (int v = 0; v < V; ++v) acc[u][v] = __bfloat162float(__float2bfloat16_rn(acc[u][v]));
        }
        const uint32_t j = j0 + static_cast<uint32_t>((r0 + u) * G + grp);  // the group's bag
#pragma unroll
        for (int v = 0; v < V; ++v)
          if (c + v < E && j < n_bags) out[static_cast<int64_t>(j) * E + c + v] = acc[u][v];
      }
    }
  }
}

template <typename T, bool kWeighted>
int launch_narrow(const void* W, const void* idx, const void* offsets, const void* wgt, void* out,
                  int64_t B, int S, int P, int E, int64_t rows, int round_bf16, void* stream) {
  constexpr int V = sizeof(T) == 2 ? 2 : 1;
  const int units = (E + V - 1) / V;
  NarrowMap map{0, (units + 31) / 32};
  while ((1 << map.rl_log2) < std::min(units, 32)) ++map.rl_log2;
  const int64_t warps = (B * S + 31) / 32;
  const int64_t blocks = (warps + kNarrowWarps - 1) / kNarrowWarps;
  embedding_bag_narrow_kernel<T, kWeighted>
      <<<static_cast<unsigned>(blocks), kNarrowWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(W), static_cast<const int32_t*>(idx),
          static_cast<const int32_t*>(offsets), static_cast<const float*>(wgt),
          static_cast<float*>(out), static_cast<uint32_t>(B * S), S, P, E, rows, round_bf16, map);
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
