// Flash attention forward: o = softmax(mask(softcap(scale * q k^T))) v, with
// q [B, H, Lq, D] and k, v [B, Hkv, Lk, D] bf16, row-major, o in q's layout.
// One block per (query tile of 64, head, batch) walks the key tiles of 128
// its queries can see, with the online softmax in registers and both products
// on bf16 mma.sync m16n8k16 with fp32 accumulators.  Ragged Lq and Lk are
// masked here, so the caller pads nothing.  The design note is in
// repro_torch/kernels/flash_attention.py.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BQ = 64;   // queries a block: 4 warps of 16 rows
constexpr int BK = 128;  // keys a tile: where the running max is updated, as the TPU kernel's bk
constexpr int PAD = 8;   // row stride D + 8 bf16: 16-byte aligned rows, ldmatrix without bank conflicts
constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;  // a masked score (the TPU kernel's NEG_INF)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  // 16 bytes global -> shared; zero-filled when !valid (src is then not read)
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);  // .x = lo (low half), round to nearest
  return *reinterpret_cast<const uint32_t*>(&t);
}

// rows [row0, row0 + ROWS) of a row-major [n, D] bf16 matrix into shared
// memory with row stride D + PAD; rows at or past n are zero-filled
template <int D, int ROWS>
__device__ __forceinline__ void load_rows(uint16_t* dst, const uint16_t* __restrict__ src, int row0,
                                          int n) {
  constexpr int kChunks = D / 8;
  for (int i = threadIdx.x; i < ROWS * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    const bool ok = row0 + r < n;
    cp_async16(dst + r * (D + PAD) + c, src + static_cast<int64_t>(ok ? row0 + r : 0) * D + c, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                           const uint16_t* __restrict__ v, __nv_bfloat16* __restrict__ o, int H,
                           int Hkv, int Lq, int Lk, float scale, int causal, float softcap,
                           int window) {
  constexpr int LD = D + PAD;
  constexpr int kDc = D / 16;   // k-chunks of the q k^T product
  constexpr int kDn = D / 8;    // n-tiles of the output
  constexpr int kKn = BK / 8;   // n-tiles of the score tile
  extern __shared__ __align__(16) uint16_t smem[];
  uint16_t* Qs = smem;
  uint16_t* Ks = Qs + BQ * LD;
  uint16_t* Vs = Ks + BK * LD;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gid = lane >> 2;  // fragment row (and score column group)
  const int tig = lane & 3;   // thread in group
  const int qt = gridDim.x - 1 - blockIdx.x;  // causal: the tiles with the most keys start first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);  // GQA: jnp.repeat's order
  const int q0 = qt * BQ;
  const int shift = Lk - Lq;  // right-aligned: query i sits at key position Lk - Lq + i
  const uint16_t* qb = q + (static_cast<int64_t>(b) * H + h) * Lq * D;
  const uint16_t* kb = k + (static_cast<int64_t>(b) * Hkv + hk) * Lk * D;
  const uint16_t* vb = v + (static_cast<int64_t>(b) * Hkv + hk) * Lk * D;
  __nv_bfloat16* ob = o + (static_cast<int64_t>(b) * H + h) * Lq * D;

  // the key tiles any query of this block can see (the TPU kernel's `needed`)
  const int qa0 = q0 + shift;
  const int qa1 = min(q0 + BQ, Lq) - 1 + shift;
  const int kfirst = window > 0 ? max(0, qa0 - window + 1) : 0;
  const int klast = causal ? min(Lk - 1, qa1) : Lk - 1;
  const int t0 = kfirst / BK;
  const int t1 = klast >= kfirst ? klast / BK : t0 - 1;

  // this thread's two query rows (absolute positions) and their running state
  const int r0 = q0 + warp * 16 + gid;
  const int pa[2] = {r0 + shift, r0 + 8 + shift};
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  float acc[kDn][4];
#pragma unroll
  for (int j = 0; j < kDn; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  load_rows<D, BQ>(Qs, qb, q0, Lq);
  if (t0 <= t1) load_rows<D, BK>(Ks, kb, t0 * BK, Lk);
  cp_async_commit();
  if (t0 <= t1) load_rows<D, BK>(Vs, vb, t0 * BK, Lk);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  uint32_t qf[kDc][4];
#pragma unroll
  for (int c = 0; c < kDc; ++c)
    ldmatrix_x4(qf[c], Qs + (warp * 16 + (lane & 15)) * LD + c * 16 + (lane >> 4) * 8);

  for (int t = t0; t <= t1; ++t) {
    const int k0 = t * BK;
    if (t > t0) {
      cp_async_wait<1>();  // this tile's keys (its values may still be in flight)
      __syncthreads();
    }
    float s[kKn][4];
#pragma unroll
    for (int j = 0; j < kKn; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int c = 0; c < kDc; ++c) {
#pragma unroll
      for (int j = 0; j < kKn; j += 2) {
        uint32_t kf[4];
        ldmatrix_x4(kf, Ks + (j * 8 + (lane & 7) + ((lane >> 4) << 3)) * LD + c * 16 +
                            ((lane >> 3) & 1) * 8);
        mma_16816(s[j], qf[c], kf[0], kf[1]);
        mma_16816(s[j + 1], qf[c], kf[2], kf[3]);
      }
    }
    __syncthreads();  // every warp is done with Ks: fetch the next tile's keys behind the softmax
    if (t < t1) load_rows<D, BK>(Ks, kb, k0 + BK, Lk);
    cp_async_commit();

    // scale, softcap after the scale, mask; the masking only where the tile
    // can hold a masked pair for some query of the block
    const bool edge = k0 + BK > Lk || (causal && k0 + BK - 1 > qa0) ||
                      (window > 0 && k0 <= qa1 - window);
    uint64_t live = ~0ull;
#pragma unroll
    for (int j = 0; j < kKn; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        if (edge) {
          const int kp = k0 + j * 8 + tig * 2 + (e & 1);
          const int qp = pa[e >> 1];
          const bool ok = kp < Lk && (!causal || kp <= qp) && (window <= 0 || kp > qp - window);
          if (!ok) {
            x = kNegInf;
            live &= ~(1ull << (j * 4 + e));
          }
        }
        s[j][e] = x;
      }
    }
    float alpha[2];
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < kKn; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * i], s[j][2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      alpha[i] = expf(m[i] - mx);
      m[i] = mx;
    }
#pragma unroll
    for (int j = 0; j < kKn; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = (live >> (j * 4 + e)) & 1ull ? expf(s[j][e] - m[e >> 1]) : 0.f;
        s[j][e] = p;
        sum[e >> 1] += p;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
      l[i] = __fadd_rn(__fmul_rn(l[i], alpha[i]), sum[i]);
    }
#pragma unroll
    for (int j = 0; j < kDn; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }

    cp_async_wait<1>();  // this tile's values (the next keys may still be in flight)
    __syncthreads();
    // acc += bf16(p) v: the score fragments of two n-tiles are the A fragment of one k-chunk
#pragma unroll
    for (int c = 0; c < BK / 16; ++c) {
      const uint32_t a[4] = {pack_bf16(s[2 * c][0], s[2 * c][1]),
                             pack_bf16(s[2 * c][2], s[2 * c][3]),
                             pack_bf16(s[2 * c + 1][0], s[2 * c + 1][1]),
                             pack_bf16(s[2 * c + 1][2], s[2 * c + 1][3])};
#pragma unroll
      for (int j = 0; j < kDn; j += 2) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, Vs + (c * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + j * 8 +
                                  (lane >> 4) * 8);
        mma_16816(acc[j], a, vf[0], vf[1]);
        mma_16816(acc[j + 1], a, vf[2], vf[3]);
      }
    }
    __syncthreads();  // every warp is done with Vs: fetch the next tile's values
    if (t < t1) load_rows<D, BK>(Vs, vb, k0 + BK, Lk);
    cp_async_commit();
  }
  cp_async_wait<0>();

  // o = acc / l, with l == 0 (a row that saw no key) read as 1
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    if (r >= Lq) continue;
    const float li = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int j = 0; j < kDn; ++j) {
      const __nv_bfloat162 val =
          __floats2bfloat162_rn(acc[j][2 * i] / li, acc[j][2 * i + 1] / li);
      *reinterpret_cast<__nv_bfloat162*>(ob + static_cast<int64_t>(r) * D + j * 8 + tig * 2) = val;
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H, int Hkv, int Lq,
           int Lk, float scale, int causal, float softcap, int window, cudaStream_t stream) {
  const int smem = (BQ + 2 * BK) * (D + PAD) * static_cast<int>(sizeof(uint16_t));
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Lq + BQ - 1) / BQ, H, B);
  flash_attention_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<__nv_bfloat16*>(o), H, Hkv, Lq, Lk, scale,
      causal, softcap, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [B, H, Lq, D], k and v [B, Hkv, Lk, D] bf16 contiguous, o [B, H, Lq, D]
// bf16; D 64 or 128, H % Hkv == 0; window 0 = global, softcap 0 = none.
// Returns the CUDA error of the launch (0 = none; -1 = an unsupported D).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int B,
                                   int H, int Hkv, int Lq, int Lk, int D, float scale, int causal,
                                   float softcap, int window, void* stream) {
  if (B == 0 || H == 0 || Lq == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 128) return launch<128>(q, k, v, o, B, H, Hkv, Lq, Lk, scale, causal, softcap, window, s);
  if (D == 64) return launch<64>(q, k, v, o, B, H, Hkv, Lq, Lk, scale, causal, softcap, window, s);
  return -1;
}
