// Attention forward kernels for Hopper (sm_90a); the backward pair is in
// flash_attention_bwd.cu.
//
// flash_attention_bf16 replaces the Pallas TPU kernels
//   src/repro/kernels/flash_attention.py::flash_attention (_kernel,
//   with_stats=False): online-softmax attention for prefill, and
//   src/repro/kernels/flash_attention.py::flash_attention_fwd (_kernel,
//   with_stats=True): the same kernel also writing the per-row
//   log-sum-exp lse = m + log(l) (B, H, T) f32 when given an lse pointer —
//   the one residual the training backward rebuilds p from.
// decode_attention_bf16 replaces
//   src/repro/kernels/flash_attention.py::decode_attention
//   (_decode_kernel): one query token per (slot, head) against the dense
//   (B, S, KV, d) cache, masked by the slot's position.
//
// What bounds them on an H100:
//   * prefill (T = S <= 256, d = 64): 4·T·S·d flops per head against
//     (T + 2S)·d·2 bytes — at most ~85 flops/byte, under the ~295 balance
//     point, so the kernel wants to read q/k/v once and never write the
//     (T, S) scores to device memory. One block per (q tile, head, batch)
//     keeps S, P and the running output in shared memory; the causal
//     tile skip drops the tiles above the diagonal; the KV head h / G is
//     read through strides, so no repeated or transposed copy exists.
//   * decode: ~4 flops per cache byte — purely bound by reading the
//     cache cells 0..pos[b]. One block per (kv head, slot) reads each K/V
//     row once for all G query heads of its group; cells past pos[b] are
//     never touched. Four warps split the cells and merge their partial
//     softmax states at the end.
// Numerics follow the TPU kernels: scores in f32, masked entries set to
// -1e30, p rounded to v's dtype (bf16) before P·V, l floored at 1e-30
// (so an empty row yields 0, never NaN), output rounded once to bf16; lse
// is taken from the same floored l.
//
// The C functions return cudaGetLastError() of the launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr float NEG = -1e30f;

// ---------------------------------------------------------------- prefill

constexpr int FBQ = 64;   // query rows per block (16 per warp)
constexpr int FBKV = 64;  // keys per tile
constexpr int FNW = 4;    // warps per block

template <int D>
struct FlashSmem {
  static constexpr int DS = D + 8;      // bf16 stride of q/k/v tiles
  static constexpr int SS = FBKV + 4;   // f32 stride of the score tile
  static constexpr int PS = FBKV + 8;   // bf16 stride of the P tile
  static constexpr int OS = D + 4;      // f32 stride of the output rows
  static constexpr int Q = 0;
  static constexpr int K = Q + FBQ * DS * 2;
  static constexpr int V = K + FBKV * DS * 2;
  static constexpr int S = V + FBKV * DS * 2;
  static constexpr int P = S + FNW * 16 * SS * 4;
  static constexpr int O = P + FNW * 16 * PS * 2;
  static constexpr int TOTAL = O + FNW * 16 * OS * 4;
  static_assert(K % 128 == 0 && V % 128 == 0 && S % 128 == 0 &&
                    P % 128 == 0 && O % 128 == 0,
                "shared-memory regions must stay 128-byte aligned");
};

template <int D>
__global__ void __launch_bounds__(FNW * 32)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 float* __restrict__ lse, int T, int S, int H, int KV,
                 int kv_len, int causal, float scale,
                 long long qsb, long long qst, long long qsh, long long ksb,
                 long long kss, long long ksh, long long vsb, long long vss,
                 long long vsh, long long osb, long long ost,
                 long long osh) {
  using L = FlashSmem<D>;
  constexpr int DS = L::DS, SS = L::SS, PS = L::PS, OS = L::OS;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem + L::Q);
  bf16* ks = reinterpret_cast<bf16*>(smem + L::K);
  bf16* vs = reinterpret_cast<bf16*>(smem + L::V);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* ssw = reinterpret_cast<float*>(smem + L::S) + warp * 16 * SS;
  bf16* pw = reinterpret_cast<bf16*>(smem + L::P) + warp * 16 * PS;
  float* osw = reinterpret_cast<float*>(smem + L::O) + warp * 16 * OS;

  const int q0 = blockIdx.x * FBQ, h = blockIdx.y, bb = blockIdx.z;
  const int kvh = h / (H / KV);
  const bf16* qb = q + bb * qsb + h * qsh;
  const bf16* kb = k + bb * ksb + kvh * ksh;
  const bf16* vb = v + bb * vsb + kvh * vsh;
  const uint4 zero4 = make_uint4(0, 0, 0, 0);

  for (int c = tid; c < FBQ * (D / 8); c += FNW * 32) {
    const int row = c / (D / 8), col = (c % (D / 8)) * 8;
    const int t = q0 + row;
    *reinterpret_cast<uint4*>(qs + row * DS + col) =
        t < T ? *reinterpret_cast<const uint4*>(qb + t * qst + col) : zero4;
  }
  for (int i = lane; i < 16 * D; i += 32) osw[(i / D) * OS + i % D] = 0.f;

  const int myrow = lane >> 1, half = lane & 1;  // two lanes per query row
  const int qi = q0 + warp * 16 + myrow;
  float m_i = NEG, l_i = 0.f;

  int kv_end = kv_len;
  if (causal) kv_end = min(kv_end, q0 + FBQ);  // tiles above the diagonal
  const int nkv = (kv_end + FBKV - 1) / FBKV;

  for (int j = 0; j < nkv; ++j) {
    const int k0 = j * FBKV;
    __syncthreads();  // previous K/V tile consumed (and Q stored at j == 0)
    for (int c = tid; c < FBKV * (D / 8); c += FNW * 32) {
      const int row = c / (D / 8), col = (c % (D / 8)) * 8;
      const int s = k0 + row;
      const bool ok = s < S;
      *reinterpret_cast<uint4*>(ks + row * DS + col) =
          ok ? *reinterpret_cast<const uint4*>(kb + s * kss + col) : zero4;
      *reinterpret_cast<uint4*>(vs + row * DS + col) =
          ok ? *reinterpret_cast<const uint4*>(vb + s * vss + col) : zero4;
    }
    __syncthreads();

    // S = Q · K^T for this warp's 16 query rows
#pragma unroll
    for (int jn = 0; jn < FBKV / 16; ++jn) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sc;
      wmma::fill_fragment(sc, 0.f);
#pragma unroll
      for (int kk = 0; kk < D; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
        wmma::load_matrix_sync(fa, qs + warp * 16 * DS + kk, DS);
        wmma::load_matrix_sync(fb, ks + jn * 16 * DS + kk, DS);
        wmma::mma_sync(sc, fa, fb, sc);
      }
      wmma::store_matrix_sync(ssw + jn * 16, sc, SS, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax: lanes (2r, 2r+1) own row r, 32 columns each
    const float* srow = ssw + myrow * SS + half * 32;
    float sv[32];
    float mx = NEG;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int ki = k0 + half * 32 + c;
      const bool ok = ki < kv_len && (!causal || qi >= ki);
      sv[c] = ok ? srow[c] * scale : NEG;
      mx = fmaxf(mx, sv[c]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_i, mx);
    float sum = 0.f;
    bf16* prow = pw + myrow * PS + half * 32;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int ki = k0 + half * 32 + c;
      const bool ok = ki < kv_len && (!causal || qi >= ki);
      const float p = ok ? expf(sv[c] - m_new) : 0.f;
      sum += p;
      prow[c] = __float2bfloat16(p);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    const float corr = expf(m_i - m_new);
    l_i = l_i * corr + sum;
    m_i = m_new;
    float* orow = osw + myrow * OS + half * (D / 2);
#pragma unroll
    for (int c = 0; c < D / 2; ++c) orow[c] *= corr;
    __syncwarp();

    // O += P · V
#pragma unroll
    for (int jd = 0; jd < D / 16; ++jd) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> oc;
      wmma::load_matrix_sync(oc, osw + jd * 16, OS, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < FBKV; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, pw + kk, PS);
        wmma::load_matrix_sync(fb, vs + kk * DS + jd * 16, DS);
        wmma::mma_sync(oc, fa, fb, oc);
      }
      wmma::store_matrix_sync(osw + jd * 16, oc, OS, wmma::mem_row_major);
    }
    __syncwarp();
  }

  if (qi < T) {
    const float l = fmaxf(l_i, 1e-30f);
    bf16* orow = o + bb * osb + qi * ost + h * osh + half * (D / 2);
    const float* src = osw + myrow * OS + half * (D / 2);
#pragma unroll
    for (int c = 0; c < D / 2; ++c) orow[c] = __float2bfloat16(src[c] / l);
    if (lse != nullptr && half == 0)
      lse[((size_t)bb * H + h) * T + qi] = m_i + logf(l);
  }
}

template <int D>
int launch_flash(const void* q, const void* k, const void* v, void* o,
                 void* lse, int B, int T, int S, int H, int KV, int kv_len,
                 int causal, const long long* st, void* stream) {
  constexpr int smem = FlashSmem<D>::TOTAL;
  auto kern = flash_fwd_kernel<D>;
  static bool attr_set = false;
  if (smem > 48 * 1024 && !attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  dim3 grid((T + FBQ - 1) / FBQ, H, B);
  const float scale = 1.0f / sqrtf((float)D);
  kern<<<grid, FNW * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), T, S, H, KV, kv_len, causal, scale, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10],
      st[11]);
  return (int)cudaGetLastError();
}

// ----------------------------------------------------------------- decode

constexpr int DNW = 4;  // warps per block

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int D, int G>
__global__ void __launch_bounds__(DNW * 32)
decode_attn_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const int* __restrict__ pos,
                   bf16* __restrict__ o, int S, float scale, long long qsb,
                   long long qsh, long long ksb, long long kss,
                   long long ksh, long long vsb, long long vss,
                   long long vsh, long long osb, long long osh) {
  constexpr int DL = D / 32;  // output dims per lane
  __shared__ float qsm[G][D];
  __shared__ float red_m[DNW][G], red_l[DNW][G];
  __shared__ float red_acc[DNW][G][D];

  const int kvh = blockIdx.x, bb = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  for (int i = tid; i < G * D; i += DNW * 32) {
    const int g = i / D, c = i % D;
    qsm[g][c] = __bfloat162float(q[bb * qsb + (kvh * G + g) * qsh + c]);
  }
  __syncthreads();

  const int nkeys = min(pos[bb], S - 1) + 1;  // cells 0..pos[b]
  const bf16* kb = k + bb * ksb + kvh * ksh;
  const bf16* vb = v + bb * vsb + kvh * vsh;

  float m[G], l[G], acc[G][DL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = NEG;
    l[g] = 0.f;
#pragma unroll
    for (int d = 0; d < DL; ++d) acc[g][d] = 0.f;
  }

  for (int c0 = warp * 32; c0 < nkeys; c0 += DNW * 32) {
    const int ki = c0 + lane;
    const bool ok = ki < nkeys;
    float s[G];
#pragma unroll
    for (int g = 0; g < G; ++g) s[g] = 0.f;
    if (ok) {  // this lane's key row, 16 bytes at a time
      const bf16* kr = kb + ki * kss;
#pragma unroll
      for (int c = 0; c < D; c += 8) {
        const uint4 u = *reinterpret_cast<const uint4*>(kr + c);
        const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const float kv = __bfloat162float(e[t]);
#pragma unroll
          for (int g = 0; g < G; ++g) s[g] += qsm[g][c + t] * kv;
        }
      }
    }
    float p[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float sg = ok ? s[g] * scale : NEG;
      const float m_new = fmaxf(m[g], warp_max(sg));
      p[g] = ok ? expf(sg - m_new) : 0.f;
      const float corr = expf(m[g] - m_new);
      l[g] = l[g] * corr + warp_sum(p[g]);
      m[g] = m_new;
#pragma unroll
      for (int d = 0; d < DL; ++d) acc[g][d] *= corr;
    }
    // acc += p (rounded to bf16) · V over this chunk's keys; each lane
    // owns DL output dims, so every V row is one coalesced warp read
    const int nk = min(32, nkeys - c0);
    for (int kk = 0; kk < nk; ++kk) {
      const bf16* vr = vb + (c0 + kk) * vss + lane * DL;
      float vv[DL];
#pragma unroll
      for (int d = 0; d < DL; ++d) vv[d] = __bfloat162float(vr[d]);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float pk = __bfloat162float(
            __float2bfloat16(__shfl_sync(0xffffffffu, p[g], kk)));
#pragma unroll
        for (int d = 0; d < DL; ++d) acc[g][d] += pk * vv[d];
      }
    }
  }

  // merge the four warps' partial softmax states
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      red_m[warp][g] = m[g];
      red_l[warp][g] = l[g];
    }
#pragma unroll
    for (int d = 0; d < DL; ++d) red_acc[warp][g][lane * DL + d] = acc[g][d];
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += DNW * 32) {
    const int g = i / D, c = i % D;
    float mm = NEG;
#pragma unroll
    for (int w = 0; w < DNW; ++w) mm = fmaxf(mm, red_m[w][g]);
    float ll = 0.f, aa = 0.f;
#pragma unroll
    for (int w = 0; w < DNW; ++w) {
      const float f = expf(red_m[w][g] - mm);
      ll += red_l[w][g] * f;
      aa += red_acc[w][g][c] * f;
    }
    o[bb * osb + (kvh * G + g) * osh + c] =
        __float2bfloat16(aa / fmaxf(ll, 1e-30f));
  }
}

template <int D, int G>
int launch_decode(const void* q, const void* k, const void* v,
                  const void* pos, void* o, int B, int S, int KV,
                  const long long* st, void* stream) {
  dim3 grid(KV, B);
  const float scale = 1.0f / sqrtf((float)D);
  decode_attn_kernel<D, G>
      <<<grid, DNW * 32, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), static_cast<const int*>(pos),
          static_cast<bf16*>(o), S, scale, st[0], st[1], st[2], st[3], st[4],
          st[5], st[6], st[7], st[8], st[9]);
  return (int)cudaGetLastError();
}

template <int D>
int decode_for_d(int G, const void* q, const void* k, const void* v,
                 const void* pos, void* o, int B, int S, int KV,
                 const long long* st, void* stream) {
  switch (G) {
    case 1: return launch_decode<D, 1>(q, k, v, pos, o, B, S, KV, st, stream);
    case 2: return launch_decode<D, 2>(q, k, v, pos, o, B, S, KV, st, stream);
    case 4: return launch_decode<D, 4>(q, k, v, pos, o, B, S, KV, st, stream);
    case 8: return launch_decode<D, 8>(q, k, v, pos, o, B, S, KV, st, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q (B, T, H, d), k/v (B, S, KV, d), o (B, T, H, d), bf16, last dim
// contiguous. strides: 12 element strides (q: b, t, h; k: b, s, kv;
// v: b, s, kv; o: b, t, h), each a multiple of 8 with 16-byte aligned
// bases. Keys at index >= kv_len are masked; causal masks ki > qi.
// lse: nullptr (prefill), or (B, H, T) f32 contiguous, written with the
// per-row log-sum-exp (the training forward).
int flash_attention_bf16(const void* q, const void* k, const void* v,
                         void* o, void* lse, int B, int T, int S, int H,
                         int KV, int d, int kv_len, int causal,
                         const long long* strides, void* stream) {
  if (B < 1 || T < 1 || S < 1 || KV < 1 || H % KV != 0 || kv_len > S)
    return (int)cudaErrorInvalidValue;
  if (d == 64)
    return launch_flash<64>(q, k, v, o, lse, B, T, S, H, KV, kv_len, causal,
                            strides, stream);
  if (d == 128)
    return launch_flash<128>(q, k, v, o, lse, B, T, S, H, KV, kv_len,
                             causal, strides, stream);
  return (int)cudaErrorInvalidValue;
}

// q (B, H, d), k/v (B, S, KV, d) dense cache, pos (B,) int32, o (B, H, d).
// strides: 10 element strides (q: b, h; k: b, s, kv; v: b, s, kv; o: b, h).
int decode_attention_bf16(const void* q, const void* k, const void* v,
                          const void* pos, void* o, int B, int S, int H,
                          int KV, int d, const long long* strides,
                          void* stream) {
  if (B < 1 || S < 1 || KV < 1 || H % KV != 0)
    return (int)cudaErrorInvalidValue;
  const int G = H / KV;
  if (d == 64)
    return decode_for_d<64>(G, q, k, v, pos, o, B, S, KV, strides, stream);
  if (d == 128)
    return decode_for_d<128>(G, q, k, v, pos, o, B, S, KV, strides, stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
