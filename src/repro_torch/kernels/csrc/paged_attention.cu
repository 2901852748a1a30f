// Paged attention for Hopper (sm_90a): decode and in-loop chunked prefill
// over flat KV block pools, addressed through per-slot block tables.
//
// paged_attention_bf16 replaces the fp leg of the Pallas TPU kernel
//   src/repro/kernels/paged_attention.py::paged_decode_attention
//   (_kernel, quantized=False).
// Slot b carries C query tokens; query c sits at absolute position
// pos[b] + c and attends cache cells [0, pos[b] + c]. Cell i of slot b
// lives in physical block tables[b, i / page], row i % page, of the
// (N, page, KV, d) pools. An entry >= N is a sentinel (an unallocated
// page): it is clamped to N - 1 exactly as the TPU index map clamps it, so
// the pool is never read past its end, and the position mask hides it
// whenever it lies past a query's position. Pages past the last query's
// position (pos[b] + C - 1) are never touched.
//
// What bounds it on an H100: ~4 flops per cache byte at C = 1, at most
// ~4·C·G at C columns — below the ~295 flops/byte balance point at the
// engine's shapes, so the kernel is bound by reading each K/V cell of the
// slot's window once. One block per (kv head, slot, tile of R query rows):
// a row is one (column c, head g) pair of the GQA group, so the G heads
// and the C columns share every K/V read of the tile; each of the four
// warps takes 32 cells at a time (one lane per cell, the block-table
// lookup done by the lane that reads the cell) and keeps an online softmax
// per row; the warps merge their partial states at the end. Rows of a
// tile that are past the last column are padding: computed as fully
// masked, never written. A tile re-reads the window once per tile, so
// C·G > R costs ceil(C·G / R) reads of the window (a wgmma/TMA version
// with all rows of a slot in one block is the next step).
// Numerics follow the TPU kernel: scores in f32 scaled by d^-0.5, masked
// scores at -1e30, p rounded to bf16 before P·V, l floored at 1e-30,
// output rounded once to bf16.
//
// The C function returns cudaGetLastError() of the launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr float NEG = -1e30f;
constexpr int NW = 4;  // warps per block
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

template <int D, int R>
__global__ void __launch_bounds__(NW * 32)
paged_attn_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const int* __restrict__ tables,
                  const int* __restrict__ pos, bf16* __restrict__ o, int C,
                  int G, int N, int page, int P, float scale, long long tsb,
                  long long qsb, long long qsc, long long qsh, long long ksn,
                  long long ksp, long long ksh, long long vsn, long long vsp,
                  long long vsh, long long osb, long long osc,
                  long long osh) {
  constexpr int DL = D / 32;  // output dims per lane
  __shared__ __align__(16) float qsm[R][D];
  __shared__ float red_m[NW][R], red_l[NW][R];
  __shared__ float red_acc[NW][R][D];

  const int kvh = blockIdx.x, bb = blockIdx.y, r0 = blockIdx.z * R;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rows = C * G;
  const int p0 = pos[bb];

  // this tile's query rows in f32; row r0 + r is (column c, head g) with
  // c = (r0 + r) / G, g = (r0 + r) % G
  for (int i = tid; i < R * D; i += NW * 32) {
    const int r = i / D, e = i % D, rr = r0 + r;
    float val = 0.f;
    if (rr < rows) {
      const int c = rr / G, g = rr - (rr / G) * G;
      val = __bfloat162float(q[bb * qsb + c * qsc + (kvh * G + g) * qsh + e]);
    }
    qsm[r][e] = val;
  }
  __syncthreads();

  // last cell each row attends (-1: a padding row), and the window
  int lim[R];
#pragma unroll
  for (int r = 0; r < R; ++r)
    lim[r] = r0 + r < rows ? p0 + (r0 + r) / G : -1;
  const int c_last = (min(r0 + R, rows) - 1) / G;
  const int nkeys = min(p0 + c_last + 1, P * page);

  const bf16* kb = k + kvh * ksh;
  const bf16* vb = v + kvh * vsh;
  const int* trow = tables + bb * tsb;

  float m[R], l[R], acc[R][DL];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = NEG;
    l[r] = 0.f;
#pragma unroll
    for (int d = 0; d < DL; ++d) acc[r][d] = 0.f;
  }

  for (int c0 = warp * 32; c0 < nkeys; c0 += NW * 32) {
    const int ki = c0 + lane;
    const bool ok = ki < nkeys;
    long long voff = 0;
    float s[R];
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] = 0.f;
    if (ok) {
      const int j = ki / page;
      int blk = trow[j];
      blk = blk < 0 ? 0 : (blk >= N ? N - 1 : blk);  // sentinel: clamp
      const int cell = ki - j * page;
      voff = (long long)blk * vsn + (long long)cell * vsp;
      const bf16* kr = kb + (long long)blk * ksn + (long long)cell * ksp;
#pragma unroll
      for (int e = 0; e < D; e += 8) {  // this lane's key row, 16 B a load
        const uint4 u = *reinterpret_cast<const uint4*>(kr + e);
        const bf16* ev = reinterpret_cast<const bf16*>(&u);
        float kf[8];
#pragma unroll
        for (int t = 0; t < 8; ++t) kf[t] = __bfloat162float(ev[t]);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float4 qa = *reinterpret_cast<const float4*>(&qsm[r][e]);
          const float4 qc = *reinterpret_cast<const float4*>(&qsm[r][e + 4]);
          s[r] += qa.x * kf[0] + qa.y * kf[1] + qa.z * kf[2] + qa.w * kf[3] +
                  qc.x * kf[4] + qc.y * kf[5] + qc.z * kf[6] + qc.w * kf[7];
        }
      }
    }
    float p[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      p[r] = 0.f;
      if (c0 > lim[r]) continue;  // every cell of the chunk masked: no-op
      const bool valid = ok && ki <= lim[r];
      const float sr = valid ? s[r] * scale : NEG;
      const float m_new = fmaxf(m[r], warp_max(sr));
      p[r] = valid ? expf(sr - m_new) : 0.f;
      const float corr = expf(m[r] - m_new);
      l[r] = l[r] * corr + warp_sum(p[r]);
      m[r] = m_new;
#pragma unroll
      for (int d = 0; d < DL; ++d) acc[r][d] *= corr;
    }
    // acc += p (rounded to bf16) · V over this chunk's cells; each lane
    // owns DL output dims, so every V row is one coalesced warp read
    const int nk = min(32, nkeys - c0);
    for (int kk = 0; kk < nk; ++kk) {
      const long long vo = __shfl_sync(FULL, voff, kk);
      const bf16* vr = vb + vo + lane * DL;
      float vv[DL];
#pragma unroll
      for (int d = 0; d < DL; ++d) vv[d] = __bfloat162float(vr[d]);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float pk = __bfloat162float(
            __float2bfloat16(__shfl_sync(FULL, p[r], kk)));
#pragma unroll
        for (int d = 0; d < DL; ++d) acc[r][d] += pk * vv[d];
      }
    }
  }

  // merge the warps' partial softmax states
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (lane == 0) {
      red_m[warp][r] = m[r];
      red_l[warp][r] = l[r];
    }
#pragma unroll
    for (int d = 0; d < DL; ++d) red_acc[warp][r][lane * DL + d] = acc[r][d];
  }
  __syncthreads();
  for (int i = tid; i < R * D; i += NW * 32) {
    const int r = i / D, e = i % D, rr = r0 + r;
    if (rr >= rows) continue;
    float mm = NEG;
#pragma unroll
    for (int w = 0; w < NW; ++w) mm = fmaxf(mm, red_m[w][r]);
    float ll = 0.f, aa = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float f = expf(red_m[w][r] - mm);
      ll += red_l[w][r] * f;
      aa += red_acc[w][r][e] * f;
    }
    const int c = rr / G, g = rr - (rr / G) * G;
    o[bb * osb + c * osc + (kvh * G + g) * osh + e] =
        __float2bfloat16(aa / fmaxf(ll, 1e-30f));
  }
}

template <int D, int R>
int launch(const void* q, const void* k, const void* v, const void* tables,
           const void* pos, void* o, int B, int C, int G, int KV, int N,
           int page, int P, const long long* st, void* stream) {
  dim3 grid(KV, B, (C * G + R - 1) / R);
  const float scale = 1.0f / sqrtf((float)D);
  paged_attn_kernel<D, R><<<grid, NW * 32, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const int*>(tables),
      static_cast<const int*>(pos), static_cast<bf16*>(o), C, G, N, page, P,
      scale, st[12], st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], st[9], st[10], st[11]);
  return (int)cudaGetLastError();
}

// rows per block: the smallest power of two covering C·G, at most 16
// (8 at d = 128, where each row holds 4 accumulator registers a lane)
template <int D>
int launch_for_d(int R, const void* q, const void* k, const void* v,
                 const void* tables, const void* pos, void* o, int B, int C,
                 int G, int KV, int N, int page, int P, const long long* st,
                 void* stream) {
  switch (R) {
    case 1: return launch<D, 1>(q, k, v, tables, pos, o, B, C, G, KV, N,
                                page, P, st, stream);
    case 2: return launch<D, 2>(q, k, v, tables, pos, o, B, C, G, KV, N,
                                page, P, st, stream);
    case 4: return launch<D, 4>(q, k, v, tables, pos, o, B, C, G, KV, N,
                                page, P, st, stream);
    case 8: return launch<D, 8>(q, k, v, tables, pos, o, B, C, G, KV, N,
                                page, P, st, stream);
    case 16:
      if constexpr (D == 64)
        return launch<D, 16>(q, k, v, tables, pos, o, B, C, G, KV, N, page,
                             P, st, stream);
      return (int)cudaErrorInvalidValue;
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q (B, C, H, d) bf16; k/v (N, page, KV, d) bf16 pools; tables (B, P)
// int32 (entries >= N are sentinels), last dim contiguous; pos (B,) int32;
// o (B, C, H, d) bf16. strides: 13 element strides (q: b, c, h; k: n, p,
// kv; v: n, p, kv; o: b, c, h; tables: b), q/k/v/o ones a multiple of 8
// with 16-byte aligned bases. d in {64, 128}; H / KV in {1, 2, 4, 8};
// page a multiple of 8 in [8, 64].
int paged_attention_bf16(const void* q, const void* k, const void* v,
                         const void* tables, const void* pos, void* o, int B,
                         int C, int H, int KV, int d, int N, int page, int P,
                         const long long* strides, void* stream) {
  if (B < 1 || C < 1 || KV < 1 || H % KV != 0 || N < 1 || P < 1 ||
      page < 8 || page > 64 || page % 8 != 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const int G = H / KV;
  if (G != 1 && G != 2 && G != 4 && G != 8) return (int)cudaErrorInvalidValue;
  const int rmax = d == 64 ? 16 : 8;
  int R = 1;
  while (R < C * G && R < rmax) R *= 2;
  if ((C * G + R - 1) / R > 65535) return (int)cudaErrorInvalidValue;
  if (d == 64)
    return launch_for_d<64>(R, q, k, v, tables, pos, o, B, C, G, KV, N, page,
                            P, strides, stream);
  if (d == 128)
    return launch_for_d<128>(R, q, k, v, tables, pos, o, B, C, G, KV, N,
                             page, P, strides, stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
