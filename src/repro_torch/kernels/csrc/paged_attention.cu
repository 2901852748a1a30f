// Paged attention for Hopper (sm_90a): decode and in-loop chunked prefill
// over flat KV block pools, addressed through per-slot block tables.
//
// paged_attention_bf16 replaces the fp leg of the Pallas TPU kernel
//   src/repro/kernels/paged_attention.py::paged_decode_attention
//   (_kernel, quantized=False); paged_attention_int8 its int8 leg
//   (quantized=True).
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
// int8 leg (Q8): the pools hold int8 cells and two (N, page, KV) f32
// scale pools, one scale per (token, kv head), gathered through the same
// clamped table entry as the cell. A lane reads its key row as int8 (64 B
// at d = 64, half the bf16 row) with its scale and dequantizes it in
// registers; each V row is dequantized by the scale of
// its cell, passed across the warp with the row offset. q is taken in
// f32, and p stays f32 through P·V (after dequantization v is f32 in the
// TPU kernel, so its p.astype(v.dtype) keeps f32): unlike the fp leg,
// nothing rounds to bf16 before the output.
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

// K/V cell types: bf16 for the fp leg, int8 with f32 scales for Q8
template <bool Q8>
struct Cell;
template <>
struct Cell<false> {
  typedef bf16 T;
};
template <>
struct Cell<true> {
  typedef int8_t T;
};

__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(int8_t v) { return (float)v; }

// strides (elements): st[0..2] q (b, c, h); st[3..5] k (n, p, kv);
// st[6..8] v; st[9..11] o (b, c, h); st[12] tables (b); Q8 only:
// st[13..15] k_scale (n, p, kv); st[16..18] v_scale
struct Strides {
  long long v[19];
};

template <int D, int R, bool Q8>
__global__ void __launch_bounds__(NW * 32)
paged_attn_kernel(const bf16* __restrict__ q,
                  const typename Cell<Q8>::T* __restrict__ k,
                  const typename Cell<Q8>::T* __restrict__ v,
                  const float* __restrict__ k_scale,
                  const float* __restrict__ v_scale,
                  const int* __restrict__ tables, const int* __restrict__ pos,
                  bf16* __restrict__ o, int C, int G, int N, int page, int P,
                  float scale, const Strides st) {
  typedef typename Cell<Q8>::T CT;
  constexpr int DL = D / 32;   // output dims per lane
  constexpr int VEC = 16 / sizeof(CT);  // cell values per 16-byte load
  const long long qsb = st.v[0], qsc = st.v[1], qsh = st.v[2];
  const long long ksn = st.v[3], ksp = st.v[4], ksh = st.v[5];
  const long long vsn = st.v[6], vsp = st.v[7], vsh = st.v[8];
  const long long osb = st.v[9], osc = st.v[10], osh = st.v[11];
  const long long tsb = st.v[12];
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

  const CT* kb = k + kvh * ksh;
  const CT* vb = v + kvh * vsh;
  const float* ksb = Q8 ? k_scale + kvh * st.v[15] : nullptr;
  const float* vsb = Q8 ? v_scale + kvh * st.v[18] : nullptr;
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
    float vsc = 0.f;  // Q8: this lane's cell's V scale
    float s[R];
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] = 0.f;
    if (ok) {
      const int j = ki / page;
      int blk = trow[j];
      blk = blk < 0 ? 0 : (blk >= N ? N - 1 : blk);  // sentinel: clamp
      const int cell = ki - j * page;
      voff = (long long)blk * vsn + (long long)cell * vsp;
      const CT* kr = kb + (long long)blk * ksn + (long long)cell * ksp;
      float ksc = 1.f;
      if (Q8) {
        ksc = ksb[(long long)blk * st.v[13] + (long long)cell * st.v[14]];
        vsc = vsb[(long long)blk * st.v[16] + (long long)cell * st.v[17]];
      }
#pragma unroll
      for (int e = 0; e < D; e += VEC) {  // this lane's key row, 16 B a load
        const uint4 u = *reinterpret_cast<const uint4*>(kr + e);
        const CT* ev = reinterpret_cast<const CT*>(&u);
        float kf[VEC];
#pragma unroll
        for (int t = 0; t < VEC; ++t)
          kf[t] = Q8 ? to_f(ev[t]) * ksc : to_f(ev[t]);  // dequantize
#pragma unroll
        for (int r = 0; r < R; ++r) {
#pragma unroll
          for (int t = 0; t < VEC; t += 4) {
            const float4 qa =
                *reinterpret_cast<const float4*>(&qsm[r][e + t]);
            s[r] += qa.x * kf[t] + qa.y * kf[t + 1] + qa.z * kf[t + 2] +
                    qa.w * kf[t + 3];
          }
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
    // acc += p · V over this chunk's cells (fp leg: p rounded to bf16;
    // Q8: p in f32, V dequantized by its cell's scale); each lane owns DL
    // output dims, so every V row is one coalesced warp read
    const int nk = min(32, nkeys - c0);
    for (int kk = 0; kk < nk; ++kk) {
      const long long vo = __shfl_sync(FULL, voff, kk);
      const float vs = Q8 ? __shfl_sync(FULL, vsc, kk) : 1.f;
      const CT* vr = vb + vo + lane * DL;
      float vv[DL];
#pragma unroll
      for (int d = 0; d < DL; ++d)
        vv[d] = Q8 ? to_f(vr[d]) * vs : to_f(vr[d]);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float pr = __shfl_sync(FULL, p[r], kk);
        const float pk =
            Q8 ? pr : __bfloat162float(__float2bfloat16(pr));
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

struct Args {
  const void *q, *k, *v, *ks, *vs, *tables, *pos;
  void* o;
  int B, C, G, KV, N, page, P;
};

template <int D, int R, bool Q8>
int launch(const Args& a, const Strides& st, void* stream) {
  typedef typename Cell<Q8>::T CT;
  dim3 grid(a.KV, a.B, (a.C * a.G + R - 1) / R);
  const float scale = 1.0f / sqrtf((float)D);
  paged_attn_kernel<D, R, Q8><<<grid, NW * 32, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(a.q), static_cast<const CT*>(a.k),
      static_cast<const CT*>(a.v), static_cast<const float*>(a.ks),
      static_cast<const float*>(a.vs), static_cast<const int*>(a.tables),
      static_cast<const int*>(a.pos), static_cast<bf16*>(a.o), a.C, a.G,
      a.N, a.page, a.P, scale, st);
  return (int)cudaGetLastError();
}

// rows per block: the smallest power of two covering C·G, at most 16
// (8 at d = 128, where each row holds 4 accumulator registers a lane)
template <int D, bool Q8>
int launch_for_d(int R, const Args& a, const Strides& st, void* stream) {
  switch (R) {
    case 1: return launch<D, 1, Q8>(a, st, stream);
    case 2: return launch<D, 2, Q8>(a, st, stream);
    case 4: return launch<D, 4, Q8>(a, st, stream);
    case 8: return launch<D, 8, Q8>(a, st, stream);
    case 16:
      if constexpr (D == 64) return launch<D, 16, Q8>(a, st, stream);
      return (int)cudaErrorInvalidValue;
    default: return (int)cudaErrorInvalidValue;
  }
}

template <bool Q8>
int run(const void* q, const void* k, const void* v, const void* ks,
        const void* vs, const void* tables, const void* pos, void* o, int B,
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
  Strides st{};
  for (int i = 0; i < (Q8 ? 19 : 13); ++i) st.v[i] = strides[i];
  const Args a{q, k, v, ks, vs, tables, pos, o, B, C, G, KV, N, page, P};
  if (d == 64) return launch_for_d<64, Q8>(R, a, st, stream);
  if (d == 128) return launch_for_d<128, Q8>(R, a, st, stream);
  return (int)cudaErrorInvalidValue;
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
  return run<false>(q, k, v, nullptr, nullptr, tables, pos, o, B, C, H, KV,
                    d, N, page, P, strides, stream);
}

// The int8 leg: k/v (N, page, KV, d) int8 pools, k_scale / v_scale
// (N, page, KV) f32 per-cell scales. strides: the 13 above (k / v ones a
// multiple of 16 with 16-byte aligned bases), then k_scale (n, p, kv) and
// v_scale (n, p, kv) element strides.
int paged_attention_int8(const void* q, const void* k, const void* v,
                         const void* k_scale, const void* v_scale,
                         const void* tables, const void* pos, void* o, int B,
                         int C, int H, int KV, int d, int N, int page, int P,
                         const long long* strides, void* stream) {
  return run<true>(q, k, v, k_scale, v_scale, tables, pos, o, B, C, H, KV,
                   d, N, page, P, strides, stream);
}

}  // extern "C"
