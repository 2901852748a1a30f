// Flash-attention backward for Hopper (sm_90a): the two recompute passes.
//
// flash_attention_bwd_dq_bf16 replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention.py::flash_attention_bwd, dq pass
//   (_bwd_dq_kernel): one block per (query tile, head, batch) loops over
//   the KV tiles at or below the causal diagonal and accumulates
//   dq += ds·k in f32. Its prologue also computes D = rowsum(dO ⊙ O) for
//   its rows (f32) and writes it out for the second pass.
// flash_attention_bwd_dkv_bf16 replaces the dk/dv pass (_bwd_dkv_kernel):
//   one block per (KV tile, kv head, batch) loops over the G query heads
//   of its group and over the query tiles at or below the diagonal, and
//   accumulates dv += pᵀ·dO and dk += dsᵀ·q in f32 — the GQA group sum
//   happens in the accumulators, so no head-repeated k/v is ever made.
//
// Both rebuild each probability tile from the forward's per-row lse:
//   s = q·kᵀ·scale, p = exp(s − lse), dp = dO·vᵀ, ds = p·(dp − D)·scale,
// so no (T, S) tensor exists in device memory. As in the TPU kernels, p
// and ds are rounded to bf16 before the products that consume them;
// keys ≥ S and query rows ≥ T are masked, causal masks ki > qi.
//
// What bounds them on an H100: at the training shape (T = S = 1024,
// d = 64) the seven products take 14·d flops per (query, key) pair
// against ~(4 T + 2 S)·d·2 bytes per head — hundreds of flops per byte,
// so the kernels are bound by operations. This first version is the
// simple one: WMMA bf16 16x16x16 tiles with f32 sums staged through
// shared memory, four warps of 16 rows each; `wgmma`, TMA and register-
// resident accumulators are the later, faster design.
//
// The C functions return cudaGetLastError() of the launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BQ = 64;   // query rows per tile
constexpr int BKV = 64;  // keys per tile
constexpr int NW = 4;    // warps per block, 16 rows each

// 18 element strides, passed to the kernel by value (batch, row, head of
// each of six operands)
struct Strides {
  long long s[18];
};

// dq pass: q, dO, k, v tiles (bf16), per-warp S and dP (f32), dS (bf16)
// and the dq accumulator (f32).
template <int D>
struct DqSmem {
  static constexpr int DS = D + 8;     // bf16 stride of the tiles
  static constexpr int SS = BKV + 4;   // f32 stride of S / dP
  static constexpr int PS = BKV + 8;   // bf16 stride of dS
  static constexpr int AS = D + 4;     // f32 stride of the accumulator
  static constexpr int Q = 0;
  static constexpr int G = Q + BQ * DS * 2;
  static constexpr int K = G + BQ * DS * 2;
  static constexpr int V = K + BKV * DS * 2;
  static constexpr int S = V + BKV * DS * 2;
  static constexpr int DP = S + NW * 16 * SS * 4;
  static constexpr int DSB = DP + NW * 16 * SS * 4;
  static constexpr int ACC = DSB + NW * 16 * PS * 2;
  static constexpr int TOTAL = ACC + NW * 16 * AS * 4;
  static_assert(G % 128 == 0 && K % 128 == 0 && V % 128 == 0 &&
                    S % 128 == 0 && DP % 128 == 0 && DSB % 128 == 0 &&
                    ACC % 128 == 0,
                "shared-memory regions must stay 128-byte aligned");
};

// dk/dv pass: k, v (this block's keys), q, dO tiles, per-warp Sᵀ and dPᵀ
// (f32), Pᵀ and dSᵀ (bf16), the dk and dv accumulators (f32), and the
// query tile's lse and D.
template <int D>
struct DkvSmem {
  static constexpr int DS = D + 8;
  static constexpr int SS = BQ + 4;
  static constexpr int PS = BQ + 8;
  static constexpr int AS = D + 4;
  static constexpr int K = 0;
  static constexpr int V = K + BKV * DS * 2;
  static constexpr int Q = V + BKV * DS * 2;
  static constexpr int G = Q + BQ * DS * 2;
  static constexpr int ST = G + BQ * DS * 2;
  static constexpr int DPT = ST + NW * 16 * SS * 4;
  static constexpr int PT = DPT + NW * 16 * SS * 4;
  static constexpr int DST = PT + NW * 16 * PS * 2;
  static constexpr int DK = DST + NW * 16 * PS * 2;
  static constexpr int DV = DK + NW * 16 * AS * 4;
  static constexpr int LSE = DV + NW * 16 * AS * 4;
  static constexpr int DLT = LSE + BQ * 4;
  static constexpr int TOTAL = DLT + BQ * 4;
  static_assert(V % 128 == 0 && Q % 128 == 0 && G % 128 == 0 &&
                    ST % 128 == 0 && DPT % 128 == 0 && PT % 128 == 0 &&
                    DST % 128 == 0 && DK % 128 == 0 && DV % 128 == 0 &&
                    LSE % 128 == 0 && DLT % 128 == 0,
                "shared-memory regions must stay 128-byte aligned");
};

// rows [r0, r0 + 64) of a (rows, D) bf16 operand into a padded tile,
// zero past `n`, 16 bytes per thread and step
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long row_stride, int r0,
                                          int n, int tid) {
  constexpr int DS = D + 8;
  const uint4 zero4 = make_uint4(0, 0, 0, 0);
  for (int c = tid; c < 64 * (D / 8); c += NW * 32) {
    const int row = c / (D / 8), col = (c % (D / 8)) * 8;
    const int r = r0 + row;
    *reinterpret_cast<uint4*>(dst + row * DS + col) =
        r < n ? *reinterpret_cast<const uint4*>(src + r * row_stride + col)
              : zero4;
  }
}

// out (16 x 64, f32, stride OS) = A (16 x D rows at a, stride DS) ·
// Bᵀ where B is 64 rows at b (stride DS): A·Bᵀ over d
template <int D>
__device__ __forceinline__ void abt_16x64(float* out, int os, const bf16* a,
                                          const bf16* b) {
  constexpr int DS = D + 8;
#pragma unroll
  for (int jn = 0; jn < 4; ++jn) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
      wmma::load_matrix_sync(fa, a + kk, DS);
      wmma::load_matrix_sync(fb, b + jn * 16 * DS + kk, DS);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(out + jn * 16, acc, os, wmma::mem_row_major);
  }
}

// acc (16 x D, f32 in shared memory, stride AS) += P (16 x 64 bf16, stride
// PS) · B (64 rows of D at b, stride DS)
template <int D>
__device__ __forceinline__ void acc_pb(float* acc, const bf16* p, int ps,
                                       const bf16* b) {
  constexpr int DS = D + 8, AS = D + 4;
#pragma unroll
  for (int jd = 0; jd < D / 16; ++jd) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
    wmma::load_matrix_sync(c, acc + jd * 16, AS, wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < 64; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
      wmma::load_matrix_sync(fa, p + kk, ps);
      wmma::load_matrix_sync(fb, b + kk * DS + jd * 16, DS);
      wmma::mma_sync(c, fa, fb, c);
    }
    wmma::store_matrix_sync(acc + jd * 16, c, AS, wmma::mem_row_major);
  }
}

// ------------------------------------------------------------- dq pass

template <int D>
__global__ void __launch_bounds__(NW * 32)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ o,
                    const bf16* __restrict__ g,
                    const float* __restrict__ lse, float* __restrict__ delta,
                    bf16* __restrict__ dq, int T, int S, int H, int KV,
                    int causal, float scale, const Strides sd) {
  using L = DqSmem<D>;
  constexpr int DS = L::DS, SS = L::SS, PS = L::PS, AS = L::AS;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem + L::Q);
  bf16* gs = reinterpret_cast<bf16*>(smem + L::G);
  bf16* ks = reinterpret_cast<bf16*>(smem + L::K);
  bf16* vs = reinterpret_cast<bf16*>(smem + L::V);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* ssw = reinterpret_cast<float*>(smem + L::S) + warp * 16 * SS;
  float* dpw = reinterpret_cast<float*>(smem + L::DP) + warp * 16 * SS;
  bf16* dsw = reinterpret_cast<bf16*>(smem + L::DSB) + warp * 16 * PS;
  float* acw = reinterpret_cast<float*>(smem + L::ACC) + warp * 16 * AS;

  // element strides: q, k, v, o, g, dq — (batch, row, head) each
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, bb = blockIdx.z;
  const int kvh = h / (H / KV);
  const bf16* qb = q + bb * sd.s[0] + h * sd.s[2];
  const bf16* kb = k + bb * sd.s[3] + kvh * sd.s[5];
  const bf16* vb = v + bb * sd.s[6] + kvh * sd.s[8];
  const bf16* ob = o + bb * sd.s[9] + h * sd.s[11];
  const bf16* gb = g + bb * sd.s[12] + h * sd.s[14];

  load_tile<D>(qs, qb, sd.s[1], q0, T, tid);
  load_tile<D>(gs, gb, sd.s[13], q0, T, tid);
  for (int i = lane; i < 16 * D; i += 32) acw[(i / D) * AS + i % D] = 0.f;
  __syncthreads();

  // lanes (2r, 2r+1) own query row r of this warp, half the columns each
  const int myrow = lane >> 1, half = lane & 1;
  const int qi = q0 + warp * 16 + myrow;
  const size_t rowid = ((size_t)bb * H + h) * T + qi;
  float dlt = 0.f, lse_i = 0.f;
  if (qi < T) {  // D = rowsum(dO ⊙ O) in f32
    const bf16* gr = gs + (warp * 16 + myrow) * DS + half * (D / 2);
    const bf16* orow = ob + qi * sd.s[10] + half * (D / 2);
#pragma unroll
    for (int c = 0; c < D / 2; c += 8) {
      const uint4 u = *reinterpret_cast<const uint4*>(orow + c);
      const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
      for (int t = 0; t < 8; ++t)
        dlt += __bfloat162float(gr[c + t]) * __bfloat162float(e[t]);
    }
  }
  dlt += __shfl_xor_sync(0xffffffffu, dlt, 1);
  if (qi < T) {
    lse_i = lse[rowid];
    if (half == 0) delta[rowid] = dlt;
  }

  int kv_end = S;
  if (causal) kv_end = min(kv_end, q0 + BQ);  // tiles above the diagonal
  const int nkv = (kv_end + BKV - 1) / BKV;
  for (int j = 0; j < nkv; ++j) {
    const int k0 = j * BKV;
    __syncthreads();  // the previous K/V tile is consumed
    load_tile<D>(ks, kb, sd.s[4], k0, S, tid);
    load_tile<D>(vs, vb, sd.s[7], k0, S, tid);
    __syncthreads();

    abt_16x64<D>(ssw, SS, qs + warp * 16 * DS, ks);  // S = Q·Kᵀ
    abt_16x64<D>(dpw, SS, gs + warp * 16 * DS, vs);  // dP = dO·Vᵀ
    __syncwarp();

    const float* srow = ssw + myrow * SS + half * 32;
    const float* dprow = dpw + myrow * SS + half * 32;
    bf16* drow = dsw + myrow * PS + half * 32;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int ki = k0 + half * 32 + c;
      const bool ok = qi < T && ki < S && (!causal || qi >= ki);
      const float p = ok ? expf(srow[c] * scale - lse_i) : 0.f;
      drow[c] = __float2bfloat16(p * (dprow[c] - dlt) * scale);
    }
    __syncwarp();
    acc_pb<D>(acw, dsw, PS, ks);  // dq += dS·K
    __syncwarp();
  }

  __syncwarp();
  if (qi < T) {
    bf16* out =
        dq + bb * sd.s[15] + qi * sd.s[16] + h * sd.s[17] + half * (D / 2);
    const float* src = acw + myrow * AS + half * (D / 2);
#pragma unroll
    for (int c = 0; c < D / 2; ++c) out[c] = __float2bfloat16(src[c]);
  }
}

// ----------------------------------------------------------- dk/dv pass

template <int D>
__global__ void __launch_bounds__(NW * 32)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ g,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int T, int S, int H, int KV,
                     int causal, float scale, const Strides sd) {
  using L = DkvSmem<D>;
  constexpr int DS = L::DS, SS = L::SS, PS = L::PS, AS = L::AS;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem + L::K);
  bf16* vs = reinterpret_cast<bf16*>(smem + L::V);
  bf16* qs = reinterpret_cast<bf16*>(smem + L::Q);
  bf16* gs = reinterpret_cast<bf16*>(smem + L::G);
  float* lse_s = reinterpret_cast<float*>(smem + L::LSE);
  float* dlt_s = reinterpret_cast<float*>(smem + L::DLT);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* stw = reinterpret_cast<float*>(smem + L::ST) + warp * 16 * SS;
  float* dptw = reinterpret_cast<float*>(smem + L::DPT) + warp * 16 * SS;
  bf16* ptw = reinterpret_cast<bf16*>(smem + L::PT) + warp * 16 * PS;
  bf16* dstw = reinterpret_cast<bf16*>(smem + L::DST) + warp * 16 * PS;
  float* dkw = reinterpret_cast<float*>(smem + L::DK) + warp * 16 * AS;
  float* dvw = reinterpret_cast<float*>(smem + L::DV) + warp * 16 * AS;

  // element strides: q, k, v, g, dk, dv — (batch, row, head) each
  const int k0 = blockIdx.x * BKV, kvh = blockIdx.y, bb = blockIdx.z;
  const int grp = H / KV;

  load_tile<D>(ks, k + bb * sd.s[3] + kvh * sd.s[5], sd.s[4], k0, S, tid);
  load_tile<D>(vs, v + bb * sd.s[6] + kvh * sd.s[8], sd.s[7], k0, S, tid);
  for (int i = lane; i < 16 * D; i += 32) {
    dkw[(i / D) * AS + i % D] = 0.f;
    dvw[(i / D) * AS + i % D] = 0.f;
  }

  // lanes (2r, 2r+1) own key row r of this warp, half the query columns
  const int myrow = lane >> 1, half = lane & 1;
  const int ki = k0 + warp * 16 + myrow;
  const int i0 = causal ? k0 / BQ : 0;  // query tiles above the diagonal
  const int nq = (T + BQ - 1) / BQ;

  for (int gi = 0; gi < grp; ++gi) {
    const int h = kvh * grp + gi;
    const bf16* qb = q + bb * sd.s[0] + h * sd.s[2];
    const bf16* gb = g + bb * sd.s[9] + h * sd.s[11];
    const size_t rows = ((size_t)bb * H + h) * T;
    for (int i = i0; i < nq; ++i) {
      const int q0 = i * BQ;
      __syncthreads();  // the previous q / dO tile is consumed
      load_tile<D>(qs, qb, sd.s[1], q0, T, tid);
      load_tile<D>(gs, gb, sd.s[10], q0, T, tid);
      if (tid < BQ) {
        const int t = q0 + tid;
        lse_s[tid] = t < T ? lse[rows + t] : 0.f;
        dlt_s[tid] = t < T ? delta[rows + t] : 0.f;
      }
      __syncthreads();

      abt_16x64<D>(stw, SS, ks + warp * 16 * DS, qs);   // Sᵀ = K·Qᵀ
      abt_16x64<D>(dptw, SS, vs + warp * 16 * DS, gs);  // dPᵀ = V·dOᵀ
      __syncwarp();

      const float* srow = stw + myrow * SS + half * 32;
      const float* dprow = dptw + myrow * SS + half * 32;
      bf16* prow = ptw + myrow * PS + half * 32;
      bf16* drow = dstw + myrow * PS + half * 32;
#pragma unroll
      for (int c = 0; c < 32; ++c) {
        const int qq = half * 32 + c, qi = q0 + qq;
        const bool ok = qi < T && ki < S && (!causal || qi >= ki);
        const float p = ok ? expf(srow[c] * scale - lse_s[qq]) : 0.f;
        prow[c] = __float2bfloat16(p);
        drow[c] = __float2bfloat16(p * (dprow[c] - dlt_s[qq]) * scale);
      }
      __syncwarp();
      acc_pb<D>(dvw, ptw, PS, gs);   // dv += Pᵀ·dO
      acc_pb<D>(dkw, dstw, PS, qs);  // dk += dSᵀ·Q
      __syncwarp();
    }
  }

  __syncwarp();
  if (ki < S) {
    const int c0 = half * (D / 2);
    bf16* odk = dk + bb * sd.s[12] + ki * sd.s[13] + kvh * sd.s[14] + c0;
    bf16* odv = dv + bb * sd.s[15] + ki * sd.s[16] + kvh * sd.s[17] + c0;
    const float* sk = dkw + myrow * AS + c0;
    const float* sv = dvw + myrow * AS + c0;
#pragma unroll
    for (int c = 0; c < D / 2; ++c) {
      odk[c] = __float2bfloat16(sk[c]);
      odv[c] = __float2bfloat16(sv[c]);
    }
  }
}

template <typename Kern>
cudaError_t allow_smem(Kern kern, int smem, bool* done) {
  if (smem <= 48 * 1024 || *done) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess) *done = true;
  return e;
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* o,
              const void* g, const void* lse, void* delta, void* dq, int B,
              int T, int S, int H, int KV, int causal, const Strides& st,
              void* stream) {
  constexpr int smem = DqSmem<D>::TOTAL;
  static bool done = false;
  cudaError_t e = allow_smem(flash_bwd_dq_kernel<D>, smem, &done);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((T + BQ - 1) / BQ, H, B);
  flash_bwd_dq_kernel<D>
      <<<grid, NW * 32, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), static_cast<const bf16*>(o),
          static_cast<const bf16*>(g), static_cast<const float*>(lse),
          static_cast<float*>(delta), static_cast<bf16*>(dq), T, S, H, KV,
          causal, 1.0f / sqrtf((float)D), st);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* g,
               const void* lse, const void* delta, void* dk, void* dv, int B,
               int T, int S, int H, int KV, int causal, const Strides& st,
               void* stream) {
  constexpr int smem = DkvSmem<D>::TOTAL;
  static bool done = false;
  cudaError_t e = allow_smem(flash_bwd_dkv_kernel<D>, smem, &done);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((S + BKV - 1) / BKV, KV, B);
  flash_bwd_dkv_kernel<D>
      <<<grid, NW * 32, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), static_cast<const bf16*>(g),
          static_cast<const float*>(lse), static_cast<const float*>(delta),
          static_cast<bf16*>(dk), static_cast<bf16*>(dv), T, S, H, KV,
          causal, 1.0f / sqrtf((float)D), st);
  return (int)cudaGetLastError();
}

bool shape_ok(int B, int T, int S, int H, int KV) {
  if (B < 1 || T < 1 || S < 1 || KV < 1 || H % KV != 0) return false;
  const int grp = H / KV;
  return grp == 1 || grp == 2 || grp == 4 || grp == 8;
}

Strides to_strides(const long long* p) {
  Strides st;
  for (int i = 0; i < 18; ++i) st.s[i] = p[i];
  return st;
}

}  // namespace

extern "C" {

// q, o, g, dq (B, T, H, d); k, v (B, S, KV, d); bf16, last dim contiguous,
// strides multiples of 8 elements, 16-byte aligned bases. lse, delta
// (B, H, T) f32 contiguous: lse from the forward; delta is written with
// D = rowsum(g ⊙ o) for the dk/dv pass. strides: 18 element strides
// (q, k, v, o, g, dq: batch, row, head each).
int flash_attention_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                const void* o, const void* g, const void* lse,
                                void* delta, void* dq, int B, int T, int S,
                                int H, int KV, int d, int causal,
                                const long long* strides, void* stream) {
  if (!shape_ok(B, T, S, H, KV)) return (int)cudaErrorInvalidValue;
  if (d == 64)
    return launch_dq<64>(q, k, v, o, g, lse, delta, dq, B, T, S, H, KV,
                         causal, to_strides(strides), stream);
  if (d == 128)
    return launch_dq<128>(q, k, v, o, g, lse, delta, dq, B, T, S, H, KV,
                          causal, to_strides(strides), stream);
  return (int)cudaErrorInvalidValue;
}

// dk, dv (B, S, KV, d) bf16, the GQA group summed in f32. strides: 18
// element strides (q, k, v, g, dk, dv: batch, row, head each).
int flash_attention_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                                 const void* g, const void* lse,
                                 const void* delta, void* dk, void* dv, int B,
                                 int T, int S, int H, int KV, int d,
                                 int causal, const long long* strides,
                                 void* stream) {
  if (!shape_ok(B, T, S, H, KV)) return (int)cudaErrorInvalidValue;
  if (d == 64)
    return launch_dkv<64>(q, k, v, g, lse, delta, dk, dv, B, T, S, H, KV,
                          causal, to_strides(strides), stream);
  if (d == 128)
    return launch_dkv<128>(q, k, v, g, lse, delta, dk, dv, B, T, S, H, KV,
                           causal, to_strides(strides), stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
