// Attention forward kernel for Hopper (sm_90a); the backward pair is in
// flash_attention_bwd.cu, and the dense-cache decode kernel (K4) is the
// paged kernel's dense instantiation in paged_attention.cu.
//
// flash_attention_bf16 replaces the Pallas TPU kernels
//   src/repro/kernels/flash_attention.py::flash_attention (_kernel,
//   with_stats=False): online-softmax attention for prefill, and
//   src/repro/kernels/flash_attention.py::flash_attention_fwd (_kernel,
//   with_stats=True): the same kernel also writing the per-row
//   log-sum-exp lse = m + log(l) (B, H, T) f32 when given an lse pointer —
//   the one residual the training backward rebuilds p from.
//
// What bounds it on an H100: 4·d flops per (query, key) pair against one
// read of q, k, v and one write of o (and lse). At the training shape
// (B = 4, T = S = 1024, H = KV = 32, d = 64, causal) that is 17.2 GFLOP
// against 67 MB: 0.017 ms of tensor-core time against 0.020 ms of bytes,
// so only `wgmma` at a good share of its rate, with q/k/v read once and
// no (T, S) tensor in device memory, gets near the bound. Prefill
// (T = S ≤ ~300 a request) is far smaller and bound by latency; it shares
// the kernel.
//
// The forward's design (the recipe of flash_attention_bwd.cu):
//  - one warpgroup owns 64 query rows, its q tile resident in shared
//    memory in the 128-byte swizzled layout; a block holds one warpgroup
//    (several blocks an SM) or two (128 rows sharing each K/V tile), the
//    launcher's choice (at d = 256 one: its q tile and three stages of K
//    and V take 224 KB of the 227 a block may have);
//  - S = Q·Kᵀ is a `wgmma` m64n64k16 product with both operands in shared
//    memory, K read K-major from the tile that arrived;
//  - the online softmax runs on the f32 accumulator registers: a row's
//    values sit in the 4 lanes of a quad, so its max takes two shfl.xor
//    and its sum is kept a lane and reduced once at the end;
//  - p is rounded to bf16 in registers in the accumulator layout, which is
//    the A-operand layout of O += P·V, a `wgmma` with V read MN-major
//    (transposed) from the same tile;
//  - O stays in f32 registers for the whole KV loop (d/2 a thread), where
//    the correction factor is applied; at d = 256 that is 128 registers
//    a thread beside S's 32 and P's 16 (m64n256k16 for P·V), so the block
//    is bounded for one resident block an SM (255 registers a thread);
//  - K/V tiles of 64 keys stream through a three-stage cp.async ring that
//    zero-fills keys ≥ S; each thread fences (fence.proxy.async) before
//    the barrier that precedes the products, and a tile's P·V is waited
//    for only after the next tile's S product is issued;
//  - under causal masking the tiles above the diagonal are skipped (per
//    warpgroup), only the diagonal and the S edge are masked, and the
//    longest query tiles launch first;
//  - head_dim 112 (kimi-k2, 7168 / 64) runs the d = 128 instance padded
//    in shared memory (template DR = 112): each row is read as 14 chunks
//    of 16 bytes, chunks 14-15 of the 128-wide swizzled tile are
//    zero-filled, so Q·Kᵀ and P·V run unchanged on the d = 128 tiles
//    (the zero columns add exact zeros to S, and O's columns 112-127 are
//    never stored); the scale is 112^-0.5, the operands in device memory
//    stay 112 wide. 16/128 of the tensor-core work is padding, which a
//    prefill bound by latency and a training forward at a fraction of
//    the peak do not feel first.
// Numerics follow the TPU kernels: scores in f32 scaled by 1/sqrt(d)
// (carried in log2 units, so exp is one ex2), masked entries at -1e30 and
// their p at 0, l summed from the f32 p, p rounded to v's dtype (bf16)
// before P·V, l floored at 1e-30 (an empty row yields 0, never NaN),
// output rounded once to bf16; lse = m + log(l) from the same floored l.
//
// The C functions return cudaGetLastError() of the launch.

#include <math.h>

#include "attention_f32.cuh"
#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr float NEG = -1e30f;

// ---------------------------------------------------------------- forward

constexpr int FWD_BN = 64;       // keys per streamed tile
constexpr int FWD_STAGES = 3;    // depth of the K/V ring

// 12 element strides: batch, row, head of q, k, v and o
struct FwdStrides {
  long long s[12];
};

template <int D, int NWG>
struct FwdSmem {
  static constexpr int BM = 64 * NWG;          // query rows a block
  static constexpr int RES = BM * D * 2;       // resident q
  static constexpr int STR = FWD_BN * D * 2;   // a streamed k or v tile
  static constexpr int Q = 0;
  static constexpr int K = Q + RES;            // FWD_STAGES k tiles
  static constexpr int V = K + FWD_STAGES * STR;
  static constexpr int TOTAL = V + FWD_STAGES * STR;
  static_assert(RES % 1024 == 0 && STR % 1024 == 0,
                "tiles must keep the 1024-byte alignment of the swizzle");
  static_assert(TOTAL + 1024 <= 227 * 1024,
                "q and the ring (+ the alignment slack) fit in a block");
};

template <int D, int NWG>
constexpr int fwd_min_blocks() {   // blocks an SM the registers allow
  return D == 256 ? 1 : NWG == 1 ? (D == 64 ? 3 : 2) : (D == 64 ? 2 : 1);
}

// DR: the operands' head_dim; D: the tile width, DR padded to the next
// multiple of 64 (kimi-k2's 112 runs as 128, its columns past 112 zero in
// shared memory and never stored)
template <int D, int NWG, int DR = D>
__global__ void __launch_bounds__(NWG * 128, (fwd_min_blocks<D, NWG>()))
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 float* __restrict__ lse, int T, int S, int H, int KV,
                 int causal, float scale, const FwdStrides sd) {
  using L = FwdSmem<D, NWG>;
  constexpr int NT = NWG * 128, BM = L::BM, BN = FWD_BN;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;

  const int tid = threadIdx.x, wg = tid >> 7;
  const int h = blockIdx.x, bb = blockIdx.y;
  const int nqt = (T + BM - 1) / BM;   // longest tiles first under causal
  const int q0 = (causal ? nqt - 1 - (int)blockIdx.z : (int)blockIdx.z) * BM;
  const int kvh = h / (H / KV);
  const bf16* qb = q + bb * sd.s[0] + h * sd.s[2];
  const bf16* kb = k + bb * sd.s[3] + kvh * sd.s[5];
  const bf16* vb = v + bb * sd.s[6] + kvh * sd.s[8];

  // the block's key tiles, and this warpgroup's (64 rows from qw on)
  const int qw = q0 + 64 * wg;
  const int nkv = ((causal ? min(S, q0 + BM) : S) + BN - 1) / BN;
  const int nkv_wg =
      causal ? min(nkv, (min(S, qw + 64) + BN - 1) / BN) : nkv;

  load_tile<BM, D, NT, DR>(base + L::Q, qb, sd.s[1], q0, T, tid);
  auto issue = [&](int j) {
    const int st = j % FWD_STAGES;
    load_tile<BN, D, NT, DR>(base + L::K + st * L::STR, kb, sd.s[4], j * BN,
                             S, tid);
    load_tile<BN, D, NT, DR>(base + L::V + st * L::STR, vb, sd.s[7], j * BN,
                             S, tid);
  };
  issue(0);
  cp_async_commit();

  // this thread's accumulator rows qa and qa + 8
  const int lane = tid & 31, warp = (tid >> 5) & 3;
  const int ra = warp * 16 + (lane >> 2), ca = 2 * (lane & 3);
  const int qa = qw + ra;
  const float sl2 = scale * LOG2E;   // scores in log2 units
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  float oacc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;

  for (int j = 0; j < nkv; ++j) {
    const int st = j % FWD_STAGES;
    cp_async_wait<0>();   // tile j (and, at j = 0, q) has landed
    fence_proxy_async();
    __syncthreads();      // ... for every thread; every warpgroup has
                          // waited for its P·V of tile j - 2
    if (j + 1 < nkv) issue(j + 1);   // into the stage of tile j - 2
    cp_async_commit();
    if (j >= nkv_wg) {    // above this warpgroup's diagonal
      wg_wait<0>();
      continue;
    }
    const int k0 = j * BN;
    const uint32_t kt = base + L::K + st * L::STR;
    const uint32_t vt = base + L::V + st * L::STR;
    float s[BN / 2];
    reg_fence(s);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)   // S = Q·Kᵀ
      WgSS<BN>::mma(s, desc_k<BM>(base + L::Q, 64 * wg, kk),
                    desc_k<BN>(kt, 0, kk), kk);
    wg_commit();
    wg_wait<0>();   // S, and the previous tile's P·V, are done
    reg_fence(s);
    reg_fence(oacc);

    const bool edge = k0 + BN > S || (causal && k0 + BN - 1 > qw);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int c = 0; c < BN / 8; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[4 * c + e] * sl2;
        if (edge) {
          const int ki = k0 + 8 * c + ca + (e & 1), qi = qa + 8 * (e >> 1);
          if (!(ki < S && (!causal || qi >= ki))) x = NEG;
        }
        s[4 * c + e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {   // the row's max over its quad
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = ex2(m[r] - mx[r]);
      m[r] = mx[r];
    }
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const int r = (i >> 1) & 1;
      float p = ex2(s[i] - m[r]);
      if (edge && s[i] == NEG) p = 0.f;
      s[i] = p;
      rs[r] += p;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + rs[r];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) oacc[i] *= corr[(i >> 1) & 1];
    uint32_t pa[BN / 16][4];
    to_a<BN>(pa, s);
    reg_fence(pa);
    reg_fence(oacc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)   // O += P·V
      WgRS<D>::mma(oacc, pa[kk], desc_mn<BN>(vt, kk));
    wg_commit();   // waited for after the next tile's S product
  }
  cp_async_wait<0>();
  wg_wait<0>();
  reg_fence(oacc);

  bf16* ob = o + bb * sd.s[9] + h * sd.s[11];
#pragma unroll
  for (int r = 0; r < 2; ++r) {   // l: each lane kept its columns' share
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
    const int qi = qa + 8 * r;
    if (qi < T) {
      const float inv = 1.f / l[r];
#pragma unroll
      for (int c = 0; c < DR / 8; ++c)   // the DR real columns only
        *reinterpret_cast<__nv_bfloat162*>(ob + qi * sd.s[10] + 8 * c +
                                           ca) =
            __floats2bfloat162_rn(oacc[4 * c + 2 * r] * inv,
                                  oacc[4 * c + 2 * r + 1] * inv);
      if (lse != nullptr && (lane & 3) == 0)
        lse[(static_cast<size_t>(bb) * H + h) * T + qi] =
            m[r] / LOG2E + logf(l[r]);
    }
  }
}

template <int D, int NWG, int DR = D>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               void* lse, int B, int T, int S, int H, int KV, int causal,
               const long long* st, void* stream) {
  using L = FwdSmem<D, NWG>;
  constexpr int smem = L::TOTAL + 1024;   // + the alignment slack
  static bool done = false;
  cudaError_t e = allow_smem(flash_fwd_kernel<D, NWG, DR>, smem, &done);
  if (e != cudaSuccess) return (int)e;
  FwdStrides sd;
  for (int i = 0; i < 12; ++i) sd.s[i] = st[i];
  dim3 grid(H, B, (T + L::BM - 1) / L::BM);
  flash_fwd_kernel<D, NWG, DR>
      <<<grid, NWG * 128, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), static_cast<bf16*>(o),
          static_cast<float*>(lse), T, S, H, KV, causal,
          1.0f / sqrtf((float)DR), sd);   // the real head_dim's scale
  return (int)cudaGetLastError();
}

// ------------------------------------------------ forward in f32 (FFMA)
//
// flash_attention_f32: the f32 instance of the same two TPU kernels (K3,
// and #5 with lse) for RoBERTa's f32 training and its no-grad forward. It
// computes in f32 (attention_f32.cuh: FFMA, no tensor-core rounding): the
// scores, p and P·V all f32, p never rounded. A block owns 64 query rows
// of one head (256 threads), its q tile resident; 64-key tiles of k and v
// are copied in turn, S = Q·Kᵀ (4 x 4 scores a thread), the online softmax
// on those registers (a row's 16 lanes reduce by shfl.xor), p written to a
// score tile, and O += P·V (4 x D/16 a thread) kept in registers across
// the key loop. Numerics as the bf16 kernel: scores scaled by 1/sqrt(d) in
// log2 units, masked p at 0, l floored at 1e-30, lse = m + log(l). At the
// training shape (B = 4, T = S = 1024, H = KV = 16, d = 64, causal) that
// is 8.6 GFLOP: 0.13 ms at FFMA's 67 TFLOP/s.

namespace af = attn_f32;

template <int D>
struct F32FwdSmem {
  static constexpr int Q = 0;
  static constexpr int K = Q + attn_f32::tile_floats<D>();
  static constexpr int V = K + attn_f32::tile_floats<D>();
  static constexpr int P = V + attn_f32::tile_floats<D>();
  static constexpr int BYTES = 4 * (P + attn_f32::score_floats());
};

template <int D>
__global__ void __launch_bounds__(attn_f32::THREADS)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int T, int S, int H, int KV,
                     int causal, float scale, const FwdStrides sd) {
  using L = F32FwdSmem<D>;
  extern __shared__ __align__(16) float smf[];
  float *qs = smf + L::Q, *ks = smf + L::K, *vs = smf + L::V,
        *ps = smf + L::P;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int h = blockIdx.x, bb = blockIdx.y;
  const int nqt = (T + af::ROWS - 1) / af::ROWS;   // longest first (causal)
  const int q0 =
      (causal ? nqt - 1 - (int)blockIdx.z : (int)blockIdx.z) * af::ROWS;
  const int kvh = h / (H / KV);
  const float* qb = q + bb * sd.s[0] + h * sd.s[2];
  const float* kb = k + bb * sd.s[3] + kvh * sd.s[5];
  const float* vb = v + bb * sd.s[6] + kvh * sd.s[8];
  const int nkv =
      ((causal ? min(S, q0 + af::ROWS) : S) + af::ROWS - 1) / af::ROWS;
  const float sl2 = scale * LOG2E;

  af::load_tile<D>(qs, qb, sd.s[1], q0, T);
  float m[4], l[4], oacc[4][D / 16];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = af::NEG;
    l[a] = 0.f;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) oacc[a][c] = 0.f;
  }
  for (int j = 0; j < nkv; ++j) {
    const int k0 = j * af::ROWS;
    __syncthreads();   // the previous tile's k, v and p are consumed
    af::load_tile<D>(ks, kb, sd.s[4], k0, S);
    af::load_tile<D>(vs, vb, sd.s[7], k0, S);
    __syncthreads();
    float sc[4][4] = {};
    af::dot_nt<D>(sc, qs, ks, tx, ty);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int qi = q0 + ty * 4 + a;
      float mt = af::NEG;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int kj = k0 + tx + 16 * b;
        const bool ok = kj < S && !(causal && kj > qi);
        sc[a][b] = ok ? sc[a][b] * sl2 : af::NEG;
        mt = fmaxf(mt, sc[a][b]);
      }
      const float mn = fmaxf(m[a], af::row_max(mt));
      const float corr = exp2f(m[a] - mn);
      float rs = 0.f;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        sc[a][b] = sc[a][b] == af::NEG ? 0.f : exp2f(sc[a][b] - mn);
        rs += sc[a][b];
      }
      m[a] = mn;
      l[a] = l[a] * corr + rs;
#pragma unroll
      for (int c = 0; c < D / 16; ++c) oacc[a][c] *= corr;
    }
    af::store_scores(ps, sc, tx, ty);
    __syncthreads();
    af::dot_nn<D>(oacc, ps, vs, tx, ty);
  }

  float* ob = o + bb * sd.s[9] + h * sd.s[11];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const float lt = fmaxf(af::row_sum(l[a]), 1e-30f);
    const int qi = q0 + ty * 4 + a;
    if (qi >= T) continue;
    const float inv = 1.f / lt;
#pragma unroll
    for (int g = 0; g < D / 64; ++g)
      *reinterpret_cast<float4*>(ob + qi * sd.s[10] + g * 64 + tx * 4) =
          make_float4(oacc[a][g * 4] * inv, oacc[a][g * 4 + 1] * inv,
                      oacc[a][g * 4 + 2] * inv, oacc[a][g * 4 + 3] * inv);
    if (lse != nullptr && tx == 0)
      lse[(static_cast<size_t>(bb) * H + h) * T + qi] =
          m[a] / LOG2E + logf(lt);
  }
}

template <int D>
int launch_fwd_f32(const void* q, const void* k, const void* v, void* o,
                   void* lse, int B, int T, int S, int H, int KV, int causal,
                   const long long* st, void* stream) {
  constexpr int smem = F32FwdSmem<D>::BYTES;
  cudaError_t e = attn_f32::allow_smem(flash_fwd_f32_kernel<D>, smem);
  if (e != cudaSuccess) return (int)e;
  FwdStrides sd;
  for (int i = 0; i < 12; ++i) sd.s[i] = st[i];
  dim3 grid(H, B, (T + attn_f32::ROWS - 1) / attn_f32::ROWS);
  flash_fwd_f32_kernel<D>
      <<<grid, attn_f32::THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(q), static_cast<const float*>(k),
          static_cast<const float*>(v), static_cast<float*>(o),
          static_cast<float*>(lse), T, S, H, KV, causal,
          1.0f / sqrtf((float)D), sd);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B, T, H, d), k/v (B, S, KV, d), o (B, T, H, d), bf16, last dim
// contiguous. strides: 12 element strides (q: b, t, h; k: b, s, kv;
// v: b, s, kv; o: b, t, h), each a multiple of 8 with 16-byte aligned
// bases. Causal masks ki > qi. lse: nullptr (prefill), or (B, H, T) f32
// contiguous, written with the per-row log-sum-exp (the training
// forward). d in {64, 112, 128, 256} (112 on the d = 128 tiles, padded
// in shared memory). variant: 1 one warpgroup a block, 2 two warpgroups a
// block (the wrapper chooses; kernels/flash_attention.py); d = 256 takes
// variant 1 only (shared memory).
int flash_attention_bf16(const void* q, const void* k, const void* v,
                         void* o, void* lse, int B, int T, int S, int H,
                         int KV, int d, int causal, int variant,
                         const long long* strides, void* stream) {
  if (B < 1 || T < 1 || S < 1 || KV < 1 || H % KV != 0 || B > 65535 ||
      (T + 63) / 64 > 65535 ||
      (d != 64 && d != 112 && d != 128 && d != 256))
    return (int)cudaErrorInvalidValue;
  switch (variant * 1000 + d) {
    case 1064: return launch_fwd<64, 1>(q, k, v, o, lse, B, T, S, H, KV,
                                        causal, strides, stream);
    case 1112: return launch_fwd<128, 1, 112>(q, k, v, o, lse, B, T, S, H,
                                              KV, causal, strides, stream);
    case 1128: return launch_fwd<128, 1>(q, k, v, o, lse, B, T, S, H, KV,
                                         causal, strides, stream);
    case 1256: return launch_fwd<256, 1>(q, k, v, o, lse, B, T, S, H, KV,
                                         causal, strides, stream);
    case 2064: return launch_fwd<64, 2>(q, k, v, o, lse, B, T, S, H, KV,
                                        causal, strides, stream);
    case 2112: return launch_fwd<128, 2, 112>(q, k, v, o, lse, B, T, S, H,
                                              KV, causal, strides, stream);
    case 2128: return launch_fwd<128, 2>(q, k, v, o, lse, B, T, S, H, KV,
                                         causal, strides, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The f32 instance: the same arguments in f32 (q, k, v, o; lse f32 as
// above), strides multiples of 4 elements, 16-byte aligned bases; d = 64.
int flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                        void* lse, int B, int T, int S, int H, int KV, int d,
                        int causal, const long long* strides, void* stream) {
  if (B < 1 || T < 1 || S < 1 || KV < 1 || H % KV != 0 || B > 65535 ||
      (T + 63) / 64 > 65535 || d != 64)
    return (int)cudaErrorInvalidValue;
  return launch_fwd_f32<64>(q, k, v, o, lse, B, T, S, H, KV, causal, strides,
                            stream);
}

}  // extern "C"
