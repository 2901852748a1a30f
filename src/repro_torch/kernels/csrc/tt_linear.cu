// Fused adapted linear for Hopper (sm_90a): y = x·W + alpha·(x·A)·B.
//
// Replaces the Pallas TPU kernels in src/repro/kernels/tt_linear.py:
//   tt_linear               (_kernel + _epilogue_out) -> tt_linear_bf16
//   tt_linear_batched_a     (_batched_a_kernel)       -> tt_linear_batched_a_bf16
//   tt_linear_w8            (_kernel, int8 W)         -> tt_linear_w8_bf16
//   tt_linear_batched_a_w8  (_batched_a_kernel, int8) -> tt_linear_batched_a_w8_bf16
// and, in f32 (FFMA, below): tt_linear -> tt_linear_f32,
// tt_linear_batched_a -> tt_linear_batched_a_f32, tt_linear_w8 ->
// tt_linear_w8_f32, tt_linear_batched_a_w8 -> tt_linear_batched_a_w8_f32.
//
// What bounds it on an H100: at the serving shapes (M = 4..256 rows,
// K = N = 2048) the work is 2·M·K·N flops against K·N·2 bytes of W, i.e.
// M flops per byte — below the card's ~295 flops/byte balance point for
// every M the engine sends, so the serving calls are bound by reading W;
// the training calls (M = 4096) are bound by the tensor cores. Two
// `wgmma` kernels cover every call:
//   * K1 (one A, any M): tt_linear_wgmma_kernel, 128 x 128 output tiles
//     (the "K1 on `wgmma`" section);
//   * K2, #9 and #10 (M ≤ 256 prefill rows, M ≤ 64 decode slots):
//     tt_linear_splitk_kernel, 64 x 64 output tiles over up to eight
//     slices of K, one thread-block cluster a tile (the "#9, #10 and K2
//     on the split-K `wgmma` kernel" section).
// The TPU kernels keep P = x·A whole in a (bm, r) f32 scratch, at any
// rank. Here ranks up to RANK_WGMMA keep P in registers; every larger
// rank runs a pre-pass that writes alpha·P as a bf16 pair hi + lo into an
// (M, 2·rp) workspace in device memory, and the main kernel extends its
// K loop over [hi | lo]·[B; B] on the tensor cores — so no rank is
// bounded by shared memory or registers, only by the workspace. Both
// kernels take operands that allow 16-byte copies (K % 8 == 0, N % 8 ==
// 0, int8 W: N % 16 == 0, aligned bases); the wrappers
// (kernels/tt_linear.py) copy ragged or unaligned operands into
// zero-padded aligned buffers first, and K1 also reads strided W, A and
// B eight elements at a time.
//
// The C functions take device pointers and the CUDA stream as opaque
// pointers and return cudaGetLastError() of the launch.

#include <cooperative_groups.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace hopper;

// ------------------------------------------------- K1 on `wgmma`
//
// y = x·W + alpha·(x·A)·B for ranks up to RANK_WGMMA, the training
// forward and dx and the serving prefill. A block owns a 128 x 128 output
// tile: two warpgroups of 64 rows, each a `wgmma` m64n128k16 from
// 128-byte swizzled tiles of x (K-major) and W — MN-major when W is
// (K, N) row-major (the forward), K-major when it is a transposed view
// (dx reads W through its strides as Wᵀ: no copy exists). In the same K
// loop a second `wgmma` m64nRPk16 sums P = x·A from the same x tile into
// a small f32 register accumulator (r padded to RP = 16 or 64). x, W and
// A tiles of 64 K columns come through a three-stage cp.async ring; a
// tile's products are waited for before the barrier after which its
// stage is refilled, so two tiles are in flight while one is consumed,
// and two blocks share an SM at RP = 16. Operands that cannot take
// 16-byte copies (ragged or odd strides, a row-major A) are read eight
// elements at a time, in a separate instantiation: the all-vector one
// carries no such code and fits 128 registers a thread. The model builds
// A K-contiguous (peft/api.py), as Bᵀ in dx already is. Epilogue: P goes
// through a small shared-memory tile,
// B's (RP, 128) tile was loaded once a block, and each thread adds
// alpha·P·B to its accumulators in f32 — P is never rounded to bf16 —
// then rounds once to bf16 on the store. Ragged M / N / K are zero-filled
// on load and masked on the store.

// Ranks above RANK_WGMMA (VeRA's 1024 in the paper's Table 1, and any
// larger) cannot keep P in registers or shared memory: a (128, 1024) f32 P is
// 512 KB. The TPU kernel keeps it whole in a (bm, r) f32 scratch. Here a
// pre-pass (MODE K1_PRE: the same kernel with A in W's place, N = r)
// writes alpha·P = alpha·x·A as a bf16 pair hi + lo, hi = bf16(alpha·P),
// lo = bf16(alpha·P - hi), into PL (M, 2·rp) (rp = r rounded up to 64,
// columns r .. rp zero), so P keeps about 16 bits and is never cut to
// one bf16. The main kernel (MODE K1_EXT) runs the base K loop, then
// extends it over 2·rp / 64 more tiles: x tiles from PL's hi and lo
// halves, W tiles from B's rows (each B row twice), so alpha·P·B is summed
// on the tensor cores into the same f32 accumulator as x·W — the rank
// term costs 2·M·2r·N flops at `wgmma` rate and no shared-memory P. B's
// tiles are MN-major whatever W's layout. The main kernel is the
// pre-pass's programmatic dependent: its base loop runs while the
// pre-pass does, and it waits for PL (griddepcontrol.wait) before its
// first extension tile. The base product is launched once.

constexpr int LBM = 128, LBN = 128, LBK = 64;   // output tile, K tile
constexpr int LSTAGES = 3;                      // depth of the ring
constexpr int LNT = 256;                        // two warpgroups
constexpr int RANK_WGMMA = 64;   // P in registers; larger ranks: pre-pass
constexpr int LV_X = 1, LV_W = 2, LV_A = 4, LV_B = 8;   // 16-byte copies
// the modes of the `wgmma` kernel: x·W + alpha·(x·A)·B with P in
// registers (RP = 16 or 64); the pre-pass (PL = alpha·x·W as hi + lo);
// x·W summed on over the extension tiles [hi | lo] · [B; B]
constexpr int K1_PLAIN = 0, K1_PRE = 1, K1_EXT = 2;

// element strides: W (k, n), A (k, j), B (j, n)
struct LinStrides {
  long long s[6];
};

template <int RP>
struct LinSmem {
  static constexpr int XS = LBM * LBK * 2;    // an x tile
  static constexpr int WS = LBK * LBN * 2;    // a W tile
  static constexpr int AS = RP * LBK * 2;     // an A tile (rows j, K-major)
  static constexpr int X = 0;
  static constexpr int W = X + LSTAGES * XS;
  static constexpr int A = W + LSTAGES * WS;
  static constexpr int B = A + LSTAGES * AS;  // B's tile, bf16, once
  static constexpr int TOTAL = B + RP * LBN * 2;
  static constexpr int PS = RP + 4;           // f32 row of the staged P
  static constexpr int ACH = RP * LBK / 8;    // 16-byte chunks of A
  static constexpr int APER = (ACH + LNT - 1) / LNT;   // a thread's
  static_assert(AS % 1024 == 0,
                "tiles must keep the 1024-byte alignment of the swizzle");
  static_assert(LBM * PS * 4 <= LSTAGES * XS,
                "P is staged where the x ring was");
};

__device__ __forceinline__ uint32_t elem2(const bf16* p, long long o0,
                                          long long o1, bool ok0,
                                          bool ok1) {
  const uint32_t lo = ok0 ? __bfloat16_as_ushort(p[o0]) : 0u;
  const uint32_t hi = ok1 ? __bfloat16_as_ushort(p[o1]) : 0u;
  return lo | (hi << 16);
}

// an R-row swizzled tile of C bf16 columns from an operand read through
// strides: element (row, col) at src[row·rs + col·cs]; rows ≥ nr and
// columns ≥ nc are zero. vec: 16-byte cp.async (cs = 1, nc a multiple of
// 8, aligned rows); else eight loads a chunk and one 16-byte store.
template <int R, int C>
__device__ __forceinline__ void load_strided(uint32_t tile, const bf16* src,
                                             long long rs, long long cs,
                                             int nr, int nc, bool vec,
                                             int tid) {
  constexpr int CPR = C / 8;
  static_assert(R * CPR % LNT == 0, "whole rounds of 16-byte chunks");
#pragma unroll
  for (int i = 0; i < R * CPR / LNT; ++i) {
    const int c = tid + i * LNT;
    const int row = c / CPR, ch = c % CPR, col = ch * 8;
    const uint32_t dst = tile + (ch / 8) * R * 128 + row * 128 +
                         (((ch % 8) ^ (row % 8)) << 4);
    if (vec) {
      const bool ok = row < nr && col < nc;
      cp_async16(dst, ok ? src + row * rs + col : src, ok ? 16 : 0);
    } else {
      uint32_t u[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c0 = col + 2 * e;
        u[e] = elem2(src, row * rs + c0 * cs, row * rs + (c0 + 1) * cs,
                     row < nr && c0 < nc, row < nr && c0 + 1 < nc);
      }
      st_shared16(dst, u);
    }
  }
}

template <int RP, bool WK, bool VEC, int MODE>
__global__ void __launch_bounds__(LNT, RP <= 16 ? 2 : 1)
tt_linear_wgmma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                       const bf16* __restrict__ a, const bf16* __restrict__ b,
                       bf16* __restrict__ y, int M, int N, int K, int r,
                       float alpha, const LinStrides ls, int vec,
                       const bf16* __restrict__ pl, int rp) {
  // K1_PRE and K1_EXT carry no P in the K loop (RP = 0)
  static_assert(MODE == K1_PLAIN ? RP > 0 : RP == 0, "P only in K1_PLAIN");
  if constexpr (MODE == K1_PRE)   // the main kernel may start: its base
    asm volatile("griddepcontrol.launch_dependents;\n" ::);   // loop
  using L = LinSmem<RP>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);

  const int tid = threadIdx.x, wg = tid >> 7;
  const int n0 = blockIdx.x * LBN, m0 = blockIdx.y * LBM;
  // VEC: every operand takes 16-byte copies, and no other load path is
  // compiled in (it would cost the registers of two blocks an SM)
  const bool vx = VEC || (vec & LV_X), vw = VEC || (vec & LV_W),
             va = VEC || (vec & LV_A), vb = VEC || (vec & LV_B);
  const long long wsk = ls.s[0], wsn = ls.s[1], ask = ls.s[2],
                  asj = ls.s[3];

  // B's (RP, 128) tile for the epilogue, once a block; rows ≥ r and
  // columns ≥ N zero
  bf16* bs = reinterpret_cast<bf16*>(smem + L::B);
  for (int i = tid; i < RP * LBN; i += LNT) {   // RP = 0: no B tile
    const int j = i / LBN, c = i % LBN;
    bs[i] = (j < r && n0 + c < N) ? b[j * ls.s[4] + (n0 + c) * ls.s[5]]
                                  : __float2bfloat16(0.f);
  }

  // A's tile (rows j < RP, 64 K columns, K-major): 16-byte copies when
  // A's K stride is 1 (the model's factors, and Bᵀ in dx), else eight
  // loads a chunk
  auto put_a = [&](int kt) {
    const uint32_t tile = base + L::A + (kt % LSTAGES) * L::AS;
#pragma unroll
    for (int i = 0; i < L::APER; ++i) {
      const int c = tid + i * LNT, j = c / 8, ch = c % 8;
      if (c >= L::ACH) break;
      const uint32_t dst = tile + j * 128 + ((ch ^ (j % 8)) << 4);
      const int k = kt * LBK + ch * 8;
      if (va) {
        const bool ok = j < r && k < K;
        cp_async16(dst, ok ? a + j * asj + k : a, ok ? 16 : 0);
      } else {
        uint32_t u[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          u[e] = elem2(a, (k + 2 * e) * ask + j * asj,
                       (k + 2 * e + 1) * ask + j * asj,
                       j < r && k + 2 * e < K, j < r && k + 2 * e + 1 < K);
        st_shared16(dst, u);
      }
    }
  };
  const int nk = (K + LBK - 1) / LBK;
  // K1_EXT: tiles nk .. nt - 1 are the extension, PL's hi then lo half
  // against B's rows j0 .. j0 + 63
  const int nt = MODE == K1_EXT ? nk + 2 * (rp / LBK) : nk;
  auto issue_xw = [&](int kt) {
    const int st = kt % LSTAGES, k0 = kt * LBK;
    if (MODE == K1_EXT && kt >= nk) {
      if (kt == nk)   // PL is the pre-pass's: wait for it to be complete
        asm volatile("griddepcontrol.wait;\n" ::: "memory");
      const int e = (kt - nk) * LBK, j0 = e % rp;
      load_strided<LBM, LBK>(base + L::X + st * L::XS,
                             pl + static_cast<long long>(m0) * 2 * rp + e,
                             2 * rp, 1, M - m0, LBK, true, tid);
      load_strided<LBK, LBN>(base + L::W + st * L::WS,
                             b + j0 * ls.s[4] + n0 * ls.s[5], ls.s[4],
                             ls.s[5], max(r - j0, 0), N - n0, vb, tid);
      return;
    }
    load_strided<LBM, LBK>(base + L::X + st * L::XS,
                           x + static_cast<long long>(m0) * K + k0, K, 1,
                           M - m0, K - k0, vx, tid);
    if (WK)
      load_strided<LBN, LBK>(base + L::W + st * L::WS,
                             w + n0 * wsn + k0 * wsk, wsn, wsk, N - n0,
                             K - k0, vw, tid);
    else
      load_strided<LBK, LBN>(base + L::W + st * L::WS,
                             w + k0 * wsk + n0 * wsn, wsk, wsn, K - k0,
                             N - n0, vw, tid);
  };

#pragma unroll
  for (int kt = 0; kt < LSTAGES - 1; ++kt) {
    if (kt < nt) {
      issue_xw(kt);
      if (MODE == K1_PLAIN) put_a(kt);
    }
    cp_async_commit();
  }

  const int lane = tid & 31, warp = (tid >> 5) & 3;
  const int ra = 64 * wg + warp * 16 + (lane >> 2), ca = 2 * (lane & 3);
  const bool live = m0 + 64 * wg < M;   // this warpgroup has rows
  float acc[LBN / 2], p[RP > 0 ? RP / 2 : 1];
#pragma unroll
  for (int i = 0; i < LBN / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (RP > 0 ? RP / 2 : 1); ++i) p[i] = 0.f;

  for (int kt = 0; kt < nt; ++kt) {
    const int st = kt % LSTAGES;
    cp_async_wait<LSTAGES - 2>();   // tile kt has landed
    fence_proxy_async();
    __syncthreads();   // ... for every thread; every warpgroup has waited
                       // for its products of tile kt - 1, whose stage
    if (kt + LSTAGES - 1 < nt) {   // now takes tile kt + 2
      issue_xw(kt + LSTAGES - 1);
      if (MODE == K1_PLAIN) put_a(kt + LSTAGES - 1);
    }
    cp_async_commit();
    if (!live) continue;
    const uint32_t xt = base + L::X + st * L::XS;
    const uint32_t wt = base + L::W + st * L::WS;
    const uint32_t at = base + L::A + st * L::AS;
    reg_fence(acc);
    reg_fence(p);
    wg_fence();
    if (WK && MODE == K1_EXT && kt >= nk) {
#pragma unroll   // an extension tile: B's rows are MN-major
      for (int kk = 0; kk < LBK / 16; ++kk)
        WgSS<LBN, 1>::mma(acc, desc_k<LBM>(xt, 64 * wg, kk),
                          desc_mn<LBK>(wt, kk), 1);
    } else {
#pragma unroll
      for (int kk = 0; kk < LBK / 16; ++kk) {
        const uint64_t dx = desc_k<LBM>(xt, 64 * wg, kk);
        WgSS<LBN, WK ? 0 : 1>::mma(
            acc, dx, WK ? desc_k<LBN>(wt, 0, kk) : desc_mn<LBK>(wt, kk), 1);
        if constexpr (MODE == K1_PLAIN)
          WgSS<RP>::mma(p, dx, desc_k<RP>(at, 0, kk), 1);   // P += x·A
      }
    }
    wg_commit();
    wg_wait<0>();
    reg_fence(acc);
    reg_fence(p);
  }
  cp_async_wait<0>();
  if constexpr (MODE == K1_PRE) {
    // PL row gm: hi = bf16(alpha·P) in columns < rp, lo = bf16(alpha·P -
    // hi) in rp + columns; acc is 0 in the columns r .. rp (A's zero
    // fill), which zero PL's padding
    if (!live) return;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int gm = m0 + ra + 8 * hh;
      if (gm >= M) continue;
      bf16* hr = y + static_cast<long long>(gm) * 2 * rp;
#pragma unroll
      for (int c = 0; c < LBN / 8; ++c) {
        const int gn = n0 + 8 * c + ca;
        if (gn >= rp) continue;
        const float v0 = alpha * acc[4 * c + 2 * hh],
                    v1 = alpha * acc[4 * c + 2 * hh + 1];
        const __nv_bfloat162 hi = __floats2bfloat162_rn(v0, v1);
        const float2 hf = __bfloat1622float2(hi);
        *reinterpret_cast<__nv_bfloat162*>(hr + gn) = hi;
        *reinterpret_cast<__nv_bfloat162*>(hr + rp + gn) =
            __floats2bfloat162_rn(v0 - hf.x, v1 - hf.y);
      }
    }
    return;
  }
  __syncthreads();   // the ring is free: stage P where x was

  float* ps = reinterpret_cast<float*>(smem + L::X);
#pragma unroll
  for (int c = 0; c < RP / 8; ++c)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      *reinterpret_cast<float2*>(ps + (ra + 8 * hh) * L::PS + 8 * c + ca) =
          make_float2(p[4 * c + 2 * hh], p[4 * c + 2 * hh + 1]);
  __syncthreads();
  for (int j = 0; j < (MODE == K1_PLAIN ? r : 0); ++j) {
    // acc += alpha·P·B, in f32 (K1_EXT summed it in the K loop)
    const float p0 = alpha * ps[ra * L::PS + j];
    const float p1 = alpha * ps[(ra + 8) * L::PS + j];
    const bf16* brow = bs + j * LBN + ca;
#pragma unroll
    for (int c = 0; c < LBN / 8; ++c) {
      const float2 bv = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(brow + 8 * c));
      acc[4 * c] += p0 * bv.x;
      acc[4 * c + 1] += p0 * bv.y;
      acc[4 * c + 2] += p1 * bv.x;
      acc[4 * c + 3] += p1 * bv.y;
    }
  }

  const bool pairs = (N & 1) == 0;   // bf16x2 stores stay aligned
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int gm = m0 + ra + 8 * hh;
    if (gm >= M) continue;
    bf16* yr = y + static_cast<long long>(gm) * N;
#pragma unroll
    for (int c = 0; c < LBN / 8; ++c) {
      const int gn = n0 + 8 * c + ca;
      const float v0 = acc[4 * c + 2 * hh], v1 = acc[4 * c + 2 * hh + 1];
      if (pairs && gn + 1 < N) {
        *reinterpret_cast<__nv_bfloat162*>(yr + gn) =
            __floats2bfloat162_rn(v0, v1);
      } else {
        if (gn < N) yr[gn] = __float2bfloat16(v0);
        if (gn + 1 < N) yr[gn + 1] = __float2bfloat16(v1);
      }
    }
  }
}

template <int RP, bool WK, bool VEC, int MODE>
int launch_wgmma(const void* x, const void* w, const void* a, const void* b,
                 void* y, int M, int N, int K, int r, float alpha,
                 const LinStrides& ls, int vec, const void* pl, int rp,
                 void* stream) {
  constexpr int smem = LinSmem<RP>::TOTAL + 1024;   // + the alignment slack
  static bool done = false;
  auto kern = tt_linear_wgmma_kernel<RP, WK, VEC, MODE>;
  cudaError_t e = allow_smem(kern, smem, &done);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + LBN - 1) / LBN, (M + LBM - 1) / LBM);
  cfg.blockDim = dim3(LNT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  // K1_EXT: a programmatic dependent of the pre-pass (griddepcontrol)
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = MODE == K1_EXT ? 1 : 0;
  e = cudaLaunchKernelEx(
      &cfg, kern, static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const bf16*>(a), static_cast<const bf16*>(b),
      static_cast<bf16*>(y), M, N, K, r, alpha, ls, vec,
      static_cast<const bf16*>(pl), rp);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// ------------------- #9, #10 and K2 on the split-K `wgmma` kernel
//
// y = x·(q·s) + alpha·(x·A)·B over an int8 W (K, N) with f32 scales
// (G, N) — #9, and #10 with a per-row A — and over a bf16 W with a
// per-row A — K2 — at every rank, on operands that take 16-byte copies
// (K % 8 == 0, N % 16 == 0 for int8 W and N % 8 == 0 for bf16 W, aligned
// bases; the wrappers pad and copy the others). At the serving shapes
// (M ≤ 256 prefill rows, M ≤ 64 decode slots, K = N = 2048) the work is
// M flops a byte of W, far below the card's balance point: the kernel is
// bound by reading the 4 MB of int8 W (8 MB of bf16 W) once, and at
// M = 64 a 64 x 64 output tiling has only 32 tiles for 132 SMs. So:
//  - a block (one warpgroup) owns 64 rows x 64 output channels over one
//    of S slices of K (split-K, the launcher's choice, see w8_splits in
//    kernels/tt_linear.py): 32 channel tiles x 8 slices put 256 blocks on
//    the card at M = 64, each streaming a 64 x 256 strip of W;
//  - x, W and (#9) A tiles of 64 K columns come through a four-stage
//    cp.async ring: three of a slice's four tiles are in flight at once;
//  - bf16 W (K2): a row of 64 channels is eight 16-byte chunks, one
//    swizzle row, so each copy lands straight in the 128-byte-swizzled
//    tile that `wgmma` m64n64k16 reads MN-major as its B operand (x
//    K-major as A, K1's forward layout); the product reads the stage in
//    place: no widening pass and no second barrier. The ring is 4 x (8 KB
//    of x + 8 KB of W) = 64 KB, three blocks an SM;
//  - int8 W into the product: each int8 stage is widened in registers
//    (hopper.cuh's widen16, exact) into one 128-byte-swizzled bf16 tile,
//    which `wgmma` m64n64k16 reads MN-major as its B operand, x K-major
//    as A — K1's forward layout, at the cost of one shared-memory pass and
//    one barrier a tile, small beside the bytes of W;
//  - the rank term at ranks up to RANK_WGMMA. #9 (one A): P = x·A is a
//    second `wgmma` m64nRPk16 from the same x tile into a small f32
//    register accumulator (r padded to RP = 16 or 64). #10 and K2
//    (BATCHED: a per-row A[m], M ≤ 64): P[m] = x[m]·A[m] is no one
//    product, and every channel tile needs all of it, so a pre-pass kernel
//    (tt_linear_batched_p_kernel) reads A once (M·K·r·2 bytes) and writes
//    f32 partial sums of P[m] over 256 K rows each, which the epilogue
//    adds in K order. The main kernel is launched as the pre-pass's
//    programmatic dependent: its K loop runs while the pre-pass does, and
//    it waits for P (griddepcontrol.wait) only before the epilogue.
//    (Summing P in the K loop instead, from A[m]'s (64, r) blocks staged
//    in the ring, measured slower at every M from 4 to 64, PERF.md §6.)
//  - the rank term above RANK_WGMMA (EXT): K1's design. A pre-pass writes
//    alpha·P as a bf16 pair hi + lo into PL (M, 2·rp), rp = r rounded up
//    to 64 (#9: K1's own pre-pass, the `wgmma` kernel with A in W's place;
//    #10 and K2: tt_linear_batched_p_kernel, one block a (64 rank columns,
//    row) summing all of K). The K loop runs over nk + 2·rp / 64 tiles:
//    the base tiles, then the extension tiles — x tiles from PL's hi and
//    lo halves, bf16 W tiles from B's rows (each row twice), a second
//    tile loader straight into the swizzle as K2's W — and the slices of
//    K split that whole range, so the rank term spreads over the cluster
//    like the base rows. An int8 stage is sized for a bf16 tile, and only
//    base tiles are widened. The base sum is scaled (per channel, or per
//    group as below) where a slice's base tiles end, before the unscaled
//    extension is added. The main kernel is the pre-pass's programmatic
//    dependent and waits for PL before its first extension tile.
//  - scales in registers (int8 W; none for K2): per channel (G = 1), the
//    f32 sum is multiplied by scale[n] in the epilogue before alpha·P·B
//    is added, as the TPU kernel does. Grouped (G > 1, a group a multiple
//    of 64 rows), a group's x·q partial lives in the `wgmma` accumulator,
//    restarted at the group's first tile; at its last tile (or the
//    slice's) each thread adds partial · scale[g, n] into a second f32
//    register sum — no shared-memory round trip, and q·s is never rounded
//    to bf16;
//  - split-K reduction without float atomics or a workspace: the S ≤ 8
//    slices of a tile are one thread-block cluster. Each block writes its
//    f32 partials (the sum and P) to its own shared memory in its register
//    layout; after a cluster barrier every block sums P over the S blocks'
//    shared memory (distributed shared memory reads, all in flight at
//    once) and block c sums the sum's column groups c, c + S, ... in
//    slice order 0 .. S - 1 — a fixed f32 order, so two calls are
//    bit-identical — and runs their epilogue: P staged in shared memory,
//    B's (RP, 64) tile (copied into the free W ring while the slices
//    reduce) and acc += alpha·P·B in f32 (P is never rounded to bf16),
//    one rounding to bf16 on the store. The scales are loaded into
//    registers ahead of their use (per channel at the start, grouped at
//    a group's first tile). Ragged M / N / K are zero-filled on load and
//    masked on the store.

constexpr int QBM = 64, QBN = 64, QBK = 64;   // output tile, K tile
constexpr int QSTAGES = 4;                     // depth of the ring
constexpr int QNT = 128;                       // one warpgroup
constexpr int QCLUSTER = 8;   // most slices of K: a portable cluster
constexpr int PKC = 256;      // K rows a partial P sum of the pre-pass covers

__host__ __device__ constexpr int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// BATCHED (#10, K2, and every EXT): no A in the ring; P comes from a
// pre-pass. W8: int8 W tiles in the ring, widened into WB before use;
// else (K2) bf16 W tiles, each already in the swizzled layout `wgmma`
// reads. EXT: a stage also takes a bf16 tile of B's rows
template <int RP, bool BATCHED, bool W8, bool EXT>
struct SplitSmem {
  static constexpr int XS = QBM * QBK * 2;     // an x tile, swizzled
  static constexpr int WS = QBK * QBN * (W8 && !EXT ? 1 : 2);   // (k, n)
  static constexpr int AS = BATCHED ? 0 : RP * QBK * 2;   // an A tile
  static constexpr int X = 0;
  static constexpr int W = X + QSTAGES * XS;
  static constexpr int A = W + QSTAGES * WS;
  static constexpr int WB = A + QSTAGES * AS;  // the widened bf16 W tile
  static constexpr int TOTAL = WB + (W8 ? QBK * QBN * 2 : 0);
  static constexpr int PS = RP + 4;            // f32 row of the staged P
  // f32 partials a thread stages for the cluster's sum
  static constexpr int NV = QBN / 2 + (BATCHED ? 0 : RP / 2);
  static_assert(AS % 1024 == 0 && XS % 1024 == 0 && WS % 1024 == 0,
                "tiles must keep the 1024-byte alignment of the swizzle");
  static_assert(NV * QNT * 4 <= W && QBM * PS * 4 <= W &&
                    RP * QBN * 2 <= QSTAGES * WS,
                "the partials, then P, are staged where the x ring was, "
                "B's tile in the W ring");
};

template <int RP, bool GROUPED, bool BATCHED, bool W8, bool EXT>
__global__ void __launch_bounds__(QNT, RP <= 16 || BATCHED ? 3 : 2)
tt_linear_splitk_kernel(const bf16* __restrict__ x,
                        const void* __restrict__ wv,
                        const float* __restrict__ wscale,
                        const bf16* __restrict__ a,
                        const bf16* __restrict__ b, bf16* __restrict__ y,
                        const float* __restrict__ pp,
                        const bf16* __restrict__ pl, int M, int N, int K,
                        int r, int rp, int group, int tps, int nkc,
                        float alpha, const LinStrides ls) {
  static_assert(W8 || (BATCHED && !GROUPED),
                "a bf16 W is K2's: per-row A, no scales");
  static_assert(!EXT || (RP == 0 && BATCHED),
                "EXT carries no P: the pre-pass wrote it to PL");
  // EXT over int8 W: the base sum is scaled where the slice's base tiles
  // end, into tot, before the extension adds to it
  constexpr bool TOT = GROUPED || (EXT && W8);
  using L = SplitSmem<RP, BATCHED, W8, EXT>;
  const int8_t* w = static_cast<const int8_t*>(wv);
  const bf16* wh = static_cast<const bf16*>(wv);
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * QBN, m0 = blockIdx.y * QBM;
  const int S = gridDim.z, sp = blockIdx.z;
  const int nk = (K + QBK - 1) / QBK;   // base tiles; EXT adds 2·rp / 64
  const int nt = EXT ? nk + 2 * rp / QBK : nk;
  const int kt0 = sp * tps, kt1 = min(nt, kt0 + tps);
  const long long ask = ls.s[2], asj = ls.s[3];
  const bool va = ask == 1 && asj % 8 == 0 && K % 8 == 0 &&
                  reinterpret_cast<uintptr_t>(a) % 16 == 0;
  bool waited = false;   // EXT: PL is complete and visible

  // a bf16 (64, 64) tile of rows src[row·rs + col], rows ≥ nr and columns
  // ≥ nc zero, straight into the 128-byte swizzle
  auto put_bf16 = [&](uint32_t tile, const bf16* src, long long rs, int nr,
                      int nc) {
#pragma unroll
    for (int i = 0; i < 64 * 8 / QNT; ++i) {
      const int c = tid + i * QNT, row = c >> 3, ch = c & 7;
      const bool ok = row < nr && ch * 8 < nc;
      cp_async16(tile + row * 128 + ((ch ^ (row & 7)) << 4),
                 ok ? src + row * rs + ch * 8 : src, ok ? 16 : 0);
    }
  };
  auto issue = [&](int kt) {   // tile kt into its stage of the ring
    const int st = (kt - kt0) % QSTAGES, k0 = kt * QBK;
    const uint32_t xt = base + L::X + st * L::XS;
    const uint32_t wt = base + L::W + st * L::WS;
    if (EXT && kt >= nk) {   // an extension tile: PL's columns e .. e + 63
      if (!waited) {   // PL is the pre-pass's: wait for it to be complete
        asm volatile("griddepcontrol.wait;\n" ::: "memory");
        waited = true;
      }
      const int e = (kt - nk) * QBK, j0 = e % rp;
      put_bf16(xt, pl + static_cast<long long>(m0) * 2 * rp + e, 2 * rp,
               M - m0, QBK);
      put_bf16(wt, b + j0 * ls.s[4] + n0, ls.s[4], r - j0, N - n0);
      return;
    }
    put_bf16(xt, x + static_cast<long long>(m0) * K + k0, K, M - m0,
             K - k0);
    if constexpr (W8) {
#pragma unroll
      for (int i = 0; i < QBK * 4 / QNT; ++i) {   // W: 64 rows x 4 chunks
        const int c = tid + i * QNT, row = c >> 2, ch = c & 3;
        const int gk = k0 + row, gn = n0 + ch * 16;
        const bool ok = gk < K && gn < N;
        cp_async16(wt + row * QBN + ch * 16,
                   ok ? w + static_cast<long long>(gk) * N + gn : w,
                   ok ? 16 : 0);
      }
    } else {   // bf16 W: 64 rows x 8 chunks, straight into the swizzle
      put_bf16(wt, wh + static_cast<long long>(k0) * N + n0, N, K - k0,
               N - n0);
    }
    if constexpr (!BATCHED) {
      const uint32_t at = base + L::A + st * L::AS;
      for (int c = tid; c < RP * 8; c += QNT) {   // A: rows j, K-major
        const int j = c >> 3, ch = c & 7, k = k0 + ch * 8;
        const uint32_t dst = at + j * 128 + ((ch ^ (j & 7)) << 4);
        if (va) {
          const bool ok = j < r && k < K;
          cp_async16(dst, ok ? a + j * asj + k : a, ok ? 16 : 0);
        } else {
          uint32_t u[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            u[e] = elem2(a, (k + 2 * e) * ask + j * asj,
                         (k + 2 * e + 1) * ask + j * asj,
                         j < r && k + 2 * e < K, j < r && k + 2 * e + 1 < K);
          st_shared16(dst, u);
        }
      }
    }
  };

#pragma unroll
  for (int i = 0; i < QSTAGES - 1; ++i) {
    if (kt0 + i < kt1) issue(kt0 + i);
    cp_async_commit();
  }

  const int lane = tid & 31, warp = tid >> 5;
  const int ra = warp * 16 + (lane >> 2), ca = 2 * (lane & 3);
  float acc[QBN / 2], tot[TOT ? QBN / 2 : 1];
  float p[BATCHED ? 1 : RP / 2];
#pragma unroll
  for (int i = 0; i < QBN / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (TOT ? QBN / 2 : 1); ++i) tot[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (BATCHED ? 1 : RP / 2); ++i) p[i] = 0.f;

  // scales into registers ahead of their use: per channel once, grouped
  // at a group's first tile (the load's latency hides behind the group)
  float2 sc[QBN / 8];
  auto load_scales = [&](int g) {
    const float* srow = wscale + static_cast<long long>(g) * N;
#pragma unroll
    for (int c = 0; c < QBN / 8; ++c) {
      const int gn = n0 + 8 * c + ca;
      sc[c] = gn < N ? *reinterpret_cast<const float2*>(srow + gn)
                     : make_float2(0.f, 0.f);
    }
  };
  if constexpr (W8)   // an EXT slice past the base tiles needs none
    if (kt0 < nk) load_scales(GROUPED ? kt0 * QBK / group : 0);

  for (int kt = kt0; kt < kt1; ++kt) {
    const int st = (kt - kt0) % QSTAGES;
    const bool base_tile = kt < nk;
    cp_async_wait<QSTAGES - 2>();   // tile kt has landed
    if constexpr (!W8) fence_proxy_async();   // cp.async, to `wgmma`
    __syncthreads();   // ... for every thread; the products of tile kt - 1
                       // are done, so its stage and the widened tile are free
    if (kt + QSTAGES - 1 < kt1) issue(kt + QSTAGES - 1);
    cp_async_commit();
    // the bf16 tile `wgmma` reads: the stage itself (bf16 W, B's rows), or
    // int8 W widened into WB
    uint32_t wb = base + L::W + st * L::WS;
    if constexpr (W8) {
      if (base_tile) {
        const unsigned char* qt = smem + L::W + st * L::WS;
        wb = base + L::WB;
#pragma unroll
        for (int i = 0; i < QBK * 4 / QNT; ++i) {   // 16 values a chunk
          const int c = tid + i * QNT, row = c >> 2, ch = c & 3;
          uint32_t lo[4], hi[4];
          widen16(*reinterpret_cast<const uint4*>(qt + row * QBN + ch * 16),
                  lo, hi);
          st_shared16(wb + row * 128 + (((2 * ch) ^ (row & 7)) << 4), lo);
          st_shared16(wb + row * 128 + (((2 * ch + 1) ^ (row & 7)) << 4),
                      hi);
        }
      }
      fence_proxy_async();   // cp.async and the widened stores, to `wgmma`
      __syncthreads();
    }
    const uint32_t xt = base + L::X + st * L::XS;
    const uint32_t at = base + L::A + st * L::AS;
    reg_fence(acc);
    reg_fence(p);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < QBK / 16; ++kk) {
      const uint64_t dx = desc_k<QBM>(xt, 0, kk);
      WgSS<QBN, 1>::mma(acc, dx, desc_mn<QBK>(wb, kk), 1);
      if constexpr (!BATCHED)
        WgSS<RP>::mma(p, dx, desc_k<RP>(at, 0, kk), 1);   // P += x·A
    }
    wg_commit();
    wg_wait<0>();
    reg_fence(acc);
    reg_fence(p);
    // the group's, the slice's or (EXT) the base's last tile: tot +=
    // partial · scale
    if (TOT && W8 && base_tile &&
        ((GROUPED && ((kt + 1) * QBK) % group == 0) || kt + 1 == kt1 ||
         (EXT && kt + 1 == nk))) {
#pragma unroll
      for (int c = 0; c < QBN / 8; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          tot[4 * c + e] += acc[4 * c + e] * ((e & 1) ? sc[c].y : sc[c].x);
          acc[4 * c + e] = 0.f;
        }
      if (GROUPED && kt + 1 < min(kt1, nk))
        load_scales((kt + 1) * QBK / group);
    }
  }
  cp_async_wait<0>();
  if constexpr (EXT && W8) {   // + the extension, which is not scaled
#pragma unroll
    for (int i = 0; i < QBN / 2; ++i) tot[i] += acc[i];
  }
  float* sum = TOT ? tot : acc;
  __syncthreads();   // the rings are free: the partials go where x was

  // B's (RP, 64) tile for the epilogue, into the W ring while the slices
  // reduce; rows ≥ r and columns ≥ N zero
  const uint32_t bt = base + L::W;
  const bool vb = ls.s[5] == 1 && ls.s[4] % 8 == 0 &&
                  reinterpret_cast<uintptr_t>(b) % 16 == 0;
  for (int c = tid; c < RP * 8; c += QNT) {
    const int j = c >> 3, ch = c & 7, gn = n0 + ch * 8;
    const uint32_t dst = bt + j * 128 + ch * 16;
    if (vb) {
      const bool ok = j < r && gn < N;
      cp_async16(dst, ok ? b + j * ls.s[4] + gn : b, ok ? 16 : 0);
    } else {
      uint32_t u[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        u[e] = elem2(b, j * ls.s[4] + (gn + 2 * e) * ls.s[5],
                     j * ls.s[4] + (gn + 2 * e + 1) * ls.s[5],
                     j < r && gn + 2 * e < N, j < r && gn + 2 * e + 1 < N);
      st_shared16(dst, u);
    }
  }
  cp_async_commit();

  // split-K across the cluster (S = 1: a cluster of one)
  float4* part = reinterpret_cast<float4*>(smem);   // [v][tid]
#pragma unroll
  for (int v = 0; v < QBN / 8; ++v)
    part[v * QNT + tid] = make_float4(sum[4 * v], sum[4 * v + 1],
                                      sum[4 * v + 2], sum[4 * v + 3]);
  if constexpr (!BATCHED) {
#pragma unroll
    for (int v = 0; v < RP / 8; ++v)
      part[(QBN / 8 + v) * QNT + tid] =
          make_float4(p[4 * v], p[4 * v + 1], p[4 * v + 2], p[4 * v + 3]);
  }
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  cluster.sync();   // every slice's partials are in its shared memory
  // the S partials of entry v of this thread, summed in slice order
  auto reduce = [&](int v, float* out) {
    float4 t[QCLUSTER];
#pragma unroll
    for (int q = 0; q < QCLUSTER; ++q)
      if (q < S) t[q] = *(cluster.map_shared_rank(part, q) + v * QNT + tid);
    float4 u = t[0];
#pragma unroll
    for (int q = 1; q < QCLUSTER; ++q)
      if (q < S) {
        u.x += t[q].x;
        u.y += t[q].y;
        u.z += t[q].z;
        u.w += t[q].w;
      }
    out[0] = u.x;
    out[1] = u.y;
    out[2] = u.z;
    out[3] = u.w;
  };
  if constexpr (!BATCHED) {
#pragma unroll
    for (int v = 0; v < RP / 8; ++v) reduce(QBN / 8 + v, p + 4 * v);
  }
#pragma unroll
  for (int c = 0; c < QBN / 8; ++c)   // this block's column groups
    if (c % S == rank) reduce(c, sum + 4 * c);
  cluster.sync();   // no block reads another's shared memory past here

  float* ps = reinterpret_cast<float*>(smem);   // P (64, RP), f32
  if constexpr (!BATCHED) {
#pragma unroll
    for (int c = 0; c < RP / 8; ++c)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<float2*>(ps + (ra + 8 * hh) * L::PS + 8 * c + ca) =
            make_float2(p[4 * c + 2 * hh], p[4 * c + 2 * hh + 1]);
  } else if constexpr (!EXT) {   // #10: the pre-pass's partials, K order
    // launched as its dependent, this grid may start before the pre-pass
    // ends: wait here for it to finish and its writes to show
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
    for (int idx = tid; idx < M * r; idx += QNT) {
      const int m = idx / r, j = idx - m * r;
      const float* src = pp + static_cast<long long>(m) * nkc * r + j;
      float t = 0.f;
      for (int c = 0; c < nkc; ++c) t += __ldcg(src + c * r);
      ps[m * L::PS + j] = t;
    }
  }
  cp_async_wait<0>();   // B's tile
  __syncthreads();
  const bf16* bs = reinterpret_cast<const bf16*>(smem + L::W);
#pragma unroll
  for (int c = 0; c < QBN / 8; ++c) {
    const int gn = n0 + 8 * c + ca;
    if (c % S != rank || gn >= N) continue;
    float* g = sum + 4 * c;
    if (W8 && !TOT) {   // per output channel: the f32 sum · scale[n]
      g[0] *= sc[c].x;
      g[1] *= sc[c].y;
      g[2] *= sc[c].x;
      g[3] *= sc[c].y;
    }
    for (int j = 0; j < (EXT ? 0 : r); ++j) {   // + alpha·P·B, in f32
      const float p0 = alpha * ps[ra * L::PS + j];
      const float p1 = alpha * ps[(ra + 8) * L::PS + j];
      const float2 bv = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(bs + j * QBN + 8 * c + ca));
      g[0] += p0 * bv.x;
      g[1] += p0 * bv.y;
      g[2] += p1 * bv.x;
      g[3] += p1 * bv.y;
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {   // N is even: bf16x2 stores
      const int gm = m0 + ra + 8 * hh;
      if (gm < M)
        *reinterpret_cast<__nv_bfloat162*>(
            y + static_cast<long long>(gm) * N + gn) =
            __floats2bfloat162_rn(g[2 * hh], g[2 * hh + 1]);
    }
  }
}

// #10's and K2's pre-pass, over the per-row A (M, K, r). Ranks up to
// RANK_WGMMA (HL false): part[m, c, j] = Σ x[m, k]·A[m, k, j] over the K
// rows k of chunk c (PKC of them), in f32, one block a (chunk, row).
// Larger ranks (HL): one block a (64 rank columns j0.., row) sums all of
// K and writes alpha·P as hi = bf16(alpha·P), lo = bf16(alpha·P - hi) into
// PL row m, columns j0.. and rp + j0.. (zero past r). Either way a
// thread's rows are summed in registers, the block's lanes in a fixed
// tree and its four warps in order. vec: A's rows take 16-byte loads.
template <int RPP, bool HL>
__global__ void __launch_bounds__(QNT)
tt_linear_batched_p_kernel(const bf16* __restrict__ x,
                           const bf16* __restrict__ a,
                           float* __restrict__ part, bf16* __restrict__ pl,
                           int K, int r, int vec, float alpha, int rp) {
  __shared__ float red[QNT / 32][RPP];
  // let the main kernel start now: its base K loop does not read P
  asm volatile("griddepcontrol.launch_dependents;\n" ::);
  const int m = blockIdx.y;
  const int c = HL ? 0 : blockIdx.x, nkc = HL ? 1 : gridDim.x;
  const int j0 = HL ? blockIdx.x * RPP : 0;
  const int nr = min(RPP, r - j0);   // HL: ≤ 0 for rank padding only
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int k1 = HL ? K : min(K, (c + 1) * PKC);
  float pr[RPP];
#pragma unroll
  for (int j = 0; j < RPP; ++j) pr[j] = 0.f;
#pragma unroll 2
  for (int k = (HL ? 0 : c * PKC) + tid; k < k1; k += QNT) {
    const float xv = __bfloat162float(x[static_cast<long long>(m) * K + k]);
    const bf16* ak = a + (static_cast<long long>(m) * K + k) * r + j0;
    if (vec) {
#pragma unroll
      for (int jc = 0; jc < RPP / 8; ++jc) {
        if (jc * 8 >= nr) break;
        const uint4 u = __ldg(reinterpret_cast<const uint4*>(ak + jc * 8));
        const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const float2 f = __bfloat1622float2(e[t]);
          pr[jc * 8 + 2 * t] += xv * f.x;
          pr[jc * 8 + 2 * t + 1] += xv * f.y;
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < RPP; ++j)
        if (j < nr) pr[j] += xv * __bfloat162float(ak[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < RPP; ++j) {
    if (j >= nr) break;
#pragma unroll
    for (int o = 16; o >= 1; o >>= 1)
      pr[j] += __shfl_xor_sync(0xffffffffu, pr[j], o);
    if (lane == 0) red[warp][j] = pr[j];
  }
  __syncthreads();
  if constexpr (HL) {
    if (tid < RPP) {
      const float v =
          tid < nr ? alpha * (((red[0][tid] + red[1][tid]) + red[2][tid]) +
                              red[3][tid])
                   : 0.f;
      const bf16 hi = __float2bfloat16(v);
      bf16* row = pl + static_cast<long long>(m) * 2 * rp + j0 + tid;
      row[0] = hi;
      row[rp] = __float2bfloat16(v - __bfloat162float(hi));
    }
  } else if (tid < r) {
    part[(static_cast<long long>(m) * nkc + c) * r + tid] =
        ((red[0][tid] + red[1][tid]) + red[2][tid]) + red[3][tid];
  }
}

// the slices of K over nt = nk (+ 2·rp / 64 for EXT) tiles: tps tiles a
// slice, no slice empty
template <int RP, bool GROUPED, bool BATCHED, bool W8, bool EXT>
int launch_splitk(const void* x, const void* w, const float* s,
                  const void* a, const void* b, void* y, const float* pp,
                  const void* pl, int M, int N, int K, int r, int rp,
                  int group, int splits, int nkc, float alpha,
                  const LinStrides& ls, void* stream) {
  constexpr int smem = SplitSmem<RP, BATCHED, W8, EXT>::TOTAL + 1024;
  static bool done = false;
  auto kern = tt_linear_splitk_kernel<RP, GROUPED, BATCHED, W8, EXT>;
  cudaError_t e = allow_smem(kern, smem, &done);
  if (e != cudaSuccess) return (int)e;
  const int nt = (K + QBK - 1) / QBK + (EXT ? 2 * rp / QBK : 0);
  const int tps = (nt + splits - 1) / splits;
  const int nsl = (nt + tps - 1) / tps;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + QBN - 1) / QBN, (M + QBM - 1) / QBM, nsl);
  cfg.blockDim = dim3(QNT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;   // the slices of a tile
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = nsl;
  // after a pre-pass (#10, K2, EXT): its programmatic dependent
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = BATCHED ? 2 : 1;
  e = cudaLaunchKernelEx(&cfg, kern, static_cast<const bf16*>(x), w, s,
                         static_cast<const bf16*>(a),
                         static_cast<const bf16*>(b), static_cast<bf16*>(y),
                         pp, static_cast<const bf16*>(pl), M, N, K, r, rp,
                         group, tps, nkc, alpha, ls);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// the main kernel over PL after a pre-pass (EXT): int8 W per channel or
// grouped, or bf16 W
template <bool W8>
int launch_ext(const void* x, const void* w, const float* s, const void* b,
               void* y, const void* pl, int M, int N, int K, int r, int rp,
               int G, int splits, const LinStrides& ls, void* stream) {
#define EXT_ARGS x, w, s, nullptr, b, y, nullptr, pl, M, N, K, r, rp, K / G, \
                 splits, 0, 1.f, ls, stream
  if constexpr (!W8) return launch_splitk<0, false, true, false, true>(EXT_ARGS);
  return G > 1 ? launch_splitk<0, true, true, true, true>(EXT_ARGS)
               : launch_splitk<0, false, true, true, true>(EXT_ARGS);
#undef EXT_ARGS
}

// #10 (W8) and K2 on the split-K `wgmma` kernel: the pre-pass into ws,
// then the kernel. r ≤ RANK_WGMMA: ws holds f32 partial P sums
// (M · ceil(K / 256) · r); above: PL, bf16 (M, 2·rp)
template <bool W8>
int run_batched_splitk(const void* x, const void* w, const float* s,
                       const void* a, const void* b, void* y, void* ws,
                       int M, int N, int K, int r, int G, float alpha,
                       int splits, void* stream) {
  LinStrides ls = {{0, 0, 0, 0, N, 1}};   // b contiguous
  const int group = K / G;
  if (ws == nullptr) return (int)cudaErrorInvalidValue;
  const int vec = r % 8 == 0 && aligned16(a);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* ab = static_cast<const bf16*>(a);
  if (r > RANK_WGMMA) {
    const int rp = round_up(r, QBK);
    tt_linear_batched_p_kernel<64, true><<<dim3(rp / 64, M), QNT, 0, st>>>(
        xb, ab, nullptr, static_cast<bf16*>(ws), K, r, vec, alpha, rp);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    return launch_ext<W8>(x, w, s, b, y, ws, M, N, K, r, rp, G, splits, ls,
                          stream);
  }
  float* pp = static_cast<float*>(ws);
  const int nkc = (K + PKC - 1) / PKC;
  const dim3 pgrid(nkc, M);
  if (r <= 16)
    tt_linear_batched_p_kernel<16, false><<<pgrid, QNT, 0, st>>>(
        xb, ab, pp, nullptr, K, r, vec, 1.f, 0);
  else
    tt_linear_batched_p_kernel<64, false><<<pgrid, QNT, 0, st>>>(
        xb, ab, pp, nullptr, K, r, vec, 1.f, 0);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
#define BA_ARGS x, w, s, a, b, y, pp, nullptr, M, N, K, r, 0, group, splits, \
                nkc, alpha, ls, stream
  if constexpr (!W8)
    return launch_splitk<64, false, true, false, false>(BA_ARGS);
  return G > 1 ? launch_splitk<64, true, true, true, false>(BA_ARGS)
               : launch_splitk<64, false, true, true, false>(BA_ARGS);
#undef BA_ARGS
}

// K1's pre-pass: PL = alpha·x·A as hi + lo (M, 2·rp) with A (K, r), read
// through its strides, in W's place (N = r); x contiguous
int k1_pre_pass(const void* x, const void* a, void* pl, int M, int K, int r,
                float alpha, long long ask, long long asj, void* stream) {
  const int rp = round_up(r, LBK);
  LinStrides la = {{ask, asj, 0, 0, 0, 0}};
  const bool ak = ask == 1 && asj != 1;
  const bool va = ak ? K % 8 == 0 && asj % 8 == 0
                     : asj == 1 && r % 8 == 0 && ask % 8 == 0;
  const int pv = (K % 8 == 0 && aligned16(x) ? LV_X : 0) |
                 (va && aligned16(a) ? LV_W : 0);
#define PRE_ARGS x, a, nullptr, nullptr, pl, M, r, K, r, alpha, la, pv, \
                 nullptr, rp, stream
  return pv == (LV_X | LV_W)
             ? (ak ? launch_wgmma<0, true, true, K1_PRE>(PRE_ARGS)
                   : launch_wgmma<0, false, true, K1_PRE>(PRE_ARGS))
             : (ak ? launch_wgmma<0, true, false, K1_PRE>(PRE_ARGS)
                   : launch_wgmma<0, false, false, K1_PRE>(PRE_ARGS));
#undef PRE_ARGS
}

// ------------------------------------------------- K1 in f32 (FFMA)
//
// The f32 instance of K1 (RoBERTa's f32 training: the forward, the remat
// recompute and dx on the (g, Wᵀ, Bᵀ, Aᵀ) views). It computes in f32, not
// on f32 inputs rounded down: every product is an FFMA on the CUDA cores
// (one TF32 tensor-core pass would keep 10 mantissa bits). At the training
// shape (M = 4096, K = N = 1024, r = 8) that is 8.7 GFLOP against 21 MB:
// bound by the FFMA rate (67 TFLOP/s), where a register-blocked tile gets
// a good share of it.
//
// Two launches of one tile kernel, C = alpha·(A0·B0 + A1·B1) over two
// segments of the K loop:
//   pre-pass  P = alpha·x·A into an (M, r) f32 workspace (segment 1 empty)
//             — P stays f32 at every rank (VeRA's 1024 too);
//   main      y = x·W + P·B: the K loop runs over K rows of (x, W), then
//             r rows of (P, B), into one f32 accumulator.
// A block owns a BM x BN tile (128 x 128 for the main kernel, 64 x 64 for
// a pre-pass of rank <= 64), each of 256 threads TM x TN outputs split
// into 4 x 4 groups spaced BM / (TM / 4) apart, so the float4 reads of a
// quarter-warp hit distinct banks. Depth tiles of 8 pass through two
// shared-memory buffers (registers hold the next tile while the current
// one is consumed; one barrier a tile). The A operand (x, g, P) is
// K-contiguous; the B operand (W, A, B and their transposed views) is read
// through its strides, consecutive threads along whichever of its two
// dimensions is contiguous. Rows and columns past M, N, K are zero-filled
// and masked; no operand needs any alignment.
//
// #9's f32 instance (tt_linear_w8_f32: RoBERTa served over int8 weights)
// is the same two launches with segment 0's B an int8 W (Q != 0): each
// int8 value is widened to f32 as it is loaded (|q| <= 127 is exact), and
// the f32 tile in shared memory feeds the same FFMA loop. The scales
// follow the TPU kernel: per output channel (Q_CHANNEL, G = 1) the
// accumulator is multiplied by s[n] where the K loop crosses from W's
// rows to B's, so s touches the base sum only (_epilogue_out's order);
// per group of K / G rows (Q_GROUP) each widened value is multiplied by
// its group's s[g, n] on load (_base_dot's q·s per K tile). At
// roberta-large's prefill (M = 16..96 prompt rows, K = N = 1024, r = 8)
// it reads 1 MB of int8 W and does 2·M·K·N flops: bound by the bytes
// below M ≈ 25, by the operations above (the f32 bound of PERF.md §2);
// its 128 x 128 tiles leave most SMs idle at these M.

struct F32Seg {
  const float* a;   // (M, k), K-contiguous, row stride lda
  long long lda;
  const float* b;   // (k, N), element strides bsk, bsn
  long long bsk, bsn;
  int k;
};

// segment 0's B as an int8 W (read through the segment's strides) with
// f32 scales s (G, N) row-major, a scale row every `group` rows of K
struct F32Q {
  const int8_t* q;
  const float* s;
  int group;
};

constexpr int F32_BK = 8;
constexpr int Q_NONE = 0, Q_CHANNEL = 1, Q_GROUP = 2;

template <int BM, int BN, int TM, int TN, int Q = Q_NONE>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
tt_linear_f32_kernel(const F32Seg s0, const F32Seg s1, const F32Q wq,
                     float* __restrict__ c, int M, int N, float alpha) {
  constexpr int NT = (BM / TM) * (BN / TN), BK = F32_BK;
  constexpr int LA = BM * BK / NT, LB = BN * BK / NT;
  constexpr int GM = TM / 4, GN = TN / 4;   // 4 x 4 groups a thread
  static_assert(LA * NT == BM * BK && LB * NT == BN * BK, "tile split");
  __shared__ __align__(16) float As[2][BK][BM + 4];
  __shared__ __align__(16) float Bs[2][BK][BN + 4];
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int t0 = (s0.k + BK - 1) / BK, nt = t0 + (s1.k + BK - 1) / BK;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  float ra[LA], rb[LB];
  bool bn_rows = true;   // the B tile's threads run along n (else along k)

  auto load = [&](int t) {
    const bool first = t < t0;
    const float* pa = first ? s0.a : s1.a;
    const float* pb = first ? s0.b : s1.b;
    const long long lda = first ? s0.lda : s1.lda;
    const long long bsk = first ? s0.bsk : s1.bsk;
    const long long bsn = first ? s0.bsn : s1.bsn;
    const int kd = first ? s0.k : s1.k;
    const int k0 = (first ? t : t - t0) * BK;
    bn_rows = bsn == 1 || bsk != 1;
#pragma unroll
    for (int i = 0; i < LA; ++i) {
      const int e = tid + i * NT, mm = e / BK, kk = e % BK;
      const int gm = m0 + mm, gk = k0 + kk;
      ra[i] = gm < M && gk < kd ? pa[(long long)gm * lda + gk] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < LB; ++i) {
      const int e = tid + i * NT;
      const int kk = bn_rows ? e / BN : e % BK;
      const int nn = bn_rows ? e % BN : e / BK;
      const int gk = k0 + kk, gn = n0 + nn;
      const bool in = gk < kd && gn < N;
      if (Q != Q_NONE && first) {   // int8 W, widened (and group-scaled)
        float v = in ? static_cast<float>(wq.q[gk * bsk + gn * bsn]) : 0.f;
        if (Q == Q_GROUP && in)
          v *= wq.s[static_cast<long long>(gk / wq.group) * N + gn];
        rb[i] = v;
      } else {
        rb[i] = in ? pb[gk * bsk + gn * bsn] : 0.f;
      }
    }
  };
  // per-channel scales: the base sum (tiles 0 .. t0 - 1) times s[n], once
  auto scale_base = [&]() {
#pragma unroll
    for (int g = 0; g < GN; ++g)
#pragma unroll
      for (int c4 = 0; c4 < 4; ++c4) {
        const int gn = n0 + g * (BN / GN) + tx * 4 + c4;
        const float sv = gn < N ? wq.s[gn] : 0.f;
#pragma unroll
        for (int i = 0; i < TM; ++i) acc[i][g * 4 + c4] *= sv;
      }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < LA; ++i) {
      const int e = tid + i * NT;
      As[buf][e % BK][e / BK] = ra[i];
    }
#pragma unroll
    for (int i = 0; i < LB; ++i) {
      const int e = tid + i * NT;
      if (bn_rows) Bs[buf][e / BN][e % BN] = rb[i];
      else Bs[buf][e % BK][e / BK] = rb[i];
    }
  };

  if (nt > 0) {
    load(0);
    store(0);
  }
  __syncthreads();
  for (int t = 0; t < nt; ++t) {
    const int buf = t & 1;
    if (t + 1 < nt) load(t + 1);
    if (Q == Q_CHANNEL && t == t0) scale_base();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[TM], bv[TN];
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        const float4 v = *reinterpret_cast<const float4*>(
            &As[buf][kk][g * (BM / GM) + ty * 4]);
        av[g * 4 + 0] = v.x; av[g * 4 + 1] = v.y;
        av[g * 4 + 2] = v.z; av[g * 4 + 3] = v.w;
      }
#pragma unroll
      for (int g = 0; g < GN; ++g) {
        const float4 v = *reinterpret_cast<const float4*>(
            &Bs[buf][kk][g * (BN / GN) + tx * 4]);
        bv[g * 4 + 0] = v.x; bv[g * 4 + 1] = v.y;
        bv[g * 4 + 2] = v.z; bv[g * 4 + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (t + 1 < nt) store(buf ^ 1);
    __syncthreads();
  }
  if (Q == Q_CHANNEL && t0 == nt) scale_base();

  const bool vec = N % 4 == 0 && (reinterpret_cast<uintptr_t>(c) & 15) == 0;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + (i / 4) * (BM / GM) + ty * 4 + i % 4;
    if (gm >= M) continue;
    float* row = c + (long long)gm * N;
#pragma unroll
    for (int g = 0; g < GN; ++g) {
      const int gn = n0 + g * (BN / GN) + tx * 4;
      if (vec && gn + 3 < N) {
        *reinterpret_cast<float4*>(row + gn) =
            make_float4(alpha * acc[i][g * 4], alpha * acc[i][g * 4 + 1],
                        alpha * acc[i][g * 4 + 2], alpha * acc[i][g * 4 + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (gn + j < N) row[gn + j] = alpha * acc[i][g * 4 + j];
      }
    }
  }
}

template <int BM, int BN, int TM, int TN, int Q = Q_NONE>
int launch_f32(const F32Seg& s0, const F32Seg& s1, float* c, int M, int N,
               float alpha, void* stream, const F32Q& wq = F32Q{}) {
  if ((M + BM - 1) / BM > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  tt_linear_f32_kernel<BM, BN, TM, TN, Q>
      <<<grid, (BM / TM) * (BN / TN), 0, (cudaStream_t)stream>>>(
          s0, s1, wq, c, M, N, alpha);
  return (int)cudaGetLastError();
}


// ------------------------------------------------- K2 in f32 (FFMA)
//
// The f32 instance of K2 (RoBERTa's f32 decode: the (slots, 1) adapted q
// and v, each slot with its task's A[m]). FFMA throughout, no operand
// rounded. At roberta-large's decode shape (M = 2..8 slots, K = N = 1024,
// r = 8) the work is M flops a byte of W: bound by reading W's 4 MB once.
// Two launches:
//   pre-pass  partial sums of P[m] = x[m]·A[m] over KC = 256 rows of K,
//             (M, ceil(K / KC), r) f32 — A read once through its strides;
//   main      y = [x | α·P]·[W; B] over K + r rows, split into S slices:
//             a block owns BN = 128 output channels x MT = 8 rows over one
//             slice, each warp lane 4 consecutive channels (a warp reads
//             512 contiguous bytes of a W row), the 8 warps every 8th row
//             of the slice; the slice's x (and α·P, its partials summed in
//             K order) sit in shared memory, read as broadcasts. The warps'
//             sums meet in shared memory in warp order; with S > 1 each
//             slice writes its (MT, BN) partial to a workspace and the
//             last block of the tile (an integer ticket, as #8's chunks)
//             sums the slices in slice order — a fixed order, so two calls
//             are bit-identical, with no float atomics.
// S is the launcher's (kernels/tt_linear.py::ba_f32_splits): enough slices
// for about two blocks an SM, each at least 32 rows and at most
// BA32_MAX_ROWS. W and B are read through their strides (16-byte loads
// where both allow them), A through its three; x is contiguous; any M, N,
// K and r.
//
// #10's f32 instance (tt_linear_batched_a_w8_f32: RoBERTa's decode over
// int8 weights) is the same two launches over an int8 W (Q != 0): a lane
// reads its 4 channels of a W row as one 4-byte word and widens them to
// f32 (exact), so a warp streams 128 contiguous bytes of W a row — at
// roberta-large's decode (M = 2..8, K = N = 1024) the kernel is bound by
// reading W's 1 MB once. Per-channel scales (Q_CHANNEL) multiply each
// warp's base sum where its rows cross from W's to B's (or after its last
// row, if it has no B row): each warp's rows ascend, so that is after all
// its base rows, and s touches the base sum only; a slice that straddles
// the boundary scales no adapter row. Group scales (Q_GROUP) multiply the
// widened row by its group's s[g, n], kept in registers while a warp's
// rows stay in one group. The sums meet in the same fixed order.

constexpr int BA32_BN = 128, BA32_MT = 8, BA32_WARPS = 8;
constexpr int BA32_KC = 256, BA32_MAX_ROWS = 1024;

// raw partials of P: grid (ceil(K / KC), M); lanes over 32 rank columns,
// warps over every 8th row of the chunk, summed in warp order
__global__ void __launch_bounds__(256)
ba_f32_pre_kernel(const float* __restrict__ x, const float* __restrict__ a,
                  float* __restrict__ pp, int K, int r, long long asm_,
                  long long ask, long long asj) {
  __shared__ float red[BA32_WARPS][32];
  const int kc = blockIdx.x, m = blockIdx.y, nkc = gridDim.x;
  const int lane = threadIdx.x % 32, wp = threadIdx.x / 32;
  const int k0 = kc * BA32_KC, k1 = min(K, k0 + BA32_KC);
  const float* xr = x + static_cast<long long>(m) * K;
  const float* am = a + m * asm_;
  for (int j0 = 0; j0 < r; j0 += 32) {
    const int j = j0 + lane;
    float s = 0.f;
    if (j < r)
      for (int k = k0 + wp; k < k1; k += BA32_WARPS)
        s = fmaf(xr[k], am[k * ask + j * asj], s);
    red[wp][lane] = s;
    __syncthreads();
    if (wp == 0 && j < r) {
      float t = 0.f;
#pragma unroll
      for (int w = 0; w < BA32_WARPS; ++w) t += red[w][lane];
      pp[(static_cast<long long>(m) * nkc + kc) * r + j] = t;
    }
    __syncthreads();
  }
}

// 4 consecutive elements of a row (element stride sn) from column n; past
// N zero. VEC: one 16-byte load (sn = 1, N % 4 == 0, aligned rows)
template <bool VEC>
__device__ __forceinline__ float4 row4(const float* row, int n, int N,
                                       long long sn) {
  if (VEC) {
    if (n < N) return __ldg(reinterpret_cast<const float4*>(row + n));
    return make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float v[4];
#pragma unroll
  for (int c = 0; c < 4; ++c)
    v[c] = n + c < N ? __ldg(row + (n + c) * sn) : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

// 4 consecutive int8 elements of a row (element stride sn) from column
// n, widened to f32; past N zero. VEC: one 4-byte load (sn = 1,
// N % 4 == 0, 4-byte aligned rows)
template <bool VEC>
__device__ __forceinline__ float4 row4q(const int8_t* row, int n, int N,
                                        long long sn) {
  if (VEC) {
    if (n >= N) return make_float4(0.f, 0.f, 0.f, 0.f);
    const char4 q = __ldg(reinterpret_cast<const char4*>(row + n));
    return make_float4(q.x, q.y, q.z, q.w);
  }
  float v[4];
#pragma unroll
  for (int c = 0; c < 4; ++c)
    v[c] = n + c < N ? static_cast<float>(__ldg(row + (n + c) * sn)) : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

// grid (ceil(N / BN), ceil(M / MT), S); rows [s·ks, (s + 1)·ks) of K + r.
// Q != Q_NONE: w is an int8 W and s its f32 scales (G, N), a scale row
// every `group` rows
template <bool VEC, int Q = Q_NONE>
__global__ void __launch_bounds__(256)
ba_f32_kernel(const float* __restrict__ x, const void* __restrict__ wv_,
              const float* __restrict__ pp, const float* __restrict__ b,
              float* __restrict__ y, float* __restrict__ part,
              int* __restrict__ cnt, int M, int N, int K, int r, int nkc,
              int ks, float alpha, long long wsk, long long wsn,
              long long bsj, long long bsn, const float* __restrict__ sc,
              int group) {
  constexpr int MT = BA32_MT, BN = BA32_BN;
  extern __shared__ __align__(16) float smb[];
  float* red = smb;                          // [warp][MT][BN]
  float* xs = smb + BA32_WARPS * MT * BN;    // [slice row][MT]
  __shared__ int last_flag;
  const int tid = threadIdx.x, lane = tid % 32, wp = tid / 32;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * MT, s = blockIdx.z;
  const int S = gridDim.z;
  const int kr0 = s * ks, kr1 = min(K + r, kr0 + ks), nr = kr1 - kr0;
  for (int i = tid; i < nr * MT; i += 256) {   // x, or α·P in K order
    const int kk = i / MT, mm = i % MT, k = kr0 + kk, m = m0 + mm;
    float v = 0.f;
    if (m < M) {
      if (k < K) {
        v = x[static_cast<long long>(m) * K + k];
      } else {
        float t = 0.f;
        for (int c = 0; c < nkc; ++c)
          t += pp[(static_cast<long long>(m) * nkc + c) * r + (k - K)];
        v = alpha * t;
      }
    }
    xs[i] = v;
  }
  __syncthreads();
  const int n = n0 + lane * 4;
  const float* w = static_cast<const float*>(wv_);
  const int8_t* w8 = static_cast<const int8_t*>(wv_);
  float acc[MT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
  float4 sv = make_float4(0.f, 0.f, 0.f, 0.f);
  int sg = -1;                 // the group whose scales sv holds
  bool scaled = false;         // Q_CHANNEL: the base sum scaled
  auto scale_acc = [&]() {
    const float4 s4 = row4<VEC>(sc, n, N, 1);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      acc[i][0] *= s4.x;
      acc[i][1] *= s4.y;
      acc[i][2] *= s4.z;
      acc[i][3] *= s4.w;
    }
    scaled = true;
  };
  for (int kk = wp; kk < nr; kk += BA32_WARPS) {
    const int k = kr0 + kk;
    float4 wv;
    if (k >= K) {
      if (Q == Q_CHANNEL && !scaled) scale_acc();
      wv = row4<VEC>(b + (k - K) * bsj, n, N, bsn);
    } else if (Q == Q_NONE) {
      wv = row4<VEC>(w + k * wsk, n, N, wsn);
    } else {
      wv = row4q<VEC>(w8 + k * wsk, n, N, wsn);
      if (Q == Q_GROUP) {
        if (k / group != sg) {
          sg = k / group;
          sv = row4<VEC>(sc + static_cast<long long>(sg) * N, n, N, 1);
        }
        wv.x *= sv.x;
        wv.y *= sv.y;
        wv.z *= sv.z;
        wv.w *= sv.w;
      }
    }
    const float4 x0 = *reinterpret_cast<const float4*>(xs + kk * MT);
    const float4 x1 = *reinterpret_cast<const float4*>(xs + kk * MT + 4);
    const float xv[MT] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      acc[i][0] = fmaf(xv[i], wv.x, acc[i][0]);
      acc[i][1] = fmaf(xv[i], wv.y, acc[i][1]);
      acc[i][2] = fmaf(xv[i], wv.z, acc[i][2]);
      acc[i][3] = fmaf(xv[i], wv.w, acc[i][3]);
    }
  }
  if (Q == Q_CHANNEL && !scaled) scale_acc();
#pragma unroll
  for (int i = 0; i < MT; ++i)
    *reinterpret_cast<float4*>(red + (wp * MT + i) * BN + lane * 4) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  __syncthreads();
  // the slice's (MT, BN) sums, warps in order
  float out[MT * BN / 256];
#pragma unroll
  for (int u = 0; u < MT * BN / 256; ++u) {
    const int e = tid + u * 256;
    float t = 0.f;
#pragma unroll
    for (int w_ = 0; w_ < BA32_WARPS; ++w_) t += red[w_ * MT * BN + e];
    out[u] = t;
  }
  const int bk = blockIdx.y * gridDim.x + blockIdx.x;
  if (S > 1) {   // partials out; the last slice of the tile sums them
    float* mine = part + ((static_cast<long long>(bk) * S + s) * MT * BN);
#pragma unroll
    for (int u = 0; u < MT * BN / 256; ++u) mine[tid + u * 256] = out[u];
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      last_flag = atomicAdd(cnt + bk, 1) == S - 1;
      if (last_flag) cnt[bk] = 0;   // ready for the next launch
    }
    __syncthreads();
    if (!last_flag) return;
    __threadfence();
    const float* all = part + static_cast<long long>(bk) * S * MT * BN;
#pragma unroll
    for (int u = 0; u < MT * BN / 256; ++u) {
      float t = 0.f;
      for (int s_ = 0; s_ < S; ++s_)
        t += __ldcg(all + static_cast<long long>(s_) * MT * BN + tid +
                    u * 256);
      out[u] = t;
    }
  }
#pragma unroll
  for (int u = 0; u < MT * BN / 256; ++u) {
    const int e = tid + u * 256, m = m0 + e / BN, nn = n0 + e % BN;
    if (m < M && nn < N) y[static_cast<long long>(m) * N + nn] = out[u];
  }
}

// K2f (Q_NONE: w f32) or #10f (w int8 with scales s (G, N), G rows a
// group of K / G)
template <int Q>
int run_ba_f32(const float* x, const void* w, const float* a,
               const float* b, float* y, int M, int N, int K, int r,
               float alpha, const long long* st, int splits, float* ws,
               int* cnt, const float* s, int G, cudaStream_t stream) {
  const int nkc = (K + BA32_KC - 1) / BA32_KC;
  const int ks = (K + r + splits - 1) / splits;
  const int tn = (N + BA32_BN - 1) / BA32_BN, tm = (M + BA32_MT - 1) / BA32_MT;
  if (ks > BA32_MAX_ROWS || tm > 65535 || M > 65535 || splits > 65535)
    return (int)cudaErrorInvalidValue;
  float* pp = ws;
  float* part = ws + static_cast<long long>(M) * nkc * r;
  ba_f32_pre_kernel<<<dim3(nkc, M), 256, 0, stream>>>(x, a, pp, K, r, st[2],
                                                       st[3], st[4]);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long wsk = st[0], wsn = st[1], bsj = st[5], bsn = st[6];
  // 16-byte rows of f32 W and B; an int8 W's rows in 4-byte words, its
  // scale rows in 16 bytes
  const bool wvec = Q == Q_NONE
      ? wsk % 4 == 0 && aligned16(w)
      : wsk % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 4 == 0 &&
            aligned16(s);
  const bool vec = wsn == 1 && bsn == 1 && N % 4 == 0 && bsj % 4 == 0 &&
                   wvec && aligned16(b);
  const int smem = 4 * (BA32_WARPS * BA32_MT * BA32_BN + ks * BA32_MT);
  static int smem_set[2] = {0, 0};   // per instantiation, grows only
  if (smem > smem_set[vec]) {
    e = cudaFuncSetAttribute(vec ? ba_f32_kernel<true, Q>
                                 : ba_f32_kernel<false, Q>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return (int)e;
    smem_set[vec] = smem;
  }
  const dim3 grid(tn, tm, splits);
  const int group = G > 0 ? K / G : K;
  if (vec)
    ba_f32_kernel<true, Q><<<grid, 256, smem, stream>>>(
        x, w, pp, b, y, part, cnt, M, N, K, r, nkc, ks, alpha, wsk, wsn, bsj,
        bsn, s, group);
  else
    ba_f32_kernel<false, Q><<<grid, 256, smem, stream>>>(
        x, w, pp, b, y, part, cnt, M, N, K, r, nkc, ks, alpha, wsk, wsn, bsj,
        bsn, s, group);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (M, K) row-major, contiguous; w (K, N), a (K, r), b (r, N) read
// through their element strides (w: k, n; a: k, j; b: j, n — a transposed
// view is a stride swap, no copy); y (M, N) row-major; all bf16.
// variant 1: the `wgmma` kernel with P in registers (r <= 64); 2: the
// pre-pass into ws, a bf16 workspace of M · 2·rp elements (rp = r rounded
// up to 64), then the `wgmma` kernel over K + 2·rp (any r; the wrapper
// chooses, kernels/tt_linear.py).
int tt_linear_bf16(const void* x, const void* w, const void* a,
                   const void* b, void* y, int M, int N, int K, int r,
                   float alpha, const long long* strides, int variant,
                   void* ws, void* stream) {
  if (M < 1 || N < 1 || K < 1 || r < 1 || (M + LBM - 1) / LBM > 65535)
    return (int)cudaErrorInvalidValue;
  LinStrides ls;
  for (int i = 0; i < 6; ++i) ls.s[i] = strides[i];
  const long long wsk = ls.s[0], wsn = ls.s[1], ask = ls.s[2],
                  asj = ls.s[3], bsj = ls.s[4], bsn = ls.s[5];
  const bool wk = wsk == 1 && wsn != 1;   // W read as Wᵀ: K-major tiles
  const bool vw = wk ? K % 8 == 0 && wsn % 8 == 0
                     : wsn == 1 && N % 8 == 0 && wsk % 8 == 0;
  const int vx = K % 8 == 0 && aligned16(x) ? LV_X : 0;
  if (variant == 2) {
    if (ws == nullptr) return (int)cudaErrorInvalidValue;
    const int rp = round_up(r, LBK);
    const int e = k1_pre_pass(x, a, ws, M, K, r, alpha, ask, asj, stream);
    if (e != cudaSuccess) return e;
    const bool vb = bsn == 1 && N % 8 == 0 && bsj % 8 == 0 && aligned16(b);
    const int ev = vx | (vw && aligned16(w) ? LV_W : 0) | (vb ? LV_B : 0);
#define EXT_ARGS x, w, nullptr, b, y, M, N, K, r, 1.f, ls, ev, ws, rp, stream
    if (ev == (LV_X | LV_W | LV_B))
      return wk ? launch_wgmma<0, true, true, K1_EXT>(EXT_ARGS)
                : launch_wgmma<0, false, true, K1_EXT>(EXT_ARGS);
    return wk ? launch_wgmma<0, true, false, K1_EXT>(EXT_ARGS)
              : launch_wgmma<0, false, false, K1_EXT>(EXT_ARGS);
#undef EXT_ARGS
  }
  if (variant != 1 || r > RANK_WGMMA) return (int)cudaErrorInvalidValue;
  const int vec = vx | (vw && aligned16(w) ? LV_W : 0) |
                  (ask == 1 && asj % 8 == 0 && K % 8 == 0 && aligned16(a)
                       ? LV_A : 0);
  const bool all = vec == (LV_X | LV_W | LV_A);
#define K1_ARGS x, w, a, b, y, M, N, K, r, alpha, ls, vec, nullptr, 0, stream
  if (r <= 16)
    return wk ? (all ? launch_wgmma<16, true, true, K1_PLAIN>(K1_ARGS)
                     : launch_wgmma<16, true, false, K1_PLAIN>(K1_ARGS))
              : (all ? launch_wgmma<16, false, true, K1_PLAIN>(K1_ARGS)
                     : launch_wgmma<16, false, false, K1_PLAIN>(K1_ARGS));
  return wk ? (all ? launch_wgmma<64, true, true, K1_PLAIN>(K1_ARGS)
                   : launch_wgmma<64, true, false, K1_PLAIN>(K1_ARGS))
            : (all ? launch_wgmma<64, false, true, K1_PLAIN>(K1_ARGS)
                   : launch_wgmma<64, false, false, K1_PLAIN>(K1_ARGS));
#undef K1_ARGS
}

// The f32 instance: x (M, K) row-major, contiguous; w (K, N), a (K, r),
// b (r, N) read through their element strides (as tt_linear_bf16); y
// (M, N) row-major; all f32, FFMA throughout. ws: an f32 workspace of
// M · r elements for P = alpha·x·A (the pre-pass), then y = x·W + P·B.
int tt_linear_f32(const void* x, const void* w, const void* a, const void* b,
                  void* y, int M, int N, int K, int r, float alpha,
                  const long long* strides, void* ws, void* stream) {
  if (M < 1 || N < 1 || K < 1 || r < 1 || ws == nullptr)
    return (int)cudaErrorInvalidValue;
  const float* xf = static_cast<const float*>(x);
  float* p = static_cast<float*>(ws);
  const F32Seg none = {nullptr, 0, nullptr, 0, 0, 0};
  const F32Seg pre = {xf, K, static_cast<const float*>(a), strides[2],
                      strides[3], K};
  const int e = r <= 64
      ? launch_f32<64, 64, 4, 4>(pre, none, p, M, r, alpha, stream)
      : launch_f32<128, 128, 8, 8>(pre, none, p, M, r, alpha, stream);
  if (e != cudaSuccess) return e;
  const F32Seg base = {xf, K, static_cast<const float*>(w), strides[0],
                       strides[1], K};
  const F32Seg rank = {p, r, static_cast<const float*>(b), strides[4],
                       strides[5], r};
  return launch_f32<128, 128, 8, 8>(base, rank, static_cast<float*>(y), M, N,
                                    1.f, stream);
}

// K2's f32 instance: x (M, K) row-major, contiguous; w (K, N), a
// (M, K, r) and b (r, N) read through their element strides (7: w k, n;
// a m, k, j; b j, n); y (M, N) row-major; all f32, FFMA throughout; any M,
// N, K, r. The pre-pass, then the main kernel over `splits` slices of
// K + r rows (each at most 1024). ws: f32, M · ceil(K / 256) · r +
// ceil(N / 128) · ceil(M / 8) · 8 · 128 · splits (the slices' partials,
// splits > 1); cnt: ceil(N / 128) · ceil(M / 8) zeroed int counters (left
// at zero).
int tt_linear_batched_a_f32(const void* x, const void* w, const void* a,
                            const void* b, void* y, int M, int N, int K,
                            int r, float alpha, const long long* strides,
                            int splits, void* ws, void* cnt, void* stream) {
  if (M < 1 || N < 1 || K < 1 || r < 1 || splits < 1 || ws == nullptr ||
      (splits > 1 && cnt == nullptr))
    return (int)cudaErrorInvalidValue;
  return run_ba_f32<Q_NONE>(
      static_cast<const float*>(x), w, static_cast<const float*>(a),
      static_cast<const float*>(b), static_cast<float*>(y), M, N, K, r,
      alpha, strides, splits, static_cast<float*>(ws),
      static_cast<int*>(cnt), nullptr, 1, static_cast<cudaStream_t>(stream));
}

// #9's f32 instance: x (M, K) row-major, contiguous; w int8 (K, N), a
// (K, r), b (r, N) read through their element strides (6: w k, n; a k, j;
// b j, n); scale f32 (G, N) contiguous, G = 1 per output channel, G > 1
// per group of K / G rows; y (M, N) row-major f32; FFMA throughout, any
// M, N, K, r. ws: f32, M · r (P = alpha·x·A, K1f's pre-pass).
int tt_linear_w8_f32(const void* x, const void* w, const void* scale,
                     const void* a, const void* b, void* y, int M, int N,
                     int K, int r, int G, float alpha,
                     const long long* strides, void* ws, void* stream) {
  if (M < 1 || N < 1 || K < 1 || r < 1 || G < 1 || K % G != 0 ||
      ws == nullptr)
    return (int)cudaErrorInvalidValue;
  const float* xf = static_cast<const float*>(x);
  float* p = static_cast<float*>(ws);
  const F32Seg none = {nullptr, 0, nullptr, 0, 0, 0};
  const F32Seg pre = {xf, K, static_cast<const float*>(a), strides[2],
                      strides[3], K};
  const int e = r <= 64
      ? launch_f32<64, 64, 4, 4>(pre, none, p, M, r, alpha, stream)
      : launch_f32<128, 128, 8, 8>(pre, none, p, M, r, alpha, stream);
  if (e != cudaSuccess) return e;
  // segment 0's b is unused (the int8 W is read through wq); its strides
  // are W's
  const F32Seg base = {xf, K, nullptr, strides[0], strides[1], K};
  const F32Seg rank = {p, r, static_cast<const float*>(b), strides[4],
                       strides[5], r};
  const F32Q wq = {static_cast<const int8_t*>(w),
                   static_cast<const float*>(scale), K / G};
  float* yf = static_cast<float*>(y);
  return G > 1
      ? launch_f32<128, 128, 8, 8, Q_GROUP>(base, rank, yf, M, N, 1.f,
                                            stream, wq)
      : launch_f32<128, 128, 8, 8, Q_CHANNEL>(base, rank, yf, M, N, 1.f,
                                              stream, wq);
}

// #10's f32 instance: K2f's arguments with w int8 (K, N) read through
// its strides and scale f32 (G, N) contiguous (G = 1 per output channel,
// G > 1 per group of K / G rows); any M, N, K, r; ws and cnt as K2f's.
int tt_linear_batched_a_w8_f32(const void* x, const void* w,
                               const void* scale, const void* a,
                               const void* b, void* y, int M, int N, int K,
                               int r, int G, float alpha,
                               const long long* strides, int splits,
                               void* ws, void* cnt, void* stream) {
  if (M < 1 || N < 1 || K < 1 || r < 1 || G < 1 || K % G != 0 ||
      splits < 1 || ws == nullptr || (splits > 1 && cnt == nullptr))
    return (int)cudaErrorInvalidValue;
#define BA8_ARGS static_cast<const float*>(x), w, \
    static_cast<const float*>(a), static_cast<const float*>(b), \
    static_cast<float*>(y), M, N, K, r, alpha, strides, splits, \
    static_cast<float*>(ws), static_cast<int*>(cnt), \
    static_cast<const float*>(scale), G, static_cast<cudaStream_t>(stream)
  return G > 1 ? run_ba_f32<Q_GROUP>(BA8_ARGS)
               : run_ba_f32<Q_CHANNEL>(BA8_ARGS);
#undef BA8_ARGS
}

// K2, per-row A: x (M, K), w (K, N), a (M, K, r), b (r, N) contiguous,
// M <= 64, K % 8 == 0, N % 8 == 0, 16-byte aligned x, w and b; any r.
// The pre-pass, then the split-K `wgmma` kernel over `splits` <= 8
// slices of K (and, r > 64, of the 2·rp extension rows), one cluster a
// tile. ws: f32 M · ceil(K / 256) · r (r <= 64), else bf16 M · 2·rp.
int tt_linear_batched_a_bf16(const void* x, const void* w, const void* a,
                             const void* b, void* y, int M, int N, int K,
                             int r, float alpha, int splits, void* ws,
                             void* stream) {
  if (M < 1 || M > 64 || N < 1 || K < 1 || r < 1 || K % 8 != 0 ||
      N % 8 != 0 || !aligned16(x) || !aligned16(w) || !aligned16(b) ||
      splits < 1 || splits > QCLUSTER)
    return (int)cudaErrorInvalidValue;
  return run_batched_splitk<false>(x, w, nullptr, a, b, y, ws, M, N, K, r, 1,
                                   alpha, splits, stream);
}

// w8a16 (#9): w int8 (K, N) and scale f32 (G, N) contiguous; G = 1
// scales per output channel, G > 1 per group of K / G rows (a multiple of
// 64). K % 8 == 0, N % 16 == 0, x and w 16-byte aligned, scale 8-byte
// aligned; any r. a (K, r) and b (r, N) read through their element
// strides (a: k, j; b: j, n); above r = 64, b must be row-contiguous
// (b: N, 1) and 16-byte aligned, and ws is a bf16 workspace of M · 2·rp
// for K1's pre-pass. The split-K `wgmma` kernel over `splits` <= 8
// slices of K, one cluster a tile.
int tt_linear_w8_bf16(const void* x, const void* w, const void* scale,
                      const void* a, const void* b, void* y, int M, int N,
                      int K, int r, int G, float alpha,
                      const long long* strides, int splits, void* ws,
                      void* stream) {
  const float* s = static_cast<const float*>(scale);
  const int group = G > 0 ? K / G : 0;
  if (M < 1 || N < 1 || K < 1 || r < 1 || G < 1 || K % G != 0 ||
      K % 8 != 0 || N % 16 != 0 || !aligned16(x) || !aligned16(w) ||
      reinterpret_cast<uintptr_t>(scale) % 8 != 0 ||
      (G > 1 && group % QBK != 0) || splits < 1 || splits > QCLUSTER ||
      (M + QBM - 1) / QBM > 65535)
    return (int)cudaErrorInvalidValue;
  LinStrides ls;
  for (int i = 0; i < 6; ++i) ls.s[i] = strides[i];
  if (r > RANK_WGMMA) {
    if (ws == nullptr || ls.s[5] != 1 || ls.s[4] % 8 != 0 || !aligned16(b))
      return (int)cudaErrorInvalidValue;
    const int e = k1_pre_pass(x, a, ws, M, K, r, alpha, ls.s[2], ls.s[3],
                              stream);
    if (e != cudaSuccess) return e;
    return launch_ext<true>(x, w, s, b, y, ws, M, N, K, r, round_up(r, QBK),
                            G, splits, ls, stream);
  }
#define W8_ARGS x, w, s, a, b, y, nullptr, nullptr, M, N, K, r, 0, group, \
                splits, 0, alpha, ls, stream
  if (r <= 16)
    return G > 1 ? launch_splitk<16, true, false, true, false>(W8_ARGS)
                 : launch_splitk<16, false, false, true, false>(W8_ARGS);
  return G > 1 ? launch_splitk<64, true, false, true, false>(W8_ARGS)
               : launch_splitk<64, false, false, true, false>(W8_ARGS);
#undef W8_ARGS
}

// w8a16 with a per-row A (#10): x (M, K), a (M, K, r), b (r, N)
// contiguous, M <= 64; w and scale as #9's, b 16-byte aligned; any r.
// K2's pre-pass and workspace, then the split-K `wgmma` kernel over
// `splits` <= 8 slices of K, one cluster a tile.
int tt_linear_batched_a_w8_bf16(const void* x, const void* w,
                                const void* scale, const void* a,
                                const void* b, void* y, int M, int N, int K,
                                int r, int G, float alpha, int splits,
                                void* ws, void* stream) {
  const float* s = static_cast<const float*>(scale);
  if (M < 1 || M > 64 || N < 1 || K < 1 || r < 1 || G < 1 || K % G != 0 ||
      K % 8 != 0 || N % 16 != 0 || !aligned16(x) || !aligned16(w) ||
      !aligned16(b) || reinterpret_cast<uintptr_t>(scale) % 8 != 0 ||
      (G > 1 && (K / G) % QBK != 0) || splits < 1 || splits > QCLUSTER)
    return (int)cudaErrorInvalidValue;
  return run_batched_splitk<true>(x, w, s, a, b, y, ws, M, N, K, r, G, alpha,
                                  splits, stream);
}

}  // extern "C"
