// Flash-attention backward for Hopper (sm_90a): the two recompute passes.
//
// flash_attention_bwd_dq_bf16 replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention.py::flash_attention_bwd, dq pass
//   (_bwd_dq_kernel, the pallas_call at :295): dq = Σ_j ds·k over the KV
//   tiles at or below the causal diagonal. Its prologue also computes
//   D = rowsum(dO ⊙ O) for its rows (f32) and writes it for the second pass.
// flash_attention_bwd_dkv_bf16 replaces the dk/dv pass (_bwd_dkv_kernel,
//   the pallas_call at :310): dv = Σ_i pᵀ·dO and dk = Σ_i dsᵀ·q over the
//   G query heads of a KV head's group and the query tiles at or below the
//   diagonal — the GQA group sum happens in the accumulators, so no
//   head-repeated k/v is ever made.
//
// Both rebuild each probability tile from the forward's per-row lse:
//   s = q·kᵀ·scale, p = exp(s − lse), dp = dO·vᵀ, ds = p·(dp − D)·scale,
// so no (T, S) tensor exists in device memory. As in the TPU kernels, p
// and ds are rounded to bf16 before the products that consume them;
// keys ≥ S and query rows ≥ T are masked, causal masks ki > qi. There are
// no float atomics: each output element has one owner (the slab merge
// below adds in a fixed order), and the result is the same bit for bit
// from call to call.
//
// What bounds them on an H100: the two passes do seven products of 2·d
// flops per (query, key) pair — three in the dq pass (s, dp, dq), four in
// the dk/dv pass (s, dp, dv, dk) — against one read of q, k, v, o, dO, lse
// and D and one write of dq, dk, dv, D. At the training shape (B = 4,
// T = S = 1024, H = KV = 32, d = 64, causal) that is 25.8 GFLOP against
// 102 MB for the dq pass and 34.4 GFLOP against 102 MB for dk/dv: both
// bounds lie near 0.03 ms (989 TFLOP/s bf16, 3.35 TB/s), and only the
// tensor cores at a large share of their `wgmma` rate get near them.
//
// The design, for that: one warpgroup (128 threads) a block, owning 64
// rows (the `wgmma` M: queries in the dq pass, keys in the dk/dv pass),
// and several blocks an SM, so that one block's exp and masking overlap
// another's products with no barrier between them; and
//  - every product is `wgmma` m64nNk16 (bf16 in, f32 sums): s and dp with
//    both operands in shared memory; dq, dk and dv with A from registers —
//    p and ds are converted to bf16 in the accumulator layout, which is
//    the A-operand layout, so they never touch shared memory — and B
//    read transposed (the MN-major mode of bf16 `wgmma`) from the same
//    tile that fed s or dp;
//  - the f32 sums (dq; dk and dv) stay in registers for the whole loop,
//    with one bf16 epilogue;
//  - the streamed tiles (k and v in the dq pass; q, dO, lse and D in the
//    dk/dv pass) come through a ring of cp.async copies, the next tile in
//    flight while the tensor cores work on this one; rows past T or S are
//    zero-filled by the copy (source size 0) and masked;
//  - the tiles sit in shared memory in the 128-byte swizzled layout that
//    the `wgmma` descriptors read (16-byte chunk c of row r at c ^ (r % 8)),
//    which also keeps the row copies free of bank conflicts;
//  - under causal masking the longest blocks are launched first (the
//    last query tile of the dq pass, the first key tile of the dk/dv pass).
// The dq pass streams 64-key tiles (32 at d = 256) through a three-stage
// ring and waits for each tile's dq product only at the next tile; at
// d = 64 three blocks fit an SM. The dk/dv pass holds dk and dv (d/2 f32
// registers each a thread), two blocks an SM; it streams query tiles of
// 128 (32 at d = 128, to fit the register file) through a two-stage ring
// and turns Sᵀ and dPᵀ into P and dSᵀ in place. At d = 256 (gemma-7b)
// dk and dv need 256 registers a thread together: that pass runs two
// warpgroups a block, one owning each (flash_bwd_dkv_wg2_kernel below).
//
// Any GQA group (bf16). The dq pass reads KV head h / G; the dk/dv pass
// walks its group's G heads in one block. Where the (kv head, batch, key
// tile) blocks leave the SMs short — MQA: granite-34b's 48 heads over one
// KV head make 64 blocks at 4 x 1024 tokens, each walking 48 x 32 query
// tiles — the group is cut into slabs of heads on the grid's x dimension
// (blockIdx.x = kv head x slabs + slab). Each slab's block writes its f32
// dk/dv sums to a workspace and takes a ticket from an integer counter of
// its (batch, kv head, key tile); the last to arrive adds the slabs in
// slab order — a fixed f32 order, so two calls are bit-identical with no
// float atomics — resets the counter, and rounds to bf16 once, as #8's
// chunk merge does (csrc/paged_attention.cu). The wrapper picks the slab
// size (flash_attention.py::dkv_slab_heads); one slab is the unsplit pass.
// The f32 instances keep G in {1, 2, 4, 8}.
//
// Head_dim 112 (kimi-k2, 7168 / 64) runs the d = 128 passes on tiles
// padded in shared memory (template DR = 112), as the forward does
// (csrc/flash_attention.cu): each row of q, k, v and dO is read as 14
// chunks of 16 bytes and chunks 14-15 of the 128-wide swizzled tile are
// zero-filled, so S, dP and the dq / dk / dv products run unchanged (the
// zero columns add exact zeros to S and dP, and the padding columns of
// dq, dk and dv are never stored). The δ prologue sums exactly DR columns
// of O and dO (two halves of 56), the scale is 112^-0.5, and the slab
// workspace keeps whole 128-wide accumulators (sized by
// flash_attention.py::tile_dim).
//
// The C functions return cudaGetLastError() of the launch.

#include "attention_f32.cuh"
#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int WG = 128;       // threads in a warpgroup: one a block
constexpr int BM = 64;        // rows a block owns (the `wgmma` M)
constexpr int DQ_STAGES = 3;  // depth of the dq pass's cp.async ring
constexpr int DKV_STAGES = 2; // and of the dk/dv pass's

// keys per streamed tile of the dq pass: 64; 32 at d = 256, where dq's
// accumulator alone takes 128 f32 registers a thread (S and dP then take
// 16 each) and q, dO and three stages of k and v fit in 161 KB
template <int D>
__host__ __device__ constexpr int dq_bk() {
  return D == 256 ? 32 : 64;
}

// 18 element strides, passed to the kernel by value (batch, row, head of
// each of six operands)
struct Strides {
  long long s[18];
};

// ------------------------------------------------- shared-memory layouts
//
// An R-row tile of D bf16 columns is D / 64 column blocks of R rows of
// 128 bytes, each block 1024-byte aligned (the swizzle's repeat).

template <int D>
struct DqSmem {
  static constexpr int RES = BM * D * 2;           // resident q, dO
  static constexpr int STR = dq_bk<D>() * D * 2;   // streamed k, v
  static constexpr int Q = 0;
  static constexpr int G = Q + RES;
  static constexpr int K = G + RES;        // DQ_STAGES k tiles
  static constexpr int V = K + DQ_STAGES * STR;
  static constexpr int LSE = V + DQ_STAGES * STR;
  static constexpr int DLT = LSE + BM * 4;
  static constexpr int TOTAL = DLT + BM * 4;
  static_assert(RES % 1024 == 0 && STR % 1024 == 0,
                "tiles must keep the 1024-byte alignment of the swizzle");
};

template <int D, int BN>
struct DkvSmem {
  static constexpr int RES = BM * D * 2;   // resident k, v
  static constexpr int STR = BN * D * 2;   // streamed q, dO
  static constexpr int K = 0;
  static constexpr int V = K + RES;
  static constexpr int Q = V + RES;        // DKV_STAGES q tiles
  static constexpr int G = Q + DKV_STAGES * STR;
  static constexpr int LSE = G + DKV_STAGES * STR;   // DKV_STAGES x BN f32
  static constexpr int DLT = LSE + DKV_STAGES * BN * 4;
  static constexpr int TOTAL = DLT + DKV_STAGES * BN * 4;
  static_assert(RES % 1024 == 0 && STR % 1024 == 0,
                "tiles must keep the 1024-byte alignment of the swizzle");
};

// ------------------------------------------------------------- dq pass
//
// One warpgroup a block, per (query tile of 64, head, batch); q and dO of
// the tile stay in shared memory. k and v tiles of 64 keys stream through
// the ring, up to the causal diagonal. Three blocks fit an SM at d = 64.

// DR: the operands' head_dim; D: the tile width, DR padded to the next
// multiple of 64 (112 runs as 128, its columns past 112 zero in shared
// memory and never stored)
template <int D, int DR = D>
__global__ void __launch_bounds__(WG, D == 64 ? 3 : 1)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ o,
                    const bf16* __restrict__ g,
                    const float* __restrict__ lse, float* __restrict__ delta,
                    bf16* __restrict__ dq, int T, int S, int H, int KV,
                    int causal, float scale, const Strides sd) {
  using L = DqSmem<D>;
  constexpr int KT = dq_bk<D>();   // keys a streamed tile
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  float* lse_s = reinterpret_cast<float*>(smem + L::LSE);
  float* dlt_s = reinterpret_cast<float*>(smem + L::DLT);

  const int tid = threadIdx.x;
  const int h = blockIdx.x, bb = blockIdx.y;
  const int nqt = (T + BM - 1) / BM;   // longest tiles first under causal
  const int q0 = (causal ? nqt - 1 - (int)blockIdx.z : (int)blockIdx.z) * BM;
  const int kvh = h / (H / KV);

  // element strides: q, k, v, o, g, dq — (batch, row, head) each
  const bf16* qb = q + bb * sd.s[0] + h * sd.s[2];
  const bf16* kb = k + bb * sd.s[3] + kvh * sd.s[5];
  const bf16* vb = v + bb * sd.s[6] + kvh * sd.s[8];
  const bf16* ob = o + bb * sd.s[9] + h * sd.s[11];
  const bf16* gb = g + bb * sd.s[12] + h * sd.s[14];

  const int kv_end = causal ? min(S, q0 + BM) : S;
  const int nkv = (kv_end + KT - 1) / KT;
  load_tile<BM, D, WG, DR>(base + L::Q, qb, sd.s[1], q0, T, tid);
  load_tile<BM, D, WG, DR>(base + L::G, gb, sd.s[13], q0, T, tid);
  auto issue = [&](int j) {
    const int st = j % DQ_STAGES;
    load_tile<KT, D, WG, DR>(base + L::K + st * L::STR, kb, sd.s[4], j * KT,
                             S, tid);
    load_tile<KT, D, WG, DR>(base + L::V + st * L::STR, vb, sd.s[7], j * KT,
                             S, tid);
  };
  issue(0);
  cp_async_commit();

  {  // D = rowsum(dO ⊙ O) in f32: two threads a row, half of the DR real
     // columns each (56 at DR = 112: 7 chunks of 16 bytes)
    static_assert(DR % 16 == 0, "two halves of whole 16-byte chunks");
    const int row = tid >> 1, half = tid & 1, qi = q0 + row;
    float acc = 0.f;
    if (qi < T) {
      const bf16* orow = ob + qi * sd.s[10] + half * (DR / 2);
      const bf16* grow = gb + qi * sd.s[13] + half * (DR / 2);
#pragma unroll
      for (int c = 0; c < DR / 2; c += 8) {
        const uint4 uo = *reinterpret_cast<const uint4*>(orow + c);
        const uint4 ug = *reinterpret_cast<const uint4*>(grow + c);
        const bf16* eo = reinterpret_cast<const bf16*>(&uo);
        const bf16* eg = reinterpret_cast<const bf16*>(&ug);
#pragma unroll
        for (int t = 0; t < 8; ++t)
          acc += __bfloat162float(eg[t]) * __bfloat162float(eo[t]);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) {
      dlt_s[row] = acc;
      lse_s[row] = 0.f;
      if (qi < T) {
        const size_t rowid = (static_cast<size_t>(bb) * H + h) * T + qi;
        lse_s[row] = lse[rowid];
        delta[rowid] = acc;
      }
    }
  }
  __syncthreads();

  // this thread's accumulator rows ra and ra + 8 of the block's 64
  const int lane = tid & 31, warp = tid >> 5;
  const int ra = warp * 16 + (lane >> 2), ca = 2 * (lane & 3);
  const int qa = q0 + ra, qb8 = qa + 8;
  const float lse2[2] = {lse_s[ra] * LOG2E, lse_s[ra + 8] * LOG2E};
  const float dlt[2] = {dlt_s[ra], dlt_s[ra + 8]};
  const float sl2 = scale * LOG2E;

  float dqa[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dqa[i] = 0.f;

  for (int j = 0; j < nkv; ++j) {
    const int st = j % DQ_STAGES;
    if (j + 1 < nkv) issue(j + 1);
    cp_async_commit();
    cp_async_wait<1>();   // tile j (and, at j = 0, q and dO) has landed
    fence_proxy_async();
    __syncthreads();

    const int k0 = j * KT;
    const uint32_t kt = base + L::K + st * L::STR;
    const uint32_t vt = base + L::V + st * L::STR;
    float s[KT / 2], dp[KT / 2];
    reg_fence(s);
    reg_fence(dp);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)   // S = Q·Kᵀ
      WgSS<KT>::mma(s, desc_k<BM>(base + L::Q, 0, kk), desc_k<KT>(kt, 0, kk),
                    kk);
    wg_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)   // dP = dO·Vᵀ
      WgSS<KT>::mma(dp, desc_k<BM>(base + L::G, 0, kk),
                    desc_k<KT>(vt, 0, kk), kk);
    wg_commit();

    wg_wait<1>();   // S, and the previous tile's dQ product, are done
    reg_fence(s);
    const bool edge = k0 + KT > S || q0 + BM > T ||
                      (causal && k0 + KT - 1 > q0);
#pragma unroll
    for (int c = 0; c < KT / 8; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ki = k0 + 8 * c + ca + (e & 1), qi = e < 2 ? qa : qb8;
        float p = ex2(s[4 * c + e] * sl2 - lse2[e >> 1]);
        if (edge && !(qi < T && ki < S && (!causal || qi >= ki))) p = 0.f;
        s[4 * c + e] = p;
      }
    wg_wait<0>();
    reg_fence(dp);
#pragma unroll
    for (int i = 0; i < KT / 2; ++i)
      s[i] = s[i] * (dp[i] - dlt[(i >> 1) & 1]) * scale;   // dS
    uint32_t da[KT / 16][4];
    to_a<KT>(da, s);
    reg_fence(da);
    reg_fence(dqa);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk)   // dQ += dS·K
      WgRS<D>::mma(dqa, da[kk], desc_mn<KT>(kt, kk));
    wg_commit();   // waited for at the next tile: the ring's third stage
    __syncthreads();   // keeps tile j until then; stage st - 1 is free
  }
  cp_async_wait<0>();
  wg_wait<0>();
  reg_fence(dqa);

  bf16* out = dq + bb * sd.s[15] + h * sd.s[17];
#pragma unroll
  for (int c = 0; c < DR / 8; ++c)   // the DR real columns only
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int qi = hh ? qb8 : qa;
      if (qi < T)
        *reinterpret_cast<__nv_bfloat162*>(out + qi * sd.s[16] + 8 * c + ca) =
            __floats2bfloat162_rn(dqa[4 * c + 2 * hh],
                                  dqa[4 * c + 2 * hh + 1]);
    }
}

// ------------------------------------------------- slabs of a GQA group
//
// A dk/dv block's slab: blockIdx.x = kv head x nslab + slab, where slab s
// holds heads [s·hs, min((s + 1)·hs, G)) of the group. The unsplit
// instance (SLABS false) has one slab of all G, blockIdx.x = kv head.
struct Slab {
  int kvh, slab, nslab, h0, nh;
};

template <bool SLABS>
__device__ __forceinline__ Slab slab_of(int H, int KV, int hs) {
  const int grp = H / KV;
  Slab s;
  if (!SLABS) {
    s.kvh = blockIdx.x;
    s.slab = 0;
    s.nslab = 1;
    s.h0 = s.kvh * grp;
    s.nh = grp;
    return s;
  }
  s.nslab = gridDim.x / KV;
  s.kvh = blockIdx.x / s.nslab;
  s.slab = blockIdx.x - s.kvh * s.nslab;
  s.h0 = s.kvh * grp + s.slab * hs;
  s.nh = min(hs, grp - s.slab * hs);
  return s;
}

// N f32 sums a thread, NT threads, out to one slab's slot of the
// workspace: float4 i of thread t at i·NT + t
template <int N, int NT>
__device__ __forceinline__ void ws_put(float4* dst, const float (&a)[N],
                                       int tid) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i)
    dst[i * NT + tid] =
        make_float4(a[4 * i], a[4 * i + 1], a[4 * i + 2], a[4 * i + 3]);
}

// The last slab's block: one of dk / dv (its DR real columns of the
// accumulator) from the workspace, the nslab slots (``stride`` float4s
// apart) added in slab order, rounded to bf16 once. Float4 i of a thread
// holds its accumulator entries 4i..4i + 3: columns 8i + ca, + 1 of its
// rows key0 and key1, as the unsplit epilogue stores them. A loop over i,
// not unrolled: the accumulators are dead here, and the merge keeps few
// registers.
template <int DR, int NT>
__device__ __noinline__ void store_merged(const float4* part, int stride,
                                          int nslab, int tid, int ca,
                                          int key0, int key1, int S,
                                          bf16* out, long long rs) {
#pragma unroll 1
  for (int i = 0; i < DR / 8; ++i) {
    float4 a = __ldcg(part + i * NT + tid);
    for (int s = 1; s < nslab; ++s) {
      const float4 t = __ldcg(part + s * stride + i * NT + tid);
      a.x += t.x;
      a.y += t.y;
      a.z += t.z;
      a.w += t.w;
    }
    if (key0 < S)
      *reinterpret_cast<__nv_bfloat162*>(out + key0 * rs + 8 * i + ca) =
          __floats2bfloat162_rn(a.x, a.y);
    if (key1 < S)
      *reinterpret_cast<__nv_bfloat162*>(out + key1 * rs + 8 * i + ca) =
          __floats2bfloat162_rn(a.z, a.w);
  }
}

// after this block's ws_put: true in every thread of the last of n blocks
// of counter id to arrive (which resets it for the next launch)
__device__ __forceinline__ bool last_to_arrive(int* cnt, int id, int n) {
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(cnt + id, 1) == n - 1;
    if (last) cnt[id] = 0;
  }
  __syncthreads();
  if (!last) return false;
  __threadfence();
  return true;
}

// ----------------------------------------------------------- dk/dv pass
//
// One warpgroup a block, per (key tile of 64, kv head or slab of its
// group, batch); k and v of the tile stay in shared memory. For each of
// the slab's query heads, the q, dO, lse and D tiles of BN queries stream
// through the ring, from the causal diagonal on.

template <int D, int BN, bool SLABS, int DR = D>
__global__ void __launch_bounds__(WG, 2)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ g,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int T, int S, int H, int KV,
                     int causal, float scale, const Strides sd, int hs,
                     float* __restrict__ ws, int* __restrict__ cnt) {
  using L = DkvSmem<D, BN>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const unsigned char* smem = smem_raw + (base - raw);

  const int tid = threadIdx.x;
  const Slab sl = slab_of<SLABS>(H, KV, hs);
  const int kvh = sl.kvh, bb = blockIdx.y;
  const int k0 = blockIdx.z * BM;   // key tile 0, the longest, first

  // work items (slab head, query tile), query tiles from the first one
  // that reaches this block's keys
  const int nq = (T + BN - 1) / BN;
  const int i0 = causal ? min(k0 / BN, nq) : 0;
  const int per_head = nq - i0;
  const int n_items = sl.nh * per_head;

  // element strides: q, k, v, g, dk, dv — (batch, row, head) each
  load_tile<BM, D, WG, DR>(base + L::K, k + bb * sd.s[3] + kvh * sd.s[5],
                           sd.s[4], k0, S, tid);
  load_tile<BM, D, WG, DR>(base + L::V, v + bb * sd.s[6] + kvh * sd.s[8],
                           sd.s[7], k0, S, tid);
  auto issue = [&](int it) {
    const int st = it % DKV_STAGES;
    const int h = sl.h0 + it / per_head;
    const int q0 = (i0 + it % per_head) * BN;
    load_tile<BN, D, WG, DR>(base + L::Q + st * L::STR,
                             q + bb * sd.s[0] + h * sd.s[2], sd.s[1], q0, T,
                             tid);
    load_tile<BN, D, WG, DR>(base + L::G + st * L::STR,
                             g + bb * sd.s[9] + h * sd.s[11], sd.s[10], q0, T,
                             tid);
    for (int x = tid; x < 2 * BN; x += WG) {   // lse and D, zero past T
      const int c = x % BN, qi = q0 + c;
      const size_t row = (static_cast<size_t>(bb) * H + h) * T + min(qi, T - 1);
      cp_async4(base + (x < BN ? L::LSE : L::DLT) + (st * BN + c) * 4,
                (x < BN ? lse : delta) + row, qi < T ? 4 : 0);
    }
  };
  if (n_items > 0) issue(0);
  cp_async_commit();

  const int lane = tid & 31, warp = tid >> 5;
  const int ra = warp * 16 + (lane >> 2), ca = 2 * (lane & 3);
  const int key[2] = {k0 + ra, k0 + ra + 8};
  const float sl2 = scale * LOG2E;
  const uint32_t kt = base + L::K, vt = base + L::V;

  float dka[D / 2], dva[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;

  for (int it = 0; it < n_items; ++it) {
    const int st = it % DKV_STAGES;
    if (it + 1 < n_items) issue(it + 1);
    cp_async_commit();
    cp_async_wait<1>();   // item it (and, at it = 0, k and v) has landed
    fence_proxy_async();
    __syncthreads();

    const int q0 = (i0 + it % per_head) * BN;
    const uint32_t qt = base + L::Q + st * L::STR;
    const uint32_t gt = base + L::G + st * L::STR;
    const float* lse_t = reinterpret_cast<const float*>(smem + L::LSE) +
                         st * BN;
    const float* dlt_t = reinterpret_cast<const float*>(smem + L::DLT) +
                         st * BN;
    float s[BN / 2], dp[BN / 2];
    reg_fence(s);
    reg_fence(dp);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)   // Sᵀ = K·Qᵀ
      WgSS<BN>::mma(s, desc_k<BM>(kt, 0, kk), desc_k<BN>(qt, 0, kk), kk);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)   // dPᵀ = V·dOᵀ
      WgSS<BN>::mma(dp, desc_k<BM>(vt, 0, kk), desc_k<BN>(gt, 0, kk), kk);
    wg_commit();
    wg_wait<0>();
    reg_fence(s);
    reg_fence(dp);
    const bool edge = q0 + BN > T || k0 + BM > S ||
                      (causal && q0 < k0 + BM - 1);
#pragma unroll
    for (int c = 0; c < BN / 8; ++c)   // P and dSᵀ in place of Sᵀ and dPᵀ
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = 8 * c + ca + (e & 1), qi = q0 + qc, ki = key[e >> 1];
        const int i = 4 * c + e;
        float p = ex2(s[i] * sl2 - lse_t[qc] * LOG2E);
        if (edge && !(qi < T && ki < S && (!causal || qi >= ki))) p = 0.f;
        s[i] = p;
        dp[i] = p * (dp[i] - dlt_t[qc]) * scale;
      }
    uint32_t pa[BN / 16][4], da[BN / 16][4];
    to_a<BN>(pa, s);
    to_a<BN>(da, dp);
    reg_fence(pa);
    reg_fence(da);
    reg_fence(dva);
    reg_fence(dka);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)   // dV += Pᵀ·dO
      WgRS<D>::mma(dva, pa[kk], desc_mn<BN>(gt, kk));
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)   // dK += dSᵀ·Q
      WgRS<D>::mma(dka, da[kk], desc_mn<BN>(qt, kk));
    wg_commit();
    wg_wait<0>();
    __syncthreads();   // stage st is free again
  }
  cp_async_wait<0>();
  reg_fence(dka);
  reg_fence(dva);

  bf16* odk = dk + bb * sd.s[12] + kvh * sd.s[14];
  bf16* odv = dv + bb * sd.s[15] + kvh * sd.s[17];
  if (SLABS) {   // the group's slabs, added in slab order
    constexpr int PER = D / 8 * WG;   // float4s of one accumulator
    const int id = (bb * KV + kvh) * gridDim.z + blockIdx.z;
    float4* part = reinterpret_cast<float4*>(ws) +
                   static_cast<long long>(id) * sl.nslab * 2 * PER;
    ws_put<D / 2, WG>(part + sl.slab * 2 * PER, dka, tid);
    ws_put<D / 2, WG>(part + sl.slab * 2 * PER + PER, dva, tid);
    if (!last_to_arrive(cnt, id, sl.nslab)) return;
    store_merged<DR, WG>(part, 2 * PER, sl.nslab, tid, ca, key[0], key[1],
                         S, odk, sd.s[13]);
    store_merged<DR, WG>(part + PER, 2 * PER, sl.nslab, tid, ca, key[0],
                         key[1], S, odv, sd.s[16]);
    return;
  }
#pragma unroll
  for (int c = 0; c < DR / 8; ++c)   // the DR real columns only
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int ki = key[hh];
      if (ki < S) {
        const int col = 8 * c + ca, i = 4 * c + 2 * hh;
        *reinterpret_cast<__nv_bfloat162*>(odk + ki * sd.s[13] + col) =
            __floats2bfloat162_rn(dka[i], dka[i + 1]);
        *reinterpret_cast<__nv_bfloat162*>(odv + ki * sd.s[16] + col) =
            __floats2bfloat162_rn(dva[i], dva[i + 1]);
      }
    }
}

// ------------------------------------------------- dk/dv pass at d = 256
//
// At d = 256, dk and dv are 64 x 256 f32 each: 128 registers a thread
// each in one warpgroup, 256 together, more than a thread may hold. So a
// block has two warpgroups over the same 64 keys, one owning dv and one
// dk, each with half of the products of a query tile:
//   warpgroup 1: Sᵀ = K·Qᵀ, P = exp(Sᵀ − lse) masked, dV += Pᵀ·dO;
//   warpgroup 0: dPᵀ = V·dOᵀ, dSᵀ = P ⊙ (dPᵀ − D)·scale, dK += dSᵀ·Q.
// P crosses from one to the other through shared memory in f32, each
// thread's values at its own slots (thread t of both warpgroups holds the
// same accumulator positions), so dS is formed from the f32 p, as in the
// one-warpgroup pass. Neither product is done twice (the other way out, a
// split of d over two blocks, recomputes S and dP in each). A thread
// holds one 128-register accumulator, one 32-register score tile and its
// 16-register bf16 A fragments. Query tiles of 64 (q, dO: 32 KB each)
// stream through a two-stage ring beside the resident k and v (64 KB) and
// the 16 KB exchange: 209 KB, one block an SM. No atomics; the GQA group
// is summed in the accumulators in head order.

// the one-warpgroup pass's layout, then the exchange of P, [i][thread]
template <int D, int BN>
struct Dkv2Smem : DkvSmem<D, BN> {
  static constexpr int PX = DkvSmem<D, BN>::TOTAL;
  static constexpr int TOTAL = PX + (BN / 2) * WG * 4;
  static_assert(TOTAL + 1024 <= 227 * 1024, "fits in a block");
};

template <int D, int BN, bool SLABS>
__global__ void __launch_bounds__(2 * WG, 1)
flash_bwd_dkv_wg2_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ g,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int T,
                         int S, int H, int KV, int causal, float scale,
                         const Strides sd, int hs, float* __restrict__ ws,
                         int* __restrict__ cnt) {
  using L = Dkv2Smem<D, BN>;
  constexpr int NT = 2 * WG;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  float* px = reinterpret_cast<float*>(smem + L::PX);

  const int tid = threadIdx.x, wg = tid / WG, wt = tid % WG;
  const Slab sl = slab_of<SLABS>(H, KV, hs);
  const int kvh = sl.kvh, bb = blockIdx.y;
  const int k0 = blockIdx.z * BM;   // key tile 0, the longest, first
  const int nq = (T + BN - 1) / BN;
  const int i0 = causal ? min(k0 / BN, nq) : 0;
  const int per_head = nq - i0;
  const int n_items = sl.nh * per_head;

  // element strides: q, k, v, g, dk, dv — (batch, row, head) each
  load_tile<BM, D, NT>(base + L::K, k + bb * sd.s[3] + kvh * sd.s[5],
                       sd.s[4], k0, S, tid);
  load_tile<BM, D, NT>(base + L::V, v + bb * sd.s[6] + kvh * sd.s[8],
                       sd.s[7], k0, S, tid);
  auto issue = [&](int it) {
    const int st = it % DKV_STAGES;
    const int h = sl.h0 + it / per_head;
    const int q0 = (i0 + it % per_head) * BN;
    load_tile<BN, D, NT>(base + L::Q + st * L::STR,
                         q + bb * sd.s[0] + h * sd.s[2], sd.s[1], q0, T, tid);
    load_tile<BN, D, NT>(base + L::G + st * L::STR,
                         g + bb * sd.s[9] + h * sd.s[11], sd.s[10], q0, T,
                         tid);
    for (int x = tid; x < 2 * BN; x += NT) {   // lse and D, zero past T
      const int c = x % BN, qi = q0 + c;
      const size_t row = (static_cast<size_t>(bb) * H + h) * T + min(qi, T - 1);
      cp_async4(base + (x < BN ? L::LSE : L::DLT) + (st * BN + c) * 4,
                (x < BN ? lse : delta) + row, qi < T ? 4 : 0);
    }
  };
  if (n_items > 0) issue(0);
  cp_async_commit();

  const int lane = wt & 31, warp = wt >> 5;
  const int ra = warp * 16 + (lane >> 2), ca = 2 * (lane & 3);
  const int key[2] = {k0 + ra, k0 + ra + 8};
  const float sl2 = scale * LOG2E;
  // warpgroup 1: Sᵀ = K·Qᵀ and dV; warpgroup 0: dPᵀ = V·dOᵀ and dK
  const uint32_t at = base + (wg ? L::K : L::V);

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  for (int it = 0; it < n_items; ++it) {
    const int st = it % DKV_STAGES;
    if (it + 1 < n_items) issue(it + 1);
    cp_async_commit();
    cp_async_wait<1>();   // item it (and, at it = 0, k and v) has landed
    fence_proxy_async();
    __syncthreads();

    const int q0 = (i0 + it % per_head) * BN;
    const uint32_t qt = base + L::Q + st * L::STR;
    const uint32_t gt = base + L::G + st * L::STR;
    const float* lse_t = reinterpret_cast<const float*>(smem + L::LSE) +
                         st * BN;
    const float* dlt_t = reinterpret_cast<const float*>(smem + L::DLT) +
                         st * BN;
    const uint32_t bt = wg ? qt : gt;   // Sᵀ's Qᵀ, dPᵀ's dOᵀ
    float s[BN / 2];
    reg_fence(s);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      WgSS<BN>::mma(s, desc_k<BM>(at, 0, kk), desc_k<BN>(bt, 0, kk), kk);
    wg_commit();
    wg_wait<0>();
    reg_fence(s);
    if (wg) {   // P in place of Sᵀ, and out to warpgroup 0
      const bool edge = q0 + BN > T || k0 + BM > S ||
                        (causal && q0 < k0 + BM - 1);
#pragma unroll
      for (int c = 0; c < BN / 8; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = 8 * c + ca + (e & 1), qi = q0 + qc, ki = key[e >> 1];
          const int i = 4 * c + e;
          float p = ex2(s[i] * sl2 - lse_t[qc] * LOG2E);
          if (edge && !(qi < T && ki < S && (!causal || qi >= ki))) p = 0.f;
          s[i] = p;
          px[i * WG + wt] = p;
        }
    }
    __syncthreads();   // P is in shared memory
    if (!wg) {         // dSᵀ in place of dPᵀ
#pragma unroll
      for (int c = 0; c < BN / 8; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * c + e;
          s[i] = px[i * WG + wt] * (s[i] - dlt_t[8 * c + ca + (e & 1)]) *
                 scale;
        }
    }
    uint32_t fa[BN / 16][4];
    to_a<BN>(fa, s);
    reg_fence(fa);
    reg_fence(acc);
    wg_fence();
    // dV += Pᵀ·dO (warpgroup 1), dK += dSᵀ·Q (warpgroup 0)
    const uint32_t mt = wg ? gt : qt;
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      WgRS<D>::mma(acc, fa[kk], desc_mn<BN>(mt, kk));
    wg_commit();
    wg_wait<0>();
    __syncthreads();   // stage st and the exchange are free again
  }
  cp_async_wait<0>();
  reg_fence(acc);

  bf16* out = wg ? dv + bb * sd.s[15] + kvh * sd.s[17]
                 : dk + bb * sd.s[12] + kvh * sd.s[14];
  const long long rs = wg ? sd.s[16] : sd.s[13];
  if (SLABS) {   // the group's slabs, added in slab order
    constexpr int PER = D / 8 * NT;   // float4s of the block's dk and dv
    const int id = (bb * KV + kvh) * gridDim.z + blockIdx.z;
    float4* part = reinterpret_cast<float4*>(ws) +
                   static_cast<long long>(id) * sl.nslab * PER;
    ws_put<D / 2, NT>(part + sl.slab * PER, acc, tid);
    if (!last_to_arrive(cnt, id, sl.nslab)) return;
    store_merged<D, NT>(part, PER, sl.nslab, tid, ca, key[0], key[1], S,
                        out, rs);
    return;
  }
#pragma unroll
  for (int c = 0; c < D / 8; ++c)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int ki = key[hh];
      if (ki < S) {
        const int i = 4 * c + 2 * hh;
        *reinterpret_cast<__nv_bfloat162*>(out + ki * rs + 8 * c + ca) =
            __floats2bfloat162_rn(acc[i], acc[i + 1]);
      }
    }
}

template <int D, int DR = D>
int launch_dq(const void* q, const void* k, const void* v, const void* o,
              const void* g, const void* lse, void* delta, void* dq, int B,
              int T, int S, int H, int KV, int causal, const Strides& st,
              void* stream) {
  constexpr int smem = DqSmem<D>::TOTAL + 1024;   // + the alignment slack
  static bool done = false;
  cudaError_t e = allow_smem(flash_bwd_dq_kernel<D, DR>, smem, &done);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(H, B, (T + BM - 1) / BM);
  flash_bwd_dq_kernel<D, DR>
      <<<grid, WG, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), static_cast<const bf16*>(o),
          static_cast<const bf16*>(g), static_cast<const float*>(lse),
          static_cast<float*>(delta), static_cast<bf16*>(dq), T, S, H, KV,
          causal, 1.0f / sqrtf((float)DR), st);   // the real head_dim's scale
  return (int)cudaGetLastError();
}

// query tile of the dk/dv pass: 128 at d = 64; 32 at d = 128, where dk
// and dv take 64 f32 registers each a thread; 64 at d = 256, where each
// of two warpgroups holds one of them (flash_bwd_dkv_wg2_kernel)
template <int D>
constexpr int dkv_bn() {
  return D == 64 ? 128 : D == 128 ? 32 : 64;
}

// hs heads a slab of each GQA group: nslab = ⌈G / hs⌉ blocks a (kv head,
// batch, key tile); above one slab ws holds B·KV·⌈S/64⌉·nslab·128·D f32
// and cnt B·KV·⌈S/64⌉ zeroed int counters (left at zero); D the tile
// width, DR the operands' head_dim
template <int D, int DR = D>
int launch_dkv(const void* q, const void* k, const void* v, const void* g,
               const void* lse, const void* delta, void* dk, void* dv, int B,
               int T, int S, int H, int KV, int causal, const Strides& st,
               int hs, void* ws, void* cnt, void* stream) {
  constexpr int BN = dkv_bn<D>();
  const int grp = H / KV;
  if (hs < 1 || hs > grp) hs = grp;
  const int nslab = (grp + hs - 1) / hs;
  if (nslab > 1 && (ws == nullptr || cnt == nullptr))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(KV * nslab, B, (S + BM - 1) / BM);
  auto launch = [&](auto kern, int threads, int smem, bool* done) {
    cudaError_t e = allow_smem(kern, smem, done);
    if (e != cudaSuccess) return (int)e;
    kern<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(g),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<bf16*>(dk), static_cast<bf16*>(dv), T, S, H, KV, causal,
        1.0f / sqrtf((float)DR), st, hs, static_cast<float*>(ws),
        static_cast<int*>(cnt));
    return (int)cudaGetLastError();
  };
  static bool done[2] = {false, false};
  if constexpr (D == 256) {   // two warpgroups: dk and dv apart
    constexpr int smem = Dkv2Smem<D, BN>::TOTAL + 1024;
    return nslab > 1
               ? launch(flash_bwd_dkv_wg2_kernel<D, BN, true>, 2 * WG, smem,
                        &done[1])
               : launch(flash_bwd_dkv_wg2_kernel<D, BN, false>, 2 * WG, smem,
                        &done[0]);
  } else {
    constexpr int smem = DkvSmem<D, BN>::TOTAL + 1024;
    return nslab > 1
               ? launch(flash_bwd_dkv_kernel<D, BN, true, DR>, WG, smem,
                        &done[1])
               : launch(flash_bwd_dkv_kernel<D, BN, false, DR>, WG, smem,
                        &done[0]);
  }
}

// ------------------------------------------------ backward in f32 (FFMA)
//
// flash_attention_bwd_dq_f32 / _dkv_f32: the f32 instances of the same two
// passes, for RoBERTa's f32 training. They compute in f32 (FFMA through
// attention_f32.cuh's tiles; p and ds stay f32 into the products that
// consume them) with the recompute, masking and ownership of the bf16
// passes: one block of 256 threads owns 64 rows (queries in the dq pass,
// keys in the dk/dv pass), sums in registers over the whole loop, no
// atomics, the GQA group summed in the dk/dv accumulators — the same bits
// from call to call. At the training shape (B = 4, T = S = 1024,
// H = KV = 16, d = 64, causal) the passes do 12.9 and 17.2 GFLOP: 0.19 and
// 0.26 ms at FFMA's 67 TFLOP/s.

namespace af = attn_f32;

// dq pass: q, dO, k, v tiles and the (64, 64) ds tile
template <int D>
struct F32DqSmem {
  static constexpr int Q = 0;
  static constexpr int G = Q + af::tile_floats<D>();
  static constexpr int K = G + af::tile_floats<D>();
  static constexpr int V = K + af::tile_floats<D>();
  static constexpr int DS = V + af::tile_floats<D>();
  static constexpr int LSE = DS + af::score_floats();
  static constexpr int DLT = LSE + af::ROWS;
  static constexpr int BYTES = 4 * (DLT + af::ROWS);
};

template <int D>
__global__ void __launch_bounds__(af::THREADS)
flash_bwd_dq_f32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ o,
                        const float* __restrict__ g,
                        const float* __restrict__ lse,
                        float* __restrict__ delta, float* __restrict__ dq,
                        int T, int S, int H, int KV, int causal, float scale,
                        const Strides sd) {
  using L = F32DqSmem<D>;
  extern __shared__ __align__(16) float smf[];
  float *qs = smf + L::Q, *gs = smf + L::G, *ks = smf + L::K,
        *vs = smf + L::V, *dss = smf + L::DS, *lse_s = smf + L::LSE,
        *dlt_s = smf + L::DLT;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int h = blockIdx.x, bb = blockIdx.y;
  const int nqt = (T + af::ROWS - 1) / af::ROWS;
  const int q0 =
      (causal ? nqt - 1 - (int)blockIdx.z : (int)blockIdx.z) * af::ROWS;
  const int kvh = h / (H / KV);
  // element strides: q, k, v, o, g, dq — (batch, row, head) each
  const float* qb = q + bb * sd.s[0] + h * sd.s[2];
  const float* kb = k + bb * sd.s[3] + kvh * sd.s[5];
  const float* vb = v + bb * sd.s[6] + kvh * sd.s[8];
  const float* ob = o + bb * sd.s[9] + h * sd.s[11];
  const float* gb = g + bb * sd.s[12] + h * sd.s[14];
  const size_t row0 = (static_cast<size_t>(bb) * H + h) * T;

  af::load_tile<D>(qs, qb, sd.s[1], q0, T);
  af::load_tile<D>(gs, gb, sd.s[13], q0, T);
  {  // D = rowsum(dO ⊙ O): four threads a row, then the lse of the rows
    const int r = tid / 4, part = tid % 4, qi = q0 + r;
    float acc = 0.f;
    if (qi < T) {
      const float* orow = ob + qi * sd.s[10];
      const float* grow = gb + qi * sd.s[13];
      for (int c = part * (D / 4); c < (part + 1) * (D / 4); c += 4) {
        const float4 a = *reinterpret_cast<const float4*>(orow + c);
        const float4 b = *reinterpret_cast<const float4*>(grow + c);
        acc = fmaf(a.x, b.x, acc);
        acc = fmaf(a.y, b.y, acc);
        acc = fmaf(a.z, b.z, acc);
        acc = fmaf(a.w, b.w, acc);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (part == 0) {
      dlt_s[r] = acc;
      lse_s[r] = qi < T ? lse[row0 + qi] * LOG2E : 0.f;
      if (qi < T) delta[row0 + qi] = acc;
    }
  }
  const float sl2 = scale * LOG2E;
  const int nkv =
      ((causal ? min(S, q0 + af::ROWS) : S) + af::ROWS - 1) / af::ROWS;
  float dacc[4][D / 16];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) dacc[a][c] = 0.f;
  for (int j = 0; j < nkv; ++j) {
    const int k0 = j * af::ROWS;
    __syncthreads();   // the previous tile's k and ds are consumed
    af::load_tile<D>(ks, kb, sd.s[4], k0, S);
    af::load_tile<D>(vs, vb, sd.s[7], k0, S);
    __syncthreads();
    float sc[4][4] = {}, dp[4][4] = {};
    af::dot_nt<D>(sc, qs, ks, tx, ty);
    af::dot_nt<D>(dp, gs, vs, tx, ty);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = ty * 4 + a, qi = q0 + r;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int kj = k0 + tx + 16 * b;
        const bool ok = qi < T && kj < S && !(causal && kj > qi);
        const float p = ok ? exp2f(sc[a][b] * sl2 - lse_s[r]) : 0.f;
        sc[a][b] = p * (dp[a][b] - dlt_s[r]) * scale;
      }
    }
    af::store_scores(dss, sc, tx, ty);
    __syncthreads();
    af::dot_nn<D>(dacc, dss, ks, tx, ty);
  }
  float* dqb = dq + bb * sd.s[15] + h * sd.s[17];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int qi = q0 + ty * 4 + a;
    if (qi >= T) continue;
#pragma unroll
    for (int gi = 0; gi < D / 64; ++gi)
      *reinterpret_cast<float4*>(dqb + qi * sd.s[16] + gi * 64 + tx * 4) =
          make_float4(dacc[a][gi * 4], dacc[a][gi * 4 + 1],
                      dacc[a][gi * 4 + 2], dacc[a][gi * 4 + 3]);
  }
}

// dk/dv pass: k, v (resident), q, dO tiles, and the p and ds tiles, as
// Pᵀ / dSᵀ: rows are this block's keys
template <int D>
struct F32DkvSmem {
  static constexpr int K = 0;
  static constexpr int V = K + af::tile_floats<D>();
  static constexpr int Q = V + af::tile_floats<D>();
  static constexpr int G = Q + af::tile_floats<D>();
  static constexpr int P = G + af::tile_floats<D>();
  static constexpr int DS = P + af::score_floats();
  static constexpr int LSE = DS + af::score_floats();
  static constexpr int DLT = LSE + af::ROWS;
  static constexpr int BYTES = 4 * (DLT + af::ROWS);
};

template <int D>
__global__ void __launch_bounds__(af::THREADS)
flash_bwd_dkv_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ g,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv,
                         int T, int S, int H, int KV, int causal, float scale,
                         const Strides sd) {
  using L = F32DkvSmem<D>;
  extern __shared__ __align__(16) float smf[];
  float *ks = smf + L::K, *vs = smf + L::V, *qs = smf + L::Q,
        *gs = smf + L::G, *ps = smf + L::P, *dss = smf + L::DS,
        *lse_s = smf + L::LSE, *dlt_s = smf + L::DLT;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int kvh = blockIdx.x, bb = blockIdx.y;
  const int k0 = blockIdx.z * af::ROWS;   // key tile 0, the longest, first
  const int grp = H / KV;
  const int nq = (T + af::ROWS - 1) / af::ROWS;
  const int i0 = causal ? min(k0 / af::ROWS, nq) : 0;
  // element strides: q, k, v, g, dk, dv — (batch, row, head) each
  af::load_tile<D>(ks, k + bb * sd.s[3] + kvh * sd.s[5], sd.s[4], k0, S);
  af::load_tile<D>(vs, v + bb * sd.s[6] + kvh * sd.s[8], sd.s[7], k0, S);
  const float sl2 = scale * LOG2E;
  float dka[4][D / 16], dva[4][D / 16];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) dka[a][c] = dva[a][c] = 0.f;
  for (int hh = 0; hh < grp; ++hh) {
    const int h = kvh * grp + hh;
    const float* qb = q + bb * sd.s[0] + h * sd.s[2];
    const float* gb = g + bb * sd.s[9] + h * sd.s[11];
    const size_t row0 = (static_cast<size_t>(bb) * H + h) * T;
    for (int it = i0; it < nq; ++it) {
      const int q0 = it * af::ROWS;
      __syncthreads();   // the previous tile's q, dO, p and ds are consumed
      af::load_tile<D>(qs, qb, sd.s[1], q0, T);
      af::load_tile<D>(gs, gb, sd.s[10], q0, T);
      if (tid < af::ROWS) {
        const int qi = q0 + tid;
        lse_s[tid] = qi < T ? lse[row0 + qi] * LOG2E : 0.f;
        dlt_s[tid] = qi < T ? delta[row0 + qi] : 0.f;
      }
      __syncthreads();
      float st[4][4] = {}, dpt[4][4] = {};   // Sᵀ, dPᵀ: [key][query]
      af::dot_nt<D>(st, ks, qs, tx, ty);
      af::dot_nt<D>(dpt, vs, gs, tx, ty);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int kj = k0 + ty * 4 + a;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int c = tx + 16 * b, qi = q0 + c;
          const bool ok = qi < T && kj < S && !(causal && kj > qi);
          const float p = ok ? exp2f(st[a][b] * sl2 - lse_s[c]) : 0.f;
          st[a][b] = p;
          dpt[a][b] = p * (dpt[a][b] - dlt_s[c]) * scale;
        }
      }
      af::store_scores(ps, st, tx, ty);
      af::store_scores(dss, dpt, tx, ty);
      __syncthreads();
      af::dot_nn<D>(dva, ps, gs, tx, ty);
      af::dot_nn<D>(dka, dss, qs, tx, ty);
    }
  }
  float* dkb = dk + bb * sd.s[12] + kvh * sd.s[14];
  float* dvb = dv + bb * sd.s[15] + kvh * sd.s[17];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int kj = k0 + ty * 4 + a;
    if (kj >= S) continue;
#pragma unroll
    for (int gi = 0; gi < D / 64; ++gi) {
      const int c = gi * 64 + tx * 4;
      *reinterpret_cast<float4*>(dkb + kj * sd.s[13] + c) =
          make_float4(dka[a][gi * 4], dka[a][gi * 4 + 1],
                      dka[a][gi * 4 + 2], dka[a][gi * 4 + 3]);
      *reinterpret_cast<float4*>(dvb + kj * sd.s[16] + c) =
          make_float4(dva[a][gi * 4], dva[a][gi * 4 + 1],
                      dva[a][gi * 4 + 2], dva[a][gi * 4 + 3]);
    }
  }
}

template <int D>
int launch_dq_f32(const void* q, const void* k, const void* v, const void* o,
                  const void* g, const void* lse, void* delta, void* dq,
                  int B, int T, int S, int H, int KV, int causal,
                  const Strides& st, void* stream) {
  constexpr int smem = F32DqSmem<D>::BYTES;
  cudaError_t e = af::allow_smem(flash_bwd_dq_f32_kernel<D>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(H, B, (T + af::ROWS - 1) / af::ROWS);
  flash_bwd_dq_f32_kernel<D>
      <<<grid, af::THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(q), static_cast<const float*>(k),
          static_cast<const float*>(v), static_cast<const float*>(o),
          static_cast<const float*>(g), static_cast<const float*>(lse),
          static_cast<float*>(delta), static_cast<float*>(dq), T, S, H, KV,
          causal, 1.0f / sqrtf((float)D), st);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv_f32(const void* q, const void* k, const void* v,
                   const void* g, const void* lse, const void* delta,
                   void* dk, void* dv, int B, int T, int S, int H, int KV,
                   int causal, const Strides& st, void* stream) {
  constexpr int smem = F32DkvSmem<D>::BYTES;
  cudaError_t e = af::allow_smem(flash_bwd_dkv_f32_kernel<D>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(KV, B, (S + af::ROWS - 1) / af::ROWS);
  flash_bwd_dkv_f32_kernel<D>
      <<<grid, af::THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(q), static_cast<const float*>(k),
          static_cast<const float*>(v), static_cast<const float*>(g),
          static_cast<const float*>(lse), static_cast<const float*>(delta),
          static_cast<float*>(dk), static_cast<float*>(dv), T, S, H, KV,
          causal, 1.0f / sqrtf((float)D), st);
  return (int)cudaGetLastError();
}

// any GQA group (bf16); the f32 instances add group_f32
bool shape_ok(int B, int T, int S, int H, int KV) {
  if (B < 1 || T < 1 || S < 1 || KV < 1 || H % KV != 0) return false;
  return B <= 65535 && (T + BM - 1) / BM <= 65535 &&
         (S + BM - 1) / BM <= 65535;
}

bool group_f32(int H, int KV) {
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

// q, o, g, dq (B, T, H, d); k, v (B, S, KV, d); bf16, d in {64, 112, 128,
// 256} (112 on the d = 128 tiles, padded in shared memory), last dim
// contiguous,
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
  if (d == 112)
    return launch_dq<128, 112>(q, k, v, o, g, lse, delta, dq, B, T, S, H,
                               KV, causal, to_strides(strides), stream);
  if (d == 128)
    return launch_dq<128>(q, k, v, o, g, lse, delta, dq, B, T, S, H, KV,
                          causal, to_strides(strides), stream);
  if (d == 256)
    return launch_dq<256>(q, k, v, o, g, lse, delta, dq, B, T, S, H, KV,
                          causal, to_strides(strides), stream);
  return (int)cudaErrorInvalidValue;
}

// dk, dv (B, S, KV, d) bf16, the GQA group summed in f32. strides: 18
// element strides (q, k, v, g, dk, dv: batch, row, head each). hs: heads
// a slab of each group (hs >= G: one block sums the whole group); above
// one slab, ws and cnt as launch_dkv says (128-wide accumulators at
// d = 112).
int flash_attention_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                                 const void* g, const void* lse,
                                 const void* delta, void* dk, void* dv, int B,
                                 int T, int S, int H, int KV, int d,
                                 int causal, const long long* strides, int hs,
                                 void* ws, void* cnt, void* stream) {
  if (!shape_ok(B, T, S, H, KV)) return (int)cudaErrorInvalidValue;
  if (d == 64)
    return launch_dkv<64>(q, k, v, g, lse, delta, dk, dv, B, T, S, H, KV,
                          causal, to_strides(strides), hs, ws, cnt, stream);
  if (d == 112)
    return launch_dkv<128, 112>(q, k, v, g, lse, delta, dk, dv, B, T, S, H,
                                KV, causal, to_strides(strides), hs, ws, cnt,
                                stream);
  if (d == 128)
    return launch_dkv<128>(q, k, v, g, lse, delta, dk, dv, B, T, S, H, KV,
                           causal, to_strides(strides), hs, ws, cnt, stream);
  if (d == 256)
    return launch_dkv<256>(q, k, v, g, lse, delta, dk, dv, B, T, S, H, KV,
                           causal, to_strides(strides), hs, ws, cnt, stream);
  return (int)cudaErrorInvalidValue;
}

// The f32 instances: the same arguments with q, k, v, o, g, dq, dk, dv in
// f32 (strides multiples of 4 elements, 16-byte aligned bases); d = 64,
// G in {1, 2, 4, 8}.
int flash_attention_bwd_dq_f32(const void* q, const void* k, const void* v,
                               const void* o, const void* g, const void* lse,
                               void* delta, void* dq, int B, int T, int S,
                               int H, int KV, int d, int causal,
                               const long long* strides, void* stream) {
  if (!shape_ok(B, T, S, H, KV) || !group_f32(H, KV) || d != 64)
    return (int)cudaErrorInvalidValue;
  return launch_dq_f32<64>(q, k, v, o, g, lse, delta, dq, B, T, S, H, KV,
                           causal, to_strides(strides), stream);
}

int flash_attention_bwd_dkv_f32(const void* q, const void* k, const void* v,
                                const void* g, const void* lse,
                                const void* delta, void* dk, void* dv, int B,
                                int T, int S, int H, int KV, int d,
                                int causal, const long long* strides,
                                void* stream) {
  if (!shape_ok(B, T, S, H, KV) || !group_f32(H, KV) || d != 64)
    return (int)cudaErrorInvalidValue;
  return launch_dkv_f32<64>(q, k, v, g, lse, delta, dk, dv, B, T, S, H, KV,
                            causal, to_strides(strides), stream);
}

}  // extern "C"
