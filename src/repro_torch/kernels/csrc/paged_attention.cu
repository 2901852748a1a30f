// Paged attention for Hopper (sm_90a): decode and in-loop chunked prefill
// over flat KV block pools, addressed through per-slot block tables.
//
// paged_attention_bf16 replaces the fp leg of the Pallas TPU kernel
//   src/repro/kernels/paged_attention.py::paged_decode_attention
//   (_kernel, quantized=False); paged_attention_int8 its int8 leg
//   (quantized=True). Both run paged_tc_kernel. dense_decode_attention_bf16
//   replaces src/repro/kernels/flash_attention.py::decode_attention
//   (_decode_kernel): the fp leg at C = 1 over the dense (B, S, KV, d)
//   cache (K4, the DENSE instantiation, below). paged_attention_f32,
//   paged_attention_int8_f32 and dense_decode_attention_f32 are the f32
//   instances of the three (paged_f32_kernel, at the end).
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
// ~4·C·G at C columns (twice that for int8 cells) — below the ~295
// flops/byte balance point at the engine's shapes, so the kernel is bound
// by reading each K/V cell of the slot's window once.
//
// On the tensor cores:
//  - one block owns all C·G query rows of a (slot, kv head) — a row is
//    one (column c, head g) pair of the GQA group, row = c·G + g — so the
//    window is read once for every row (at most 256 rows a block: four
//    warpgroups, 64 for the int8 leg; above that, slabs take a block
//    each, and each slab reads the window again). Any group G: a slab
//    may start mid-column (granite-34b's G = 48: 256 % 48 = 16), so its
//    window runs to its last row's column and each row is masked at its
//    own position;
//  - the block loads its block-table row into shared memory once (the
//    sentinels clamped) and walks it itself: K and V tiles of 64 cells
//    come through a three-stage cp.async ring, 16 bytes a copy (a page of
//    one kv head is `page` rows of d cells at stride KV·d); cells past
//    the window are zero-filled;
//  - S = Q·Kᵀ and O += P·V on the tensor cores. Below 64 rows (C·G < 64:
//    32 rows at MHA with C = 32, one at decode) each warp owns 16 rows
//    and runs `mma.sync` m16n8k16, K through ldmatrix and V through
//    ldmatrix.trans from 128-byte-swizzled bf16 tiles; from 64 rows
//    (fp leg) each warpgroup owns 64 and runs `wgmma` m64n64k16 (S, both
//    operands in shared memory) and m64ndk16 (P·V, P from registers, V
//    read MN-major). The kernel is bound by its bytes, so `mma.sync` is
//    enough when the tile is small, and it wastes no 48-row padding at
//    C·G ≤ 16;
//  - DENSE (K4): cell i of slot b's kv head is read at
//    k + b·ksb + i·kss + kvh·ksh, with no table, no sentinel and no page;
//    the window is min(pos[b], S − 1) + 1 cells (the launcher passes
//    page = 1 and P = S, so P·page is the cache length); groups above 64
//    take slabs of 64 rows, a block each. At G = 1 each
//    `mma.sync` carries 15 padded rows: the kernel is bound by bytes, so
//    the padding costs no time, and padded rows are never written;
//  - the online softmax stays in the accumulator registers (a row's
//    values sit in one quad of lanes); O stays f32;
//  - head_dim 112 (kimi-k2, 7168 / 64): the d = 128 instances padded in
//    shared memory (template DR = 112). A bf16 row is read as 14 chunks
//    of 16 bytes and an int8 row (112 bytes) as 7, the rest of the
//    128-wide swizzled tile zero-filled by the copies themselves (#8q's
//    zero chunk widens to two zero chunks), so the products, the ring and
//    the chunk merge run unchanged at 128; the scale is 112^-0.5, only
//    112 columns a row are stored (o holds 64 heads x 112), and the pools
//    and q stay 112 wide in device memory. Bound by bytes, the kernel
//    reads no padding from device memory: the zero columns cost
//    tensor-core and shared-memory work only;
//  - head_dim 256 (gemma-7b): a 64-cell tile of K or V is 32 KB, so the
//    ring has two stages (q 32 KB + 2 x 2 x 32 KB; #8q 2 x 2 x 16 KB of
//    int8 ring and the two 32 KB widened tiles), and every block runs
//    `mma.sync` with at most 64 rows (slabs above that): a `wgmma` block
//    of 128 or 256 rows holds 64 or 128 KB of q and does not fit beside
//    the ring. The engine's paged step has C·G = 32 rows, decode one.
//    O is 128 f32 registers a thread, so the q fragments are read from
//    shared memory at each tile rather than held;
//  - where the blocks leave the card under-filled (fewer than two an
//    SM), each window is split into chunks of a few tiles, one block a
//    chunk (flash-decoding: at C = 1 the 8 slots x 32 heads of ragged
//    windows of 1 to 480 cells fill the 132 SMs); a chunk past a short
//    window exits at once. Each block writes its (m, l, O) to a
//    workspace and takes a ticket from an integer counter of its (slot,
//    kv head); the last block merges the chunks in chunk order — a fixed
//    f32 order, so two calls are bit-identical, with no float atomics —
//    resets the counter and writes the output. (#9's slices of K merge
//    through a thread-block cluster instead; here a cluster measured
//    slower: its empty chunks stay resident until their siblings finish.)
// Numerics follow the TPU kernel: scores in f32 scaled by d^-0.5 (carried
// in log2 units, so exp is one ex2), masked scores at -1e30 and their p
// at 0, l floored at 1e-30, output rounded once to bf16. The fp leg
// rounds p to bf16 as the A operand of P·V, as the TPU kernel does.
//
// The int8 leg (Q8): the pools hold int8 cells (half the bf16 bytes) and
// two (N, page, KV) f32 scale pools, one scale per (cell, kv head),
// gathered through the same clamped table entry as the cell; each tile's
// 64 scales of K and of V ride in the ring with 4-byte copies. The TPU
// kernel dequantizes in f32: q·(k·s_k) in f32, p f32, and p·(v·s_v) in
// f32 (its p.astype(v.dtype) keeps f32) — nothing is rounded to bf16
// before the output. Here, on `mma.sync` (every row count: the engine's
// blocks hold 32 rows or one):
//  - each stage's int8 K and V tiles are widened exactly into the bf16
//    swizzled tiles the fp leg reads (hopper.cuh's widen16: every int8
//    value is exact in bf16), one pass and one barrier a tile;
//  - S: bf16 q against the widened K is exact products with f32 sums;
//    each column is then scaled by its cell's k scale and d^-0.5 in f32:
//    Σ q·(k·s_k) up to the summation order;
//  - P·V: the v scale is folded into p (p' = p·s_v in f32), and p' goes
//    in as a bf16 hi + lo pair, two `mma.sync` against the same widened V
//    tile, error ≈ 2^-16 of p' — p is never cut to bf16. (TF32 m16n8k8
//    would keep ≈ 2^-11 and need V widened to f32 in another layout; the
//    pair reuses the fp leg's V fragments.) l sums p itself.
//
// The C functions return cudaGetLastError() of the launch.

#include "attention_f32.cuh"
#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr float NEG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

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

// strides (elements): st[0..2] q (b, c, h); st[3..5] k (n, p, kv);
// st[6..8] v; st[9..11] o (b, c, h); st[12] tables (b); Q8 only:
// st[13..15] k_scale (n, p, kv); st[16..18] v_scale. DENSE: k and v
// (b, s, kv) of the dense cache.
struct Strides {
  long long v[19];
};

// ------------------------------------------- the fp leg, tensor cores

constexpr int PT = 64;         // cells a streamed tile
constexpr int SLAB = 256;      // most rows a block (four warpgroups)
constexpr int SLAB_MMA = 64;   // most rows a block of the int8 leg and of
                               // d = 256 (one `mma.sync` warpgroup)

// depth of the K/V ring: three stages, two at d = 256 (a 64-cell tile is
// 32 KB there: q's 32 KB and three stages of K and V would take 224 of
// the 227 KB a block may have, past launch_tc's 200 KB cap)
template <int D>
constexpr int paged_stages() { return D == 256 ? 2 : 3; }

// D (16 x 8 f32) += A (16 x 16 bf16, the m16n8k16 A fragment) · B (16 x 8)
__device__ __forceinline__ void mma16816(float* d, const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
      "{%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
// 16-byte chunk ch (of 8 bf16) of row `row` in a ROWS-row swizzled tile
template <int ROWS>
__device__ __forceinline__ uint32_t chunk_at(uint32_t tile, int row,
                                             int ch) {
  return tile + (ch >> 3) * ROWS * 128 + row * 128 +
         (((ch & 7) ^ (row & 7)) << 4);
}

template <int D, int NWG, bool Q8>
struct PagedSmem {
  static constexpr int QR = 64 * NWG;          // query rows, padded
  static constexpr int TB = PT * D * 2;        // a bf16 K or V tile
  static constexpr int TC = Q8 ? PT * D : TB;  // a ring tile (Q8: int8)
  static constexpr int ST = paged_stages<D>();   // ring stages
  static constexpr int Q = 0;
  static constexpr int K = Q + QR * D * 2;
  static constexpr int V = K + ST * TC;
  // Q8: the stage being read, widened to bf16, and the f32 scales of each
  // stage's cells ([stage][k | v][cell])
  static constexpr int KW = V + ST * TC;
  static constexpr int VW = KW + (Q8 ? TB : 0);
  static constexpr int SC = VW + (Q8 ? TB : 0);
  static constexpr int TBL = SC + (Q8 ? ST * 2 * PT * 4 : 0);
  static_assert(K % 1024 == 0 && TC % 1024 == 0 && TB % 1024 == 0,
                "tiles must keep the 1024-byte alignment of the swizzle");
};

// one m16n8k16 A fragment (16 columns: accumulator values d[0..7], as
// to_a reads them) of f32 as bf16 hi and lo parts, hi + lo = x to within
// 2^-16 |x| (p·s_v of the int8 leg: P·V runs twice, p is never cut to
// bf16)
__device__ __forceinline__ void split_a(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                        const float* d) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float x0 = d[2 * r], x1 = d[2 * r + 1];
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    hi[r] = *reinterpret_cast<const uint32_t*>(&h);
    lo[r] = pack_bf16(x0 - __low2float(h), x1 - __high2float(h));
  }
}

// WG: `wgmma`, 64 rows a warpgroup; else `mma.sync` (NWG = 1), 16 rows a
// warp. Q8: the int8 leg (`mma.sync` only). DENSE: the dense cache, no
// table (K4; the fp leg on `mma.sync`). grid (KV, B, slabs · chunks);
// split: tiles a chunk, 0 for one chunk a window. At d = 128 a block's
// shared memory leaves room for two blocks an SM, so the registers are
// bounded for two; at d = 256 (`mma.sync` only) for one: O alone is 128
// registers a thread, and the q fragments are read from shared memory at
// each tile instead of being held (64 more)
// DR: the operands' head_dim (kimi-k2's 112) on tiles of D = DR padded
// to the next multiple of 64: the chunks past DR are zero-filled in shared
// memory, the products run at D, and only DR columns are stored
template <int D, int NWG, bool WG, bool Q8, bool DENSE = false, int DR = D>
__global__ void __launch_bounds__(NWG * 128,
                                  NWG == 1 ? (D == 256 ? 1
                                              : D == 128 ? 2 : 3)
                                           : (NWG == 2 ? 2 : 1))
paged_tc_kernel(const bf16* __restrict__ q, const void* __restrict__ kv_k,
                const void* __restrict__ kv_v,
                const float* __restrict__ k_scale,
                const float* __restrict__ v_scale,
                const int* __restrict__ tables, const int* __restrict__ pos,
                bf16* __restrict__ o, float* __restrict__ ws,
                int* __restrict__ cnt, int C, int G, int N, int page, int P,
                int split, float sl2, const Strides st) {
  using L = PagedSmem<D, NWG, Q8>;
  typedef typename Cell<Q8>::T CT;
  constexpr int NT = NWG * 128, QR = L::QR, CH = D / 8;
  constexpr int CC = D * sizeof(CT) / 16;   // 16-byte copies a tile cell
  constexpr int CCR = DR * sizeof(CT) / 16;  // ... of them holding data
  static_assert(DR <= D && D - DR < 64 && DR * sizeof(CT) % 16 == 0,
                "DR padded to D in whole 16-byte chunks");
  static_assert(WG || NWG == 1, "mma.sync blocks are one warpgroup");
  static_assert(!(WG && Q8), "the int8 leg runs mma.sync");
  static_assert(!DENSE || (!WG && !Q8), "the dense leg runs mma.sync, fp");
  static_assert(D != 256 || !WG, "d = 256 runs mma.sync");
  constexpr int ST = L::ST;
  constexpr bool QREG = D <= 128;   // the q fragments held in registers
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  int* tbl = reinterpret_cast<int*>(smem + L::TBL);
  __shared__ int last_flag;

  const int kvh = blockIdx.x, bb = blockIdx.y;
  const int nch = split ? (P * page + PT * split - 1) / (PT * split) : 1;
  const int slab = blockIdx.z / nch, ch = blockIdx.z % nch;
  const int tid = threadIdx.x, rows = C * G, r0 = slab * QR;
  const int p0 = pos[bb];
  // the block's window: cells up to its last row's position
  const int c_last = (min(r0 + QR, rows) - 1) / G;
  const int nkeys = min(p0 + c_last + 1, P * page);
  const int ntiles = (nkeys + PT - 1) / PT;
  const int t0 = split ? ch * split : 0;
  const int t1 = split ? min(ntiles, t0 + split) : ntiles;
  if (t0 >= t1) return;   // a chunk past this slot's window

  if constexpr (!DENSE) {
    const int npages = (nkeys + page - 1) / page;
    for (int j = tid; j < npages; j += NT) {   // sentinels clamped
      const int e = tables[bb * st.v[12] + j];
      tbl[j] = e < 0 ? 0 : (e >= N ? N - 1 : e);
    }
  }
  const CT* kb = static_cast<const CT*>(kv_k) + kvh * st.v[5];
  const CT* vb = static_cast<const CT*>(kv_v) + kvh * st.v[8];
  // this block's query rows r0 .. r0 + QR - 1 (rows past C·G are zero)
  for (int i = tid; i < QR * CH; i += NT) {
    const int row = i / CH, c = i % CH, rr = r0 + row;
    const bool ok = rr < rows && c < DR / 8;   // padding columns zero
    const int cc = rr / G, g = rr - cc * G;
    cp_async16(chunk_at<QR>(base + L::Q, row, c),
               ok ? q + bb * st.v[0] + cc * st.v[1] + (kvh * G + g) * st.v[2] +
                        c * 8
                  : q,
               ok ? 16 : 0);
  }
  __syncthreads();   // the table row, for the copies below
  auto issue = [&](int t) {   // tile t (cells 64 t ..) into its stage
    const int stg = (t - t0) % ST;
    const uint32_t kt = base + L::K + stg * L::TC;
    const uint32_t vt = base + L::V + stg * L::TC;
    for (int i = tid; i < 2 * PT * CC; i += NT) {
      const int isv = i >= PT * CC, rem = isv ? i - PT * CC : i;
      const int cell = rem / CC, c = rem % CC, ci = t * PT + cell;
      const bool ok = ci < nkeys && c < CCR;   // padding columns zero
      long long off = 0;
      if (ok && DENSE) {   // slot bb's cell ci
        off = bb * (isv ? st.v[6] : st.v[3]) +
              static_cast<long long>(ci) * (isv ? st.v[7] : st.v[4]) + c * 8;
      } else if (ok) {     // row ci % page of the cell's table entry
        const int pg = ci / page;
        off = static_cast<long long>(tbl[pg]) * (isv ? st.v[6] : st.v[3]) +
              static_cast<long long>(ci - pg * page) *
                  (isv ? st.v[7] : st.v[4]) + c * (16 / sizeof(CT));
      }
      // Q8: an int8 tile is plain rows of D bytes, widened before use
      const uint32_t dst = Q8 ? (isv ? vt : kt) + cell * D + c * 16
                              : chunk_at<PT>(isv ? vt : kt, cell, c);
      cp_async16(dst, (isv ? vb : kb) + off, ok ? 16 : 0);
    }
    if constexpr (Q8) {   // the cells' scales, gathered the same way
      for (int i = tid; i < 2 * PT; i += NT) {
        const int isv = i >= PT, cell = i % PT, ci = t * PT + cell;
        const bool ok = ci < nkeys;
        const int pg = ci / page;
        const long long off =
            ok ? static_cast<long long>(tbl[pg]) * st.v[isv ? 16 : 13] +
                     static_cast<long long>(ci - pg * page) *
                         st.v[isv ? 17 : 14]
               : 0;
        cp_async4(base + L::SC + (stg * 2 + isv) * PT * 4 + cell * 4,
                  (isv ? v_scale + kvh * st.v[18] : k_scale + kvh * st.v[15]) +
                      off,
                  ok ? 4 : 0);
      }
    }
  };
#pragma unroll
  for (int i = 0; i < ST - 1; ++i) {
    if (t0 + i < t1) issue(t0 + i);
    cp_async_commit();
  }

  const int lane = tid & 31, warp = (tid >> 5) & 3, wg = tid >> 7;
  const int ra = 64 * wg + 16 * warp + (lane >> 2), ca = 2 * (lane & 3);
  // the last cell each of this thread's two rows attends (-1: padding)
  int lim[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rr = r0 + ra + 8 * h;
    lim[h] = rr < rows ? min(p0 + rr / G, nkeys - 1) : -1;
  }
  const bool active = WG || r0 + 16 * warp < rows;   // mma.sync: warp rows
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  float oacc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
  // mma.sync: this warp's q fragments (QREG; else read at each tile)
  uint32_t qa[WG || !QREG ? 1 : D / 16][4];

  for (int t = t0; t < t1; ++t) {
    const int stg = (t - t0) % ST;
    cp_async_wait<ST - 2>();   // tile t (and at t0, q) has landed
    fence_proxy_async();
    __syncthreads();   // ... for every thread; tile t - 1 is consumed
    if (t + ST - 1 < t1) issue(t + ST - 1);   // tile t - 1's stage
    cp_async_commit();
    uint32_t kt = base + L::K + stg * L::TC;
    uint32_t vt = base + L::V + stg * L::TC;
    const float* ksc = reinterpret_cast<const float*>(
        smem + L::SC + stg * 2 * PT * 4);
    const float* vsc = ksc + PT;
    if constexpr (Q8) {
      // widen the stage's int8 K and V tiles exactly into the bf16
      // swizzled tiles the fp leg reads (16 cell values a chunk); the
      // widened tiles of tile t - 1 are free past the barrier above
      for (int i = tid; i < 2 * PT * CC; i += NT) {
        const int isv = i >= PT * CC, rem = isv ? i - PT * CC : i;
        const int cell = rem / CC, c = rem % CC;
        uint32_t lo[4], hi[4];
        widen16(*reinterpret_cast<const uint4*>(
                    smem + (isv ? L::V : L::K) + stg * L::TC + cell * D +
                    c * 16),
                lo, hi);
        const uint32_t wt = base + (isv ? L::VW : L::KW);
        st_shared16(chunk_at<PT>(wt, cell, 2 * c), lo);
        st_shared16(chunk_at<PT>(wt, cell, 2 * c + 1), hi);
      }
      __syncthreads();
      kt = base + L::KW;
      vt = base + L::VW;
    }
    if (!active) continue;
    float s[PT / 2];
    if constexpr (WG) {
      reg_fence(s);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)   // S = Q·Kᵀ
        WgSS<PT>::mma(s, desc_k<QR>(base + L::Q, 64 * wg, kk),
                      desc_k<PT>(kt, 0, kk), kk);
      wg_commit();
      wg_wait<0>();
      reg_fence(s);
      reg_fence(oacc);
    } else if constexpr (QREG) {
      if (t == t0) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          ldsm4(qa[kk], chunk_at<QR>(base + L::Q, 16 * warp + (lane & 15),
                                     2 * kk + (lane >> 4)));
      }
#pragma unroll
      for (int i = 0; i < PT / 2; ++i) s[i] = 0.f;
#pragma unroll
      for (int c = 0; c < PT / 8; ++c)   // S = Q·Kᵀ, 8 cells at a time
#pragma unroll
        for (int k2 = 0; k2 < D / 32; ++k2) {
          uint32_t b[4];
          ldsm4(b, chunk_at<PT>(kt, 8 * c + (lane & 7), 4 * k2 + (lane >> 3)));
          mma16816(s + 4 * c, qa[2 * k2], b[0], b[1]);
          mma16816(s + 4 * c, qa[2 * k2 + 1], b[2], b[3]);
        }
    } else {   // d = 256: 32 dims of q at a time, each score summed over
               // k2 in the same order as above
#pragma unroll
      for (int i = 0; i < PT / 2; ++i) s[i] = 0.f;
#pragma unroll
      for (int k2 = 0; k2 < D / 32; ++k2) {
        uint32_t q0[4], q1[4];
        ldsm4(q0, chunk_at<QR>(base + L::Q, 16 * warp + (lane & 15),
                               4 * k2 + (lane >> 4)));
        ldsm4(q1, chunk_at<QR>(base + L::Q, 16 * warp + (lane & 15),
                               4 * k2 + 2 + (lane >> 4)));
#pragma unroll
        for (int c = 0; c < PT / 8; ++c) {
          uint32_t b[4];
          ldsm4(b, chunk_at<PT>(kt, 8 * c + (lane & 7), 4 * k2 + (lane >> 3)));
          mma16816(s + 4 * c, q0, b[0], b[1]);
          mma16816(s + 4 * c, q1, b[2], b[3]);
        }
      }
    }

    // online softmax on the accumulator: a row's values sit in a quad.
    // Q8: q·k is exact products of bf16 q and the int8 cells, summed in
    // f32; each column is then scaled by its cell's k scale
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int c = 0; c < PT / 8; ++c) {
      float2 kscale = make_float2(sl2, sl2);
      if constexpr (Q8) {
        kscale = *reinterpret_cast<const float2*>(ksc + 8 * c + ca);
        kscale.x *= sl2;
        kscale.y *= sl2;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ci = t * PT + 8 * c + ca + (e & 1);
        const float x = ci <= lim[e >> 1]
                            ? s[4 * c + e] * ((e & 1) ? kscale.y : kscale.x)
                            : NEG;
        s[4 * c + e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(FULL, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(FULL, mx[h], 2));
      corr[h] = ex2(m[h] - mx[h]);
      m[h] = mx[h];
    }
#pragma unroll
    for (int i = 0; i < PT / 2; ++i) {
      const int h = (i >> 1) & 1;
      const float pr = s[i] == NEG ? 0.f : ex2(s[i] - m[h]);
      s[i] = pr;
      rs[h] += pr;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + rs[h];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) oacc[i] *= corr[(i >> 1) & 1];
    if constexpr (Q8) {
      // O += (p·s_v)·V with p·s_v in f32 as a bf16 hi + lo pair against
      // the exactly widened V: two products a fragment, error ~2^-16
#pragma unroll
      for (int c = 0; c < PT / 8; ++c) {
        const float2 vs = *reinterpret_cast<const float2*>(vsc + 8 * c + ca);
        s[4 * c] *= vs.x;
        s[4 * c + 1] *= vs.y;
        s[4 * c + 2] *= vs.x;
        s[4 * c + 3] *= vs.y;
      }
#pragma unroll
      for (int kk = 0; kk < PT / 16; ++kk) {
        uint32_t hi[4], lo[4];
        split_a(hi, lo, s + 8 * kk);
#pragma unroll
        for (int n2 = 0; n2 < D / 16; ++n2) {
          uint32_t b[4];
          ldsm4t(b, chunk_at<PT>(vt, 16 * kk + (lane & 15),
                                 2 * n2 + (lane >> 4)));
          mma16816(oacc + 8 * n2, hi, b[0], b[1]);
          mma16816(oacc + 8 * n2 + 4, hi, b[2], b[3]);
          mma16816(oacc + 8 * n2, lo, b[0], b[1]);
          mma16816(oacc + 8 * n2 + 4, lo, b[2], b[3]);
        }
      }
      continue;
    }
    uint32_t pa[PT / 16][4];   // p in bf16, the A operand of P·V
    to_a<PT>(pa, s);
    if constexpr (WG) {
      reg_fence(pa);
      reg_fence(oacc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < PT / 16; ++kk)   // O += P·V
        WgRS<D>::mma(oacc, pa[kk], desc_mn<PT>(vt, kk));
      wg_commit();
      wg_wait<0>();   // before the barrier that frees this stage
      reg_fence(oacc);
    } else {
#pragma unroll
      for (int n2 = 0; n2 < D / 16; ++n2)   // O += P·V, 16 dims at a time
#pragma unroll
        for (int kk = 0; kk < PT / 16; ++kk) {
          uint32_t b[4];
          ldsm4t(b, chunk_at<PT>(vt, 16 * kk + (lane & 15),
                                 2 * n2 + (lane >> 4)));
          mma16816(oacc + 8 * n2, pa[kk], b[0], b[1]);
          mma16816(oacc + 8 * n2 + 4, pa[kk], b[2], b[3]);
        }
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int h = 0; h < 2; ++h) {   // l: each lane kept its columns' share
    l[h] += __shfl_xor_sync(FULL, l[h], 1);
    l[h] += __shfl_xor_sync(FULL, l[h], 2);
  }

  if (split) {   // flash-decoding: partials out, the last chunk merges
    const int live = (ntiles + split - 1) / split;   // this window's chunks
    const int bk = (bb * gridDim.x + kvh) * (gridDim.z / nch) + slab;
    float4* part = reinterpret_cast<float4*>(ws) +
                   static_cast<long long>(bk) * nch * (D / 8 + 1) * NT;
    float4* mine = part + static_cast<long long>(ch) * (D / 8 + 1) * NT;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      mine[i * NT + tid] = make_float4(oacc[4 * i], oacc[4 * i + 1],
                                       oacc[4 * i + 2], oacc[4 * i + 3]);
    mine[(D / 8) * NT + tid] = make_float4(m[0], m[1], l[0], l[1]);
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      last_flag = atomicAdd(cnt + bk, 1) == live - 1;
      if (last_flag) cnt[bk] = 0;   // ready for the next launch
    }
    __syncthreads();
    if (!last_flag) return;
    __threadfence();
    for (int c = 0; c < live; ++c) {   // chunk order: the same f32 sums
      const float4* src = part + static_cast<long long>(c) * (D / 8 + 1) * NT;
      const float4 ml = __ldcg(src + (D / 8) * NT + tid);
      const float mc[2] = {ml.x, ml.y}, lc[2] = {ml.z, ml.w};
      float fa[2], fb[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float mn = c == 0 ? mc[h] : fmaxf(m[h], mc[h]);
        fa[h] = c == 0 ? 0.f : ex2(m[h] - mn);
        fb[h] = ex2(mc[h] - mn);
        l[h] = (c == 0 ? 0.f : l[h] * fa[h]) + lc[h] * fb[h];
        m[h] = mn;
      }
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        const float4 t4 = __ldcg(src + i * NT + tid);
        const float ov[4] = {t4.x, t4.y, t4.z, t4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          oacc[4 * i + e] =
              (c == 0 ? 0.f : oacc[4 * i + e] * fa[h]) + ov[e] * fb[h];
        }
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {   // rows past C·G are padding: not written
    const int rr = r0 + ra + 8 * h;
    if (rr >= rows) continue;
    const int cc = rr / G, g = rr - cc * G;
    bf16* ob = o + bb * st.v[9] + cc * st.v[10] + (kvh * G + g) * st.v[11];
    const float inv = 1.f / fmaxf(l[h], 1e-30f);
#pragma unroll
    for (int n = 0; n < DR / 8; ++n)   // the DR real columns only
      *reinterpret_cast<__nv_bfloat162*>(ob + 8 * n + ca) =
          __floats2bfloat162_rn(oacc[4 * n + 2 * h] * inv,
                                oacc[4 * n + 2 * h + 1] * inv);
  }
}

struct TcArgs {
  const void *q, *k, *v, *ks, *vs, *tables, *pos;
  void *o, *ws, *cnt;
  int B, C, G, KV, N, page, P, split, nslab, nch;
};

template <int D, int NWG, bool WG, bool Q8, bool DENSE = false, int DR = D>
int launch_tc(const TcArgs& a, const Strides& st, void* stream) {
  using L = PagedSmem<D, NWG, Q8>;
  // + the table row (none when DENSE) and the alignment slack
  const int smem = L::TBL + (DENSE ? 0 : (a.P * 4 + 15) & ~15) + 1024;
  if (smem > 200 * 1024) return (int)cudaErrorInvalidValue;
  static int smem_set = 48 * 1024;   // per instantiation, grows only
  if (smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_tc_kernel<D, NWG, WG, Q8, DENSE, DR>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  dim3 grid(a.KV, a.B, a.nslab * a.nch);
  paged_tc_kernel<D, NWG, WG, Q8, DENSE, DR>
      <<<grid, NWG * 128, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const bf16*>(a.q), a.k, a.v,
          static_cast<const float*>(a.ks), static_cast<const float*>(a.vs),
          static_cast<const int*>(a.tables), static_cast<const int*>(a.pos),
          static_cast<bf16*>(a.o), static_cast<float*>(a.ws),
          static_cast<int*>(a.cnt), a.C, a.G, a.N, a.page, a.P, a.split,
          LOG2E / sqrtf((float)DR), st);   // the real head_dim's scale
  return (int)cudaGetLastError();
}

template <int D, bool Q8, int DR = D>
int launch_tc_d(int rows, const TcArgs& a, const Strides& st, void* stream) {
  if constexpr (Q8 || D == 256) {   // `mma.sync`, at most SLAB_MMA rows
    return launch_tc<D, 1, false, Q8, false, DR>(a, st, stream);
  } else {
    if (rows < 64)
      return launch_tc<D, 1, false, false, false, DR>(a, st, stream);
    if (rows <= 64)
      return launch_tc<D, 1, true, false, false, DR>(a, st, stream);
    if (rows <= 128)
      return launch_tc<D, 2, true, false, false, DR>(a, st, stream);
    return launch_tc<D, 4, true, false, false, DR>(a, st, stream);
  }
}

// Q8: the int8 leg, whose blocks take at most SLAB_MMA rows (`mma.sync`),
// as every block at d = 256
template <bool Q8>
int run_tc(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, const void* tables, const void* pos, void* o,
           int B, int C, int H, int KV, int d, int N, int page, int P,
           const long long* strides, int split, void* ws, void* cnt,
           void* stream) {
  if (B < 1 || C < 1 || KV < 1 || H % KV != 0 || N < 1 || P < 1 ||
      page < 8 || page > 64 || page % 8 != 0 || B > 65535 || split < 0 ||
      (split > 0 && (ws == nullptr || cnt == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int G = H / KV;   // any group: a slab may start mid-column
  const int rows = C * G, cap = Q8 || d == 256 ? SLAB_MMA : SLAB;
  const int nslab = (rows + cap - 1) / cap;
  const int nch = split ? (P * page + PT * split - 1) / (PT * split) : 1;
  if (static_cast<long long>(nslab) * nch > 65535)
    return (int)cudaErrorInvalidValue;
  Strides st{};
  for (int i = 0; i < (Q8 ? 19 : 13); ++i) st.v[i] = strides[i];
  const TcArgs a{q, k, v, ks, vs, tables, pos, o, ws, cnt, B, C, G, KV, N,
                 page, P, split, nslab, nch};
  // rows a block: all C·G (padded to the product's tile), or slabs
  const int brows = nslab > 1 ? cap : rows;
  if (d == 64) return launch_tc_d<64, Q8>(brows, a, st, stream);
  if (d == 112) return launch_tc_d<128, Q8, 112>(brows, a, st, stream);
  if (d == 128) return launch_tc_d<128, Q8>(brows, a, st, stream);
  if (d == 256) return launch_tc_d<256, Q8>(brows, a, st, stream);
  return (int)cudaErrorInvalidValue;
}

// K4: one query a slot (C = 1) over the dense cache, the G rows of a
// (slot, kv head) in slabs of at most SLAB_MMA (one `mma.sync` warpgroup;
// one slab up to G = 64), a block each
int run_dense(const void* q, const void* k, const void* v, const void* pos,
              void* o, int B, int S, int H, int KV, int d,
              const long long* strides, int split, void* ws, void* cnt,
              void* stream) {
  if (B < 1 || S < 1 || KV < 1 || H % KV != 0 || B > 65535 || split < 0 ||
      (split > 0 && (ws == nullptr || cnt == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int G = H / KV;
  const int nslab = (G + SLAB_MMA - 1) / SLAB_MMA;
  const int nch = split ? (S + PT * split - 1) / (PT * split) : 1;
  if (static_cast<long long>(nslab) * nch > 65535)
    return (int)cudaErrorInvalidValue;
  // q (b, h) and o (b, h) as (b, c = 0, h); k, v (b, s, kv)
  const long long* s = strides;
  const Strides st{{s[0], 0, s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8],
                    0, s[9], 0}};
  const TcArgs a{q, k, v, nullptr, nullptr, nullptr, pos, o, ws, cnt, B, 1,
                 G, KV, 0, 1, S, split, nslab, nch};
  if (d == 64) return launch_tc<64, 1, false, false, true>(a, st, stream);
  if (d == 112)
    return launch_tc<128, 1, false, false, true, 112>(a, st, stream);
  if (d == 128) return launch_tc<128, 1, false, false, true>(a, st, stream);
  if (d == 256) return launch_tc<256, 1, false, false, true>(a, st, stream);
  return (int)cudaErrorInvalidValue;
}

// ------------------------------------------- the f32 instances (FFMA)
//
// paged_attention_f32, paged_attention_int8_f32 and
// dense_decode_attention_f32 are the f32 instances of the same three TPU
// kernels (RoBERTa serves in f32): q, the fp pools and the output in f32,
// and every product an FFMA on the CUDA cores — no operand rounded to
// TF32 or bf16 (one TF32 pass would miss the 1e-4 f32 limit). The design
// is paged_tc_kernel's, on attention_f32.cuh's FFMA tiles:
//  - one block (256 threads) owns all C·G query rows of a (slot, kv head),
//    up to 64 (above that, slabs of 64 take a block each), padded to 16·RA
//    rows (RA = 1, 2 or 4: 16, 32 or 64), and one chunk of its window;
//  - K and V tiles of 64 cells come through a two-stage cp.async ring into
//    shared memory rows padded to d + 4 floats, 16 bytes a copy, through
//    the block-table row (sentinels clamped) or, DENSE, straight from the
//    (B, S, KV, d) cache; cells past the window are zero-filled;
//  - S = Q·Kᵀ (RA x 4 scores a thread), the online softmax on those
//    registers in f32 (a row's 16 lanes reduce by shfl.xor), p written to
//    a score tile, O += P·V (RA x d/16 a thread) in registers;
//  - Q8: the stage's int8 K and V tiles are widened exactly to f32 tiles
//    (one pass, one barrier a tile), the k scale multiplies the score
//    columns and the v scale is folded into p as it is written (l sums p
//    itself) — all in f32, so no hi + lo pair is needed;
//  - windows split into chunks where the blocks under-fill the card, each
//    chunk's (m, l, O) merged by the last block of its (slot, kv head,
//    slab) in chunk order through an f32 workspace and the integer ticket
//    of the bf16 kernels: a fixed order, so two calls are bit-identical.
// Numerics as the bf16 kernels' (scores scaled by d^-0.5 in log2 units,
// masked p at 0, l floored at 1e-30), with exp2f and p never rounded.
// Bound: bytes, as the bf16 kernels' — a decode step reads each cell once
// for G rows, a 32-column chunk for 32·G; the padded rows cost FFMA time
// where C·G is below 16, which the bytes of a tile hide at these sizes.

namespace af = attn_f32;

constexpr int F32_NT = af::THREADS;   // threads a block
constexpr int F32_STAGES = 2;         // depth of the K/V ring
constexpr int F32_SLAB = 64;          // most rows a block

template <bool Q8>
struct F32Cell;
template <>
struct F32Cell<false> {
  typedef float T;
};
template <>
struct F32Cell<true> {
  typedef int8_t T;
};

// offsets in floats: the q tile, the score tile, then (fp) the f32 K / V
// ring, or (Q8) the widened K / V tiles, the int8 ring and its scales;
// then the table row
template <int D, int RA, bool Q8>
struct F32PagedSmem {
  static constexpr int QR = 16 * RA;
  static constexpr int TILE = af::ROWS * af::ld<D>();   // a (64, D) tile
  static constexpr int Q = 0;
  static constexpr int P = Q + QR * af::ld<D>();
  static constexpr int K = P + QR * af::PLD;
  static constexpr int V = K + (Q8 ? 1 : F32_STAGES) * TILE;
  static constexpr int RING = V + (Q8 ? 1 : F32_STAGES) * TILE;
  static constexpr int SC = RING + (Q8 ? F32_STAGES * 2 * PT * D / 4 : 0);
  static constexpr int TBL = SC + (Q8 ? F32_STAGES * 2 * PT : 0);
};

// grid (KV, B, slabs · chunks); 16·RA query rows a block
template <int D, int RA, bool Q8, bool DENSE>
__global__ void __launch_bounds__(F32_NT)
paged_f32_kernel(const float* __restrict__ q, const void* __restrict__ kv_k,
                 const void* __restrict__ kv_v,
                 const float* __restrict__ k_scale,
                 const float* __restrict__ v_scale,
                 const int* __restrict__ tables, const int* __restrict__ pos,
                 float* __restrict__ o, float* __restrict__ ws,
                 int* __restrict__ cnt, int C, int G, int N, int page, int P,
                 int split, float sl2, const Strides st) {
  using L = F32PagedSmem<D, RA, Q8>;
  typedef typename F32Cell<Q8>::T CT;
  constexpr int QR = L::QR, LD = af::ld<D>(), C4 = D / 4;
  constexpr int CC = D * sizeof(CT) / 16;   // 16-byte copies a cell
  constexpr int NO = D / 16;                // output columns a thread a row
  static_assert(D % 64 == 0 && PT == af::ROWS, "64-cell tiles, d of 64s");
  static_assert(!(DENSE && Q8), "the dense leg is fp");
  extern __shared__ __align__(16) float smf[];
  int* tbl = reinterpret_cast<int*>(smf + L::TBL);
  __shared__ int last_flag;

  const int kvh = blockIdx.x, bb = blockIdx.y;
  const int nch = split ? (P * page + PT * split - 1) / (PT * split) : 1;
  const int slab = blockIdx.z / nch, ch = blockIdx.z % nch;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int rows = C * G, r0 = slab * QR;
  const int p0 = pos[bb];
  const int c_last = (min(r0 + QR, rows) - 1) / G;
  const int nkeys = min(p0 + c_last + 1, P * page);
  const int ntiles = (nkeys + PT - 1) / PT;
  const int t0 = split ? ch * split : 0;
  const int t1 = split ? min(ntiles, t0 + split) : ntiles;
  if (t0 >= t1) return;   // a chunk past this slot's window

  if constexpr (!DENSE) {
    const int npages = (nkeys + page - 1) / page;
    for (int j = tid; j < npages; j += F32_NT) {   // sentinels clamped
      const int e = tables[bb * st.v[12] + j];
      tbl[j] = e < 0 ? 0 : (e >= N ? N - 1 : e);
    }
  }
  const CT* kb = static_cast<const CT*>(kv_k) + kvh * st.v[5];
  const CT* vb = static_cast<const CT*>(kv_v) + kvh * st.v[8];
  for (int i = tid; i < QR * C4; i += F32_NT) {   // rows past C·G are zero
    const int row = i / C4, c = i % C4, rr = r0 + row;
    const bool ok = rr < rows;
    const int cc = ok ? rr / G : 0, g = ok ? rr - cc * G : 0;
    cp_async16(smem_u32(smf + L::Q + row * LD + c * 4),
               ok ? q + bb * st.v[0] + cc * st.v[1] + (kvh * G + g) * st.v[2] +
                        c * 4
                  : q,
               ok ? 16 : 0);
  }
  __syncthreads();   // the table row, for the copies below
  auto issue = [&](int t) {   // tile t (cells 64 t ..) into its stage
    const int stg = (t - t0) % F32_STAGES;
    for (int i = tid; i < 2 * PT * CC; i += F32_NT) {
      const int isv = i >= PT * CC, rem = isv ? i - PT * CC : i;
      const int cell = rem / CC, c = rem % CC, ci = t * PT + cell;
      const bool ok = ci < nkeys;
      long long off = c * (16 / sizeof(CT));
      if (ok && DENSE) {   // slot bb's cell ci
        off += bb * (isv ? st.v[6] : st.v[3]) +
               static_cast<long long>(ci) * (isv ? st.v[7] : st.v[4]);
      } else if (ok) {     // row ci % page of the cell's table entry
        const int pg = ci / page;
        off += static_cast<long long>(tbl[pg]) * (isv ? st.v[6] : st.v[3]) +
               static_cast<long long>(ci - pg * page) *
                   (isv ? st.v[7] : st.v[4]);
      }
      const uint32_t dst =
          Q8 ? smem_u32(smf + L::RING) + ((stg * 2 + isv) * PT + cell) * D +
                   c * 16
             : smem_u32(smf + (isv ? L::V : L::K) + stg * L::TILE +
                        cell * LD + c * 4);
      cp_async16(dst, (isv ? vb : kb) + off, ok ? 16 : 0);
    }
    if constexpr (Q8) {   // the cells' scales, gathered the same way
      for (int i = tid; i < 2 * PT; i += F32_NT) {
        const int isv = i >= PT, cell = i % PT, ci = t * PT + cell;
        const bool ok = ci < nkeys;
        const int pg = ci / page;
        const long long off =
            ok ? static_cast<long long>(tbl[pg]) * st.v[isv ? 16 : 13] +
                     static_cast<long long>(ci - pg * page) *
                         st.v[isv ? 17 : 14]
               : 0;
        cp_async4(smem_u32(smf + L::SC + (stg * 2 + isv) * PT + cell),
                  (isv ? v_scale + kvh * st.v[18] : k_scale + kvh * st.v[15]) +
                      off,
                  ok ? 4 : 0);
      }
    }
  };
  issue(t0);
  cp_async_commit();   // with q's copies

  // the last cell each of this thread's rows attends (-1: padding)
  int lim[RA];
  float m[RA], l[RA], oacc[RA][NO];
#pragma unroll
  for (int a = 0; a < RA; ++a) {
    const int rr = r0 + ty * RA + a;
    lim[a] = rr < rows ? min(p0 + rr / G, nkeys - 1) : -1;
    m[a] = af::NEG;
    l[a] = 0.f;
#pragma unroll
    for (int c = 0; c < NO; ++c) oacc[a][c] = 0.f;
  }

  for (int t = t0; t < t1; ++t) {
    const int stg = (t - t0) % F32_STAGES;
    // the other stage held tile t - 1, consumed before the loop's last
    // barrier
    if (t + 1 < t1) issue(t + 1);
    cp_async_commit();
    cp_async_wait<1>();   // tile t (and at t0, q) has landed
    __syncthreads();      // ... for every thread
    const float* kt = smf + L::K + (Q8 ? 0 : stg * L::TILE);
    const float* vt = smf + L::V + (Q8 ? 0 : stg * L::TILE);
    const float* ksc = smf + L::SC + stg * 2 * PT;
    const float* vsc = ksc + PT;
    if constexpr (Q8) {
      // widen the stage's int8 K and V exactly into the f32 tiles (4 cell
      // values a thread at a time); tile t - 1's are consumed
      const int8_t* ring = reinterpret_cast<const int8_t*>(smf + L::RING) +
                           stg * 2 * PT * D;
      for (int i = tid; i < 2 * PT * C4; i += F32_NT) {
        const int isv = i >= PT * C4, rem = isv ? i - PT * C4 : i;
        const int cell = rem / C4, c = rem % C4;
        const char4 u = *reinterpret_cast<const char4*>(
            ring + (isv * PT + cell) * D + c * 4);
        *reinterpret_cast<float4*>(smf + (isv ? L::V : L::K) + cell * LD +
                                   c * 4) =
            make_float4(u.x, u.y, u.z, u.w);
      }
      __syncthreads();
    }
    float sc[RA][4];
#pragma unroll
    for (int a = 0; a < RA; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) sc[a][b] = 0.f;
    af::dot_nt<D>(sc, smf + L::Q, kt, tx, ty);   // S = Q·Kᵀ
    float kscale[4], vscale[4];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      kscale[b] = Q8 ? ksc[tx + 16 * b] * sl2 : sl2;
      vscale[b] = Q8 ? vsc[tx + 16 * b] : 1.f;
    }
#pragma unroll
    for (int a = 0; a < RA; ++a) {
      float mt = af::NEG;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int ci = t * PT + tx + 16 * b;
        sc[a][b] = ci <= lim[a] ? sc[a][b] * kscale[b] : af::NEG;
        mt = fmaxf(mt, sc[a][b]);
      }
      const float mn = fmaxf(m[a], af::row_max(mt));
      const float corr = exp2f(m[a] - mn);
      float rs = 0.f;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const float p = sc[a][b] == af::NEG ? 0.f : exp2f(sc[a][b] - mn);
        rs += p;
        sc[a][b] = p * vscale[b];   // Q8: p·s_v, the P·V operand
      }
      m[a] = mn;
      l[a] = l[a] * corr + rs;
#pragma unroll
      for (int c = 0; c < NO; ++c) oacc[a][c] *= corr;
    }
    af::store_scores(smf + L::P, sc, tx, ty);
    __syncthreads();
    af::dot_nn<D>(oacc, smf + L::P, vt, tx, ty);   // O += P·V
    __syncthreads();   // this stage, the score tile (and Q8 the widened
                       // tiles) are consumed
  }
  cp_async_wait<0>();
#pragma unroll
  for (int a = 0; a < RA; ++a) l[a] = af::row_sum(l[a]);

  if (split) {   // partials out, the last chunk of the window merges
    constexpr int W = RA * (NO + 2);   // floats a thread
    const int live = (ntiles + split - 1) / split;   // this window's chunks
    const int bk = (bb * gridDim.x + kvh) * (gridDim.z / nch) + slab;
    float* part = ws + static_cast<long long>(bk) * nch * W * F32_NT;
    float* mine = part + static_cast<long long>(ch) * W * F32_NT;
#pragma unroll
    for (int a = 0; a < RA; ++a) {
#pragma unroll
      for (int c = 0; c < NO; ++c)
        mine[(a * NO + c) * F32_NT + tid] = oacc[a][c];
      mine[(RA * NO + a) * F32_NT + tid] = m[a];
      mine[(RA * NO + RA + a) * F32_NT + tid] = l[a];
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      last_flag = atomicAdd(cnt + bk, 1) == live - 1;
      if (last_flag) cnt[bk] = 0;   // ready for the next launch
    }
    __syncthreads();
    if (!last_flag) return;
    __threadfence();
    for (int c = 0; c < live; ++c) {   // chunk order: the same f32 sums
      const float* src = part + static_cast<long long>(c) * W * F32_NT;
#pragma unroll
      for (int a = 0; a < RA; ++a) {
        const float mc = __ldcg(src + (RA * NO + a) * F32_NT + tid);
        const float lc = __ldcg(src + (RA * NO + RA + a) * F32_NT + tid);
        const float mn = c == 0 ? mc : fmaxf(m[a], mc);
        const float fa = c == 0 ? 0.f : exp2f(m[a] - mn);
        const float fb = exp2f(mc - mn);
        l[a] = (c == 0 ? 0.f : l[a] * fa) + lc * fb;
        m[a] = mn;
#pragma unroll
        for (int e = 0; e < NO; ++e)
          oacc[a][e] = (c == 0 ? 0.f : oacc[a][e] * fa) +
                       __ldcg(src + (a * NO + e) * F32_NT + tid) * fb;
      }
    }
  }

#pragma unroll
  for (int a = 0; a < RA; ++a) {   // rows past C·G are padding: not written
    const int rr = r0 + ty * RA + a;
    if (rr >= rows) continue;
    const int cc = rr / G, g = rr - cc * G;
    float* ob = o + bb * st.v[9] + cc * st.v[10] + (kvh * G + g) * st.v[11];
    const float inv = 1.f / fmaxf(l[a], 1e-30f);
#pragma unroll
    for (int gq = 0; gq < D / 64; ++gq)
      *reinterpret_cast<float4*>(ob + gq * 64 + tx * 4) =
          make_float4(oacc[a][gq * 4] * inv, oacc[a][gq * 4 + 1] * inv,
                      oacc[a][gq * 4 + 2] * inv, oacc[a][gq * 4 + 3] * inv);
  }
}

template <int D, int RA, bool Q8, bool DENSE>
int launch_f32(const TcArgs& a, const Strides& st, void* stream) {
  using L = F32PagedSmem<D, RA, Q8>;
  const int smem = 4 * L::TBL + (DENSE ? 0 : (a.P * 4 + 15) & ~15);
  if (smem > 200 * 1024) return (int)cudaErrorInvalidValue;
  static int smem_set = 0;   // per instantiation, grows only
  if (smem > smem_set) {
    cudaError_t e = af::allow_smem(paged_f32_kernel<D, RA, Q8, DENSE>, smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  dim3 grid(a.KV, a.B, a.nslab * a.nch);
  paged_f32_kernel<D, RA, Q8, DENSE>
      <<<grid, F32_NT, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(a.q), a.k, a.v,
          static_cast<const float*>(a.ks), static_cast<const float*>(a.vs),
          static_cast<const int*>(a.tables), static_cast<const int*>(a.pos),
          static_cast<float*>(a.o), static_cast<float*>(a.ws),
          static_cast<int*>(a.cnt), a.C, a.G, a.N, a.page, a.P, a.split,
          LOG2E / sqrtf((float)D), st);
  return (int)cudaGetLastError();
}

// rows a block (brows <= 64) -> RA = 1, 2 or 4 (16, 32 or 64 rows)
template <bool Q8, bool DENSE>
int launch_f32_rows(int brows, const TcArgs& a, const Strides& st,
                    void* stream) {
  if (brows <= 16) return launch_f32<64, 1, Q8, DENSE>(a, st, stream);
  if (brows <= 32) return launch_f32<64, 2, Q8, DENSE>(a, st, stream);
  return launch_f32<64, 4, Q8, DENSE>(a, st, stream);
}

// the f32 legs of run_tc: d = 64 only, slabs of at most 64 rows
template <bool Q8>
int run_f32(const void* q, const void* k, const void* v, const void* ks,
            const void* vs, const void* tables, const void* pos, void* o,
            int B, int C, int H, int KV, int d, int N, int page, int P,
            const long long* strides, int split, void* ws, void* cnt,
            void* stream) {
  if (B < 1 || C < 1 || KV < 1 || H % KV != 0 || N < 1 || P < 1 ||
      page < 8 || page > 64 || page % 8 != 0 || B > 65535 || split < 0 ||
      d != 64 || (split > 0 && (ws == nullptr || cnt == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int G = H / KV;
  if (G != 1 && G != 2 && G != 4 && G != 8) return (int)cudaErrorInvalidValue;
  const int rows = C * G;
  const int nslab = (rows + F32_SLAB - 1) / F32_SLAB;
  const int nch = split ? (P * page + PT * split - 1) / (PT * split) : 1;
  if (static_cast<long long>(nslab) * nch > 65535)
    return (int)cudaErrorInvalidValue;
  Strides st{};
  for (int i = 0; i < (Q8 ? 19 : 13); ++i) st.v[i] = strides[i];
  const TcArgs a{q, k, v, ks, vs, tables, pos, o, ws, cnt, B, C, G, KV, N,
                 page, P, split, nslab, nch};
  return launch_f32_rows<Q8, false>(nslab > 1 ? F32_SLAB : rows, a, st,
                                    stream);
}

// K4 in f32: one query a slot over the dense cache, G rows a block
int run_dense_f32(const void* q, const void* k, const void* v,
                  const void* pos, void* o, int B, int S, int H, int KV,
                  int d, const long long* strides, int split, void* ws,
                  void* cnt, void* stream) {
  if (B < 1 || S < 1 || KV < 1 || H % KV != 0 || B > 65535 || split < 0 ||
      d != 64 || (split > 0 && (ws == nullptr || cnt == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int G = H / KV;
  if (G != 1 && G != 2 && G != 4 && G != 8) return (int)cudaErrorInvalidValue;
  const int nch = split ? (S + PT * split - 1) / (PT * split) : 1;
  if (nch > 65535) return (int)cudaErrorInvalidValue;
  const long long* s = strides;
  const Strides st{{s[0], 0, s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8],
                    0, s[9], 0}};
  const TcArgs a{q, k, v, nullptr, nullptr, nullptr, pos, o, ws, cnt, B, 1,
                 G, KV, 0, 1, S, split, 1, nch};
  return launch_f32<64, 1, false, true>(a, st, stream);
}

}  // namespace

extern "C" {

// q (B, C, H, d) bf16; k/v (N, page, KV, d) bf16 pools; tables (B, P)
// int32 (entries >= N are sentinels), last dim contiguous; pos (B,) int32;
// o (B, C, H, d) bf16. strides: 13 element strides (q: b, c, h; k: n, p,
// kv; v: n, p, kv; o: b, c, h; tables: b), q/k/v/o ones a multiple of 8
// with 16-byte aligned bases. d in {64, 112, 128, 256} (112 on the
// d = 128 tiles: dt = 128 below, else dt = d); any H / KV; page a
// multiple of 8 in [8, 64]. split: tiles of 64 cells a chunk
// of the window (0: one block a window); with split > 0, ws an f32
// workspace of B · KV · slabs · chunks · threads · (dt / 2 + 4) floats
// (threads = 128 · warpgroups, slabs = ceil(C·G / 256), at d = 256
// ceil(C·G / 64) with 128 threads, chunks = ceil(P · page / (64 ·
// split))) and cnt B · KV · slabs zeroed int counters (left at zero).
int paged_attention_bf16(const void* q, const void* k, const void* v,
                         const void* tables, const void* pos, void* o, int B,
                         int C, int H, int KV, int d, int N, int page, int P,
                         const long long* strides, int split, void* ws,
                         void* cnt, void* stream) {
  return run_tc<false>(q, k, v, nullptr, nullptr, tables, pos, o, B, C, H,
                       KV, d, N, page, P, strides, split, ws, cnt, stream);
}

// The int8 leg: k/v (N, page, KV, d) int8 pools, k_scale / v_scale
// (N, page, KV) f32 per-cell scales. strides: the 13 above (k / v ones a
// multiple of 16 with 16-byte aligned bases), then k_scale (n, p, kv) and
// v_scale (n, p, kv) element strides. split, ws and cnt as above, with
// 128 threads a block and slabs = ceil(C·G / 64).
int paged_attention_int8(const void* q, const void* k, const void* v,
                         const void* k_scale, const void* v_scale,
                         const void* tables, const void* pos, void* o, int B,
                         int C, int H, int KV, int d, int N, int page, int P,
                         const long long* strides, int split, void* ws,
                         void* cnt, void* stream) {
  return run_tc<true>(q, k, v, k_scale, v_scale, tables, pos, o, B, C, H,
                      KV, d, N, page, P, strides, split, ws, cnt, stream);
}

// K4: q (B, H, d) bf16; k/v (B, S, KV, d) bf16 dense cache; pos (B,)
// int32; o (B, H, d) bf16. strides: 10 element strides (q: b, h; k: b, s,
// kv; v: b, s, kv; o: b, h), each a multiple of 8 with 16-byte aligned
// bases and a contiguous last dim. Slot b attends cells
// 0 .. min(pos[b], S - 1). d in {64, 112, 128, 256}; any H / KV. split, ws
// and cnt as paged_attention_bf16's, with 128 threads a block, slabs =
// ceil(G / 64) and chunks = ceil(S / (64 · split)).
int dense_decode_attention_bf16(const void* q, const void* k, const void* v,
                                const void* pos, void* o, int B, int S,
                                int H, int KV, int d,
                                const long long* strides, int split,
                                void* ws, void* cnt, void* stream) {
  return run_dense(q, k, v, pos, o, B, S, H, KV, d, strides, split, ws, cnt,
                   stream);
}


// The f32 instances (FFMA, d = 64): the functions above with q, the fp
// pools and o in f32 (strides alike, in f32 elements: q / k / v / o ones a
// multiple of 4). split > 0: ws an f32 workspace of B · KV · slabs ·
// chunks · 256 · RA · (d / 16 + 2) floats, slabs = ceil(C·G / 64), RA =
// 1, 2 or 4 for a block of up to 16, 32 or 64 rows (K4: slabs = 1, RA =
// 1), and cnt as above; H / KV in {1, 2, 4, 8}.
int paged_attention_f32(const void* q, const void* k, const void* v,
                        const void* tables, const void* pos, void* o, int B,
                        int C, int H, int KV, int d, int N, int page, int P,
                        const long long* strides, int split, void* ws,
                        void* cnt, void* stream) {
  return run_f32<false>(q, k, v, nullptr, nullptr, tables, pos, o, B, C, H,
                        KV, d, N, page, P, strides, split, ws, cnt, stream);
}

int paged_attention_int8_f32(const void* q, const void* k, const void* v,
                             const void* k_scale, const void* v_scale,
                             const void* tables, const void* pos, void* o,
                             int B, int C, int H, int KV, int d, int N,
                             int page, int P, const long long* strides,
                             int split, void* ws, void* cnt, void* stream) {
  return run_f32<true>(q, k, v, k_scale, v_scale, tables, pos, o, B, C, H,
                       KV, d, N, page, P, strides, split, ws, cnt, stream);
}

int dense_decode_attention_f32(const void* q, const void* k, const void* v,
                               const void* pos, void* o, int B, int S, int H,
                               int KV, int d, const long long* strides,
                               int split, void* ws, void* cnt, void* stream) {
  return run_dense_f32(q, k, v, pos, o, B, S, H, KV, d, strides, split, ws,
                       cnt, stream);
}

}  // extern "C"
