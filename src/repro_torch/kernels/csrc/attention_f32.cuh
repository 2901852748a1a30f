// f32 attention tiles for the f32 instances of K3 / #5 (flash_attention.cu),
// #6 / #7 (flash_attention_bwd.cu) and K4 / #8 / #8q (paged_attention.cu):
// RoBERTa trains and serves in f32, and these compute in f32 — every
// product an FFMA on the CUDA cores, none on f32 inputs rounded to TF32 or
// bf16.
//
// A block is 256 threads, tx = tid % 16 and ty = tid / 16, over tiles of
// 64 rows (queries or keys). The query side of a product may be 16·RA rows
// (RA = 4: 64; the decode kernels take RA = 1 or 2 for 16 or 32 query
// rows), thread (tx, ty) owning rows ty·RA + a. Each tile sits in shared
// memory in its natural layout, one row of D f32 padded to D + 4, so that
//  - a row is copied with 16-byte loads and stores, consecutive threads
//    along the row;
//  - in a score product S = A·Bᵀ over d (dot_nt), thread (tx, ty) owns
//    rows ty·RA + a and columns tx + 16·b (b < 4), and reads its four
//    B rows d4 at a time: the rows of a quarter-warp start 4 banks apart,
//    so the 16-byte reads hit distinct banks;
//  - in a value product O += P·V (dot_nn), thread (tx, ty) owns rows
//    ty·RA + a and columns tx·4 + c of each 64 of D, and reads P rows and
//    V rows 16 bytes at a time.
// A score tile (64 x 64) is written to shared memory as [row][col] with a
// row of 68 for the value product that consumes it. Rows held by one ty
// live in 16 consecutive lanes, so a row's max or sum is four shfl.xor.
//
// What bounds them on an H100: 4·d (forward) and 14·d (backward) flops a
// (query, key) pair at FFMA's 67 TFLOP/s — operations, not bytes, at the
// training shape; the decode kernels read each cache cell once for a few
// query rows — bytes.

#pragma once

#include <cuda_runtime.h>

namespace attn_f32 {

constexpr int ROWS = 64;     // rows of a tile (queries or keys)
constexpr int THREADS = 256;
constexpr int PLD = ROWS + 4;   // row of a score tile in shared memory
constexpr float NEG = -1e30f;

template <int D>
__host__ __device__ constexpr int ld() { return D + 4; }

// floats of one (64, D) tile and of one (64, 64) score tile
template <int D>
__host__ __device__ constexpr int tile_floats() { return ROWS * ld<D>(); }
__host__ __device__ constexpr int score_floats() { return ROWS * PLD; }

// rows [r0, r0 + 64) of a (rows, D) f32 matrix whose row r starts at
// src + r·rs (16-byte aligned) into t; rows >= n are zero-filled
template <int D>
__device__ __forceinline__ void load_tile(float* t, const float* src,
                                          long long rs, int r0, int n) {
  constexpr int C4 = D / 4;
  for (int e = threadIdx.x; e < ROWS * C4; e += THREADS) {
    const int r = e / C4, c = (e % C4) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < n)
      v = *reinterpret_cast<const float4*>(src + (long long)(r0 + r) * rs + c);
    *reinterpret_cast<float4*>(t + r * ld<D>() + c) = v;
  }
}

// acc[a][b] += Σ_d A[ty·RA + a][d] · B[tx + 16·b][d]
template <int D, int RA>
__device__ __forceinline__ void dot_nt(float (&acc)[RA][4], const float* A,
                                       const float* B, int tx, int ty) {
  constexpr int L = ld<D>();
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 av[RA], bv[4];
#pragma unroll
    for (int a = 0; a < RA; ++a)
      av[a] = *reinterpret_cast<const float4*>(A + (ty * RA + a) * L + d);
#pragma unroll
    for (int b = 0; b < 4; ++b)
      bv[b] = *reinterpret_cast<const float4*>(B + (tx + 16 * b) * L + d);
#pragma unroll
    for (int a = 0; a < RA; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        float s = acc[a][b];
        s = fmaf(av[a].x, bv[b].x, s);
        s = fmaf(av[a].y, bv[b].y, s);
        s = fmaf(av[a].z, bv[b].z, s);
        acc[a][b] = fmaf(av[a].w, bv[b].w, s);
      }
  }
}

// acc[a][g·4 + c] += Σ_j P[ty·RA + a][j] · V[j][g·64 + tx·4 + c]; P a
// (16·RA, 64) score tile, V a (64, D) tile
template <int D, int RA>
__device__ __forceinline__ void dot_nn(float (&acc)[RA][D / 16],
                                       const float* P, const float* V,
                                       int tx, int ty) {
  constexpr int L = ld<D>(), G = D / 64;
#pragma unroll 2
  for (int j = 0; j < ROWS; j += 4) {
    float4 pv[RA];
#pragma unroll
    for (int a = 0; a < RA; ++a)
      pv[a] = *reinterpret_cast<const float4*>(P + (ty * RA + a) * PLD + j);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float4 v = *reinterpret_cast<const float4*>(
            V + (j + u) * L + g * 64 + tx * 4);
#pragma unroll
        for (int a = 0; a < RA; ++a) {
          const float p = u == 0 ? pv[a].x : u == 1 ? pv[a].y
                        : u == 2 ? pv[a].z : pv[a].w;
          acc[a][g * 4 + 0] = fmaf(p, v.x, acc[a][g * 4 + 0]);
          acc[a][g * 4 + 1] = fmaf(p, v.y, acc[a][g * 4 + 1]);
          acc[a][g * 4 + 2] = fmaf(p, v.z, acc[a][g * 4 + 2]);
          acc[a][g * 4 + 3] = fmaf(p, v.w, acc[a][g * 4 + 3]);
        }
      }
    }
  }
}

// an RA x 4 score block into the (16·RA, 64) tile at [ty·RA + a][tx + 16·b]
template <int RA>
__device__ __forceinline__ void store_scores(float* P, const float (&s)[RA][4],
                                             int tx, int ty) {
#pragma unroll
  for (int a = 0; a < RA; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) P[(ty * RA + a) * PLD + tx + 16 * b] = s[a][b];
}

// max / sum over the 16 lanes of a row (lanes with one ty)
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the dynamic shared memory a kernel asks for above the default 48 KB
template <typename K>
inline cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

}  // namespace attn_f32
