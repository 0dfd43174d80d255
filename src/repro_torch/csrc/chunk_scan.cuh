// The chunk-parallel scan shared by csrc/relu_attn_causal.cu and
// csrc/ssd.cu.
//
// Both TPU kernels walk a row's chunks in order and carry a state from
// one chunk to the next.  The state is linear in the chunks, so on the
// card each scan runs as three launches, none of them ordered over the
// chunks but the second:
//   1. states   one CTA per (row, chunk, 64-row tile of the state): the
//               chunk's own contribution dS_c = A_c^T B_c (and, for the
//               attention, dz_c = sum A_c), into a workspace slot per
//               chunk.  The last chunk's is never read and not computed.
//   2. prefix   one thread per (row, state entry) turns the slots into
//               the state entering each chunk, in place:
//               S_0 = 0, S_{c+1} = a_c S_c + dS_c (a_c = 1 for the
//               attention, the chunk's total decay for the SSD).
//               Elementwise over the entries, in order over the chunks.
//   3. outputs  one CTA per (row, chunk, 64-token query tile): the state
//               term against S_c, then the score tiles of the key tiles
//               at or before the query tile, each computed once for all
//               output columns.
// A single chunk needs only launch 3.  The workspace comes from the
// caller (PyTorch's allocator); no launch allocates.  Every sum runs in
// a fixed order and nothing uses atomics, so a call's bits repeat.
//
// Register tiles (256 threads as 16 x 16, thread (tx, ty)):
//   score_tile  4 x 4 scores, query rows 4 ty + i (a warp's 8 rows
//               consecutive), key rows tx + 16 j, float4 reads along the
//               depth of rows staged at a pitch whose float4 count is odd
//               (16 key rows in 2 wavefronts).  On a diagonal tile a warp
//               skips the key blocks past its rows, and its products with
//               V the keys past them.
//   mul_acc     a 64 x K tile times a K x 64G tile: rows 4 ty + i,
//               columns 4 tx + 64 g + u, float4 reads of both operands.
//   outer_acc   the state tile, A^T B over tokens: rows 4 ty + u,
//               columns 4 tx + 64 g + v.
// Staging: fp32 tiles by cp.async, all of a tile's copies in flight at
// once (stage_start, then stage_finish for a ReLU or a scale); in the
// output launch a key tile's V copies run under its scores and the next
// K's under scores . V, in the same buffers.  bf16 rows, and rows whose
// length is no multiple of 4, go through registers, four loads in
// flight a thread (a load at a time exposes one global latency per
// float4).
#pragma once

#include <cuda_bf16.h>

#include <type_traits>

#include "common.cuh"

namespace cscan {

constexpr int TILE = 64;   // query rows, key rows, state rows of a tile
constexpr int NT = 256;    // threads of a CTA
constexpr int SP = 68;     // pitch of the score tile

__host__ __device__ inline int pad4(int n) { return (n + 3) & ~3; }
// Pitch of a row of n values read as float4 along the row by 16 rows at
// once: pad4(n), plus 4 where its float4 count is even.
__host__ __device__ inline int apitch(int n) {
  const int p = pad4(n);
  return p / 4 % 2 ? p : p + 4;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// row[c .. c + 3], zeros past len; `vec`: len % 4 == 0 (rows aligned).
__device__ __forceinline__ float4 load4(const float* row, int c, int len,
                                        bool vec) {
  if (vec && c + 3 < len) return ld4(row + c);
  float4 v;
  v.x = c < len ? row[c] : 0.0f;
  v.y = c + 1 < len ? row[c + 1] : 0.0f;
  v.z = c + 2 < len ? row[c + 2] : 0.0f;
  v.w = c + 3 < len ? row[c + 3] : 0.0f;
  return v;
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* row, int c,
                                        int len, bool vec) {
  if (vec && c + 3 < len) {
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(row + c);
    const float2 a = __bfloat1622float2(p[0]), b = __bfloat1622float2(p[1]);
    return make_float4(a.x, a.y, b.x, b.y);
  }
  float4 v;
  v.x = c < len ? to_f32(row[c]) : 0.0f;
  v.y = c + 1 < len ? to_f32(row[c + 1]) : 0.0f;
  v.z = c + 2 < len ? to_f32(row[c + 2]) : 0.0f;
  v.w = c + 3 < len ? to_f32(row[c + 3]) : 0.0f;
  return v;
}

// dst[r * pitch + j] = src[r * len + c0 + j] for r < TILE, j < width (a
// multiple of 4): zeros for r >= nrows or c0 + j >= len, ReLU'd when
// RELU, times scale[r] when scale is given.  Four float4 loads of a
// thread in flight at once.
template <bool RELU, typename T>
__device__ __forceinline__ void stage(float* dst, int pitch, const T* src,
                                      int nrows, int len, int c0, int width,
                                      const float* scale) {
  const int w4 = width >> 2, total = TILE * w4;
  const bool vec = len % 4 == 0;
#pragma unroll 1
  for (int i0 = threadIdx.x; i0 < total; i0 += 4 * NT) {
    float4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * NT, r = i / w4, j = (i - r * w4) * 4;
      v[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (i < total && r < nrows)
        v[u] = load4(src + (size_t)r * len, c0 + j, len, vec);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * NT, r = i / w4, j = (i - r * w4) * 4;
      if (i >= total) break;
      if (RELU) {
        v[u].x = fmaxf(v[u].x, 0.0f);
        v[u].y = fmaxf(v[u].y, 0.0f);
        v[u].z = fmaxf(v[u].z, 0.0f);
        v[u].w = fmaxf(v[u].w, 0.0f);
      }
      if (scale != nullptr && r < nrows) {
        const float s = scale[r];
        v[u].x *= s;
        v[u].y *= s;
        v[u].z *= s;
        v[u].w *= s;
      }
      *reinterpret_cast<float4*>(dst + r * pitch + j) = v[u];
    }
  }
}

// The tile of `stage`, started by cp.async where it can be (fp32 rows of
// a length divisible by 4: 16-byte copies, zero-filled past nrows or
// len) and true then: the caller commits, waits for the copies and calls
// stage_finish for the ReLU or the scale.  Otherwise staged through
// registers now (ReLU and scale applied), and false.
template <bool RELU, typename T>
__device__ __forceinline__ bool stage_start(float* dst, int pitch,
                                            const T* src, int nrows, int len,
                                            int c0, int width,
                                            const float* scale) {
  if constexpr (std::is_same<T, float>::value) {
    if (len % 4 == 0) {
      const int w4 = width >> 2;
#pragma unroll 1
      for (int i = threadIdx.x; i < TILE * w4; i += NT) {
        const int r = i / w4, j = (i - r * w4) * 4;
        const bool full = r < nrows && c0 + j < len;
        cp_async16(dst + r * pitch + j,
                   full ? src + (size_t)r * len + c0 + j : src, full);
      }
      return true;
    }
  }
  stage<RELU>(dst, pitch, src, nrows, len, c0, width, scale);
  return false;
}

// After this thread's copies of a stage_start that returned true have
// landed: ReLU (RELU) or times scale[r] on the float4s it copied.
template <bool RELU>
__device__ __forceinline__ void stage_finish(float* dst, int pitch,
                                             int nrows, int width,
                                             const float* scale) {
  const int w4 = width >> 2;
#pragma unroll 1
  for (int i = threadIdx.x; i < TILE * w4; i += NT) {
    const int r = i / w4, j = (i - r * w4) * 4;
    if (r >= nrows) continue;
    float4* p = reinterpret_cast<float4*>(dst + r * pitch + j);
    float4 v = *p;
    if (RELU) {
      v.x = fmaxf(v.x, 0.0f);
      v.y = fmaxf(v.y, 0.0f);
      v.z = fmaxf(v.z, 0.0f);
      v.w = fmaxf(v.w, 0.0f);
    } else {
      const float s = scale[r];
      v.x *= s;
      v.y *= s;
      v.z *= s;
      v.w *= s;
    }
    *p = v;
  }
}

// s[i][j] = A[4 ty + i, :depth] . B[tx + 16 j, :depth] for the key
// blocks j < NJ (depth a multiple of 4, both staged at pitch ap).
template <int NJ>
__device__ __forceinline__ void score_rows(float (&s)[4][4], const float* A,
                                           const float* B, int ap,
                                           int depth) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll 2
  for (int d = 0; d < depth; d += 4) {
    float4 a[4], b[NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = ld4(A + (4 * ty + i) * ap + d);
#pragma unroll
    for (int j = 0; j < NJ; ++j) b[j] = ld4(B + (tx + 16 * j) * ap + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        float t = s[i][j];
        t = fmaf(a[i].x, b[j].x, t);
        t = fmaf(a[i].y, b[j].y, t);
        t = fmaf(a[i].z, b[j].z, t);
        t = fmaf(a[i].w, b[j].w, t);
        s[i][j] = t;
      }
  }
}

// The 64 x 64 score tile A B^T: a thread's rows 4 ty + i (a warp holds 8
// consecutive rows), its keys tx + 16 j, over the key blocks j < nj
// (warp-uniform; the rest zero): on a diagonal tile a warp skips the key
// blocks past its last row.
__device__ __forceinline__ void score_tile(float (&s)[4][4], const float* A,
                                           const float* B, int ap, int depth,
                                           int nj) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
  switch (nj) {
    case 1: score_rows<1>(s, A, B, ap, depth); break;
    case 2: score_rows<2>(s, A, B, ap, depth); break;
    case 3: score_rows<3>(s, A, B, ap, depth); break;
    default: score_rows<4>(s, A, B, ap, depth); break;
  }
}

// Key blocks of 16 and keys (a multiple of 4) a warp needs of a key tile
// of kn keys: on the diagonal tile only those at or before its last row
// (rows 8 w .. 8 w + 7 of warp w).
__device__ __forceinline__ int diag_blocks(bool diag) {
  return diag ? (threadIdx.x >> 6) + 1 : 4;
}
__device__ __forceinline__ int diag_keys(bool diag, int kn) {
  const int k4 = pad4(kn);
  return diag ? min(k4, 8 * (threadIdx.x >> 5) + 8) : k4;
}

enum Den { NO_DEN, DEN_ONES, DEN_VEC };

// acc[i][g][u] += sum_k P[4 ty + i, k] V[k, 4 tx + 64 g + u] over k <
// kn (a multiple of 4; P at pitch pp, V at pitch vp).  The denominator:
// den[i] += sum_k P[., k] (DEN_ONES) or P[., k] z[k] (DEN_VEC).
template <int G, Den DEN>
__device__ __forceinline__ void mul_acc(float (&acc)[4][G][4],
                                        float (&den)[4], const float* P,
                                        int pp, const float* V, int vp,
                                        int kn, const float* z) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll 1
  for (int k = 0; k < kn; k += 4) {
    float4 p4[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) p4[i] = ld4(P + (4 * ty + i) * pp + k);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      float4 v[G];
#pragma unroll
      for (int g = 0; g < G; ++g) v[g] = ld4(V + (k + t) * vp + 4 * tx + 64 * g);
      const float zt = DEN == DEN_VEC ? z[k + t] : 1.0f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = t == 0 ? p4[i].x : t == 1 ? p4[i].y
                      : t == 2 ? p4[i].z : p4[i].w;
        if (DEN != NO_DEN) den[i] = fmaf(p, zt, den[i]);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          acc[i][g][0] = fmaf(p, v[g].x, acc[i][g][0]);
          acc[i][g][1] = fmaf(p, v[g].y, acc[i][g][1]);
          acc[i][g][2] = fmaf(p, v[g].z, acc[i][g][2]);
          acc[i][g][3] = fmaf(p, v[g].w, acc[i][g][3]);
        }
      }
    }
  }
}

// acc[u][g][v] += sum_m A[m, 4 ty + u] B[m, 4 tx + 64 g + v] over m < mn
// (A at pitch TILE, B at pitch vp); za[u] += sum_m A[m, 4 ty + u] when
// SUM.
template <int G, bool SUM>
__device__ __forceinline__ void outer_acc(float (&acc)[4][G][4],
                                          float (&za)[4], const float* A,
                                          const float* B, int vp, int mn) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll 2
  for (int m = 0; m < mn; ++m) {
    const float4 a4 = ld4(A + m * TILE + 4 * ty);
    const float a[4] = {a4.x, a4.y, a4.z, a4.w};
    float4 b[G];
#pragma unroll
    for (int g = 0; g < G; ++g) b[g] = ld4(B + m * vp + 4 * tx + 64 * g);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (SUM) za[u] += a[u];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        acc[u][g][0] = fmaf(a[u], b[g].x, acc[u][g][0]);
        acc[u][g][1] = fmaf(a[u], b[g].y, acc[u][g][1]);
        acc[u][g][2] = fmaf(a[u], b[g].z, acc[u][g][2]);
        acc[u][g][3] = fmaf(a[u], b[g].w, acc[u][g][3]);
      }
    }
  }
}

// Store 4 consecutive values of a row of len at column c (c % 4 == 0).
__device__ __forceinline__ void store4(float* row, int c, int len,
                                       const float (&v)[4]) {
  if (len % 4 == 0 && c + 3 < len) {
    *reinterpret_cast<float4*>(row + c) = make_float4(v[0], v[1], v[2], v[3]);
    return;
  }
#pragma unroll
  for (int u = 0; u < 4; ++u)
    if (c + u < len) row[c + u] = v[u];
}

// Launch 2: ws holds (rows, nc, E) floats, slots 0 .. nc - 2 the chunks'
// own contributions; afterwards slot c holds the state entering chunk c
// (slot 0 zeros): S_{c+1} = decay[row, c] S_c + dS_c (decay 1 unless
// DECAY).  One thread per (row, entry); the next eight chunks' loads are
// issued before this eight's stores.
template <bool DECAY>
__global__ void __launch_bounds__(NT)
    chunk_prefix(float* __restrict__ ws, const float* __restrict__ decay,
                 int nc, long long E) {
  const long long e = (long long)blockIdx.x * NT + threadIdx.x;
  if (e >= E) return;
  const int row = blockIdx.y;
  float* p = ws + (size_t)row * nc * E + e;
  const int last = nc - 1;
  float run = 0.0f, t[8];
#pragma unroll
  for (int u = 0; u < 8; ++u) t[u] = u < last ? p[(size_t)u * E] : 0.0f;
#pragma unroll 1
  for (int c0 = 0; c0 < last; c0 += 8) {
    float nx[8];
#pragma unroll
    for (int u = 0; u < 8; ++u)
      nx[u] = c0 + 8 + u < last ? p[(size_t)(c0 + 8 + u) * E] : 0.0f;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (c0 + u < last) {
        p[(size_t)(c0 + u) * E] = run;
        run = DECAY ? decay[(size_t)row * nc + c0 + u] * run + t[u]
                    : run + t[u];
      }
      t[u] = nx[u];
    }
  }
  p[(size_t)last * E] = run;
}

template <bool DECAY>
static int prefix_launch(float* ws, const float* decay, int rows, int nc,
                         long long E, cudaStream_t s) {
  const dim3 grid((unsigned)((E + NT - 1) / NT), rows);
  chunk_prefix<DECAY><<<grid, NT, 0, s>>>(ws, decay, nc, E);
  return (int)cudaGetLastError();
}

}  // namespace cscan
