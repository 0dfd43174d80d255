// Device-side building blocks of the port's int8 tensor-core GEMMs:
// int8 x int8 -> int32 products on
// mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32, from operand panels
// staged in shared memory.
//
// Layout.  Both operands are K-contiguous in shared memory: A (the
// activations) row-major [rows][pitch], B (the weights) n-major
// [columns][pitch] (the MMA's "col" operand).  A pitch is a multiple of 64
// bytes that is 64 (mod 128) (panel_pitch).  K advances in blocks of
// KB = 64 bytes: lane (g = lane / 4, t = lane % 4) loads the 16 bytes at
// k = 64 kb + 16 t of A rows g and g + 8 and of B column g, and runs two
// m16n8k32 products (mma_k64).  The MMA's fragment order gives one thread
// k = 4t..4t+3 and 16+4t..16+4t+3 of a 32-deep step; here that thread holds
// the physical bytes 16t..16t+7 for the first step and 16t+8..16t+15 for
// the second.  A and B are permuted alike along k, and an integer sum does
// not depend on the order of its terms, so the products are exact.  A
// quarter warp (8 lanes: 2 rows x 4 chunks) reads 2 x 64 contiguous bytes
// at row offsets 64 (mod 128) apart: the fragment loads are free of bank
// conflicts without ldmatrix (which has no int8 transpose).
//
// Staging.  Activations arrive as 16-byte cp.async copies where the rows
// allow it (4-byte or plain byte loads otherwise), or, for an fp32 map,
// quantized once per element as they are staged (stage_act).  The
// weights are (K, N) row-major in device memory, N-contiguous; stage_wt
// transposes a column slice as it stages it, four 4 x 4 byte blocks per
// thread (__byte_perm), so no host or extra launch ever transposes them.
// Zeros fill K beyond the operand and columns beyond N, so ragged edges
// contribute an int8 0 to every sum.
//
// m16n8k16 (mma16816) is the shape of a 16-deep reduction, a grouped
// 1x1 of 16 channels per group: lane (g, t) holds the 4 bytes k = 4t..4t+3
// of A rows g and g + 8 and of B column g.
//
// Used by csrc/mbconv_int8.cuh (the FIX8 MBConv: one site, and the
// members of csrc/supersite_int8.cu), csrc/int8_matmul.cu (the W8A8 GEMM)
// and csrc/group_agg.cu (the FIX8 MSA aggregation).
#pragma once

#include <cooperative_groups.h>

#include <cstdint>

#include "int8.cuh"

namespace i8mma {

namespace cg = cooperative_groups;

constexpr int NT = 256;  // threads of a CTA
constexpr int KB = 64;   // bytes of K per fragment block (two MMA steps)

__host__ __device__ constexpr int round_up(int n, int m) {
  return (n + m - 1) / m * m;
}
// Row pitch of a panel holding k bytes of K: k rounded up to KB, then KB
// more where that is a multiple of 128 (so the pitch is 64 mod 128).
__host__ __device__ constexpr int panel_pitch(int k) {
  return round_up(k, KB) % 128 ? round_up(k, KB) : round_up(k, KB) + KB;
}

template <int N>
__device__ __forceinline__ void cp_async_zfill(void* dst, const void* src,
                                               bool full) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(full ? 16 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
                 "l"(src), "n"(N), "r"(full ? N : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// all but the newest committed group have landed
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ uint4 ld16(const int8_t* p) {
  return *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ uint32_t pack4(int8_t a, int8_t b, int8_t c,
                                          int8_t d) {
  return static_cast<uint32_t>(static_cast<uint8_t>(a)) |
         static_cast<uint32_t>(static_cast<uint8_t>(b)) << 8 |
         static_cast<uint32_t>(static_cast<uint8_t>(c)) << 16 |
         static_cast<uint32_t>(static_cast<uint8_t>(d)) << 24;
}

// dst[r][k] = src[r * ld + k] for r < rows, k < cols, and 0 for cols <= k
// < kpad (a multiple of KB).  The caller commits, waits and syncs.
__device__ __forceinline__ void stage_rows_i8(int8_t* dst, int pitch,
                                              const int8_t* src, size_t ld,
                                              int rows, int cols, int kpad) {
  const size_t al = reinterpret_cast<uintptr_t>(src) | ld |
                    static_cast<size_t>(cols);
  if (al % 16 == 0) {
    const int nc = kpad / 16;
#pragma unroll 1
    for (int e = threadIdx.x; e < rows * nc; e += NT) {
      const int r = e / nc, c = (e % nc) * 16;
      const bool ok = c < cols;
      cp_async_zfill<16>(dst + r * pitch + c, ok ? src + r * ld + c : src,
                         ok);
    }
  } else if (al % 4 == 0) {
    const int nc = kpad / 4;
#pragma unroll 1
    for (int e = threadIdx.x; e < rows * nc; e += NT) {
      const int r = e / nc, c = (e % nc) * 4;
      const bool ok = c < cols;
      cp_async_zfill<4>(dst + r * pitch + c, ok ? src + r * ld + c : src, ok);
    }
  } else {
#pragma unroll 1
    for (int e = threadIdx.x; e < rows * kpad; e += NT) {
      const int r = e / kpad, c = e % kpad;
      dst[r * pitch + c] = c < cols ? src[r * ld + c] : int8_t(0);
    }
  }
}

// The fp32 form: quant_i8(src[r * ld + k], scale), each element once.
// Four float4 loads in flight a thread.
__device__ __forceinline__ void stage_rows_quant(int8_t* dst, int pitch,
                                                 const float* src, size_t ld,
                                                 int rows, int cols, int kpad,
                                                 float scale) {
  if (reinterpret_cast<uintptr_t>(src) % 16 == 0 && ld % 4 == 0 &&
      cols % 4 == 0) {
    const int nc = kpad / 4, n = rows * nc;
#pragma unroll 1
    for (int e0 = threadIdx.x; e0 < n; e0 += 4 * NT) {
      float4 f[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = e0 + u * NT, r = e / nc, c = (e % nc) * 4;
        f[u] = e < n && c < cols
                   ? *reinterpret_cast<const float4*>(src + r * ld + c)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = e0 + u * NT;
        if (e < n)
          *reinterpret_cast<uint32_t*>(dst + e / nc * pitch + e % nc * 4) =
              pack4(quant_i8(f[u].x, scale), quant_i8(f[u].y, scale),
                    quant_i8(f[u].z, scale), quant_i8(f[u].w, scale));
      }
    }
  } else {
#pragma unroll 1
    for (int e = threadIdx.x; e < rows * kpad; e += NT) {
      const int r = e / kpad, c = e % kpad;
      dst[r * pitch + c] =
          c < cols ? quant_i8(src[r * ld + c], scale) : int8_t(0);
    }
  }
}

// An activation panel: rows x cols of an ActIn map from element `off`
// (row length cols), int8 codes copied or an fp32 map quantized with the
// final scale `scale` as it is staged.
__device__ __forceinline__ void stage_act(int8_t* dst, int pitch,
                                          const ActIn& x, size_t off,
                                          int rows, int cols, int kpad,
                                          float scale) {
  if (x.q != nullptr)
    stage_rows_i8(dst, pitch, x.q + off, cols, rows, cols, kpad);
  else
    stage_rows_quant(dst, pitch, x.fp + off, cols, rows, cols, kpad, scale);
}

// 4 bytes of row p (columns n.. of a row with `valid` columns left), 0
// beyond them.
__device__ __forceinline__ uint32_t ld_row4(const int8_t* p, int valid,
                                            bool words) {
  if (valid >= 4 && words) return __ldg(reinterpret_cast<const unsigned*>(p));
  uint32_t v = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (j < valid)
      v |= static_cast<uint32_t>(static_cast<uint8_t>(__ldg(p + j))) << 8 * j;
  return v;
}

// The weight operand, transposed as it is staged: dst[n][k] = w[k * ldw +
// n] for n < n_cnt, k < K; 0 elsewhere in [0, n_rows) x [0, kpad) (n_rows
// a multiple of 8, kpad of KB).  A thread moves a 4 x 4 byte block: four
// row loads, a __byte_perm transpose, four column stores; eight
// neighbouring lanes take neighbouring k blocks, so the stores hit eight
// banks.
__device__ __forceinline__ void stage_wt(int8_t* dst, int pitch,
                                         const int8_t* w, int ldw, int K,
                                         int n_cnt, int n_rows, int kpad) {
  const bool words = (reinterpret_cast<uintptr_t>(w) | ldw) % 4 == 0;
  const int nk8 = kpad / 32, nn = n_rows / 4, nn4 = (nn + 3) / 4;
#pragma unroll 1
  for (int e = threadIdx.x; e < nk8 * nn4 * 32; e += NT) {
    const int rest = e >> 5;
    const int k = 4 * (8 * (rest % nk8) + (e & 7));
    const int n = 4 * (4 * (rest / nk8) + ((e >> 3) & 3));
    if (n >= n_rows) continue;
    uint32_t r[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      r[i] = k + i < K ? ld_row4(w + (size_t)(k + i) * ldw + n, n_cnt - n,
                                 words)
                       : 0u;
    const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
    const uint32_t t1 = __byte_perm(r[2], r[3], 0x5140);
    const uint32_t t2 = __byte_perm(r[0], r[1], 0x7362);
    const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
    *reinterpret_cast<uint32_t*>(dst + (n + 0) * pitch + k) =
        __byte_perm(t0, t1, 0x5410);
    *reinterpret_cast<uint32_t*>(dst + (n + 1) * pitch + k) =
        __byte_perm(t0, t1, 0x7632);
    *reinterpret_cast<uint32_t*>(dst + (n + 2) * pitch + k) =
        __byte_perm(t2, t3, 0x5410);
    *reinterpret_cast<uint32_t*>(dst + (n + 3) * pitch + k) =
        __byte_perm(t2, t3, 0x7632);
  }
}

// The weight operand staged without waiting on its loads: raw[k][n] =
// w[k * ldw + n] for k < K, n < n_cnt, 16 bytes a cp.async (rows rp bytes
// apart), when wt_async_ok; transpose_wt then builds stage_wt's panel
// from shared memory.  The caller commits, waits and syncs between them.
__device__ __forceinline__ bool wt_async_ok(const int8_t* w, int ldw,
                                            int n_cnt) {
  return (reinterpret_cast<uintptr_t>(w) | ldw | n_cnt) % 16 == 0;
}
__device__ __forceinline__ void stage_w_raw(int8_t* raw, int rp,
                                            const int8_t* w, int ldw, int K,
                                            int n_cnt) {
  const int nc = n_cnt / 16;
#pragma unroll 1
  for (int e = threadIdx.x; e < K * nc; e += NT) {
    const int k = e / nc, c = 16 * (e % nc);
    cp_async_zfill<16>(raw + k * rp + c, w + (size_t)k * ldw + c, true);
  }
}
// dst[n][k] = raw[k][n] for n < n_cnt (a multiple of 4), k < K; 0
// elsewhere in [0, n_rows) x [0, kpad): stage_wt's blocks and stores.
__device__ __forceinline__ void transpose_wt(int8_t* dst, int pitch,
                                             const int8_t* raw, int rp,
                                             int K, int n_cnt, int n_rows,
                                             int kpad) {
  const int nk8 = kpad / 32, nn = n_rows / 4, nn4 = (nn + 3) / 4;
#pragma unroll 1
  for (int e = threadIdx.x; e < nk8 * nn4 * 32; e += NT) {
    const int rest = e >> 5;
    const int k = 4 * (8 * (rest % nk8) + (e & 7));
    const int n = 4 * (4 * (rest / nk8) + ((e >> 3) & 3));
    if (n >= n_rows) continue;
    uint32_t r[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      r[i] = k + i < K && n < n_cnt
                 ? *reinterpret_cast<const uint32_t*>(raw + (k + i) * rp + n)
                 : 0u;
    const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
    const uint32_t t1 = __byte_perm(r[2], r[3], 0x5140);
    const uint32_t t2 = __byte_perm(r[0], r[1], 0x7362);
    const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
    *reinterpret_cast<uint32_t*>(dst + (n + 0) * pitch + k) =
        __byte_perm(t0, t1, 0x5410);
    *reinterpret_cast<uint32_t*>(dst + (n + 1) * pitch + k) =
        __byte_perm(t0, t1, 0x7632);
    *reinterpret_cast<uint32_t*>(dst + (n + 2) * pitch + k) =
        __byte_perm(t2, t3, 0x5410);
    *reinterpret_cast<uint32_t*>(dst + (n + 3) * pitch + k) =
        __byte_perm(t2, t3, 0x7632);
  }
}

// dst[i] = src[i] for i < n, 0 for n <= i < n_pad (fp32), as cp.async
// copies: 16 bytes where src and n allow, else 4 (a CTA of any size).
__device__ __forceinline__ void stage_f32(float* dst, const float* src,
                                          int n, int n_pad) {
  const int nt = static_cast<int>(blockDim.x);
  if ((reinterpret_cast<uintptr_t>(src) | (n * 4)) % 16 == 0) {
#pragma unroll 1
    for (int e = threadIdx.x; e < n_pad / 4; e += nt) {
      const bool ok = 4 * e < n;
      cp_async_zfill<16>(dst + 4 * e, ok ? src + 4 * e : src, ok);
    }
  } else {
#pragma unroll 1
    for (int e = threadIdx.x; e < n_pad; e += nt)
      cp_async_zfill<4>(dst + e, e < n ? src + e : src, e < n);
  }
}

// d += a . b over one m16n8k32 step.
__device__ __forceinline__ void mma16832(int (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// d += a . b over one m16n8k16 step (see the header note).
__device__ __forceinline__ void mma16816(int (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// One 64-deep K block: lo / hi are this lane's 16 bytes of A rows g and
// g + 8, b its 16 bytes of B column g (see the header note).
__device__ __forceinline__ void mma_k64(int (&d)[4], uint4 lo, uint4 hi,
                                        uint4 b) {
  mma16832(d, lo.x, hi.x, lo.y, hi.y, b.x, b.y);
  mma16832(d, lo.z, hi.z, lo.w, hi.w, b.z, b.w);
}

// acc[j] += A[0, 16) x B[8j, 8j + 8) over K blocks [kb0, kb1), for j <
// nj: A points at the warp's 16 rows (pitch lda), B at its first column
// (pitch ldb), both in shared memory.  acc[j][2h + e] is the sum of row
// g + 8h, column 8j + 2t + e.
template <int NJ>
__device__ __forceinline__ void warp_mma(int (&acc)[NJ][4], const int8_t* A,
                                         int lda, const int8_t* B, int ldb,
                                         int kb0, int kb1, int nj) {
  const int lane = threadIdx.x & 31;
  const int8_t* a = A + (lane >> 2) * lda + 16 * (lane & 3);
  const int8_t* b = B + (lane >> 2) * ldb + 16 * (lane & 3);
#pragma unroll 2
  for (int kb = kb0; kb < kb1; ++kb) {
    const uint4 lo = ld16(a + KB * kb), hi = ld16(a + 8 * lda + KB * kb);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      if (j < nj) mma_k64(acc[j], lo, hi, ld16(b + 8 * j * ldb + KB * kb));
  }
}

template <int NJ>
__device__ __forceinline__ void zero_acc(int (&acc)[NJ][4]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0;
}

// The max of v >= 0 over the CTA (up to 1024 threads), returned to every
// thread.  red: 33 floats of shared memory.  Every thread must call this.
__device__ __forceinline__ float block_max(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < static_cast<int>(blockDim.x >> 5) ? red[lane] : 0.0f;
    for (int o = 16; o > 0; o >>= 1)
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (lane == 0) red[32] = v;
  }
  __syncthreads();
  return red[32];
}

// Every CTA of a cluster must have started before another reaches into
// its shared memory: a kernel that does calls cluster_arrive() at its
// start, which does not wait, and cluster_wait() before its first access
// through distributed shared memory, by when every rank has long arrived.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// The image's max of v >= 0 over a thread-block cluster, pushed: every
// rank writes its CTA max into slot `rank` of every rank's red[34 + ...]
// (red: 64 floats of shared memory), one cluster barrier makes them
// visible, and each rank reduces its own words.  Max does not depend on
// order, so every rank gets the same, exact value; no rank reads another's
// shared memory, so none waits for the others before it ends.  The first
// call follows cluster_arrive() and waits on it; a later one (first =
// false) follows an earlier call's barrier and takes its own red.  Every
// thread of every rank makes each call.
__device__ __forceinline__ float cluster_max_push(cg::cluster_group& cl,
                                                  float v, float* red,
                                                  int ranks,
                                                  bool first = true) {
  v = block_max(v, red);
  if (first) cluster_wait();
  if (threadIdx.x < ranks)
    *cl.map_shared_rank(red + 34 + cl.block_rank(), threadIdx.x) = v;
  cl.sync();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    float m = lane < ranks ? red[34 + lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (lane == 0) red[33] = m;
  }
  __syncthreads();
  return red[33];
}

}  // namespace i8mma
