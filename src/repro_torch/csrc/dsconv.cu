// dsconv_fused: depthwise 3x3 + bias -> Hardswish -> 1x1 GEMM + bias, NHWC
// fp32.
//
// Replaces the TPU kernel repro/kernels/dsconv/kernel.py::dsconv_fused
// (the Pallas grid (batch, c_out tiles) with the DW result in VMEM
// scratch, reused across c_out tiles through pl.when(j == 0)).
//
// Bound on the H100: memory.  At stem.ds0 (112x112x16 -> 16) the
// function does 2 * (9 + 16) = 50 flops per 4-byte output channel it
// writes and reads the same amount, ~6 flops/byte, below the card's
// ~20 fp32 flops/byte ridge (67 TFLOP/s over 3.35 TB/s): 12.8 MB at batch
// 8, 3.8 us at 3.35 TB/s.  So every byte has to be in flight early, and
// the arithmetic and shared-memory reads kept well under that time.
//
// Design: a CTA of 128 threads takes a band of `rows` output rows of one
// image (kernels/dsconv/kernel.py::choose_blocks sizes the bands so every
// CTA of the grid is resident at once, at most two an SM) and streams it.
// All of the band's input rows and their halo are put in flight at the
// start by 16-byte cp.async copies, one copy group a row (zeros for rows
// outside the image and a zero pixel at both ends of a row: the SAME
// padding), and the CTA computes output row k once its three input rows
// have landed, while the later rows are still on their way.  One step a
// row, one __syncthreads:
//   DW   row k: a thread takes a run of 4 output pixels x 4 channels and
//        slides the 3x3 window along the run in registers (each staged
//        float4 is read (4 + 2) / 4 times per tap row, not 3), adds the
//        bias, applies Hardswish (common.cuh's hswish, its division by 6
//        without a branch) and stores float4s into one of two row buffers
//        in shared memory.
//   1x1  row k - 1, from the other buffer: a thread takes 4 pixels x 4
//        output channels, an FFMA register tile over C; the four threads of
//        a pixel store its 16 channels as contiguous float4s.
// Staged pixels are C floats apart, or C + 4 where C % 32 == 16, so the
// float4 reads of the two runs in a quarter-warp fall in distinct banks.
// The served shape (C = F = 16, stride 1) is a template instance: every
// divisor is a constant and the thread's column of the 1x1 weights stays
// in registers.  Other C and F and strides take a generic instance, which
// reads the 9 taps of each output.  In shared memory C and F are rounded
// up to multiples of 4 and the pad channels staged as zeros (zero taps,
// weights and biases: a pad DW channel is hswish(0) = 0 and adds 0 to
// every 1x1 sum), so every step works on channel quads; where F is no
// multiple of 4 an output pixel's channels are stored one by one.  Stride s samples the
// stride-1 DW map at offset s - 1, the anchor of the reference's SAME conv.
// No cluster: nothing is reduced over the image, and the L2 absorbs the
// halo rows' second read.  fp32 FMA on CUDA cores: TF32 tensor cores would
// break fp32 parity.
#include "common.cuh"

constexpr int DSF_NT = 128;   // threads of a CTA
constexpr int DSF_RUN = 4;    // output pixels of a thread's DW run

// Floats between staged pixels (input rows and DW row buffers).
__host__ __device__ inline int dsf_pitch(int c) {
  return c % 32 == 16 ? c + 4 : c;
}

// Shared-memory layout of one CTA, in floats (Python mirror:
// kernels/dsconv/kernel.py::dsconv_smem_bytes), with C and F rounded up
// to multiples of 4 (c4, f4).  xs: the band's input rows with the halo,
// nin = (rows - 1) * stride + 3 of them, each [W + 2][cp]; dw: the DW row
// buffers, two (one for a band of one row), each [Wo][cp]; pw: the 1x1
// weights [c4][f4]; taps [9][c4]; db [c4]; pb [f4].
struct DsfLayout {
  int nin, cp, dw, pw, taps, db, pb, total;
};
__host__ __device__ inline DsfLayout dsf_layout(int W, int C, int F,
                                                int stride, int rows) {
  DsfLayout l;
  const int c4 = (C + 3) & ~3, f4 = (F + 3) & ~3;
  l.nin = (rows - 1) * stride + 3;
  l.cp = dsf_pitch(c4);
  l.dw = l.nin * (W + 2) * l.cp;
  l.pw = l.dw + (rows > 1 ? 2 : 1) * (W / stride) * l.cp;
  l.taps = l.pw + c4 * f4;
  l.db = l.taps + 9 * c4;
  l.pb = l.db + c4;
  l.total = l.pb + f4;
  return l;
}

struct DsfArgs {
  const float *x, *dw, *db, *pw, *pb;
  float* out;
  int H, W, C, F, stride, act, rows;
};

// Wait until at most n of this thread's copy groups are in flight (more
// than 7: wait for 7, which is never too few).
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  switch (n < 7 ? (n < 0 ? 0 : n) : 7) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
  }
}

// dst[i] = src[i] for i < n (a multiple of 4), in flight as cp.async.
__device__ __forceinline__ void dsf_stage(float* dst, const float* src,
                                          int n) {
  if (aligned16(src)) {
#pragma unroll 1
    for (int e = threadIdx.x; e < n / 4; e += DSF_NT)
      cp_async16(dst + 4 * e, src + 4 * e, true);
  } else {
#pragma unroll 1
    for (int e = threadIdx.x; e < n; e += DSF_NT)
      cp_async4(dst + e, src + e, true);
  }
}

// dst[r][c] = src[r * cols + c] for r < n, c < cols, and 0 elsewhere in
// [0, n_pad) x [0, pad) (pad a multiple of 4): dsf_stage where nothing
// is padded.
__device__ __forceinline__ void dsf_stage_pad(float* dst, const float* src,
                                              int n, int n_pad, int cols,
                                              int pad) {
  if (n == n_pad && cols == pad) {
    dsf_stage(dst, src, n * cols);
    return;
  }
#pragma unroll 1
  for (int e = threadIdx.x; e < n_pad * pad; e += DSF_NT) {
    const int r = e / pad, c = e - r * pad;
    const bool ok = r < n && c < cols;
    cp_async4(dst + e, src + (ok ? r * cols + c : 0), ok);
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
// acc + v * w, channel by channel (the DW taps)
__device__ __forceinline__ float4 fma4(float4 v, float4 w, float4 acc) {
  return make_float4(fmaf(v.x, w.x, acc.x), fmaf(v.y, w.y, acc.y),
                     fmaf(v.z, w.z, acc.z), fmaf(v.w, w.w, acc.w));
}
// acc + s * w (one input channel into four outputs: the 1x1)
__device__ __forceinline__ float4 fma4s(float s, float4 w, float4 acc) {
  return make_float4(fmaf(s, w.x, acc.x), fmaf(s, w.y, acc.y),
                     fmaf(s, w.z, acc.z), fmaf(s, w.w, acc.w));
}
__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
// A DW output: bias, then Hardswish when act, into shared memory.
__device__ __forceinline__ void dw_out(float* dst, float4 acc, float4 bias,
                                       int act) {
  float4 y = add4(acc, bias);
  if (act)
    y = make_float4(hswish(y.x), hswish(y.y), hswish(y.z), hswish(y.w));
  *reinterpret_cast<float4*>(dst) = y;
}

// CT, FT, ST: C, F and the stride as constants, or 0 for the generic
// instance (all three from the arguments).  CG, FG: the channel counts of
// the tensors; C, F: of shared memory (rounded up to multiples of 4).
template <int CT, int FT, int ST>
__global__ void __launch_bounds__(DSF_NT, 4) dsconv_band(const DsfArgs a) {
  extern __shared__ __align__(16) float smem[];
  constexpr bool FIXED = CT > 0;
  const int CG = CT ? CT : a.C, FG = FT ? FT : a.F, S = ST ? ST : a.stride;
  const int C = (CG + 3) & ~3, F = (FG + 3) & ~3;
  const int H = a.H, W = a.W, Ho = H / S, Wo = W / S, WP = W + 2;
  const int CQ = C / 4, FQ = F / 4;
  const DsfLayout l = dsf_layout(W, C, F, S, a.rows);
  const int cp = l.cp, nin = l.nin, nbuf = a.rows > 1 ? 2 : 1;
  float* xs = smem;
  float* dwr = smem + l.dw;
  const float* pws = smem + l.pw;
  const float* taps = smem + l.taps;
  const int tid = threadIdx.x, b = blockIdx.y, i0 = blockIdx.x * a.rows;
  const int nrows = min(a.rows, Ho - i0);
  const int need = (nrows - 1) * S + 3, ir0 = i0 * S + S - 2;
  const float* xb = a.x + (size_t)b * H * W * CG;

  // copy group 0: the weights and input row 0; then a group a row (rows
  // past this band's last needed one are empty groups)
  dsf_stage_pad(smem + l.pw, a.pw, CG, C, FG, F);
  dsf_stage_pad(smem + l.taps, a.dw, 9, 9, CG, C);
  dsf_stage_pad(smem + l.db, a.db, 1, 1, CG, C);
  dsf_stage_pad(smem + l.pb, a.pb, 1, 1, FG, F);
  const bool al = aligned16(a.x) && CG == C;
#pragma unroll 1
  for (int t = 0; t < nin; ++t) {
    const int ir = ir0 + t;
    const bool ok = ir >= 0 && ir < H;
    const float* src = xb + (size_t)(ok ? ir : 0) * W * CG;
    float* dst = xs + (t * WP + 1) * cp;
    if (t < need && al) {
#pragma unroll 1
      for (int e = tid; e < W * CQ; e += DSF_NT) {
        const int px = e / CQ, c = 4 * (e - px * CQ);
        cp_async16(dst + px * cp + c, src + px * CG + c, ok);
      }
    } else if (t < need) {
#pragma unroll 1
      for (int e = tid; e < W * C; e += DSF_NT) {
        const int px = e / C, c = e - px * C;
        cp_async4(dst + px * cp + c, src + px * CG + (c < CG ? c : 0),
                  ok && c < CG);
      }
    }
    cp_async_commit();
  }
  // the zero pixel at both ends of every staged row
#pragma unroll 1
  for (int e = tid; e < nin * 2 * CQ; e += DSF_NT) {
    const int t = e / (2 * CQ), r = e - t * 2 * CQ;
    const int px = r < CQ ? 0 : W + 1, c = 4 * (r < CQ ? r : r - CQ);
    *reinterpret_cast<float4*>(xs + (t * WP + px) * cp + c) =
        make_float4(0.f, 0.f, 0.f, 0.f);
  }

  // work items stride over (pixel run or group, channel quad); in the
  // fixed instance DSF_NT % FQ == 0, so a thread's 1x1 columns are fixed
  static_assert(!FIXED || DSF_NT % (FT / 4) == 0, "FT / 4 must divide 128");
  const int runs = (Wo + DSF_RUN - 1) / DSF_RUN, groups = (Wo + 31) / 32 * 8;
  const int f0t = 4 * (tid % FQ);
  float4 wcol[FIXED ? CT : 1];   // pw[c][f0t..f0t+3], FIXED
  float* ob = a.out + ((size_t)b * Ho + i0) * Wo * FG;

#pragma unroll 1
  for (int k = 0; k <= nrows; ++k) {
    // staged rows k*S .. k*S + 2 are groups k*S .. k*S + 2 of nin
    if (k < nrows) cp_async_wait_upto(nin - (k * S + 3));
    __syncthreads();
    if constexpr (FIXED) {
      if (k == 0) {
#pragma unroll
        for (int c = 0; c < CT; ++c) wcol[c] = ld4(pws + c * F + f0t);
      }
    }

    // DW, row k -> buffer k % nbuf: item e is channel quad e % CQ of run
    // e / CQ
    if (k < nrows) {
#pragma unroll 1
      for (int e = tid; e < runs * CQ; e += DSF_NT) {
        const int u = e / CQ, c0 = 4 * (e - u * CQ), j0 = u * DSF_RUN;
        const float* src = xs + (k * S * WP + S - 1) * cp + c0;
        float* dst = dwr + (k % nbuf) * Wo * cp + c0;
        const float4 bias = ld4(smem + l.db + c0);
        if constexpr (ST > 0) {
          // output j0 + o, tap (dy, dx) reads padded column
          // (j0 + o) * S + S - 1 + dx: column cc = o * S + dx of the run
          // (tap rows one at a time: the 1x1 weights hold 64 registers)
          float4 acc[DSF_RUN];
#pragma unroll
          for (int o = 0; o < DSF_RUN; ++o)
            acc[o] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 1
          for (int dy = 0; dy < 3; ++dy) {
            const float* row = src + (dy * WP + j0 * ST) * cp;
            float4 w[3];
#pragma unroll
            for (int dx = 0; dx < 3; ++dx)
              w[dx] = ld4(taps + (dy * 3 + dx) * C + c0);
#pragma unroll
            for (int cc = 0; cc < (DSF_RUN - 1) * ST + 3; ++cc) {
              const float4 v = ld4(row + cc * cp);
#pragma unroll
              for (int o = 0; o < DSF_RUN; ++o) {
                const int dx = cc - o * ST;
                if (dx >= 0 && dx < 3) acc[o] = fma4(v, w[dx], acc[o]);
              }
            }
          }
#pragma unroll
          for (int o = 0; o < DSF_RUN; ++o)
            if (j0 + o < Wo) dw_out(dst + (j0 + o) * cp, acc[o], bias, a.act);
        } else {
#pragma unroll 1
          for (int o = 0; o < DSF_RUN && j0 + o < Wo; ++o) {
            const float* px = src + (j0 + o) * S * cp;
            float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
            for (int dy = 0; dy < 3; ++dy)
#pragma unroll
              for (int dx = 0; dx < 3; ++dx)
                acc = fma4(ld4(px + (dy * WP + dx) * cp),
                           ld4(taps + (dy * 3 + dx) * C + c0), acc);
            dw_out(dst + (j0 + o) * cp, acc, bias, a.act);
          }
        }
      }
    }

    // 1x1, row k - 1 <- buffer (k - 1) % nbuf: item e is output quad
    // e % FQ of group g = e / FQ, which takes pixels 32 (g / 8) + g % 8 +
    // 8 m, m < 4, so a warp's eight groups cover 32 consecutive pixels
    if (k > 0) {
      const float* src = dwr + ((k - 1) % nbuf) * Wo * cp;
#pragma unroll 1
      for (int e = tid; e < groups * FQ; e += DSF_NT) {
        const int g = e / FQ, f0 = FIXED ? f0t : 4 * (e - g * FQ);
        const int p0 = (g >> 3) * 32 + (g & 7);
        float* orow = ob + (size_t)(k - 1) * Wo * FG + f0;
        const float4 bias = ld4(smem + l.pb + f0);
        float4 acc[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) acc[m] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int c = 0; c < C; c += 4) {
          float4 w0, w1, w2, w3;
          if constexpr (FIXED) {
            w0 = wcol[c];
            w1 = wcol[c + 1];
            w2 = wcol[c + 2];
            w3 = wcol[c + 3];
          } else {
            w0 = ld4(pws + c * F + f0);
            w1 = ld4(pws + (c + 1) * F + f0);
            w2 = ld4(pws + (c + 2) * F + f0);
            w3 = ld4(pws + (c + 3) * F + f0);
          }
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const int p = p0 + 8 * m;
            const float4 v = p < Wo ? ld4(src + p * cp + c)
                                    : make_float4(0.f, 0.f, 0.f, 0.f);
            acc[m] = fma4s(v.x, w0, acc[m]);
            acc[m] = fma4s(v.y, w1, acc[m]);
            acc[m] = fma4s(v.z, w2, acc[m]);
            acc[m] = fma4s(v.w, w3, acc[m]);
          }
        }
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int p = p0 + 8 * m;
          const float4 y = add4(acc[m], bias);
          if (p >= Wo) continue;
          if (FG == F) {
            *reinterpret_cast<float4*>(orow + (size_t)p * FG) = y;
          } else {
            const float v[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
              if (f0 + i < FG) orow[(size_t)p * FG + i] = v[i];
          }
        }
      }
    }
  }
}

template <int CT, int FT, int ST>
static cudaError_t dsf_launch(const DsfArgs& a, int B, cudaStream_t s) {
  static size_t granted = 48 * 1024;
  const size_t smem =
      sizeof(float) * dsf_layout(a.W, a.C, a.F, a.stride, a.rows).total;
  cudaError_t err = allow_smem(dsconv_band<CT, FT, ST>, smem, &granted);
  if (err != cudaSuccess) return err;
  const int Ho = a.H / a.stride;
  dsconv_band<CT, FT, ST>
      <<<dim3((Ho + a.rows - 1) / a.rows, B), DSF_NT, smem, s>>>(a);
  return cudaGetLastError();
}

// Any C and F; rows >= 1 output rows a CTA.  A refused launch returns its
// error.
REPRO_EXPORT int dsconv_fused_f32(const float* x, const float* dw_w,
                                  const float* dw_b, const float* pw_w,
                                  const float* pw_b, float* out, int B, int H,
                                  int W, int C, int F, int stride, int act,
                                  int rows, void* stream) {
  if (C < 1 || F < 1 || rows < 1 || stride < 1)
    return (int)cudaErrorInvalidValue;
  const DsfArgs a{x, dw_w, dw_b, pw_w, pw_b, out, H, W, C, F, stride, act,
                  rows};
  const cudaStream_t s = (cudaStream_t)stream;
  if (C == 16 && F == 16 && stride == 1)
    return (int)dsf_launch<16, 16, 1>(a, B, s);
  return (int)dsf_launch<0, 0, 0>(a, B, s);
}

__global__ void hswish_check(unsigned long long* mismatches) {
  unsigned long long n = 0;
  for (unsigned long long i = blockIdx.x * blockDim.x + threadIdx.x;
       i < (1ull << 32); i += gridDim.x * blockDim.x) {
    const float x = __uint_as_float(static_cast<unsigned>(i));
    const float ref = x * (fminf(fmaxf(x + 3.0f, 0.0f), 6.0f) / 6.0f);
    n += __float_as_uint(hswish(x)) != __float_as_uint(ref);
  }
  if (n) atomicAdd(mismatches, n);
}

// The fp32 x (all 2^32 bit patterns) where common.cuh's hswish(x) and
// x * (relu6(x + 3) / 6) with the IEEE division differ in a bit, added to
// *mismatches (zeroed by the caller).
REPRO_EXPORT int dsconv_hswish_mismatches(unsigned long long* mismatches,
                                          void* stream) {
  hswish_check<<<2048, 256, 0, (cudaStream_t)stream>>>(mismatches);
  return (int)cudaGetLastError();
}

// Shared bytes of one CTA; Python mirror: kernels/dsconv/kernel.py::
// dsconv_smem_bytes.
REPRO_EXPORT long long dsconv_smem_c(int W, int C, int F, int stride,
                                     int rows) {
  return (long long)sizeof(float) * dsf_layout(W, C, F, stride, rows).total;
}
