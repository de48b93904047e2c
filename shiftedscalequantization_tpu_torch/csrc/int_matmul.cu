// Int8 GEMM on the tensor cores: fused quantize -> int8 GEMM -> dequant,
// and the int8 implicit-GEMM convolution grown from it.
//
// Replaces shiftedscalequantization_tpu/ops/pallas/int_matmul.py:_qmm_kernel
// (quant_matmul, quant_conv1x1). The same tile core also serves the deploy
// path's int8 / bf16_codes units, which the JAX package hands to XLA's int8
// convolution (deploy._int_conv); PyTorch has no int8 convolution on CUDA.
//
// ssq_quant_matmul:  x (M, K) f32, w (K, N) int8 ->
//   out = relu?(acc * (scale_n * delta) + bias_n),
//   acc = sum_k q[m, k] * w[k, n], q = clip(rint(x / delta) + zp, lo, hi) - zp
//   (IEEE division and half-to-even rint, as jnp.round(x / delta)).
// ssq_int8_conv:  codes (B, H, W, C) int8 NHWC, w (S, N, KH*KW*C) int8 in
//   (kh, kw, c) order -> for each group s the int32 sums of the convolution,
//   with pad_value outside the image, plus acc_offset[s, n] when given.
//   S = 1 without a scale table writes the int32 sums (M, N); otherwise
//   out = 0 + sum_s float(acc_s) * (table[s, n] * delta), rounded step by
//   step in the JAX package's order.
//
// Bound on an H100: bytes at the ResNet-18 serving shapes. A 3x3 conv at
// batch 256 reads 3-51 MB of int8 codes and writes 51-205 MB of 32-bit
// sums, 31-77 us at 3.35 TB/s, while its 59 G int8 operations take 30 us
// at the tensor cores' 1979 TOP/s. The design: each block gathers its A tile
// (128 output pixels x 64 bytes of K) straight from the NHWC codes into
// shared memory, 16 bytes at a time when C is a multiple of 16, so no
// im2col tensor exists; the B tiles of all S weight groups sit beside it,
// and eight warps run mma.sync m16n8k32 s8 x s8 -> s32 on them, one A
// fragment feeding all S groups. No pipelining, TMA or wgmma yet: the
// tile loop loads, synchronises and multiplies in turn.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;          // output rows (pixels) per block
constexpr int BN = 64;           // output columns per block
constexpr int BK = 64;           // bytes of K per shared-memory tile
constexpr int LDS = BK + 16;     // row stride of 20 words: the eight rows
                                 // a fragment load touches hit distinct banks
constexpr int THREADS = 256;     // 8 warps: 4 along M x 2 along N, 32 x 32
constexpr int MAX_S = 4;

__device__ __forceinline__ void mma_s8(int (&c)[4], const int (&a)[4],
                                       int b0, int b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct Conv {
  const int8_t* x;
  int H, W, C, KW, SH, SW, PH, PW, HoWo, Wo;
  int pad;                        // code outside the image
};

struct Quant {
  const float* x;
  const float* qp;                // delta, zp, lo, hi
};

// A tile rows m0.., K bytes k0..: conv gather (QUANT false) or f32 rows
// quantized on the way in (QUANT true). Rows past M and K past K hold 0.
template <bool QUANT, bool VEC>
__device__ __forceinline__ void load_a(int8_t* As, const Conv& cv,
                                       const Quant& qt, int m0, int k0,
                                       int M, int K) {
  const int tid = threadIdx.x;
  if (QUANT) {
    const float delta = qt.qp[0], zp = qt.qp[1], lo = qt.qp[2],
                hi = qt.qp[3];
    for (int i = tid; i < BM * BK; i += THREADS) {
      const int r = i / BK, c = i - r * BK;
      const int m = m0 + r, k = k0 + c;
      int8_t v = 0;
      if (m < M && k < K) {
        const float q = rintf(__fdiv_rn(qt.x[(size_t)m * K + k], delta)) + zp;
        v = (int8_t)(int)(fminf(fmaxf(q, lo), hi) - zp);
      }
      As[r * LDS + c] = v;
    }
  } else if (VEC) {
    // C % 16 == 0: each 16-byte chunk is 16 channels of one input pixel
    const uint32_t p = (uint32_t)(uint8_t)cv.pad * 0x01010101u;
#pragma unroll
    for (int j = 0; j < (BM * BK / 16) / THREADS; ++j) {
      const int chunk = tid + j * THREADS;
      const int r = chunk / (BK / 16), kc = chunk % (BK / 16);
      const int m = m0 + r, k = k0 + kc * 16;
      int4 v = make_int4(0, 0, 0, 0);
      if (m < M && k < K) {
        const int b = m / cv.HoWo, rem = m - b * cv.HoWo;
        const int ho = rem / cv.Wo, wo = rem - ho * cv.Wo;
        const int t = k / cv.C, ic = k - t * cv.C;
        const int kh = t / cv.KW, kw = t - kh * cv.KW;
        const int hi = ho * cv.SH - cv.PH + kh, wi = wo * cv.SW - cv.PW + kw;
        if (hi >= 0 && hi < cv.H && wi >= 0 && wi < cv.W) {
          v = *reinterpret_cast<const int4*>(
              cv.x + (((size_t)b * cv.H + hi) * cv.W + wi) * cv.C + ic);
        } else {
          v = make_int4((int)p, (int)p, (int)p, (int)p);
        }
      }
      *reinterpret_cast<int4*>(As + r * LDS + kc * 16) = v;
    }
  } else {
    for (int i = tid; i < BM * BK; i += THREADS) {
      const int r = i / BK, c = i - r * BK;
      const int m = m0 + r, k = k0 + c;
      int8_t v = 0;
      if (m < M && k < K) {
        const int b = m / cv.HoWo, rem = m - b * cv.HoWo;
        const int ho = rem / cv.Wo, wo = rem - ho * cv.Wo;
        const int t = k / cv.C, ic = k - t * cv.C;
        const int kh = t / cv.KW, kw = t - kh * cv.KW;
        const int hi = ho * cv.SH - cv.PH + kh, wi = wo * cv.SW - cv.PW + kw;
        v = (hi >= 0 && hi < cv.H && wi >= 0 && wi < cv.W)
                ? cv.x[(((size_t)b * cv.H + hi) * cv.W + wi) * cv.C + ic]
                : (int8_t)cv.pad;
      }
      As[r * LDS + c] = v;
    }
  }
}

// B tile of group s as Bs[n][k]: w (S, N, K) rows (KN false; 16-byte
// loads when VEC) or w (K, N) read across (KN true, S = 1).
template <bool KN, bool VEC>
__device__ __forceinline__ void load_b(int8_t* Bs, const int8_t* w, int s,
                                       int n0, int k0, int N, int K) {
  const int tid = threadIdx.x;
  if (KN) {
    for (int i = tid; i < BN * BK; i += THREADS) {
      const int kk = i / BN, nn = i - kk * BN;
      const int n = n0 + nn, k = k0 + kk;
      Bs[nn * LDS + kk] = (n < N && k < K) ? w[(size_t)k * N + n] : (int8_t)0;
    }
  } else if (VEC) {
#pragma unroll
    for (int j = 0; j < (BN * BK / 16) / THREADS; ++j) {
      const int chunk = tid + j * THREADS;
      const int nn = chunk / (BK / 16), kc = chunk % (BK / 16);
      const int n = n0 + nn, k = k0 + kc * 16;
      int4 v = make_int4(0, 0, 0, 0);
      if (n < N && k < K)
        v = *reinterpret_cast<const int4*>(w + ((size_t)s * N + n) * K + k);
      *reinterpret_cast<int4*>(Bs + nn * LDS + kc * 16) = v;
    }
  } else {
    for (int i = tid; i < BN * BK; i += THREADS) {
      const int nn = i / BK, kk = i - nn * BK;
      const int n = n0 + nn, k = k0 + kk;
      Bs[nn * LDS + kk] =
          (n < N && k < K) ? w[((size_t)s * N + n) * K + k] : (int8_t)0;
    }
  }
}

// One kernel core for both entry points. QUANT: quant_matmul (A quantized
// from f32, B (K, N), affine epilogue, S = 1). Otherwise the convolution:
// int32 sums (S = 1, table == nullptr) or the scale-table sum in f32.
template <int S, bool QUANT, bool VEC>
__global__ void __launch_bounds__(THREADS)
int8_gemm_kernel(Conv cv, Quant qt, const int8_t* __restrict__ w,
                 const float* __restrict__ table,   // (S, N) or scale (N)
                 const float* __restrict__ bias,    // (N), QUANT only
                 const int32_t* __restrict__ acc_offset,   // (S, N) or null
                 const float* __restrict__ delta_p, int relu,
                 int32_t* __restrict__ out_i32, float* __restrict__ out_f32,
                 int M, int K, int N) {
  __shared__ __align__(16) int8_t As[BM * LDS];
  __shared__ __align__(16) int8_t Bs[S * BN * LDS];
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;          // mma fragment coordinates
  const int wm = (warp % 4) * 32, wn = (warp / 4) * 32;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;

  int acc[S][2][4][4];
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[s][i][j][e] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    load_a<QUANT, VEC>(As, cv, qt, m0, k0, M, K);
#pragma unroll
    for (int s = 0; s < S; ++s)
      load_b<QUANT, VEC>(Bs + s * BN * LDS, w, s, n0, k0, N, K);
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < BK; ks += 32) {
      // A fragment (row-major 16 x 32): rows g and g + 8, bytes t*4.. and
      // 16 + t*4.. of this k-step
      int a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int8_t* r0 = As + (wm + i * 16 + g) * LDS + ks + t * 4;
        const int8_t* r1 = r0 + 8 * LDS;
        a[i][0] = *reinterpret_cast<const int*>(r0);
        a[i][1] = *reinterpret_cast<const int*>(r1);
        a[i][2] = *reinterpret_cast<const int*>(r0 + 16);
        a[i][3] = *reinterpret_cast<const int*>(r1 + 16);
      }
#pragma unroll
      for (int s = 0; s < S; ++s) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          // B fragment (column-major 32 x 8): column g, bytes t*4.. and
          // 16 + t*4.., i.e. row g of Bs[n][k]
          const int8_t* bp = Bs + s * BN * LDS + (wn + j * 8 + g) * LDS + ks
                             + t * 4;
          const int b0 = *reinterpret_cast<const int*>(bp);
          const int b1 = *reinterpret_cast<const int*>(bp + 16);
#pragma unroll
          for (int i = 0; i < 2; ++i) mma_s8(acc[s][i][j], a[i], b0, b1);
        }
      }
    }
    __syncthreads();
  }

  // epilogue: accumulator element e of tile (i, j) is row g + 8*(e/2),
  // column t*2 + e%2
  const float delta = QUANT ? qt.qp[0] : (delta_p ? *delta_p : 0.0f);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + wm + i * 16 + g + 8 * (e / 2);
        const int n = n0 + wn + j * 8 + t * 2 + (e % 2);
        if (m >= M || n >= N) continue;
        const size_t o = (size_t)m * N + n;
        if (QUANT) {
          float v = __fadd_rn(__fmul_rn((float)acc[0][i][j][e],
                                        __fmul_rn(table[n], delta)),
                              bias[n]);
          if (relu) v = fmaxf(v, 0.0f);
          out_f32[o] = v;
        } else if (table == nullptr) {
          out_i32[o] = acc[0][i][j][e] + (acc_offset ? acc_offset[n] : 0);
        } else {
          float v = 0.0f;
#pragma unroll
          for (int s = 0; s < S; ++s) {
            const int a = acc[s][i][j][e]
                          + (acc_offset ? acc_offset[s * N + n] : 0);
            v = __fadd_rn(v, __fmul_rn((float)a,
                                       __fmul_rn(table[s * N + n], delta)));
          }
          out_f32[o] = v;
        }
      }
}

template <int S, bool VEC>
void launch_conv(const Conv& cv, const int8_t* w, const float* table,
                 const int32_t* acc_offset, const float* delta,
                 int32_t* out_i32, float* out_f32, int M, int K, int N,
                 cudaStream_t stream) {
  dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  int8_gemm_kernel<S, false, VEC><<<grid, THREADS, 0, stream>>>(
      cv, Quant{nullptr, nullptr}, w, table, nullptr, acc_offset, delta, 0,
      out_i32, out_f32, M, K, N);
}

template <bool VEC>
int dispatch_conv(int S, const Conv& cv, const int8_t* w, const float* table,
                  const int32_t* acc_offset, const float* delta,
                  int32_t* out_i32, float* out_f32, int M, int K, int N,
                  cudaStream_t stream) {
  switch (S) {
    case 1: launch_conv<1, VEC>(cv, w, table, acc_offset, delta, out_i32,
                                out_f32, M, K, N, stream); break;
    case 2: launch_conv<2, VEC>(cv, w, table, acc_offset, delta, out_i32,
                                out_f32, M, K, N, stream); break;
    case 3: launch_conv<3, VEC>(cv, w, table, acc_offset, delta, out_i32,
                                out_f32, M, K, N, stream); break;
    case 4: launch_conv<4, VEC>(cv, w, table, acc_offset, delta, out_i32,
                                out_f32, M, K, N, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ssq_quant_matmul(const void* x, const void* w,
                                const void* scale, const void* bias,
                                const void* qp, void* out, int M, int K,
                                int N, int relu, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return 0;
  dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  Conv cv{};
  int8_gemm_kernel<1, true, false><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      cv, Quant{(const float*)x, (const float*)qp}, (const int8_t*)w,
      (const float*)scale, (const float*)bias, nullptr, nullptr, relu,
      nullptr, (float*)out, M, K, N);
  return (int)cudaGetLastError();
}

extern "C" int ssq_int8_conv(const void* x, const void* w, const void* table,
                             const void* acc_offset, const void* delta,
                             void* out, int S, int B, int H, int W, int C,
                             int KH, int KW, int SH, int SW, int PH, int PW,
                             int N, int pad, int vec, void* stream) {
  if (S < 1 || S > MAX_S || (table == nullptr && S != 1))
    return (int)cudaErrorInvalidValue;
  const int Ho = (H + 2 * PH - KH) / SH + 1, Wo = (W + 2 * PW - KW) / SW + 1;
  const int M = B * Ho * Wo, K = KH * KW * C;
  if (M <= 0 || N <= 0 || K <= 0) return 0;
  Conv cv{(const int8_t*)x, H, W, C, KW, SH, SW, PH, PW, Ho * Wo, Wo, pad};
  int32_t* out_i32 = table ? nullptr : (int32_t*)out;
  float* out_f32 = table ? (float*)out : nullptr;
  if (vec)
    return dispatch_conv<true>(S, cv, (const int8_t*)w, (const float*)table,
                               (const int32_t*)acc_offset,
                               (const float*)delta, out_i32, out_f32, M, K,
                               N, (cudaStream_t)stream);
  return dispatch_conv<false>(S, cv, (const int8_t*)w, (const float*)table,
                              (const int32_t*)acc_offset, (const float*)delta,
                              out_i32, out_f32, M, K, N,
                              (cudaStream_t)stream);
}
