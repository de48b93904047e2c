// Grouped int8 implicit-GEMM convolution on the tensor cores, with the
// scale-table and requant epilogues of int8_conv (int_matmul.cu).
//
// Replaces the grouped convolution the JAX package hands to XLA:
// shiftedscalequantization_tpu/deploy.py:_int_conv with
// feature_group_count > 1 (RegNetX's f.b units, served as grouped int8 or
// bf16_codes); PyTorch has no int8 convolution on CUDA.
//
// ssq_int8_group_conv:  codes (B, H, W, C) int8 NHWC, w (S, N, KH*KW*Cg)
//   int8 in (kh, kw, ic) order, G conv groups of Cg = C / G input and
//   OCg = N / G output channels: output channel n belongs to conv group
//   n / OCg and reads input channels [g*Cg, (g+1)*Cg). S weight groups
//   (shift candidates) share the codes. Per weight group s the int32 sums
//   acc_s, pad_value outside the image, plus acc_offset[s, n] when given.
//   Output, as ssq_int8_conv:
//   - int32 sums (M, N) (S = 1, no scale table);
//   - the f32 scale-table sum 0 + sum_s float(acc_s) * (table[s, n] *
//     delta), each step rounded on its own (__fmul_rn, __fadd_rn) in s
//     order;
//   - with a Requant (requant.cuh), int8 codes: that value (float(acc) at
//     S = 1 without a table) through deploy's quantize_out, and with a
//     residual stage through the block's requant too.
//
// Bound on an H100: bytes. RegNetX-600M's grouped units at batch 256,
// 224x224 have Cg = OCg = 24 (K = 216): 2 * 216 = 432 int8 operations per
// output code against one code read and one written, far below the
// card's 590 int8 operations per byte.
// The design, simple first:
// - one block per (128 output pixels, conv group, column tile of up to 32
//   channels of that group); eight warps, 16 pixels each, run
//   mma.sync m16n8k32 s8 x s8 -> s32 over all S weight groups' columns,
//   so one A fragment feeds every group;
// - K is walked 128 bytes at a time: each thread gathers its 1, 4, 8 or 16
//   bytes (the largest that divides Cg and C, aligned) of the pixel's
//   group channels straight from the NHWC codes (pad_value outside the
//   image), and the weight rows beside them, into shared memory rows of
//   144 bytes, which makes the fragment reads conflict-free;
// - the last chunk is padded to a whole k-step of 32 with zero codes and
//   ZERO WEIGHTS (never pad_value), so padding adds nothing;
// - the epilogue computes each output from the accumulator registers
//   directly and stores it (int32, f32, or the requant's int8 code).
// Measured on the card, RegNetX-600M's 16 baked units take 14x their
// bound (5-9x per shape in sums mode), 4.7x faster than cuDNN's bf16
// grouped convs on the same codes: the loads are synchronous, with index
// arithmetic per load and two barriers per chunk. Not yet: cp.async
// double buffering, a block's input rows staged once for all taps,
// wider column tiles for small OCg, 16-byte epilogue stores.
#include <cuda_runtime.h>
#include <stdint.h>

#include "requant.cuh"

namespace {

constexpr int BM = 128;          // output pixels per block
constexpr int WARPS = 8;         // 16 pixels each
constexpr int THREADS = 32 * WARPS;
constexpr int BK = 128;          // bytes of K per chunk
constexpr int RS = BK + 16;      // shared row stride: 144 = 16 mod 128,
                                 // conflict-free fragment loads
constexpr int MAX_S = 4;

struct GConv {
  const int8_t* x;
  const int8_t* w;
  int H, W, C, KW, SH, SW, PH, PW, HoWo, Wo;
  int Cg, OCg, N, K;              // K = KH * KW * Cg
  int pad;                        // code outside the image
  int vec;                        // bytes per load: 1, 4, 8 or 16
};

enum OutMode { OUT_I32 = 0, OUT_TABLE = 1, OUT_CODES = 2 };

struct Out {
  int mode;
  const float* table;             // (S, N) scale table, or null
  const int32_t* acc_offset;      // (S, N) or null
  const float* delta;             // device scalar
  void* out;
  Requant rq;                     // OUT_CODES
};

__device__ __forceinline__ void mma_s8(int (&c)[4], const int (&a)[4],
                                       int b0, int b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// V bytes of one repeated byte (p4 holds it four times)
template <typename T> __device__ __forceinline__ T splat(uint32_t p4);
template <> __device__ __forceinline__ int8_t splat<int8_t>(uint32_t p4) {
  return (int8_t)(p4 & 0xffu);
}
template <> __device__ __forceinline__ uint32_t splat<uint32_t>(uint32_t p4) {
  return p4;
}
template <> __device__ __forceinline__ uint2 splat<uint2>(uint32_t p4) {
  return make_uint2(p4, p4);
}
template <> __device__ __forceinline__ uint4 splat<uint4>(uint32_t p4) {
  return make_uint4(p4, p4, p4, p4);
}

// One K chunk [k0, k0 + kpad) of the A tile (BM pixels of conv group g)
// and of the B tile (S * BN weight rows: group s, columns nt0.. of conv
// group g) into shared memory, V bytes per load. Past K both are zero.
template <typename T, int S, int BN>
__device__ __forceinline__ void load_chunk(int8_t* As, int8_t* Bs,
                                           const GConv& cv, const int* rb,
                                           const int* rh, const int* rw,
                                           int g, int nt0, int k0,
                                           int kpad) {
  constexpr int V = sizeof(T);
  const int cpr = kpad / V;                      // loads per row
  const T zero = splat<T>(0u);
  const T padv = splat<T>((uint32_t)(uint8_t)cv.pad * 0x01010101u);
  const int cbase = g * cv.Cg;
#pragma unroll 1
  for (int i = threadIdx.x; i < BM * cpr; i += THREADS) {
    const int r = i / cpr, c = (i - r * cpr) * V;
    const int k = k0 + c;
    T v = zero;
    if (k < cv.K && rb[r] >= 0) {
      const int t = k / cv.Cg, ic = k - t * cv.Cg;
      const int kh = t / cv.KW, kw = t - kh * cv.KW;
      const int hi = rh[r] + kh, wi = rw[r] + kw;
      v = (hi >= 0 && hi < cv.H && wi >= 0 && wi < cv.W)
              ? __ldg(reinterpret_cast<const T*>(
                    cv.x + (((size_t)rb[r] + hi) * cv.W + wi) * cv.C + cbase
                    + ic))
              : padv;
    }
    *reinterpret_cast<T*>(As + r * RS + c) = v;
  }
#pragma unroll 1
  for (int i = threadIdx.x; i < S * BN * cpr; i += THREADS) {
    const int row = i / cpr, c = (i - row * cpr) * V;
    const int s = row / BN, nl = nt0 + row - s * BN, k = k0 + c;
    T v = zero;
    if (nl < cv.OCg && k < cv.K)
      v = __ldg(reinterpret_cast<const T*>(
          cv.w + ((size_t)s * cv.N + g * cv.OCg + nl) * cv.K + k));
    *reinterpret_cast<T*>(Bs + row * RS + c) = v;
  }
}

template <int S, int NT>
__global__ void __launch_bounds__(THREADS)
group_conv_kernel(GConv cv, Out o, int M, int ctiles) {
  constexpr int BN = NT * 8;                     // columns per weight group
  __shared__ __align__(16) int8_t As[BM * RS];
  __shared__ __align__(16) int8_t Bs[S * BN * RS];
  __shared__ int rb[BM], rh[BM], rw[BM];
  __shared__ float col_sd[S * BN];
  __shared__ int col_off[S * BN];
  __shared__ float req_cols[4 * BN];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int g = blockIdx.y / ctiles;
  const int nt0 = (blockIdx.y - g * ctiles) * BN;

  // each row's pixel: b*H and its top-left input coordinates; rb < 0 past M
  for (int r = tid; r < BM; r += THREADS) {
    const int m = m0 + r;
    rb[r] = -1, rh[r] = 0, rw[r] = 0;
    if (m < M) {
      const int b = m / cv.HoWo, rem = m - b * cv.HoWo;
      const int ho = rem / cv.Wo, wo = rem - ho * cv.Wo;
      rb[r] = b * cv.H;
      rh[r] = ho * cv.SH - cv.PH;
      rw[r] = wo * cv.SW - cv.PW;
    }
  }
  // per-column epilogue terms: table[s, n] * delta, acc_offset[s, n] and
  // the requant's m1, c1, m2, c2 (0 where absent or past the group)
  const float delta = o.delta ? *o.delta : 0.0f;
  for (int i = tid; i < S * BN; i += THREADS) {
    const int s = i / BN, nl = nt0 + i - s * BN;
    const bool ok = nl < cv.OCg;
    const size_t n = (size_t)s * cv.N + g * cv.OCg + nl;
    col_sd[i] = ok && o.table ? __fmul_rn(o.table[n], delta) : 0.0f;
    col_off[i] = ok && o.acc_offset ? o.acc_offset[n] : 0;
  }
  if (o.mode == OUT_CODES) {
    for (int i = tid; i < 4 * BN; i += THREADS) {
      const int t = i / BN, nl = nt0 + i - t * BN;
      const float* p = t == 0 ? o.rq.m1 : t == 1 ? o.rq.c1
                       : t == 2 ? o.rq.m2 : o.rq.c2;
      req_cols[i] = (p != nullptr && nl < cv.OCg) ? p[g * cv.OCg + nl]
                                                  : 0.0f;
    }
  }

  const int lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, t4 = lane & 3;
  int acc[S][NT][4];
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[s][j][e] = 0;

  for (int k0 = 0; k0 < cv.K; k0 += BK) {
    const int kn = cv.K - k0 < BK ? cv.K - k0 : BK;
    const int kpad = (kn + 31) & ~31;
    __syncthreads();               // the row terms are in; the last
                                   // chunk's fragments are read
    switch (cv.vec) {
      case 16: load_chunk<uint4, S, BN>(As, Bs, cv, rb, rh, rw, g, nt0, k0,
                                        kpad); break;
      case 8: load_chunk<uint2, S, BN>(As, Bs, cv, rb, rh, rw, g, nt0, k0,
                                       kpad); break;
      case 4: load_chunk<uint32_t, S, BN>(As, Bs, cv, rb, rh, rw, g, nt0,
                                          k0, kpad); break;
      default: load_chunk<int8_t, S, BN>(As, Bs, cv, rb, rh, rw, g, nt0, k0,
                                         kpad);
    }
    __syncthreads();
#pragma unroll 1
    for (int ks = 0; ks < kpad; ks += 32) {
      // A fragment (row-major 16 x 32): rows gq and gq + 8, bytes t4*4..
      // and 16 + t4*4..; B fragment: row gq of Bs[n][k], the same bytes
      const int8_t* r0 = As + (warp * 16 + gq) * RS + ks + t4 * 4;
      int a[4];
      a[0] = *reinterpret_cast<const int*>(r0);
      a[1] = *reinterpret_cast<const int*>(r0 + 8 * RS);
      a[2] = *reinterpret_cast<const int*>(r0 + 16);
      a[3] = *reinterpret_cast<const int*>(r0 + 8 * RS + 16);
#pragma unroll
      for (int s = 0; s < S; ++s)
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int8_t* bp = Bs + (s * BN + j * 8 + gq) * RS + ks + t4 * 4;
          mma_s8(acc[s][j], a, *reinterpret_cast<const int*>(bp),
                 *reinterpret_cast<const int*>(bp + 16));
        }
    }
  }

  // epilogue: accumulator e of tile j is row gq + 8*(e/2), column
  // j*8 + 2*t4 + e%2
  RequantScalars rs{};
  if (o.mode == OUT_CODES) rs = requant_scalars(o.rq);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m0 + warp * 16 + gq + 8 * h;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int jj = j * 8 + 2 * t4 + e;
        if (nt0 + jj >= cv.OCg) continue;
        const size_t idx = (size_t)m * cv.N + g * cv.OCg + nt0 + jj;
        float v;
        if (o.table == nullptr) {
          const int sum = acc[0][j][2 * h + e] + col_off[jj];
          if (o.mode == OUT_I32) {
            reinterpret_cast<int32_t*>(o.out)[idx] = sum;
            continue;
          }
          v = (float)sum;
        } else {
          v = 0.0f;
#pragma unroll
          for (int s = 0; s < S; ++s)
            v = __fadd_rn(v, __fmul_rn((float)(acc[s][j][2 * h + e]
                                               + col_off[s * BN + jj]),
                                       col_sd[s * BN + jj]));
          if (o.mode == OUT_TABLE) {
            reinterpret_cast<float*>(o.out)[idx] = v;
            continue;
          }
        }
        v = requant_one(v, o.rq, rs, req_cols[jj], req_cols[BN + jj],
                        req_cols[2 * BN + jj], req_cols[3 * BN + jj], idx);
        reinterpret_cast<int8_t*>(o.out)[idx] = (int8_t)(int)v;
      }
  }
}

template <int S, int NT>
int launch(const GConv& cv, const Out& o, int M, int G,
           cudaStream_t stream) {
  const int ctiles = (cv.OCg + NT * 8 - 1) / (NT * 8);
  const long long gy = (long long)G * ctiles;
  const long long gx = ((long long)M + BM - 1) / BM;
  if (gy > 65535 || gx > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  group_conv_kernel<S, NT><<<dim3((unsigned)gx, (unsigned)gy), THREADS, 0,
                             stream>>>(cv, o, M, ctiles);
  return (int)cudaGetLastError();
}

// NT 8-column tiles per weight group in a block: enough for OCg up to 32,
// else 32-column tiles
template <int S>
int dispatch_nt(const GConv& cv, const Out& o, int M, int G,
                cudaStream_t stream) {
  const int nt = cv.OCg >= 32 ? 4 : (cv.OCg + 7) / 8;
  switch (nt) {
    case 1: return launch<S, 1>(cv, o, M, G, stream);
    case 2: return launch<S, 2>(cv, o, M, G, stream);
    case 3: return launch<S, 3>(cv, o, M, G, stream);
    default: return launch<S, 4>(cv, o, M, G, stream);
  }
}

}  // namespace

extern "C" int ssq_int8_group_conv(const void* x, const void* w,
                                   const void* table, const void* acc_offset,
                                   const void* delta, void* out, int S, int B,
                                   int H, int W, int C, int KH, int KW,
                                   int SH, int SW, int PH, int PW, int N,
                                   int G, int pad, int vec,
                                   const void* requant, void* stream) {
  if (S < 1 || S > MAX_S || (table == nullptr && S != 1) || G < 1
      || C % G != 0 || N % G != 0
      || (vec != 1 && vec != 4 && vec != 8 && vec != 16)
      || (C / G) % vec != 0)
    return (int)cudaErrorInvalidValue;
  const int Ho = (H + 2 * PH - KH) / SH + 1, Wo = (W + 2 * PW - KW) / SW + 1;
  const int M = B * Ho * Wo, Cg = C / G, K = KH * KW * Cg;
  if (M <= 0 || N <= 0 || K <= 0) return 0;
  const GConv cv{(const int8_t*)x, (const int8_t*)w, H, W, C, KW, SH, SW,
                 PH, PW, Ho * Wo, Wo, Cg, N / G, N, K, pad, vec};
  Out o{};
  o.mode = requant ? OUT_CODES : (table ? OUT_TABLE : OUT_I32);
  o.table = (const float*)table;
  o.acc_offset = (const int32_t*)acc_offset;
  o.delta = (const float*)delta;
  o.out = out;
  if (requant) o.rq = *(const Requant*)requant;
  cudaStream_t st = (cudaStream_t)stream;
  switch (S) {
    case 1: return dispatch_nt<1>(cv, o, M, G, st);
    case 2: return dispatch_nt<2>(cv, o, M, G, st);
    case 3: return dispatch_nt<3>(cv, o, M, G, st);
    default: return dispatch_nt<4>(cv, o, M, G, st);
  }
}
