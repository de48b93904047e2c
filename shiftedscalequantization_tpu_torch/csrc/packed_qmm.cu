// Packed sub-byte weight matmul on the tensor cores, fed int8 codes or f32,
// with the requant in its epilogue.
//
// Replaces shiftedscalequantization_tpu/ops/pallas/packed.py:_pqmm_kernel
// (packed_quant_matmul): y = relu?(acc * (scale_n * delta) + bias_n) with
// acc = sum_k q[m, k] * (w_raw[k, n] - zp_n), all integer arithmetic exact
// in int32. q is the int8 codes fed in (their step is delta), or
// clip(rint(x / delta) + zp, lo, hi) - zp of f32 rows x. A 1x1 conv's rows
// are read at its stride straight from the NHWC input. With a Requant
// (requant.cuh) the kernel writes int8 codes: y goes through deploy's
// quantize_out, and with a residual stage through the block's requant.
//
// Packing (ops/cuda/packed.py:pack_codes): w_packed is (N, KW) int32, word
// (n, j) holds the raw codes k = j*f + s in bits [s*bits, (s+1)*bits), f =
// 32/bits, so each word unpacks to f consecutive K positions of a column.
//
// Bound on an H100: bytes. MobileNetV2's 34 1x1 convs at batch 256,
// 224x224 read and write 1.8 GB of int8 codes (0.54 ms at 3.35 TB/s; with
// f32 in and out, 7.0 GB) for 137 G int8 operations (0.07 ms at 1979
// TOP/s, but about 0.5 ms for dp4a on the CUDA cores). The design:
// - codes come in as int8, 16 (or 8) bytes per cp.async into a 3-stage
//   shared-memory ring, two tiles ahead of the tensor cores; f32 rows are
//   quantized on the way in;
// - the packed words are loaded into registers a stage ahead and unpacked
//   into K-major int8 tiles (column zero point subtracted, four codes per
//   byte-wise subtract), so the weights cross memory at 2 or 4 bits;
// - eight warps run mma.sync m16n8k32 s8 x s8 -> s32 on the tiles;
// - the epilogue puts the tile's f32 values in shared memory and walks it
//   16 columns at a time: the requant (every step __fmul_rn / __fadd_rn,
//   no FMA contraction), the residual and the codes move in 16-byte
//   pieces, and no f32 leaves the kernel.
// Most MobileNetV2 units have K <= 192, so a tile is one or two K-stages
// and its time goes to per-tile latency and epilogue instructions, not to
// bytes: four blocks per SM help; a 256-row or 128-column tile and a grid
// of resident blocks walking the row tiles (loads prefetched across tiles)
// measured slower.
#include <cuda_runtime.h>
#include <stdint.h>

#include "requant.cuh"

namespace {

constexpr int BM = 128;         // output rows per block
constexpr int BN = 64;          // output columns per block
constexpr int BK = 64;          // K codes per stage
constexpr int LDS = BK + 16;    // 80-byte rows: conflict-free fragment
                                // loads, 16-byte aligned chunks
constexpr int THREADS = 256;    // 8 warps: 4 along M x 2 along N
constexpr int STAGES = 3;
constexpr int MI = BM / 64;     // m16 tiles of a warp (BM / 4 rows)
constexpr int NJ = BN / 16;     // n8 tiles of a warp (BN / 2 columns)
constexpr int SP = BN + 4;      // staged output row stride, in floats
// the A and B rings in one buffer, which the epilogue's f32 tile reuses
constexpr int SMEM = STAGES * (BM + BN) * LDS > BM * SP * 4
                         ? STAGES * (BM + BN) * LDS : BM * SP * 4;

// A loaders: int8 codes by 16- or 8-byte cp.async, or bytes; f32 rows
// quantized on the way in, four at a time or one
enum AMode { A_CODES16, A_CODES8, A_CODES1, A_F32X4, A_F32X1 };

struct Feed {
  const void* x;        // NHWC (B, H, W, K) rows, int8 codes or f32
  int H, W, K, stride, HoWo, Wo;
  const float* qp;      // delta, zp, lo, hi
};

__device__ __forceinline__ void mma_s8(int (&c)[4], const int (&a)[4],
                                       int b0, int b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool valid) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  if (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(src), "r"(valid ? 16 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
                 "l"(src), "r"(valid ? 8 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// element offset of row m's first K position in the feed (-1: past M)
__device__ __forceinline__ long long row_offset(const Feed& f, int m, int M) {
  if (m >= M) return -1;
  const int b = m / f.HoWo, rem = m - b * f.HoWo;
  const int ho = rem / f.Wo, wo = rem - ho * f.Wo;
  return (((long long)b * f.H + ho * f.stride) * f.W + wo * f.stride)
         * f.K;
}

__device__ __forceinline__ int8_t quant_code(float x, const float* qp) {
  const float q = rintf(__fdiv_rn(x, qp[0])) + qp[1];
  return (int8_t)(int)(fminf(fmaxf(q, qp[2]), qp[3]) - qp[1]);
}

// four 2-bit (BITS 2, one byte) or 4-bit (BITS 4, 16 bits) codes spread
// into the four bytes of a word, the column zero point subtracted
template <int BITS>
__device__ __forceinline__ uint32_t spread4(uint32_t v, uint32_t zp4) {
  const uint32_t m = (1u << BITS) - 1u;
  const uint32_t s = (v & m) | (((v >> BITS) & m) << 8)
                     | (((v >> (2 * BITS)) & m) << 16)
                     | (((v >> (3 * BITS)) & m) << 24);
  return __vsub4(s, zp4);
}

template <int BITS, int AM>
// four blocks per SM (64 registers): the small-K units are bound by each
// tile's latency, and more tiles in flight hide more of it
__global__ void __launch_bounds__(THREADS, 4)
packed_qmm_kernel(Feed fd, const int32_t* __restrict__ wp,
                  const float* __restrict__ wzp,
                  const float* __restrict__ scale,
                  const float* __restrict__ bias, void* __restrict__ out,
                  int M, int N, int relu, int codes_out, Requant rq) {
  constexpr int F = 32 / BITS;             // codes per word
  constexpr int WPC = BK / F;              // words per column per stage
  constexpr int WPT = BN * WPC / THREADS;  // words per thread per stage
  constexpr int CH = AM == A_CODES16 ? 16 : 8;   // cp.async chunk bytes
  constexpr int RA = BM * BK / CH / THREADS;     // A chunks per thread
  extern __shared__ __align__(16) int8_t ring[];
  __shared__ float col_sd[BN], col_b[BN];   // scale[n] * delta, bias[n]
  __shared__ __align__(16) float req_cols[4 * BN];   // codes_out
  int8_t* const As = ring;
  int8_t* const Bs = ring + STAGES * BM * LDS;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = (warp % 4) * (BM / 4), wn = (warp / 4) * (BN / 2);
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int K = fd.K;
  const int kwords = (K + F - 1) / F;
  const int ktiles = (K + BK - 1) / BK;

  // this thread's A chunks: rows a_r0 + (THREADS*CH/BK) * i, chunk a_kc
  const int a_kc = tid % (BK / CH), a_r0 = tid / (BK / CH);
  // this thread's packed words: column b_nn[j], word b_jw[j] of the stage
  int b_nn[WPT], b_jw[WPT];
  uint32_t b_zp4[WPT];
#pragma unroll
  for (int j = 0; j < WPT; ++j) {
    const int i = tid + j * THREADS;
    b_nn[j] = i / WPC;
    b_jw[j] = i % WPC;
    const int n = n0 + b_nn[j];
    b_zp4[j] = n < N ? (uint32_t)(int)rintf(wzp[n]) * 0x01010101u : 0u;
  }
  const float delta = fd.qp[0];
  if (tid < BN) {
    const int n = n0 + tid;
    col_sd[tid] = n < N ? __fmul_rn(scale[n], delta) : 0.0f;
    col_b[tid] = n < N ? bias[n] : 0.0f;
  }
  if (codes_out) load_requant_cols<BN, THREADS>(req_cols, rq, n0, N);

  auto load_a = [&](int kt, int slot) {
    const int k0 = kt * BK;
    int8_t* as = As + slot * BM * LDS;
    if (AM == A_CODES16 || AM == A_CODES8) {
      const int8_t* x = reinterpret_cast<const int8_t*>(fd.x);
      const int k = k0 + a_kc * CH;
#pragma unroll
      for (int i = 0; i < RA; ++i) {
        const int r = a_r0 + i * (THREADS * CH / BK);
        const long long off = row_offset(fd, m0 + r, M);
        const bool ok = off >= 0 && k < K;
        cp_async<CH>(as + r * LDS + a_kc * CH, ok ? x + off + k : x, ok);
      }
    } else if (AM == A_CODES1) {
      const int8_t* x = reinterpret_cast<const int8_t*>(fd.x);
#pragma unroll 1
      for (int i = tid; i < BM * BK; i += THREADS) {
        const int r = i / BK, c = i - r * BK, k = k0 + c;
        const long long off = row_offset(fd, m0 + r, M);
        as[r * LDS + c] = (off >= 0 && k < K) ? x[off + k] : (int8_t)0;
      }
    } else if (AM == A_F32X4) {
      const float* x = reinterpret_cast<const float*>(fd.x);
#pragma unroll 1
      for (int i = tid; i < BM * BK / 4; i += THREADS) {
        const int r = i / (BK / 4), c = (i - r * (BK / 4)) * 4, k = k0 + c;
        const long long off = row_offset(fd, m0 + r, M);
        uint32_t v = 0u;
        if (off >= 0 && k < K) {
          const float4 f = *reinterpret_cast<const float4*>(x + off + k);
          v = (uint32_t)(uint8_t)quant_code(f.x, fd.qp)
              | ((uint32_t)(uint8_t)quant_code(f.y, fd.qp) << 8)
              | ((uint32_t)(uint8_t)quant_code(f.z, fd.qp) << 16)
              | ((uint32_t)(uint8_t)quant_code(f.w, fd.qp) << 24);
        }
        *reinterpret_cast<uint32_t*>(as + r * LDS + c) = v;
      }
    } else {
      const float* x = reinterpret_cast<const float*>(fd.x);
#pragma unroll 1
      for (int i = tid; i < BM * BK; i += THREADS) {
        const int r = i / BK, c = i - r * BK, k = k0 + c;
        const long long off = row_offset(fd, m0 + r, M);
        as[r * LDS + c] =
            (off >= 0 && k < K) ? quant_code(x[off + k], fd.qp) : (int8_t)0;
      }
    }
  };
  auto fetch_b = [&](int kt, uint32_t (&words)[WPT]) {
#pragma unroll
    for (int j = 0; j < WPT; ++j) {
      const int n = n0 + b_nn[j], jw = kt * WPC + b_jw[j];
      words[j] = (n < N && jw < kwords)
                     ? (uint32_t)wp[(size_t)n * kwords + jw] : 0u;
    }
  };
  // unpacked codes past K meet zero A codes, so they need no mask
  auto store_b = [&](int slot, const uint32_t (&words)[WPT]) {
#pragma unroll
    for (int j = 0; j < WPT; ++j) {
      int8_t* dst = Bs + slot * BN * LDS + b_nn[j] * LDS + b_jw[j] * F;
      if (BITS == 2) {
        const uint32_t v = words[j];
        *reinterpret_cast<uint4*>(dst) = make_uint4(
            spread4<2>(v, b_zp4[j]), spread4<2>(v >> 8, b_zp4[j]),
            spread4<2>(v >> 16, b_zp4[j]), spread4<2>(v >> 24, b_zp4[j]));
      } else {
        const uint32_t v = words[j];
        *reinterpret_cast<uint2*>(dst) = make_uint2(
            spread4<4>(v, b_zp4[j]), spread4<4>(v >> 16, b_zp4[j]));
      }
    }
  };

  int acc[MI][NJ][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  uint32_t words[WPT];
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles) {
      load_a(s, s);
      fetch_b(s, words);
      store_b(s, words);
    }
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    const int nk = kt + STAGES - 1;
    if (nk < ktiles) fetch_b(nk, words);      // in flight over the MMAs
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    // tile kt is in; every warp is done with tile kt - 1, whose slot now
    // takes tile nk
    if (nk < ktiles) load_a(nk, nk % STAGES);
    cp_async_commit();
    const int8_t* as = As + (kt % STAGES) * BM * LDS;
    const int8_t* bs = Bs + (kt % STAGES) * BN * LDS;
#pragma unroll
    for (int ks = 0; ks < BK; ks += 32) {
      // A fragment (row-major 16 x 32): rows g and g + 8, bytes t*4.. and
      // 16 + t*4.. of this k-step
      int a[MI][4];
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const int8_t* r0 = as + (wm + i * 16 + g) * LDS + ks + t * 4;
        const int8_t* r1 = r0 + 8 * LDS;
        a[i][0] = *reinterpret_cast<const int*>(r0);
        a[i][1] = *reinterpret_cast<const int*>(r1);
        a[i][2] = *reinterpret_cast<const int*>(r0 + 16);
        a[i][3] = *reinterpret_cast<const int*>(r1 + 16);
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        // B fragment (column-major 32 x 8): column g, bytes t*4.. and
        // 16 + t*4.., i.e. row g of Bs[n][k]
        const int8_t* bp = bs + (wn + j * 8 + g) * LDS + ks + t * 4;
        const int b0 = *reinterpret_cast<const int*>(bp);
        const int b1 = *reinterpret_cast<const int*>(bp + 16);
#pragma unroll
        for (int i = 0; i < MI; ++i) mma_s8(acc[i][j], a[i], b0, b1);
      }
    }
    if (nk < ktiles) store_b(nk % STAGES, words);
  }

  // epilogue, pass 1: acc * (scale * delta) + bias in f32, rounded step
  // by step as the plain version computes it, into a padded tile in the
  // ring. Accumulator element e of tile (i, j) is row g + 8*(e/2), column
  // t*2 + e%2
  __syncthreads();                         // every warp is done
  float* st = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      const int nn = wn + j * 8 + t * 2 + e2;
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v = __fadd_rn(__fmul_rn((float)acc[i][j][2 * h + e2],
                                        col_sd[nn]), col_b[nn]);
          if (relu) v = fmaxf(v, 0.0f);
          st[(wm + i * 16 + g + 8 * h) * SP + nn] = v;
        }
    }
  __syncthreads();
  // pass 2: out in 16-byte pieces, through the requant for codes
  store_tile<BM, BN, SP, THREADS>(st, codes_out ? STORE_CODES : STORE_F32,
                                  rq, req_cols, out, m0, n0, M, N);
}

template <int BITS, int AM>
int launch(const Feed& fd, const int32_t* wp, const float* wzp,
           const float* scale, const float* bias, void* out, int M, int N,
           int relu, const Requant* rq, cudaStream_t stream) {
  static bool sized = false;
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(&packed_qmm_kernel<BITS, AM>),
        cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if (grid.y > 65535u) return (int)cudaErrorInvalidConfiguration;
  packed_qmm_kernel<BITS, AM><<<grid, THREADS, SMEM, stream>>>(
      fd, wp, wzp, scale, bias, out, M, N, relu, rq != nullptr,
      rq ? *rq : Requant{});
  return (int)cudaGetLastError();
}

template <int BITS>
int dispatch(int amode, const Feed& fd, const int32_t* wp, const float* wzp,
             const float* scale, const float* bias, void* out, int M, int N,
             int relu, const Requant* rq, cudaStream_t stream) {
  switch (amode) {
    case A_CODES16: return launch<BITS, A_CODES16>(fd, wp, wzp, scale, bias,
                                                   out, M, N, relu, rq,
                                                   stream);
    case A_CODES8: return launch<BITS, A_CODES8>(fd, wp, wzp, scale, bias,
                                                 out, M, N, relu, rq, stream);
    case A_CODES1: return launch<BITS, A_CODES1>(fd, wp, wzp, scale, bias,
                                                 out, M, N, relu, rq, stream);
    case A_F32X4: return launch<BITS, A_F32X4>(fd, wp, wzp, scale, bias, out,
                                               M, N, relu, rq, stream);
    case A_F32X1: return launch<BITS, A_F32X1>(fd, wp, wzp, scale, bias, out,
                                               M, N, relu, rq, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x: int8 codes (codes = 1) or f32 rows, NHWC (B, H, W, K); a 1x1 conv of
// the given stride reads rows (b, ho*stride, wo*stride); (M, K) rows are
// B = M, H = W = 1. vec: 16 / 8 (codes) or 4 (f32) element chunks, else 1.
extern "C" int ssq_packed_qmm(const void* x, int codes, const void* w_packed,
                              const void* w_zp, const void* scale,
                              const void* bias, const void* qp, void* out,
                              int B, int H, int W, int K, int stride, int N,
                              int bits, int relu, int vec,
                              const void* requant, void* stream) {
  if (stride < 1 || (bits != 2 && bits != 4))
    return (int)cudaErrorInvalidValue;
  const int Ho = (H - 1) / stride + 1, Wo = (W - 1) / stride + 1;
  const int M = B * Ho * Wo;
  if (M <= 0 || N <= 0 || K <= 0) return 0;
  const Feed fd{x, H, W, K, stride, Ho * Wo, Wo, (const float*)qp};
  const int amode = codes ? (vec == 16 ? A_CODES16 : vec == 8 ? A_CODES8
                                                              : A_CODES1)
                          : (vec == 4 ? A_F32X4 : A_F32X1);
  const Requant* rq = (const Requant*)requant;
  if (bits == 2)
    return dispatch<2>(amode, fd, (const int32_t*)w_packed,
                       (const float*)w_zp, (const float*)scale,
                       (const float*)bias, out, M, N, relu, rq,
                       (cudaStream_t)stream);
  return dispatch<4>(amode, fd, (const int32_t*)w_packed, (const float*)w_zp,
                     (const float*)scale, (const float*)bias, out, M, N,
                     relu, rq, (cudaStream_t)stream);
}

extern "C" const char* ssq_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
