// Int8 GEMM on Hopper's warpgroup tensor cores: the int8 implicit-GEMM
// convolution of the deploy path, with the requant in its epilogue, and
// the fused quantize -> int8 GEMM -> dequant of the TPU kernel, on one
// mainloop.
//
// Replaces shiftedscalequantization_tpu/ops/pallas/int_matmul.py:_qmm_kernel
// (quant_matmul, quant_conv1x1). The same mainloop serves the deploy path's
// int8 / bf16_codes units, which the JAX package hands to XLA's int8
// convolution (deploy._int_conv); PyTorch has no int8 convolution on CUDA.
//
// ssq_int8_conv:  codes (B, H, W, C) int8 NHWC, w (S, N, KH*KW*C) int8 in
//   (kh, kw, c) order; per group s the int32 sums acc_s of the convolution,
//   pad_value outside the image, plus acc_offset[s, n] when given. Output:
//   - int32 sums (M, N) (S = 1, no scale table);
//   - the f32 scale-table sum 0 + sum_s float(acc_s) * (table[s, n] * delta),
//     rounded step by step in the JAX package's order;
//   - with a Requant (requant.cuh), int8 codes: the value v (float(acc +
//     offset) at S = 1 without a table, else the scale-table sum) goes
//     through deploy's quantize_out, and with a residual stage through the
//     block's requant too, before it leaves the registers.
// ssq_quant_matmul:  x (M, K) f32, w (K, N) int8 ->
//   out = relu?(acc * (scale_n * delta) + bias_n),
//   acc = sum_k q[m, k] * w[k, n], q = clip(rint(x / delta) + zp, lo, hi) - zp
//   (IEEE division and half-to-even rint, as jnp.round(x / delta)).
//
// Bound on an H100: operations. The method path's 19 convolutions at batch
// 256, 224x224, two weight groups, do 1.736 T int8 operations, 0.877 ms at
// the tensor cores' 1979 TOP/s, while the int8 codes they read and write
// once move 0.97 GB, 0.290 ms at 3.35 TB/s (with f32 sums out, 2.26 GB).
// Only wgmma approaches that rate, and only if its operands arrive on time
// and the sums never go back to device memory. The design:
// - each block computes 128 output pixels x BN columns for all S groups at
//   once: the B tiles of the S groups are stacked into one wgmma operand of
//   S*BN rows (m64nNk32, N = 64 or 128, bn_for), so one A fragment feeds
//   every group and each of the two warpgroups issues one wgmma per 32
//   bytes of K;
// - the A tile (128 pixels x 128 bytes of K) is gathered straight from the
//   NHWC codes with 16-byte cp.async (zero-fill past the edges; border
//   chunks whose pad code is not 0 are plain stores), so no im2col tensor
//   exists; the B tiles come in by cp.async beside it;
// - both tiles sit in a 3-stage ring of dynamic shared memory (at most
//   97 KB, two blocks per SM) laid out in CuTe's GMMA K-major 128-byte
//   swizzle atoms, whose descriptors wgmma reads directly; loads for two
//   stages ahead are in flight while the tensor cores work;
// - the epilogue sums the groups through the scale table into a padded f32
//   tile in the ring, then walks it 16 columns at a time through the
//   requant (every step __fmul_rn / __fadd_rn, no FMA contraction: the
//   codes equal the PyTorch route's bit for bit), residual and codes in
//   16-byte pieces.
// Measured on the card, the kernel runs at 2-5x its bound: half of a
// small-K unit's time is the tile's fixed cost (the first stages' loads
// and the epilogue), and the deep units are bound by the L2 traffic of
// the gather (A re-read per column tile). Four warpgroups per block,
// four stages, one wgmma group left in flight and 256-wide wgmma at S = 2
// (one block per SM) measured no faster. Not yet: TMA (im2col) with
// multicast, warp specialisation, a persistent grid.
#include <cuda_runtime.h>
#include <stdint.h>

#include <cute/tensor.hpp>
#include <cute/atom/mma_traits_sm90_gmma.hpp>

#include "requant.cuh"

namespace {

constexpr int WGS = 2;           // warpgroups per block, 64 rows each
constexpr int BM = 64 * WGS;     // output rows (pixels) per block
constexpr int BK = 128;          // bytes of K per stage: one swizzle atom row
constexpr int THREADS = 128 * WGS;
constexpr int STAGES = 3;        // two blocks of 97 KB fit an SM
constexpr int PIPE = 0;          // wgmma groups left in flight (tried 1, and
                                 // 4 warpgroups, 4 stages: no faster)
constexpr int LA = STAGES - 1 - PIPE;  // tiles loaded ahead
constexpr int MAX_S = 4;

// Columns per block: the wgmma width (all groups' B rows, S * BN) stays
// at 128 or below, which keeps two blocks per SM. One group takes 128
// columns where N >= 128 (the A gather is re-read per column tile: 25-30%
// faster than 64 on those layers on an H100) and 64 below; two take 64,
// four 32 (S = 3 runs as 4 with a zero group, ops/cuda/int_matmul.py).
constexpr int bn_for(int S, int N) {
  return S == 1 ? (N >= 128 ? 128 : 64) : S == 2 ? 64 : 32;
}

// a ROWS x BK int8 tile in GMMA K-major 128-byte swizzle atoms
template <int ROWS>
using SmemLayout = decltype(cute::tile_to_shape(
    cute::GMMA::Layout_K_SW128_Atom<int8_t>{},
    cute::Shape<cute::Int<ROWS>, cute::Int<BK>>{}));

// byte offset of (row r, byte k) in a ROWS x BK tile
template <int ROWS>
__device__ __forceinline__ int smem_off(int r, int k) {
  return SmemLayout<ROWS>{}(r, k);
}

// wgmma descriptor of the ROWS_MMA x 32-byte slab at the start of a
// ROWS x BK tile; a slab rows r.. and bytes k.. further is this plus
// (r * BK + k) >> 4, as CuTe's descriptor iterator advances it
template <int ROWS_MMA, int ROWS>
__device__ __forceinline__ uint64_t gmma_desc(const int8_t* tile) {
  auto t = cute::make_tensor(cute::make_smem_ptr(tile), SmemLayout<ROWS>{});
  auto slab = cute::local_tile(
      t, cute::Shape<cute::Int<ROWS_MMA>, cute::Int<32>>{},
      cute::make_coord(0, 0));
  return cute::GMMA::make_gmma_desc<cute::GMMA::Major::K>(slab).desc_;
}

template <int NW>
struct Wgmma;

// wgmma.mma_async m64nNk32 s32 += s8 x s8, A and B K-major in shared memory
template <> struct Wgmma<128> {
  __device__ static __forceinline__ void mma(uint32_t (&d)[64], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
          "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
          "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
          "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
          "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
          "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <> struct Wgmma<64> {
  __device__ static __forceinline__ void mma(uint32_t (&d)[32], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
          "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
          "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
        : "l"(a), "l"(b), "r"(1));
  }
};


__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// 16-byte cp.async into shared memory; src_size 0 fills zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// clip(rint(x / delta) + zp, lo, hi) - zp, qp = (delta, zp, lo, hi): IEEE
// division and half-to-even rint, as jnp.round(x / delta)
__device__ __forceinline__ int8_t quant_code(float x, const float* qp) {
  const float q = rintf(__fdiv_rn(x, qp[0])) + qp[1];
  return (int8_t)(int)(fminf(fmaxf(q, qp[2]), qp[3]) - qp[1]);
}

// generic-proxy writes (cp.async, st.shared) -> visible to wgmma's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

struct Conv {
  const int8_t* x;
  int H, W, C, KW, SH, SW, PH, PW, HoWo, Wo;
  int pad;                        // code outside the image
  int vec;                        // C % 16 == 0, aligned: 16-byte cp.async
};

struct Quant {
  const float* x;
  const float* qp;                // delta, zp, lo, hi
  int vec;                        // K % 4 == 0, aligned: float4 loads; and
                                  // N % 4 == 0: 4-byte weight loads
};

enum OutMode { OUT_I32 = 0, OUT_TABLE = 1, OUT_CODES = 2, OUT_AFFINE = 3 };

struct Out {
  int mode;
  const float* table;             // (S, N) scale table, or scale (N)
  const float* bias;              // (N), OUT_AFFINE
  const int32_t* acc_offset;      // (S, N) or null
  const float* delta;             // device scalar
  int relu;                       // OUT_AFFINE
  void* out;
  Requant rq;                     // OUT_CODES
};

// Loaders. The convolution: the A gather and the w (S, N, K)
// rows by 16-byte cp.async when cv.vec (C % 16 == 0, aligned), else bytes.
// quant_matmul (qt.x set, S = 1): f32 rows quantized on the way in, four
// at a time when qt.vec, and w (K, N) read across, four columns at a time.
template <int S, int BN>
__global__ void __launch_bounds__(THREADS, 2)
igemm_kernel(Conv cv, Quant qt, const int8_t* __restrict__ w, Out o, int M,
             int K, int N) {
  constexpr int NW = S * BN;
  constexpr int A_BYTES = BM * BK, B_BYTES = NW * BK;
  constexpr int STAGE = A_BYTES + B_BYTES;
  constexpr int RS = THREADS / 8;  // rows a 16-byte loader pass covers
  constexpr int RA = BM / RS;     // A rows per thread
  constexpr int RB = NW / RS;     // B rows per thread
  extern __shared__ uint8_t smem_raw[];
  // the block's per-column epilogue terms: table[s, n] * delta and
  // acc_offset[s, n] (or quant_matmul's scale[n] * delta and bias[n])
  __shared__ float col_sd[S * BN], col_b[BN];
  __shared__ int col_off[S * BN];
  __shared__ __align__(16) float req_cols[4 * BN];   // OUT_CODES
  // swizzle atoms must start on 1024-byte boundaries
  const uint32_t s0 = (uint32_t)__cvta_generic_to_shared(smem_raw);
  int8_t* ring = reinterpret_cast<int8_t*>(smem_raw)
                 + ((1024u - (s0 & 1023u)) & 1023u);
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int kc = tid & 7;          // this thread's 16-byte chunk of a row
  const int r0 = tid >> 3;         // its first row; then r0 + RS i

  // the output pixel of each A row this thread gathers: b*H, the top-left
  // input coordinates; a_b < 0 marks a row past M
  int a_b[RA], a_h[RA], a_w[RA];
  const bool quant = qt.x != nullptr;
  const bool gather16 = !quant && cv.vec;
  if (gather16) {
#pragma unroll
    for (int i = 0; i < RA; ++i) {
      const int m = m0 + r0 + RS * i;
      a_b[i] = -1, a_h[i] = 0, a_w[i] = 0;
      if (m < M) {
        const int b = m / cv.HoWo, rem = m - b * cv.HoWo;
        const int ho = rem / cv.Wo, wo = rem - ho * cv.Wo;
        a_b[i] = b * cv.H;
        a_h[i] = ho * cv.SH - cv.PH;
        a_w[i] = wo * cv.SW - cv.PW;
      }
    }
  }

  auto load_stage = [&](int kt, int slot) {
    int8_t* As = ring + slot * STAGE;
    int8_t* Bs = As + A_BYTES;
    const int k0 = kt * BK;
    if (gather16) {
      const int k = k0 + kc * 16;
      const bool kin = k < K;
      int kh = 0, kw = 0, ic = 0;
      if (kin) {
        const int t = k / cv.C;
        ic = k - t * cv.C;
        kh = t / cv.KW;
        kw = t - kh * cv.KW;
      }
      const uint32_t p = (uint32_t)(uint8_t)cv.pad * 0x01010101u;
#pragma unroll
      for (int i = 0; i < RA; ++i) {
        int8_t* dst = As + smem_off<BM>(r0 + RS * i, kc * 16);
        const int hi = a_h[i] + kh, wi = a_w[i] + kw;
        const bool row = kin && a_b[i] >= 0;
        const bool inside = row && hi >= 0 && hi < cv.H && wi >= 0
                            && wi < cv.W;
        if (row && !inside && cv.pad != 0) {
          *reinterpret_cast<int4*>(dst) =
              make_int4((int)p, (int)p, (int)p, (int)p);
        } else {
          const int8_t* src =
              inside ? cv.x + (((size_t)a_b[i] + hi) * cv.W + wi) * cv.C + ic
                     : cv.x;
          cp_async16(dst, src, inside);
        }
      }
    } else if (quant && qt.vec) {
#pragma unroll 1
      for (int i = tid; i < BM * BK / 4; i += THREADS) {
        const int r = i / (BK / 4), c = (i - r * (BK / 4)) * 4;
        const int m = m0 + r, k = k0 + c;
        uint32_t v = 0u;
        if (m < M && k < K) {
          const float4 f =
              *reinterpret_cast<const float4*>(qt.x + (size_t)m * K + k);
          v = (uint32_t)(uint8_t)quant_code(f.x, qt.qp)
              | ((uint32_t)(uint8_t)quant_code(f.y, qt.qp) << 8)
              | ((uint32_t)(uint8_t)quant_code(f.z, qt.qp) << 16)
              | ((uint32_t)(uint8_t)quant_code(f.w, qt.qp) << 24);
        }
        *reinterpret_cast<uint32_t*>(As + smem_off<BM>(r, c)) = v;
      }
    } else {
#pragma unroll 1
      for (int i = tid; i < BM * BK; i += THREADS) {
        const int r = i / BK, c = i - r * BK;
        const int m = m0 + r, k = k0 + c;
        int8_t v = 0;
        if (m < M && k < K) {
          if (quant) {
            v = quant_code(qt.x[(size_t)m * K + k], qt.qp);
          } else {
            const int b = m / cv.HoWo, rem = m - b * cv.HoWo;
            const int ho = rem / cv.Wo, wo = rem - ho * cv.Wo;
            const int t = k / cv.C, ic = k - t * cv.C;
            const int kh = t / cv.KW, kw = t - kh * cv.KW;
            const int hi = ho * cv.SH - cv.PH + kh;
            const int wi = wo * cv.SW - cv.PW + kw;
            v = (hi >= 0 && hi < cv.H && wi >= 0 && wi < cv.W)
                    ? cv.x[(((size_t)b * cv.H + hi) * cv.W + wi) * cv.C + ic]
                    : (int8_t)cv.pad;
          }
        }
        As[smem_off<BM>(r, c)] = v;
      }
    }
    if (gather16) {
      const int k = k0 + kc * 16;
#pragma unroll
      for (int j = 0; j < RB; ++j) {
        const int row = r0 + RS * j;
        const int s = row / BN, n = n0 + row - s * BN;
        const bool valid = n < N && k < K;
        cp_async16(Bs + smem_off<NW>(row, kc * 16),
                   valid ? w + ((size_t)s * N + n) * K + k : w, valid);
      }
    } else if (!quant) {
#pragma unroll 1
      for (int i = tid; i < NW * BK; i += THREADS) {
        const int row = i / BK, c = i - row * BK;
        const int s = row / BN, n = n0 + row - s * BN, k = k0 + c;
        Bs[smem_off<NW>(row, c)] =
            (n < N && k < K) ? w[((size_t)s * N + n) * K + k] : (int8_t)0;
      }
    } else if (qt.vec) {
      // w (K, N): neighbouring threads read neighbouring 4-column words
#pragma unroll 1
      for (int i = tid; i < NW * BK / 4; i += THREADS) {
        const int c = i / (NW / 4), row = (i - c * (NW / 4)) * 4;
        const int n = n0 + row, k = k0 + c;
        const uint32_t v = (n < N && k < K)
            ? *reinterpret_cast<const uint32_t*>(w + (size_t)k * N + n) : 0u;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          Bs[smem_off<NW>(row + j, c)] = (int8_t)(v >> (8 * j));
      }
    } else {
#pragma unroll 1
      for (int i = tid; i < NW * BK; i += THREADS) {
        const int c = i / NW, row = i - c * NW;
        const int n = n0 + row, k = k0 + c;
        Bs[smem_off<NW>(row, c)] =
            (n < N && k < K) ? w[(size_t)k * N + n] : (int8_t)0;
      }
    }
  };

  uint32_t acc[NW / 2];
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) acc[i] = 0u;
  const float delta = o.delta ? *o.delta : 0.0f;
  for (int i = tid; i < S * BN; i += THREADS) {
    const int s = i / BN, n = n0 + i - s * BN;
    const bool ok = n < N;
    col_sd[i] = ok && o.table ? __fmul_rn(o.table[s * N + n], delta) : 0.0f;
    col_off[i] = ok && o.acc_offset ? o.acc_offset[s * N + n] : 0;
    if (s == 0) col_b[i] = ok && o.bias ? o.bias[n] : 0.0f;
  }
  if (o.mode == OUT_CODES)
    load_requant_cols<BN, THREADS>(req_cols, o.rq, n0, N);

  const int ktiles = (K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < LA; ++s) {
    if (s < ktiles) load_stage(s, s);
    cp_async_commit();
  }
  const int wg = tid >> 7;
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<LA - 1>();
    fence_proxy_async();
    __syncthreads();
    // tile kt is in; every warpgroup is done with tile kt - 1 - PIPE, whose
    // slot now takes tile kt + LA
    if (kt + LA < ktiles) load_stage(kt + LA, (kt + LA) % STAGES);
    cp_async_commit();
    const int8_t* As = ring + (kt % STAGES) * STAGE;
    const uint64_t da = gmma_desc<64, BM>(As)
                        + (uint64_t)((wg * 64 * BK) >> 4);
    const uint64_t db = gmma_desc<NW, NW>(As + A_BYTES);
    // every tile is zero past K on both sides: no k-step is skipped
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks)
      Wgmma<NW>::mma(acc, da + (uint64_t)(ks * 2), db + (uint64_t)(ks * 2));
    wgmma_commit();
    wgmma_wait<PIPE>();
    fence_regs(acc);
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // epilogue, pass 1: each accumulator's value into a padded f32 tile in
  // the ring (int32 sums as their bits). Accumulator register
  // 4*(s*BN/8 + jj) + 2*h + e of this thread is row rbase + 8*h, column
  // jj*8 + 2*t4 + e of group s
  constexpr int SP = BN + 4;               // staged row stride, in floats
  __syncthreads();                         // every warpgroup is done
  float* st = reinterpret_cast<float*>(ring);
  const int lane = tid & 31, warp = (tid & 127) >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int rbase = wg * 64 + warp * 16 + g;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int jj = 0; jj < BN / 8; ++jj)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int nn = jj * 8 + 2 * t4 + e;
        int a[S];
#pragma unroll
        for (int s = 0; s < S; ++s)
          a[s] = (int)acc[4 * (s * (BN / 8) + jj) + 2 * h + e];
        float v;
        if (o.mode == OUT_AFFINE) {
          v = __fadd_rn(__fmul_rn((float)a[0], col_sd[nn]), col_b[nn]);
          if (o.relu) v = fmaxf(v, 0.0f);
        } else if (o.table == nullptr) {
          const int sum = a[0] + col_off[nn];
          v = o.mode == OUT_I32 ? __int_as_float(sum) : (float)sum;
        } else {
          v = 0.0f;
#pragma unroll
          for (int s = 0; s < S; ++s)
            v = __fadd_rn(v, __fmul_rn((float)(a[s] + col_off[s * BN + nn]),
                                       col_sd[s * BN + nn]));
        }
        st[(rbase + 8 * h) * SP + nn] = v;
      }
  __syncthreads();
  // pass 2: out in 16-byte pieces, through the requant for codes
  store_tile<BM, BN, SP, THREADS>(
      st, o.mode == OUT_CODES ? STORE_CODES
          : o.mode == OUT_I32 ? STORE_I32 : STORE_F32,
      o.rq, req_cols, o.out, m0, n0, M, N);
}

template <int S, int BN>
int launch(const Conv& cv, const Quant& qt, const int8_t* w, const Out& o,
           int M, int K, int N, cudaStream_t stream) {
  constexpr int smem = STAGES * (BM + S * BN) * BK + 1024;
  static bool sized = false;
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(&igemm_kernel<S, BN>),
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if (grid.y > 65535u) return (int)cudaErrorInvalidConfiguration;
  igemm_kernel<S, BN><<<grid, THREADS, smem, stream>>>(cv, qt, w, o, M, K,
                                                       N);
  return (int)cudaGetLastError();
}

int dispatch(int S, const Conv& cv, const Quant& qt, const int8_t* w,
             const Out& o, int M, int K, int N, cudaStream_t stream) {
  switch (S * 1000 + bn_for(S, N)) {
    case 1064: return launch<1, 64>(cv, qt, w, o, M, K, N, stream);
    case 1128: return launch<1, 128>(cv, qt, w, o, M, K, N, stream);
    case 2064: return launch<2, 64>(cv, qt, w, o, M, K, N, stream);
    case 4032: return launch<4, 32>(cv, qt, w, o, M, K, N, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int ssq_quant_matmul(const void* x, const void* w,
                                const void* scale, const void* bias,
                                const void* qp, void* out, int M, int K,
                                int N, int relu, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return 0;
  Conv cv{};
  Out o{};
  o.mode = OUT_AFFINE;
  o.table = (const float*)scale;
  o.bias = (const float*)bias;
  o.delta = (const float*)qp;       // qp[0] is delta
  o.relu = relu;
  o.out = out;
  const int vec = K % 4 == 0 && N % 4 == 0 && (uintptr_t)x % 16 == 0
                  && (uintptr_t)w % 4 == 0;
  return dispatch(1, cv, Quant{(const float*)x, (const float*)qp, vec},
                  (const int8_t*)w, o, M, K, N, (cudaStream_t)stream);
}

extern "C" int ssq_int8_conv(const void* x, const void* w, const void* table,
                             const void* acc_offset, const void* delta,
                             void* out, int S, int B, int H, int W, int C,
                             int KH, int KW, int SH, int SW, int PH, int PW,
                             int N, int pad, int vec, const void* requant,
                             void* stream) {
  if (S < 1 || S > MAX_S || (table == nullptr && S != 1))
    return (int)cudaErrorInvalidValue;
  const int Ho = (H + 2 * PH - KH) / SH + 1, Wo = (W + 2 * PW - KW) / SW + 1;
  const int M = B * Ho * Wo, K = KH * KW * C;
  if (M <= 0 || N <= 0 || K <= 0) return 0;
  const Conv cv{(const int8_t*)x, H, W, C, KW, SH, SW, PH, PW, Ho * Wo, Wo,
                pad, vec};
  Out o{};
  o.mode = requant ? OUT_CODES : (table ? OUT_TABLE : OUT_I32);
  o.table = (const float*)table;
  o.acc_offset = (const int32_t*)acc_offset;
  o.delta = (const float*)delta;
  o.out = out;
  if (requant) o.rq = *(const Requant*)requant;
  return dispatch(S, cv, Quant{nullptr, nullptr, 0}, (const int8_t*)w, o, M,
                  K, N, (cudaStream_t)stream);
}
