// Integer depthwise KxK convolution (K 3 or 5, pad K/2, stride 1 or 2) of
// int8 NHWC codes, with the scale-table and requant epilogues of int8_conv
// (int_matmul.cu).
//
// Replaces no TPU kernel: the JAX package serves its bf16_codes and int8
// depthwise units with XLA's grouped convolution
// (shiftedscalequantization_tpu/deploy.py, conv_general_dilated with
// feature_group_count = C), and PyTorch has no exact int8 convolution on
// CUDA. MNASNet's 5x5 units and every depthwise unit outside the dw_int8
// kind (csrc/dw_conv3x3.cu: 3x3, centered int8 feed and site, its own
// rint rounding) run here.
//
// ssq_dw_conv_int8:  codes (B, H, W, C) int8, w (S, C, K*K) int8 in (kh,
//   kw) order. Per weight group s (a shift candidate) the int32 sums
//   acc_s[c] = sum_taps x[., c] * w[s, c, tap], pad_value outside the
//   image, plus acc_offset[s, c] when given. Output, as ssq_int8_conv:
//   - int32 sums (S = 1, no scale table);
//   - the f32 scale-table sum 0 + sum_s float(acc_s) * (table[s, c] *
//     delta), each step rounded on its own (__fmul_rn, __fadd_rn) in s
//     order;
//   - with a Requant (requant.cuh), int8 codes: that value (float(acc) at
//     S = 1 without a table) through deploy's quantize_out, floor(x + 0.5)
//     rounding and all.
//
// Bound on an H100: bytes. A depthwise conv does K*K multiply-adds per
// output against one code read and one written (25 at 5x5, far below the
// card's 590 int8 operations per byte), so the codes in and out are the
// work. The design is the simple one:
// - a block owns one image, a tile of TH x TW output pixels and CT = 32
//   channels (one a lane; a warp an output row of the tile). It stages the
//   tile's input halo, ((TH-1)*SH + K) x ((TW-1)*SW + K) pixels of its 32
//   channels, in shared memory once (4-byte words where C % 4 == 0, bytes
//   otherwise; the pad value stored outside the image), and the S groups'
//   taps of its channels beside it, then waits at one barrier;
// - a thread takes one channel of one output row of the tile: per kernel
//   row it reads the (TW-1)*SW + K input codes of that row into registers
//   once and accumulates the TW outputs' products in int32 (exact);
// - the epilogue runs from registers, one output at a time through
//   requant.cuh's store_chunk: the warp's 32 lanes write 32 consecutive
//   channels of one pixel.
// The halo is read again by the neighbouring tiles (from L2): at 5x5,
// stride 1, about 1.9x the input bytes leave L2. Making it fast is later
// work.
#include <cuda_runtime.h>
#include <stdint.h>

#include "requant.cuh"

namespace {

constexpr int CT = 32;            // channels per block, one a lane
constexpr int TH = 8;             // output rows per tile, one a warp
constexpr int TW = 16;            // output columns per tile, all a thread's
constexpr int THREADS = CT * TH;
constexpr int MAX_S = 4;

enum Mode { OUT_I32 = 0, OUT_TABLE = 1, OUT_CODES = 2 };

struct DwArgs {
  const int8_t* x;
  const int8_t* w;               // (S, C, K*K)
  const float* table;            // (S, C) or null
  const int32_t* acc_offset;     // (S, C) or null
  const float* delta;            // device scalar, with the table
  void* out;
  int H, W, C, Ho, Wo, pad, vec, mode, tiles_h, tiles_w;
  Requant rq;
};

template <int K, int ST, int S>
__global__ void __launch_bounds__(THREADS)
    dw_conv_int8_kernel(const DwArgs a) {
  constexpr int KK = K * K;
  constexpr int IR = (TH - 1) * ST + K;      // halo rows
  constexpr int IC = (TW - 1) * ST + K;      // halo columns
  __shared__ __align__(16) int8_t xs[IR * IC * CT];
  __shared__ int ws[S * KK * CT];
  __shared__ float col_sd[S * CT];
  __shared__ int col_off[S * CT];
  __shared__ __align__(16) float req_cols[4 * CT];

  const int tid = threadIdx.x;
  const int lane = tid & 31, row = tid >> 5;
  int bx = blockIdx.x;
  const int tw = bx % a.tiles_w;
  bx /= a.tiles_w;
  const int th = bx % a.tiles_h;
  const int b = bx / a.tiles_h;
  const int C = a.C;
  const int c0 = blockIdx.y * CT;
  const int oy0 = th * TH, ox0 = tw * TW;
  const int iy0 = oy0 * ST - K / 2, ix0 = ox0 * ST - K / 2;

  // the S groups' taps of the block's channels, and the epilogue's terms
  for (int i = tid; i < S * KK * CT; i += THREADS) {
    const int cl = i % CT, st = i / CT;        // st = s * KK + tap
    const int c = c0 + cl;
    ws[i] = c < C ? (int)a.w[((size_t)(st / KK) * C + c) * KK + st % KK] : 0;
  }
  const float delta = a.delta ? *a.delta : 0.0f;
  for (int i = tid; i < S * CT; i += THREADS) {
    const int s = i / CT, c = c0 + i - s * CT;
    const bool ok = c < C;
    col_sd[i] = ok && a.table ? __fmul_rn(a.table[s * C + c], delta) : 0.0f;
    col_off[i] = ok && a.acc_offset ? a.acc_offset[s * C + c] : 0;
  }
  if (a.mode == OUT_CODES)
    load_requant_cols<CT, THREADS>(req_cols, a.rq, c0, C);

  // the tile's input halo, pad_value outside the image
  const int8_t* img = a.x + (size_t)b * a.H * a.W * C;
  if (a.vec) {
    constexpr int WPP = CT / 4;                // 4-byte words a pixel
    const uint32_t padw = (uint32_t)(uint8_t)a.pad * 0x01010101u;
    uint32_t* xw = reinterpret_cast<uint32_t*>(xs);
    for (int i = tid; i < IR * IC * WPP; i += THREADS) {
      const int q = i % WPP, pix = i / WPP;
      const int r = pix / IC, col = pix - r * IC;
      const int y = iy0 + r, x = ix0 + col, c = c0 + 4 * q;
      uint32_t v = 0u;
      if (c < C)
        v = (y >= 0 && y < a.H && x >= 0 && x < a.W)
                ? __ldg(reinterpret_cast<const uint32_t*>(
                      img + ((size_t)y * a.W + x) * C + c))
                : padw;
      xw[i] = v;
    }
  } else {
    for (int i = tid; i < IR * IC * CT; i += THREADS) {
      const int cl = i % CT, pix = i / CT;
      const int r = pix / IC, col = pix - r * IC;
      const int y = iy0 + r, x = ix0 + col, c = c0 + cl;
      int8_t v = 0;
      if (c < C)
        v = (y >= 0 && y < a.H && x >= 0 && x < a.W)
                ? img[((size_t)y * a.W + x) * C + c]
                : (int8_t)a.pad;
      xs[i] = v;
    }
  }
  __syncthreads();

  int acc[S][TW];
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int t = 0; t < TW; ++t) acc[s][t] = 0;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const int8_t* src = xs + (row * ST + i) * IC * CT + lane;
    int xr[IC];
#pragma unroll
    for (int j = 0; j < IC; ++j) xr[j] = src[j * CT];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      int wr[K];
#pragma unroll
      for (int j = 0; j < K; ++j) wr[j] = ws[(s * KK + i * K + j) * CT + lane];
#pragma unroll
      for (int t = 0; t < TW; ++t)
#pragma unroll
        for (int j = 0; j < K; ++j) acc[s][t] += xr[t * ST + j] * wr[j];
    }
  }

  const int oy = oy0 + row, c = c0 + lane;
  if (oy >= a.Ho || c >= C) return;
  const int mode = a.mode == OUT_CODES ? STORE_CODES
                   : a.mode == OUT_I32 ? STORE_I32 : STORE_F32;
  RequantScalars sc{};
  if (a.mode == OUT_CODES) sc = requant_scalars(a.rq);
  const size_t row0 = ((size_t)b * a.Ho + oy) * a.Wo;
#pragma unroll
  for (int t = 0; t < TW; ++t) {
    const int ox = ox0 + t;
    if (ox < a.Wo) {
      float v[1];
      if (a.table == nullptr) {
        const int sum = acc[0][t] + col_off[lane];
        v[0] = a.mode == OUT_I32 ? __int_as_float(sum) : (float)sum;
      } else {
        v[0] = 0.0f;
#pragma unroll
        for (int s = 0; s < S; ++s)
          v[0] = __fadd_rn(v[0], __fmul_rn((float)(acc[s][t]
                                                   + col_off[s * CT + lane]),
                                           col_sd[s * CT + lane]));
      }
      store_chunk<1>(v, mode, a.rq, sc, req_cols, CT, lane,
                     (row0 + ox) * C + c, a.out);
    }
  }
}

template <int K, int ST, int S>
int launch(const DwArgs& a, int B, cudaStream_t stream) {
  const dim3 grid(B * a.tiles_h * a.tiles_w, (a.C + CT - 1) / CT);
  dw_conv_int8_kernel<K, ST, S><<<grid, THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int K, int ST>
int dispatch_s(int S, const DwArgs& a, int B, cudaStream_t stream) {
  switch (S) {
    case 1: return launch<K, ST, 1>(a, B, stream);
    case 2: return launch<K, ST, 2>(a, B, stream);
    case 4: return launch<K, ST, 4>(a, B, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int ssq_dw_conv_int8(const void* x, const void* w,
                                const void* table, const void* acc_offset,
                                const void* delta, void* out, int S, int B,
                                int H, int W, int C, int K, int stride,
                                int pad, const void* requant, void* stream) {
  if (S < 1 || S > MAX_S || (table == nullptr && S != 1)
      || (K != 3 && K != 5) || (stride != 1 && stride != 2))
    return (int)cudaErrorInvalidValue;
  DwArgs a{};
  a.x = (const int8_t*)x;
  a.w = (const int8_t*)w;
  a.table = (const float*)table;
  a.acc_offset = (const int32_t*)acc_offset;
  a.delta = (const float*)delta;
  a.out = out;
  a.H = H, a.W = W, a.C = C;
  a.Ho = (H - 1) / stride + 1;               // pad K / 2
  a.Wo = (W - 1) / stride + 1;
  if (B <= 0 || C <= 0 || a.Ho <= 0 || a.Wo <= 0) return 0;
  a.pad = pad;
  a.vec = C % 4 == 0 && (uintptr_t)x % 4 == 0;
  a.mode = requant ? OUT_CODES : (table ? OUT_TABLE : OUT_I32);
  a.tiles_h = (a.Ho + TH - 1) / TH;
  a.tiles_w = (a.Wo + TW - 1) / TW;
  if ((long long)B * a.tiles_h * a.tiles_w >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (requant) a.rq = *(const Requant*)requant;
  const cudaStream_t s = (cudaStream_t)stream;
  if (K == 3)
    return stride == 1 ? dispatch_s<3, 1>(S, a, B, s)
                       : dispatch_s<3, 2>(S, a, B, s);
  return stride == 1 ? dispatch_s<5, 1>(S, a, B, s)
                     : dispatch_s<5, 2>(S, a, B, s);
}
