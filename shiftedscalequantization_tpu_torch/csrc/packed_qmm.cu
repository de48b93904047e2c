// Packed sub-byte weight matmul with fused activation quantization.
//
// Replaces shiftedscalequantization_tpu/ops/pallas/packed.py:_pqmm_kernel
// (packed_quant_matmul): y = relu?(acc * (scale_n * delta) + bias_n) with
// acc = sum_k q(x)[m, k] * (w_raw[k, n] - zp_n), q(x) = clip(rint(x / delta)
// + zp, lo, hi) - zp, all integer arithmetic exact in int32.
//
// Packing (ops/cuda/packed.py:pack_codes): w_packed is (N, KW) int32, word
// (n, j) holds the raw codes k = j*f + s in bits [s*bits, (s+1)*bits), f =
// 32/bits. Each word unpacks to f consecutive K positions of one column,
// so a block stages a K-slab of a column with plain byte stores.
//
// Bound on an H100: bytes. At the ResNet-18 downsample shapes (batch 256,
// K = 64..256, N = 128..512) the f32 activations in and the f32 output out
// are 154 / 77 / 38.5 MB, 46 / 23 / 11.5 us at 3.35 TB/s, while the int8
// work is under 2 GOP. The design reads x once per 64-column tile of N,
// quantizes it on the way into shared memory (int8, 4x smaller than f32),
// unpacks the 2-bit codes there, and multiplies with dp4a on int32 words
// of four codes; no f32 or int8 intermediate goes back to device memory.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TM = 64;          // rows of x per block
constexpr int TN = 64;          // output columns per block
constexpr int KS = 256;         // K-slab staged in shared memory
constexpr int ROW = KS + 4;     // bytes per staged row: a 65-word stride
                                // keeps the dp4a operand loads conflict-free
constexpr int THREADS = 256;    // 16 x 16 threads, 4 x 4 outputs each

__global__ void __launch_bounds__(THREADS)
packed_qmm_kernel(const float* __restrict__ x, const int32_t* __restrict__ wp,
                  const float* __restrict__ wzp,
                  const float* __restrict__ scale,
                  const float* __restrict__ bias,
                  const float* __restrict__ qp, float* __restrict__ out,
                  int M, int K, int N, int bits, int relu) {
  __shared__ __align__(16) int8_t xs[TM * ROW];
  __shared__ __align__(16) int8_t ws[TN * ROW];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.x * TM, n0 = blockIdx.y * TN;
  const float delta = qp[0], zp = qp[1], lo = qp[2], hi = qp[3];
  const int f = 32 / bits;
  const int kwords = (K + f - 1) / f;
  const uint32_t mask = (1u << bits) - 1u;

  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += KS) {
    const int kw = min(KS, K - k0);
    const int kw4 = (kw + 3) & ~3;   // dp4a steps read whole words
    // activations: quantize to centered int8 on the way in (division and
    // half-to-even rint, as the TPU kernel's jnp.round(x / delta))
    for (int i = tid; i < TM * kw4; i += THREADS) {
      const int r = i / kw4, c = i - r * kw4;
      const int m = m0 + r, k = k0 + c;
      int8_t v = 0;
      if (m < M && k < K) {
        float q = rintf(x[(size_t)m * K + k] / delta) + zp;
        v = (int8_t)(fminf(fmaxf(q, lo), hi) - zp);
      }
      xs[r * ROW + c] = v;
    }
    // weights: unpack the slab's words, subtract the column zero point in
    // int32; positions past K stay 0
    const int wslab = (kw4 + f - 1) / f;
    for (int i = tid; i < TN * wslab; i += THREADS) {
      const int nn = i / wslab, jj = i - nn * wslab;
      const int n = n0 + nn, j = k0 / f + jj;
      uint32_t word = 0;
      int zpw = 0;
      if (n < N) {
        zpw = (int)rintf(wzp[n]);
        if (j < kwords) word = (uint32_t)wp[(size_t)n * kwords + j];
      }
      int8_t* dst = ws + nn * ROW + jj * f;
      for (int s = 0; s < f; ++s) {
        const int k = j * f + s;
        const int code = (word >> (s * bits)) & mask;
        dst[s] = (n < N && k < K) ? (int8_t)(code - zpw) : (int8_t)0;
      }
    }
    __syncthreads();
    const int* xs32 = reinterpret_cast<const int*>(xs);
    const int* ws32 = reinterpret_cast<const int*>(ws);
    for (int kk = 0; kk < kw4 / 4; ++kk) {
      int a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs32[(ty * 4 + i) * (ROW / 4) + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ws32[(tx + 16 * j) * (ROW / 4) + kk];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue in f32, rounded step by step (no contraction into an FMA) as
  // the plain version computes it: acc * (scale * delta) + bias
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + tx + 16 * j;
    if (n >= N) continue;
    const float sd = __fmul_rn(scale[n], delta);
    const float bn = bias[n];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + ty * 4 + i;
      if (m >= M) continue;
      float v = __fadd_rn(__fmul_rn((float)acc[i][j], sd), bn);
      if (relu) v = fmaxf(v, 0.0f);
      out[(size_t)m * N + n] = v;
    }
  }
}

}  // namespace

extern "C" int ssq_packed_qmm(const void* x, const void* w_packed,
                              const void* w_zp, const void* scale,
                              const void* bias, const void* qp, void* out,
                              int M, int K, int N, int bits, int relu,
                              void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return 0;
  dim3 grid((M + TM - 1) / TM, (N + TN - 1) / TN);
  packed_qmm_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const int32_t*)w_packed, (const float*)w_zp,
      (const float*)scale, (const float*)bias, (const float*)qp,
      (float*)out, M, K, N, bits, relu);
  return (int)cudaGetLastError();
}

extern "C" const char* ssq_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
