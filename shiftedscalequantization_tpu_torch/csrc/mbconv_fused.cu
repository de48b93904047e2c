// Fused stride-1 MobileNetV2 inverted-residual block on int8 codes:
// expand 1x1 -> clip(floor(acc*A_e + B_e), 0, hi_e) -> depthwise 3x3 (zero
// padding) -> clip(floor(acc*A_d + B_d), 0, hi_d) -> project 1x1 ->
// acc*A_p + B_p (+ x*res_scale) -> clip(floor(.), lo_o, hi_o), int8 out.
//
// Replaces shiftedscalequantization_tpu/ops/pallas/mbconv.py:38
// (_mbconv_kernel, via mbconv_fused).
//
// Bound on an H100: bytes at most shapes. The block reads its int8 input
// codes once and writes its int8 output codes once, B*H*W*(CI+CO) bytes;
// its integer work, 2*B*H*W*(CI*CE + 9*CE + CE*CO) operations, is below
// that line at the int8 tensor-core rate (1,979 TOPS): at batch 256,
// features.3 (56x56, 24/144/24) is 11.5 us of bytes against 4.0 us of
// operations. The design keeps both intermediates (the expand output,
// 6x the input, and the dw output) in shared memory, never in device
// memory: one block per (image, band of R output rows) stages the band's
// input rows plus a one-row halo, expands them into 8-bit codes q1 (the
// halo rows are recomputed by both neighbouring bands, not exchanged),
// runs the 9-tap dw into 8-bit codes q2, and projects q2 with the
// epilogue. R is the largest band whose buffers fit about 100 KB, so two
// blocks share an SM. This first version multiplies with scalar int32
// IMADs and reads the weights through the read-only cache; it is far from
// the bound (tensor cores via mma/wgmma on the two 1x1 products are the
// next step).
//
// Arithmetic, as the plain version (ops/cuda/mbconv.py): every sum is an
// int32 accumulate of integer codes (exact); each epilogue is rounded after
// the multiply and after the add (__fmul_rn, __fadd_rn, never an FMA),
// and the residual term x*res_scale is added last.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 256;
constexpr size_t BAND_BYTES = 100 * 1024;   // target smem per block
constexpr size_t MAX_SMEM = 232448;         // opt-in limit per block

__host__ __device__ inline size_t align16(size_t n) {
  return (n + 15) & ~size_t(15);
}

// shared bytes of a band of R rows: q1 (R+2)x(W+2)xCE, q2 RxWxCE, and the
// staged input (R+2)xWxCI when there is an expand
__host__ __device__ inline size_t smem_bytes(int R, int W, int CI, int CE,
                                             bool expand) {
  return align16((size_t)(R + 2) * (W + 2) * CE) +
         align16((size_t)R * W * CE) +
         (expand ? (size_t)(R + 2) * W * CI : 0);
}

__device__ __forceinline__ float affine(int acc, float a, float b) {
  return __fadd_rn(__fmul_rn((float)acc, a), b);
}

// Q1: uint8_t after an expand (codes in [0, hi_e], hi_e <= 255); int8_t
// without one (q1 is the block input itself)
template <bool EXPAND, bool RESID>
__global__ void __launch_bounds__(THREADS)
mbconv_fused_kernel(const int8_t* __restrict__ x,
                    const int8_t* __restrict__ we,
                    const float* __restrict__ ae,
                    const int8_t* __restrict__ wd,
                    const float* __restrict__ ad,
                    const int8_t* __restrict__ wp,
                    const float* __restrict__ ap,
                    const float* __restrict__ qp, int8_t* __restrict__ out,
                    int H, int W, int CI, int CE, int CO, int R) {
  using Q1 = typename std::conditional<EXPAND, uint8_t, int8_t>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  const int W2 = W + 2;
  Q1* q1 = reinterpret_cast<Q1*>(smem);                 // [R+2][W+2][CE]
  uint8_t* q2 = smem + align16((size_t)(R + 2) * W2 * CE);   // [R][W][CE]
  int8_t* xs = reinterpret_cast<int8_t*>(
      q2 + align16((size_t)R * W * CE));                // [R+2][W][CI]
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * R;
  const int rows = min(R, H - r0);
  const float hi_e = qp[0], hi_d = qp[1], r_s = qp[2], lo_o = qp[3],
              hi_o = qp[4];
  const int8_t* xb = x + (size_t)b * H * W * CI;

  // q1 starts at zero: the dw's padding, and the halo rows off the image
  const int q1_words = (int)(align16((size_t)(R + 2) * W2 * CE) / 4);
  for (int i = tid; i < q1_words; i += THREADS)
    reinterpret_cast<uint32_t*>(smem)[i] = 0u;
  if (EXPAND) {
    // input rows r0-1 .. r0+rows that lie on the image
    for (int i = tid; i < (rows + 2) * W * CI; i += THREADS) {
      const int lr = i / (W * CI);
      const int ih = r0 - 1 + lr;
      xs[i] = (ih >= 0 && ih < H)
                  ? xb[(size_t)ih * W * CI + (i - lr * W * CI)]
                  : (int8_t)0;
    }
  }
  __syncthreads();

  // expand (or copy the input) into the interior of q1
  for (int i = tid; i < (rows + 2) * W * CE; i += THREADS) {
    const int e = i % CE;
    const int col = (i / CE) % W;
    const int lr = i / (CE * W);
    const int ih = r0 - 1 + lr;
    if (ih < 0 || ih >= H) continue;
    Q1 v;
    if (EXPAND) {
      const int8_t* xp = xs + ((size_t)lr * W + col) * CI;
      int acc = 0;
      for (int c = 0; c < CI; ++c)
        acc += (int)xp[c] * (int)__ldg(we + (size_t)c * CE + e);
      const float q = fminf(
          fmaxf(floorf(affine(acc, __ldg(ae + e), __ldg(ae + CE + e))),
                0.0f),
          hi_e);
      v = (Q1)(int)q;
    } else {
      v = (Q1)xb[((size_t)ih * W + col) * CI + e];
    }
    q1[((size_t)lr * W2 + col + 1) * CE + e] = v;
  }
  __syncthreads();

  // depthwise 3x3 over q1 (zero border) into q2
  for (int i = tid; i < rows * W * CE; i += THREADS) {
    const int e = i % CE;
    const int col = (i / CE) % W;
    const int r = i / (CE * W);
    int acc = 0;
#pragma unroll
    for (int k = 0; k < 9; ++k)
      acc += (int)q1[((size_t)(r + k / 3) * W2 + col + k % 3) * CE + e] *
             (int)__ldg(wd + (size_t)k * CE + e);
    const float q = fminf(
        fmaxf(floorf(affine(acc, __ldg(ad + e), __ldg(ad + CE + e))), 0.0f),
        hi_d);
    q2[((size_t)r * W + col) * CE + e] = (uint8_t)(int)q;
  }
  __syncthreads();

  // project q2, epilogue, residual, block-site clip
  for (int i = tid; i < rows * W * CO; i += THREADS) {
    const int o = i % CO;
    const int p = i / CO;                 // r * W + col within the band
    const uint8_t* qrow = q2 + (size_t)p * CE;
    int acc = 0;
    for (int e = 0; e < CE; ++e)
      acc += (int)qrow[e] * (int)__ldg(wp + (size_t)e * CO + o);
    float y = affine(acc, __ldg(ap + o), __ldg(ap + CO + o));
    if (RESID) {
      const int r = p / W, col = p - (p / W) * W;
      const int xr = (int)xb[((size_t)(r0 + r) * W + col) * CI + o];
      y = __fadd_rn(y, __fmul_rn((float)xr, r_s));
    }
    const float q = fminf(fmaxf(floorf(y), lo_o), hi_o);
    out[(((size_t)b * H + r0) * W) * CO + (size_t)p * CO + o] =
        (int8_t)(int)q;
  }
}

template <bool EXPAND, bool RESID>
cudaError_t launch(const void* x, const void* we, const void* ae,
                   const void* wd, const void* ad, const void* wp,
                   const void* ap, const void* qp, void* out, int B, int H,
                   int W, int CI, int CE, int CO, cudaStream_t stream) {
  int R = H;
  while (R > 1 && smem_bytes(R, W, CI, CE, EXPAND) > BAND_BYTES) --R;
  const size_t smem = smem_bytes(R, W, CI, CE, EXPAND);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      mbconv_fused_kernel<EXPAND, RESID>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((H + R - 1) / R, B);
  mbconv_fused_kernel<EXPAND, RESID><<<grid, THREADS, smem, stream>>>(
      (const int8_t*)x, (const int8_t*)we, (const float*)ae,
      (const int8_t*)wd, (const float*)ad, (const int8_t*)wp,
      (const float*)ap, (const float*)qp, (int8_t*)out, H, W, CI, CE, CO, R);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ssq_mbconv_fused(const void* x, const void* we,
                                const void* ae, const void* wd,
                                const void* ad, const void* wp,
                                const void* ap, const void* qp, void* out,
                                int B, int H, int W, int CI, int CE, int CO,
                                int has_expand, int has_residual,
                                void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return 0;
  if ((!has_expand && CE != CI) || (has_residual && CO != CI))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (has_expand && has_residual)
    err = launch<true, true>(x, we, ae, wd, ad, wp, ap, qp, out, B, H, W, CI,
                             CE, CO, s);
  else if (has_expand)
    err = launch<true, false>(x, we, ae, wd, ad, wp, ap, qp, out, B, H, W,
                              CI, CE, CO, s);
  else if (has_residual)
    err = launch<false, true>(x, we, ae, wd, ad, wp, ap, qp, out, B, H, W,
                              CI, CE, CO, s);
  else
    err = launch<false, false>(x, we, ae, wd, ad, wp, ap, qp, out, B, H, W,
                               CI, CE, CO, s);
  return (int)err;
}
