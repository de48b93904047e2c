// Fused int8 depthwise 3x3 (pad 1, stride 1 or 2) -> dequant epilogue ->
// relu / relu6 / none -> requant onto the unit's act grid, int8 out.
//
// Replaces shiftedscalequantization_tpu/ops/pallas/depthwise.py:35
// (_dw_kernel, via dw_conv3x3_int8). The TPU kernel computes every stride-1
// output and subsamples outside; here only the strided outputs are
// computed, which are the same values.
//
// Bound on an H100: bytes. A depthwise conv does 9 MACs per output value,
// so its int8 codes in and out are all the work: at MobileNetV2's 16 dw
// units at batch 256 that is about 1.34 GB, 0.40 ms at 3.35 TB/s
// (features.2's 112x112x96 -> 56x56 alone is 385 MB). The design reads
// the codes once from device memory and writes the output codes once: one
// thread per output pixel and 4 channels, 4-byte (char4) loads and stores
// so neighbouring threads touch neighbouring words, the 8 overlapping
// taps of neighbouring pixels served from L1/L2, and the accumulate,
// epilogue and requant kept in registers. A block covers part of one
// output row, so a thread finds its pixel with one 32-bit division.
//
// Arithmetic, as the plain version (ops/cuda/depthwise.py): the nine
// products accumulate in int32 (exact); the epilogue acc * scalef + biasf
// is rounded after the multiply and after the add (__fmul_rn, __fadd_rn:
// nvcc would otherwise contract it into one FMA); the requant multiplies by
// the f32 reciprocal 1/delta_out and rounds half to even (rintf).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float epilogue(int acc, float sc, float bi,
                                          int act, float inv, float zp,
                                          float qmax) {
  float y = __fadd_rn(__fmul_rn((float)acc, sc), bi);
  if (act == 1) {
    y = fmaxf(y, 0.0f);
  } else if (act == 2) {
    y = fminf(fmaxf(y, 0.0f), 6.0f);
  }
  const float q = fminf(fmaxf(rintf(__fmul_rn(y, inv)) + zp, 0.0f), qmax);
  return q - zp;
}

// One block row per (image, output row): blockIdx.x = b * Ho + oh, and the
// threads of blockIdx.y cover (ow, 4-channel group) of that row, so the
// index math is one 32-bit division. C % 4 == 0 and the pointers are
// aligned (the wrapper checks), so each thread's 4 channels are one word
// of codes and 16 bytes of scalef / biasf.
__global__ void __launch_bounds__(THREADS)
dw_conv3x3_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                  const float* __restrict__ scalef,
                  const float* __restrict__ biasf,
                  const float* __restrict__ qp, int8_t* __restrict__ out,
                  int H, int W, int C, int stride, int act) {
  const int Ho = (H - 1) / stride + 1, Wo = (W - 1) / stride + 1;
  const int C4 = C / 4;
  const int j = blockIdx.y * THREADS + threadIdx.x;
  if (j >= Wo * C4) return;
  const int b = blockIdx.x / Ho, oh = blockIdx.x - (blockIdx.x / Ho) * Ho;
  const int ow = j / C4, c0 = (j - ow * C4) * 4;
  const float inv = qp[0], zp = qp[1], qmax = qp[2];
  int acc[4] = {0, 0, 0, 0};
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const int ih = oh * stride + k / 3 - 1;
    const int iw = ow * stride + k % 3 - 1;
    if (ih < 0 || ih >= H || iw < 0 || iw >= W) continue;
    const char4 xv = *reinterpret_cast<const char4*>(
        x + (((size_t)b * H + ih) * W + iw) * C + c0);
    const char4 wv =
        __ldg(reinterpret_cast<const char4*>(w + (size_t)k * C + c0));
    acc[0] += (int)xv.x * (int)wv.x;
    acc[1] += (int)xv.y * (int)wv.y;
    acc[2] += (int)xv.z * (int)wv.z;
    acc[3] += (int)xv.w * (int)wv.w;
  }
  const float4 sc = __ldg(reinterpret_cast<const float4*>(scalef + c0));
  const float4 bi = __ldg(reinterpret_cast<const float4*>(biasf + c0));
  char4 r;
  r.x = (int8_t)epilogue(acc[0], sc.x, bi.x, act, inv, zp, qmax);
  r.y = (int8_t)epilogue(acc[1], sc.y, bi.y, act, inv, zp, qmax);
  r.z = (int8_t)epilogue(acc[2], sc.z, bi.z, act, inv, zp, qmax);
  r.w = (int8_t)epilogue(acc[3], sc.w, bi.w, act, inv, zp, qmax);
  *reinterpret_cast<char4*>(out + (((size_t)b * Ho + oh) * Wo + ow) * C +
                            c0) = r;
}

}  // namespace

extern "C" int ssq_dw_conv3x3(const void* x, const void* w,
                              const void* scalef, const void* biasf,
                              const void* qp, void* out, int B, int H, int W,
                              int C, int stride, int act, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0) return 0;
  if ((stride != 1 && stride != 2) || act < 0 || act > 2)
    return (int)cudaErrorInvalidValue;
  const long long Ho = (H - 1) / stride + 1, Wo = (W - 1) / stride + 1;
  const long long row = Wo * ((C + 3) / 4);
  if ((long long)B * Ho > 0x7fffffffLL || row > 0x7fffffffLL - THREADS)
    return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)(B * Ho), (unsigned)((row + THREADS - 1) / THREADS));
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  if (C % 4 != 0 ||
      ((uintptr_t)x | (uintptr_t)w | (uintptr_t)out) % 4 != 0 ||
      ((uintptr_t)scalef | (uintptr_t)biasf) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  dw_conv3x3_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const int8_t*)x, (const int8_t*)w, (const float*)scalef,
      (const float*)biasf, (const float*)qp, (int8_t*)out, H, W, C, stride,
      act);
  return (int)cudaGetLastError();
}
