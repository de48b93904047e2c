// Fused ResNet stem: 7x7/s2/p3 conv of the f32 image with integer weight
// codes -> * scale + bias -> ReLU -> act quant -> 3x3/s2/p1 maxpool on the
// codes, one pass, int8 out.
//
// Replaces shiftedscalequantization_tpu/ops/pallas/stem.py:_stem_kernel
// (stem_fused). Its banded weight matrix and parity planes work around
// Mosaic and are not carried over; this is a direct conv.
//
// Bound on an H100: operations. At batch 256, 224x224, 64 channels the
// conv is 2 * 256 * 112^2 * 64 * 147 = 60.4 GFLOP, 0.90 ms on the 67 TFLOP/s
// f32 pipe, against 154 MB in + 51 MB out = 61 us of memory traffic. So
// the design keeps the FMA pipe fed from shared memory: each block takes
// one image and a band of PB pool rows, stages its input rows (split by
// column parity, so that neighbouring lanes read neighbouring words) and
// all 64 x 147 weights once, and each thread accumulates 3 conv rows x 16
// channels in registers (48 FMAs per 7 shared loads, the weight loads
// warp-uniform). The band's pool needs one conv row above it; that row is
// recomputed rather than exchanged between blocks (1/8 extra work at PB 4).
// Codes are written to shared memory as int8 and pooled there, so only
// the pooled codes reach device memory.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int PB = 4;              // pool rows per block
constexpr int CR = 2 * PB + 1;     // conv rows per block (one halo row)
constexpr int RG = 3;              // conv rows per thread
constexpr int IR = 2 * CR + 5;     // input rows per block
constexpr int OCG = 16;            // output channels per thread
constexpr int TAPS = 3 * 7 * 7;
constexpr int THREADS = 256;
static_assert(CR % RG == 0, "conv rows split evenly over row groups");

__host__ __device__ inline size_t align16(size_t n) {
  return (n + 15) & ~size_t(15);
}

__host__ __device__ inline size_t smem_bytes(int W, int OC) {
  const int XH = W / 2 + 3;
  return align16((size_t)TAPS * OC * 4) + align16((size_t)6 * IR * XH * 4) +
         (size_t)CR * (W / 2) * OC;
}

__global__ void __launch_bounds__(THREADS, 1)
stem_fused_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ scale,
                  const float* __restrict__ bias,
                  const float* __restrict__ qp, int8_t* __restrict__ out,
                  int H, int W, int OC) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int Hc = H / 2, Wc = W / 2, Hp = H / 4, Wp = W / 4;
  const int XH = Wc + 3;
  float* wsm = reinterpret_cast<float*>(smem);              // [tap][oc]
  float* xin = reinterpret_cast<float*>(
      smem + align16((size_t)TAPS * OC * 4));  // [c][parity][row][half]
  int8_t* codes = reinterpret_cast<int8_t*>(
      smem + align16((size_t)TAPS * OC * 4) +
      align16((size_t)6 * IR * XH * 4));                    // [row][col][oc]

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int p0 = blockIdx.x * PB;        // first pool row of the band
  const int cr0 = 2 * p0 - 1;            // first conv row (halo)
  const int ir0 = 2 * cr0 - 3;           // first input row

  for (int i = tid; i < OC * TAPS; i += THREADS) {
    const int oc = i / TAPS, tap = i - oc * TAPS;
    wsm[tap * OC + oc] = w[i];
  }
  // input band, zero-padded; input col xi - 3 goes to parity xi & 1 at
  // half-column xi >> 1, so conv col c, tap kw reads half c + kw / 2
  const int rowlen = 2 * XH * 3;
  for (int i = tid; i < IR * rowlen; i += THREADS) {
    const int li = i / rowlen, rem = i - li * rowlen;
    const int xi = rem / 3, ch = rem - xi * 3;
    const int row = ir0 + li, col = xi - 3;
    float v = 0.0f;
    if (row >= 0 && row < H && col >= 0 && col < W)
      v = x[(((size_t)b * H + row) * W + col) * 3 + ch];
    xin[((ch * 2 + (xi & 1)) * IR + li) * XH + (xi >> 1)] = v;
  }
  __syncthreads();

  const float inv_d = qp[0], zp = qp[1], qmax = qp[2], coff = qp[3];
  const int n_og = OC / OCG;
  const int n_cc = (Wc + 31) / 32;
  const int n_tasks = (CR / RG) * n_cc * n_og;
  const int warp = tid / 32, lane = tid % 32;
  for (int task = warp; task < n_tasks; task += THREADS / 32) {
    const int og = task % n_og;
    const int cc = (task / n_og) % n_cc;
    const int rg = task / (n_og * n_cc);
    const int c = cc * 32 + lane;
    const int cl = min(c, Wc - 1);
    float acc[RG][OCG];
#pragma unroll
    for (int i = 0; i < RG; ++i)
#pragma unroll
      for (int j = 0; j < OCG; ++j) acc[i][j] = 0.0f;
    for (int ch = 0; ch < 3; ++ch) {
      for (int kh = 0; kh < 7; ++kh) {
#pragma unroll
        for (int kw = 0; kw < 7; ++kw) {
          const int tap = ch * 49 + kh * 7 + kw;
          const float4* wv =
              reinterpret_cast<const float4*>(wsm + tap * OC + og * OCG);
          float wr[OCG];
#pragma unroll
          for (int q = 0; q < OCG / 4; ++q) {
            const float4 t = wv[q];
            wr[4 * q] = t.x;
            wr[4 * q + 1] = t.y;
            wr[4 * q + 2] = t.z;
            wr[4 * q + 3] = t.w;
          }
          const float* plane = xin + (ch * 2 + (kw & 1)) * IR * XH;
#pragma unroll
          for (int i = 0; i < RG; ++i) {
            const float xv =
                plane[(2 * (rg * RG + i) + kh) * XH + cl + (kw >> 1)];
#pragma unroll
            for (int j = 0; j < OCG; ++j) acc[i][j] = fmaf(xv, wr[j], acc[i][j]);
          }
        }
      }
    }
    if (c < Wc) {
#pragma unroll
      for (int i = 0; i < RG; ++i) {
        const int lr = rg * RG + i;
        const int r = cr0 + lr;
        const bool valid = r >= 0 && r < Hc;
        uint32_t packed[OCG / 4];
#pragma unroll
        for (int q = 0; q < OCG / 4; ++q) packed[q] = 0;
#pragma unroll
        for (int j = 0; j < OCG; ++j) {
          const int oc = og * OCG + j;
          // rounded step by step as the plain version: relu(acc * s + b),
          // then clip(rint(y * inv_delta) + zp, 0, qmax) - center_off
          float y = __fadd_rn(__fmul_rn(acc[i][j], __ldg(scale + oc)),
                              __ldg(bias + oc));
          y = fmaxf(y, 0.0f);
          float q = rintf(__fmul_rn(y, inv_d)) + zp;
          q = fminf(fmaxf(q, 0.0f), qmax) - coff;
          const int8_t code = valid ? (int8_t)q : (int8_t)-128;
          packed[j / 4] |= (uint32_t)(uint8_t)code << (8 * (j % 4));
        }
        *reinterpret_cast<uint4*>(codes + ((size_t)lr * Wc + c) * OC +
                                  og * OCG) =
            make_uint4(packed[0], packed[1], packed[2], packed[3]);
      }
    }
  }
  __syncthreads();

  // 3x3/s2/p1 max pool on the codes, four channels per signed-byte max
  const int oc4 = OC / 4;
  for (int i = tid; i < PB * Wp * oc4; i += THREADS) {
    const int c4 = i % oc4;
    const int pc = (i / oc4) % Wp;
    const int pr = i / (oc4 * Wp);
    const int p = p0 + pr;
    if (p >= Hp) continue;
    unsigned m = 0x80808080u;              // -128 in every byte
    for (int dr = 0; dr < 3; ++dr) {
      const int lr = 2 * pr + dr;
      for (int dc = -1; dc <= 1; ++dc) {
        const int col = 2 * pc + dc;
        if (col < 0 || col >= Wc) continue;
        const unsigned v = *reinterpret_cast<const unsigned*>(
            codes + ((size_t)lr * Wc + col) * OC + c4 * 4);
        m = __vmaxs4(m, v);
      }
    }
    *reinterpret_cast<unsigned*>(
        out + (((size_t)b * Hp + p) * Wp + pc) * OC + c4 * 4) = m;
  }
}

}  // namespace

extern "C" int ssq_stem_fused(const void* x, const void* w,
                              const void* scale, const void* bias,
                              const void* qp, void* out, int B, int H, int W,
                              int OC, void* stream) {
  if (B <= 0) return 0;
  if (H % 4 != 0 || W % 4 != 0 || OC % OCG != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(W, OC);
  cudaError_t err = cudaFuncSetAttribute(
      stem_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((H / 4 + PB - 1) / PB, B);
  stem_fused_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)w, (const float*)scale,
      (const float*)bias, (const float*)qp, (int8_t*)out, H, W, OC);
  return (int)cudaGetLastError();
}
