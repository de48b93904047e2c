// Fused uniform fake-quant: out = (clip(rint(x / delta) + zp, lo, hi) - zp)
// * delta on an (R, C) f32 tensor, delta/zp per row (R) or one for all.
//
// Replaces shiftedscalequantization_tpu/ops/pallas/fake_quant.py:23
// (_fake_quant_kernel, via fake_quant_2d and its wrappers
// fake_quant_weight / fake_quant_act). The TPU kernel multiplies by
// 1/delta, because division is slow on the TPU's vector unit. The function
// the sim forward is held to, ops/quant.fake_quant of the JAX package,
// divides; a code that flips at a rounding tie would change the calibration
// and every later loss. So this kernel takes the IEEE quotient
// (__fdiv_rn) and rounds half to even (rintf), and its output equals the
// plain version (ops/cuda/fake_quant.py) bit for bit. Each step is rounded
// on its own (__fadd_rn, __fsub_rn, __fmul_rn); the clip lets NaN through
// as torch.clamp and jnp.clip do.
//
// Bound on an H100: bytes. One f32 read and one f32 write per element, a
// handful of operations: the 17 act sites of the ResNet-18 sim forward at
// batch 256 carry about 591 M elements, 4.7 GB, 1.4 ms at 3.35 TB/s. The
// design: a grid-stride loop of 16-byte loads and stores (float4) when C is
// a multiple of 4 and the pointers are 16-byte aligned, so neighbouring
// threads touch neighbouring words, and a scalar loop otherwise; delta and
// zp are read from device memory (one value, or one per row by the row
// index), never copied to the host.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float fq(float x, float d, float z, float lo,
                                    float hi) {
  float q = __fadd_rn(rintf(__fdiv_rn(x, d)), z);
  q = q < lo ? lo : (q > hi ? hi : q);
  return __fmul_rn(__fsub_rn(q, z), d);
}

// PER_ROW: delta[r], zp[r] for row r = element / C; else delta[0], zp[0].
template <bool PER_ROW>
__global__ void __launch_bounds__(THREADS)
fake_quant_vec4(const float4* __restrict__ x, const float* __restrict__ delta,
                const float* __restrict__ zp, float4* __restrict__ out,
                long long n4, int c4, float lo, float hi) {
  float d = 0.0f, z = 0.0f;
  if (!PER_ROW) {
    d = delta[0];
    z = zp[0];
  }
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n4;
       i += stride) {
    if (PER_ROW) {
      const long long r = i / c4;
      d = __ldg(delta + r);
      z = __ldg(zp + r);
    }
    const float4 v = __ldg(x + i);
    float4 o;
    o.x = fq(v.x, d, z, lo, hi);
    o.y = fq(v.y, d, z, lo, hi);
    o.z = fq(v.z, d, z, lo, hi);
    o.w = fq(v.w, d, z, lo, hi);
    out[i] = o;
  }
}

template <bool PER_ROW>
__global__ void __launch_bounds__(THREADS)
fake_quant_scalar(const float* __restrict__ x, const float* __restrict__ delta,
                  const float* __restrict__ zp, float* __restrict__ out,
                  long long n, int c, float lo, float hi) {
  float d = 0.0f, z = 0.0f;
  if (!PER_ROW) {
    d = delta[0];
    z = zp[0];
  }
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += stride) {
    if (PER_ROW) {
      const long long r = i / c;
      d = __ldg(delta + r);
      z = __ldg(zp + r);
    }
    out[i] = fq(__ldg(x + i), d, z, lo, hi);
  }
}

// Enough blocks to fill the card several times over; the loop covers the
// rest.
unsigned grid_for(long long work) {
  const long long blocks = (work + THREADS - 1) / THREADS;
  return (unsigned)(blocks < 132 * 32 ? blocks : 132 * 32);
}

}  // namespace

extern "C" int ssq_fake_quant(const void* x, const void* delta,
                              const void* zp, void* out, int R, int C,
                              int per_row, int lo, int hi, void* stream) {
  if (R <= 0 || C <= 0) return 0;
  if (lo > hi) return (int)cudaErrorInvalidValue;
  const long long n = (long long)R * C;
  const cudaStream_t st = (cudaStream_t)stream;
  const float flo = (float)lo, fhi = (float)hi;
  const bool vec = C % 4 == 0 &&
                   ((uintptr_t)x | (uintptr_t)out) % 16 == 0;
  if (vec) {
    const long long n4 = n / 4;
    if (per_row) {
      fake_quant_vec4<true><<<grid_for(n4), THREADS, 0, st>>>(
          (const float4*)x, (const float*)delta, (const float*)zp,
          (float4*)out, n4, C / 4, flo, fhi);
    } else {
      fake_quant_vec4<false><<<grid_for(n4), THREADS, 0, st>>>(
          (const float4*)x, (const float*)delta, (const float*)zp,
          (float4*)out, n4, C / 4, flo, fhi);
    }
  } else if (per_row) {
    fake_quant_scalar<true><<<grid_for(n), THREADS, 0, st>>>(
        (const float*)x, (const float*)delta, (const float*)zp, (float*)out,
        n, C, flo, fhi);
  } else {
    fake_quant_scalar<false><<<grid_for(n), THREADS, 0, st>>>(
        (const float*)x, (const float*)delta, (const float*)zp, (float*)out,
        n, C, flo, fhi);
  }
  return (int)cudaGetLastError();
}
