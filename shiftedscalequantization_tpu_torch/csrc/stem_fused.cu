// Fused ResNet stem: 7x7/s2/p3 conv of the f32 image with integer weight
// codes -> * scale + bias -> ReLU -> act quant -> 3x3/s2/p1 maxpool on the
// codes, one pass, int8 out.
//
// Replaces shiftedscalequantization_tpu/ops/pallas/stem.py:_stem_kernel
// (stem_fused). Like it, the conv is two bf16 products with f32
// accumulation: each image value x is split into hi = bf16(x) and
// lo = bf16(x - hi) (both rounded to nearest even), and both halves meet
// the weight codes cast to bf16 (exact for the integer codes every plan
// passes). Its banded weight matrix and parity planes work around Mosaic
// and are not carried over.
//
// Bound on an H100: operations, on the tensor cores. At batch 256,
// 224x224, 64 channels the two bf16 products are 2 * 60.4 = 120.8 GFLOP,
// 0.122 ms at 989 TFLOP/s dense, against 154 MB in + 51 MB out = 61 us of
// memory traffic (a direct f32 conv on the FMA pipe, the design this file
// had before, cannot go below 0.90 ms). The design:
//
// - GEMM without an im2col buffer. In NHWC with 3 channels, the 7 kw taps
//   x 3 channels of one kernel row kh are 21 consecutive values of the
//   zero-padded input row, starting at element 6c for conv column c. The
//   contraction runs over k = 22 * kh + j (j = 3 kw + ch, j = 21 a zero
//   weight), K = 154 padded to 160: 10 k-steps of wgmma m64nNk16 bf16 with
//   f32 accumulation, per pass. A comes from registers: each warp's 16
//   positions x 16 k, every register one 4-byte shared load at a
//   per-thread offset computed once, double-buffered so the next k-step's
//   loads run under the current wgmma group. B (the codes, K-major, in
//   wgmma's core matrices of 8 channels x 8 k) is laid out once at setup
//   and stays in shared memory for the block's life. Four warpgroups per
//   block, which measured faster than two or three (PERF.md).
// - Persistent grid. One block per SM walks a contiguous run of (image,
//   band of PB pool rows) items. The next band's image rows are copied with
//   cp.async into an f32 staging buffer while the current band's MMAs run;
//   a pass per band splits them into the bf16 hi and lo rows (4 values and
//   two 8-byte stores per step; the rows' zero pads are written once). The
//   band's pool needs the conv row above it: within a run that is the
//   previous band's last conv row, kept in shared memory (only a run's
//   first band computes it again).
// - Epilogue in registers. The accumulators are requantized where the MMA
//   left them (relu and the grid clip folded into one clamp, the rint a
//   magic-number add, the (zp - center_off) offset a byte add), the codes
//   go to shared memory, and the 3x3/s2 max pool runs there on 16-byte
//   words (__vmaxs4), with 16-byte output stores.
//
// Arithmetic: y = relu(acc * scale + bias) rounded after the multiply and
// after the add, q = clip(rint(y * inv) + zp, 0, qmax) - center_off, inv =
// 1/delta taken once in f32, rint half to even; for inv > 0 and integer zp
// that is rint(clamp(acc' * inv, lo, hi)) + (zp - center_off) with
// lo = max(0, -zp), hi = qmax - zp (see csrc/dw_conv3x3.cu for the
// identity). Where every image value is bf16-exact (lo = 0) and the sums
// are exact in f32 (images on a 1/8 grid), the codes equal the plain f32
// version's bit for bit; elsewhere the two sums differ by rounding and a
// code may differ by one step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int PB = 4;                 // pool rows per band
constexpr int CR = 2 * PB + 1;        // conv row slots per band (one halo)
constexpr int RMAX = 2 * CR + 5;      // image rows staged per band, at most
constexpr int KROW = 22;              // k per kernel row (21 taps + 1 zero)
constexpr int KSTEPS = 10;            // K = 160 = 10 x 16
constexpr int THREADS = 512;          // four warpgroups
constexpr int WARPS = THREADS / 32;
constexpr float MAGIC = 12582912.0f;  // 1.5 * 2^23

__host__ __device__ inline int align16(int n) { return (n + 15) & ~15; }
__host__ __device__ inline int row_bf16(int W) {   // padded bf16 row
  return (3 * (W + 6) + 7) & ~7;
}

struct Layout {
  int w, stage, hi, lo, codes, total;   // byte offsets in shared memory
  __host__ __device__ Layout(int W, int OC) {
    w = 0;
    stage = align16(w + OC * KSTEPS * 16 * 2);
    hi = align16(stage + RMAX * 3 * W * 4);
    lo = align16(hi + RMAX * row_bf16(W) * 2);
    codes = align16(lo + RMAX * row_bf16(W) * 2);
    total = align16(codes + CR * (W / 2) * OC);
  }
};

struct StemArgs {
  const float* x;
  const __nv_bfloat16* w;   // wgmma B tiles, see stem_weight_layout
  const float* scale;
  const float* bias;
  const float* qp;          // [1/delta, zp, qmax, center_off]
  int8_t* out;
  int B, H, W, n_items, n_bands;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// wgmma.mma_async m64nNk16 f32 += bf16 x bf16: A from registers (each warp
// its 16 rows, mma.sync's m16n8k16 fragment), B K-major in shared memory
template <int NT>
struct Wgmma;
template <> struct Wgmma<2> {
  __device__ static __forceinline__ void mma(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};
template <> struct Wgmma<4> {
  __device__ static __forceinline__ void mma(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};
template <> struct Wgmma<6> {
  __device__ static __forceinline__ void mma(float (&d)[24],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23"
        "}, {%24, %25, %26, %27}, %28, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};
template <> struct Wgmma<8> {
  __device__ static __forceinline__ void mma(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
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
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// generic-proxy writes (cp.async) -> visible to wgmma's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// descriptor of k-step ks's B tile: core matrices of 8 channels x 8 k
// (128 contiguous bytes), the two k halves 128 bytes apart (LBO), the
// channel blocks 256 bytes apart (SBO), no swizzle
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32);
}

// bf16 element offset of contraction index k in the staged rows of one
// conv row: kernel row k / 22 is two staged rows per conv row below.
__device__ __forceinline__ int k_offset(int k, int rowb) {
  if (k >= 7 * KROW) return 6 * rowb + (k - 7 * KROW);  // zero weights
  return (k / KROW) * rowb + k % KROW;
}

// One item: image b, pool rows [p0, p0 + PB) (fewer at the bottom).
struct Item {
  int b, p0, npool, cr_first, n_conv, ir_first, n_in, slot0;
  __device__ Item(int item, bool first, const StemArgs& a) {
    const int Hp = a.H / 4;
    b = item / a.n_bands;
    p0 = (item - b * a.n_bands) * PB;
    npool = min(PB, Hp - p0);
    // conv rows 2 p0 - 1 .. 2 p0 + 2 npool - 1; the first is the previous
    // band's last, kept from it unless this is a run's first band
    const bool halo = first && p0 > 0;
    cr_first = halo ? 2 * p0 - 1 : 2 * p0;
    n_conv = 2 * npool + (halo ? 1 : 0);
    slot0 = halo ? 0 : 1;                 // slot of conv row cr_first
    ir_first = 2 * cr_first - 3;
    n_in = 2 * n_conv + 5;
  }
};

template <int NT>   // OC = 8 NT
__global__ void __launch_bounds__(THREADS, 1)
stem_fused_kernel(const StemArgs a) {
  constexpr int OC = 8 * NT;
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = a.H, W = a.W, Wc = W / 2, Hp = H / 4, Wp = W / 4;
  const int rowb = row_bf16(W);
  const Layout lay(W, OC);
  __nv_bfloat16* const wsm = reinterpret_cast<__nv_bfloat16*>(smem + lay.w);
  float* const stage = reinterpret_cast<float*>(smem + lay.stage);
  __nv_bfloat16* const hi = reinterpret_cast<__nv_bfloat16*>(smem + lay.hi);
  __nv_bfloat16* const lo = reinterpret_cast<__nv_bfloat16*>(smem + lay.lo);
  int8_t* const codes = reinterpret_cast<int8_t*>(smem + lay.codes);
  const int code_row = Wc * OC;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int first_item = (int)((long long)blockIdx.x * a.n_items / gridDim.x);
  const int end_item =
      (int)((long long)(blockIdx.x + 1) * a.n_items / gridDim.x);

  const int row_words = 3 * W / 4;          // 16-byte words per image row
  const int n_chunks = 3 * W / 4 + 1;       // 4-value chunks per bf16 row
  auto stage_item = [&](const Item& it) {
    const uint32_t dst = smem_u32(stage);
    for (int k = tid; k < it.n_in * row_words; k += THREADS) {
      const int r = k / row_words, q = k - r * row_words;
      const int ir = it.ir_first + r;
      const bool ok = ir >= 0 && ir < H;
      const float* src =
          ok ? a.x + ((size_t)it.b * H + ir) * (size_t)(3 * W) + 4 * q : a.x;
      cp_async16(dst + (r * row_words + q) * 16, src, ok);
    }
  };

  // the bf16 rows' column pads stay zero: zero both arrays once
  for (int k = tid; k < 2 * RMAX * rowb / 8; k += THREADS)
    reinterpret_cast<uint4*>(hi)[k] = make_uint4(0u, 0u, 0u, 0u);
  // weights once, with the first item's image rows
  for (int k = tid; k < OC * 2 * KSTEPS; k += THREADS)
    cp_async16(smem_u32(wsm) + 16 * k, a.w + 8 * k, true);
  if (first_item < end_item) stage_item(Item(first_item, true, a));
  cp_commit();

  // per-thread constants: A offsets of its k pairs, its channels' scale
  // and bias, the folded requant clamp
  int koff[KSTEPS][2];
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks) {
    koff[ks][0] = k_offset(16 * ks + 2 * t4, rowb);
    koff[ks][1] = k_offset(16 * ks + 8 + 2 * t4, rowb);
  }
  float sc[NT][2], bi[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int n = 8 * j + 2 * t4;
    sc[j][0] = __ldg(a.scale + n);
    sc[j][1] = __ldg(a.scale + n + 1);
    bi[j][0] = __ldg(a.bias + n);
    bi[j][1] = __ldg(a.bias + n + 1);
  }
  const float inv = __ldg(a.qp), zp = __ldg(a.qp + 1),
              qmax = __ldg(a.qp + 2), coff = __ldg(a.qp + 3);
  float clo = fmaxf(rintf(__fmul_rn(0.0f, inv)), -zp), chi = qmax - zp;
  if (clo > chi) clo = chi;                // qmax < zp: every code is chi
  const uint32_t koffs = __byte_perm((uint32_t)(int)(zp - coff), 0, 0x0000);

  for (int item = first_item; item < end_item; ++item) {
    const Item it(item, item == first_item, a);
    cp_wait_all();
    __syncthreads();
    if (item == first_item) fence_proxy_async();   // the weights, for wgmma

    // split the staged rows into bf16 hi / lo rows: row element f = 9 + i
    // for image value i (3 per column); chunk q covers f = 8 + 4q .. 11 + 4q
    // (values 4q - 1 .. 4q + 2, zero outside the row), one 8-byte store
    {
      int r = tid / n_chunks, q = tid - r * n_chunks;
      while (r < it.n_in) {
        const float* srow = stage + r * 3 * W;
        float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (q > 0) v.x = srow[4 * q - 1];
        if (4 * q < 3 * W) {
          const float4 u = *reinterpret_cast<const float4*>(srow + 4 * q);
          v.y = u.x;
          v.z = u.y;
          v.w = u.z;
        }
        const __nv_bfloat162 h0 = __floats2bfloat162_rn(v.x, v.y);
        const __nv_bfloat162 h1 = __floats2bfloat162_rn(v.z, v.w);
        const float2 f0 = __bfloat1622float2(h0), f1 = __bfloat1622float2(h1);
        const __nv_bfloat162 l0 = __floats2bfloat162_rn(v.x - f0.x, v.y - f0.y);
        const __nv_bfloat162 l1 = __floats2bfloat162_rn(v.z - f1.x, v.w - f1.y);
        const int o = r * rowb + 8 + 4 * q;
        *reinterpret_cast<uint2*>(hi + o) = make_uint2(
            *reinterpret_cast<const uint32_t*>(&h0),
            *reinterpret_cast<const uint32_t*>(&h1));
        *reinterpret_cast<uint2*>(lo + o) = make_uint2(
            *reinterpret_cast<const uint32_t*>(&l0),
            *reinterpret_cast<const uint32_t*>(&l1));
        q += THREADS;
        while (q >= n_chunks) {
          q -= n_chunks;
          ++r;
        }
      }
    }
    if (it.p0 == 0) {   // conv row -1 is the pool's -128 pad
      for (int k = tid; k < code_row / 16; k += THREADS)
        reinterpret_cast<uint4*>(codes)[k] =
            make_uint4(0x80808080u, 0x80808080u, 0x80808080u, 0x80808080u);
    }
    __syncthreads();
    if (item + 1 < end_item) stage_item(Item(item + 1, false, a));
    cp_commit();

    // conv rows on the tensor cores: m64 tiles of (conv row, column)
    // positions x all OC channels per warpgroup, 16 rows per warp
    const int n_pos = it.n_conv * Wc;
    for (int mt = warp / 4; mt * 64 < n_pos; mt += WARPS / 4) {
      int base[2], pos[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        pos[h] = mt * 64 + 16 * (warp % 4) + g + 8 * h;
        const int pc = min(pos[h], n_pos - 1);
        const int lr = pc / Wc, c = pc - lr * Wc;
        base[h] = 2 * lr * rowb + 6 * c;
      }
      float d[4 * NT];
#pragma unroll
      for (int i = 0; i < 4 * NT; ++i) d[i] = 0.0f;
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        const int s = ks & 1;
#pragma unroll
        for (int q = 0; q < 4; ++q) {   // (row g | g + 8) x (k lo | k hi)
          const int o = base[q % 2] + koff[ks][q / 2];
          ah[s][q] = *reinterpret_cast<const uint32_t*>(hi + o);
          al[s][q] = *reinterpret_cast<const uint32_t*>(lo + o);
        }
        const uint64_t bd = b_desc(smem_u32(wsm) + ks * NT * 256);
        fence_regs(d);
        wgmma_fence();
        Wgmma<NT>::mma(d, ah[s], bd);
        Wgmma<NT>::mma(d, al[s], bd);
        wgmma_commit();
        wgmma_wait<1>();
      }
      wgmma_wait<0>();
      fence_regs(d);
      float acc[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = d[4 * j + e];
      // requant where the accumulators are: (position g + 8 h, channels
      // 8 j + 2 t4, + 1) -> two codes, one 16-bit shared store
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (pos[h] >= n_pos) continue;
        const int lr = pos[h] / Wc, c = pos[h] - lr * Wc;
        int8_t* crow = codes + (lr + it.slot0) * code_row + c * OC + 2 * t4;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          uint32_t u[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float y = __fmul_rn(
                __fadd_rn(__fmul_rn(acc[j][2 * h + e], sc[j][e]), bi[j][e]),
                inv);
            u[e] = __float_as_uint(__fadd_rn(fminf(fmaxf(y, clo), chi), MAGIC));
          }
          const uint32_t pair = __vadd4(__byte_perm(u[0], u[1], 0x0040), koffs);
          *reinterpret_cast<uint16_t*>(crow + 8 * j) = (uint16_t)pair;
        }
      }
    }
    __syncthreads();

    // 3x3/s2/p1 max pool: pool row pr reads conv slots 2 pr .. 2 pr + 2.
    // A thread owns 16 channels of one pool column and walks down the band,
    // each slot's 3-column max taken once.
    constexpr int V = OC / 16;
    for (int k = tid; k < Wp * V; k += THREADS) {
      const int v = k % V, pc = k / V;
      const int8_t* col0 = codes + (2 * pc) * OC + 16 * v;
      auto colmax = [&](int slot) {
        const int8_t* p = col0 + slot * code_row;
        uint4 m = *reinterpret_cast<const uint4*>(p);
        const uint4 u = *reinterpret_cast<const uint4*>(p + OC);
        m.x = __vmaxs4(m.x, u.x);
        m.y = __vmaxs4(m.y, u.y);
        m.z = __vmaxs4(m.z, u.z);
        m.w = __vmaxs4(m.w, u.w);
        if (pc > 0) {
          const uint4 l = *reinterpret_cast<const uint4*>(p - OC);
          m.x = __vmaxs4(m.x, l.x);
          m.y = __vmaxs4(m.y, l.y);
          m.z = __vmaxs4(m.z, l.z);
          m.w = __vmaxs4(m.w, l.w);
        }
        return m;
      };
      uint4 top = colmax(0);
      int8_t* dst = a.out + (((size_t)it.b * Hp + it.p0) * Wp + pc) * OC +
                    16 * v;
      for (int pr = 0; pr < it.npool; ++pr) {
        const uint4 mid = colmax(2 * pr + 1), bot = colmax(2 * pr + 2);
        uint4 m;
        m.x = __vmaxs4(__vmaxs4(top.x, mid.x), bot.x);
        m.y = __vmaxs4(__vmaxs4(top.y, mid.y), bot.y);
        m.z = __vmaxs4(__vmaxs4(top.z, mid.z), bot.z);
        m.w = __vmaxs4(__vmaxs4(top.w, mid.w), bot.w);
        *reinterpret_cast<uint4*>(dst + (size_t)pr * Wp * OC) = m;
        top = bot;
      }
    }
    __syncthreads();
    // the last conv row is the next band's halo row
    const uint4* last =
        reinterpret_cast<const uint4*>(codes + 2 * it.npool * code_row);
    for (int k = tid; k < code_row / 16; k += THREADS)
      reinterpret_cast<uint4*>(codes)[k] = last[k];
  }
  cp_wait_all();
}

template <int NT>
int launch(const StemArgs& a, int sms, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      stem_fused_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = a.n_items < sms ? a.n_items : sms;
  stem_fused_kernel<NT><<<grid, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ssq_stem_fused(const void* x, const void* w,
                              const void* scale, const void* bias,
                              const void* qp, void* out, int B, int H, int W,
                              int OC, void* stream) {
  if (B <= 0) return 0;
  if (H % 4 != 0 || W % 4 != 0 || H < 4 || W < 4 || OC % 16 != 0 ||
      OC < 16 || OC > 64 || ((uintptr_t)x | (uintptr_t)w | (uintptr_t)out) % 16)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)Layout(W, OC).total;
  int dev = 0, sms = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if (smem > (size_t)smem_max) return (int)cudaErrorInvalidValue;
  StemArgs a;
  a.x = (const float*)x;
  a.w = (const __nv_bfloat16*)w;
  a.scale = (const float*)scale;
  a.bias = (const float*)bias;
  a.qp = (const float*)qp;
  a.out = (int8_t*)out;
  a.B = B;
  a.H = H;
  a.W = W;
  a.n_bands = (H / 4 + PB - 1) / PB;
  if ((long long)B * a.n_bands > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  a.n_items = B * a.n_bands;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (OC / 8) {
    case 2: return launch<2>(a, sms, smem, s);
    case 4: return launch<4>(a, sms, smem, s);
    case 6: return launch<6>(a, sms, smem, s);
    default: return launch<8>(a, sms, smem, s);
  }
}
