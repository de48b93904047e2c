// Fused stride-1 MobileNetV2 inverted-residual block on int8 codes:
// expand 1x1 -> clip(floor(acc*A_e + B_e), 0, hi_e) -> depthwise 3x3 (zero
// padding) -> clip(floor(acc*A_d + B_d), 0, hi_d) -> project 1x1 ->
// acc*A_p + B_p (+ x*res_scale) -> clip(floor(.), lo_o, hi_o), int8 out.
//
// Replaces shiftedscalequantization_tpu/ops/pallas/mbconv.py:38
// (_mbconv_kernel, via mbconv_fused).
//
// Bound on an H100. The block reads its int8 input codes once and writes
// its int8 output codes once, B*H*W*(CI+CO) bytes at 3.35 TB/s; its
// integer work, 2*B*H*W*(CI*CE + 9*CE + CE*CO) operations at the int8
// tensor-core rate (1,979 TOPS). At batch 256: features.3 (56x56,
// 24/144/24) 11.5 us of bytes against 6.7 us of operations; features.15
// (7x7, 160/960/160) 3.8 us of bytes against 4.0 us of operations;
// features.1 (112x112, 32/-/16, no expand) 46 us of bytes. The second
// limit is instruction issue on the CUDA cores, where the depthwise taps
// and the two in-block epilogues run: about 20 instructions per expanded
// element (12.25 without an expand) at 132 SMs x 128 lanes x the clock
// (33.5 T a second at 1,980 MHz): features.3's 115.6 M expanded elements
// about 68 us, features.15's 12.0 M about 8 us, features.1's 102.8 M
// about 38 us. The kernel runs at 4-11x that floor; what holds it back is
// latency at two blocks of 8 warps an SM (the registers and shared memory
// allow no more), not the count of instructions.
//
// The design keeps both intermediates in shared memory and walks the
// expanded channels in chunks of 32. The depthwise conv is per channel, so
// for each chunk c of CE
//     q1[:, c] = expand(x)[:, c]     tensor cores, epilogue on accumulators
//     q2[:, c] = dw3x3(q1[:, c])     CUDA cores, shared memory
//     acc_p   += q2[:, c] @ wp[c, :] tensor cores, acc_p stays in registers
// is exact, and the shared memory a block needs no longer grows with CE.
//
// - A block owns one image's band of R output rows: the fewest bands of
//   at most 896 pixels that its accumulators and shared memory allow (a
//   whole image at 14x14 and 7x7, so no halo is recomputed and each weight
//   byte crosses from L2 once per image). It stages the band's input rows
//   and the one-row halo once by cp.async, each pixel's CI codes padded
//   with zeros to a multiple of 32 (plus 16 bytes, so that ldmatrix rows
//   fall in distinct banks).
// - The weights and epilogue rows are laid out at setup (prepare_mbconv)
//   as one record per chunk, in mma fragment order: a thread's B fragment
//   is one 8-byte shared load, and the record is one run of 16-byte
//   cp.async words, the next one in flight in a ring of four.
// - The chunk loop is software-pipelined with one barrier a step: step k
//   expands chunk k, runs the dw of chunk k - 1 and the project of chunk
//   k - 2, on two buffers each of q1 and q2, so a warp goes from one phase
//   to the next without waiting for the others.
// - Both 1x1 products run mma.sync m16n8k32 with s32 accumulators: s8 x s8
//   for the expand, u8 x s8 for the project (q2 is an unsigned code up to
//   255). A fragments come by ldmatrix.x4 from padded (input) or swizzled
//   (q2) rows, without bank conflicts. The expand's output columns are
//   permuted at setup so that a thread's accumulators are 8 consecutive
//   channels of one pixel: one 8-byte store into q1 per pixel row. A warp
//   owns a fixed set of project units (m-tile x n-tiles), in one of six
//   register classes; the launch plan picks the cheapest that covers the
//   band, at most 64 accumulator registers where one fits.
// - Zero padding is zero in q1, not expand(0): q1's border columns and the
//   halo rows off the image are zeroed once per block and never written.
// - The depthwise conv runs the dw kernel's inner loop (csrc/dw_conv3x3.cu)
//   on q1: a thread owns 4 channels of one column over a segment of rows,
//   three accumulators in registers, the next row's words loaded before
//   the current row is used; one dp4a per (channel, kernel row) on tap
//   words packed at setup (dp4a.u32.s32 after an expand, where q1 is
//   unsigned).
// - The int->float conversion is folded into the accumulators: they start
//   at the bits of 1.5*2^23 (MAGIC), so after the sum (|sum| < 2^22) the
//   bits read as the float MAGIC + sum, and one exact subtraction gives
//   (float)sum. floor and clip become one clamp to [lo, hi] and an add of
//   MAGIC rounded down (__fadd_rd), whose low byte is the code: floor and
//   clamp commute for integer bounds. No conversion instruction runs in the
//   two in-block epilogues.
// - The project epilogue reads the residual from the staged input tile and
//   writes the band's codes into shared memory, then to device memory in
//   16-byte words (the band's output is one contiguous run).
//
// Arithmetic, as the plain version (ops/cuda/mbconv.py): every sum is an
// int32 accumulate of integer codes (exact); each epilogue is rounded after
// the multiply and after the add (__fmul_rn, __fadd_rn, never an FMA),
// and the residual term x*res_scale is added last.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int NC = 32;                  // expanded channels per chunk
constexpr int MAX_SMEM = 232448;        // opt-in limit per block
constexpr float MAGIC = 12582912.0f;    // 1.5 * 2^23
constexpr int MAGIC_I = 0x4B400000;     // its bits
constexpr int RING = 4;                 // chunk records in shared memory

__host__ __device__ inline int align16(int n) { return (n + 15) & ~15; }

// Shared memory of a band of R rows, and where each buffer starts.
// EXPAND: [xs: staged input rows][2 q1 chunks | 2 q2 chunks | RING chunk
// records]; no expand: [q1: all chunks of the input][2 q2 chunks | RING
// records]. The output tile reuses the second region after the last chunk.
struct Layout {
  int KS, CIs, NCH, NT, CB;              // k-steps, xs pixel stride, chunks,
                                         // project n-tiles, record bytes
  int off_we, off_ae, off_wd, off_ad, off_wp;   // within a record
  int q1_chunk, q2_chunk;
  int off_q1, off_q2, off_w, off_out, smem;

  __host__ __device__ Layout(bool expand, int R, int H, int W, int CI,
                             int CE, int CO) {
    KS = expand ? (CI + 31) / 32 : 0;
    CIs = KS * 32 + 16;
    NCH = (CE + NC - 1) / NC;
    NT = (CO + 7) / 8;
    off_we = 0;
    off_ae = KS * 1024;
    off_wd = off_ae + (expand ? 2 * NC * 4 : 0);
    off_ad = off_wd + NC * 3 * 4;
    off_wp = off_ad + 2 * NC * 4;
    CB = off_wp + NT * 256;
    const int n_in = (R + 2 < H ? R + 2 : H);
    q1_chunk = (R + 2) * (W + 2) * NC;
    q2_chunk = (R * W + 15) / 16 * 16 * NC;
    const int region_a = expand ? align16(n_in * W * CIs) : NCH * q1_chunk;
    off_q1 = expand ? region_a : 0;
    off_q2 = region_a + (expand ? 2 * q1_chunk : 0);
    off_w = off_q2 + 2 * q2_chunk;
    off_out = region_a;
    const int end_w = off_w + RING * CB;
    const int end_out = off_out + align16(R * W * CO);
    smem = end_w > end_out ? end_w : end_out;
  }
};

struct Args {
  const int8_t* x;
  const unsigned char* chunks;     // NCH records of CB bytes
  const float* ap;                 // (2, CO) [A_p; B_p]
  const float* qp;                 // [hi_e, hi_d, res_scale, lo_o, hi_o]
  int8_t* out;
  int H, W, CI, CE, CO, R, G, resid, n_bands;
};

// n / d for n * d < 2^21 and n / d < 2^11: a multiply and a shift
struct FastDiv {
  unsigned mul;
  __device__ explicit FastDiv(int d) : mul(((1u << 21) + d - 1) / d) {}
  __device__ int operator()(int n) const {
    return (int)(((unsigned)n * mul) >> 21);
  }
};

__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         int bytes) {
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(src));
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
                 "l"(src));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// d += a (16x32 s8, row) * b (32x8 s8, col)
__device__ __forceinline__ void mma_s8s8(int (&d)[4], const uint32_t (&a)[4],
                                         uint2 b) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// d += a (16x32 u8, row) * b (32x8 s8, col)
__device__ __forceinline__ void mma_u8s8(int (&d)[4], const uint32_t (&a)[4],
                                         uint2 b) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// sum of the four byte products, unsigned a, signed b
__device__ __forceinline__ int dp4a_us(uint32_t a, int b, int c) {
  int d;
  asm("dp4a.u32.s32 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

template <bool U>
__device__ __forceinline__ int dot4(uint32_t a, int b, int c) {
  return U ? dp4a_us(a, b, c) : __dp4a((int)a, b, c);
}

// An accumulator that started at MAGIC_I -> its epilogue code in the low
// byte: clip(floor(sum * A + B), lo, hi), rounded after the multiply and
// after the add. (float)sum is exact: __int_as_float(bits) is MAGIC + sum.
__device__ __forceinline__ uint32_t code_of(int bits, float A, float B,
                                            float lo, float hi) {
  const float f = __fsub_rn(__int_as_float(bits), MAGIC);
  const float v = __fadd_rn(__fmul_rn(f, A), B);
  return __float_as_uint(__fadd_rd(fminf(fmaxf(v, lo), hi), MAGIC));
}

// the low bytes of four codes, one word
__device__ __forceinline__ uint32_t pack4(uint32_t c0, uint32_t c1,
                                          uint32_t c2, uint32_t c3) {
  return __byte_perm(__byte_perm(c0, c1, 0x0040), __byte_perm(c2, c3, 0x0040),
                     0x5410);
}

// The four channels' (L, M, R) bytes of one q1 row, regrouped so that word
// j holds channel j's three taps in bytes 0-2 (byte 3 meets a zero weight).
__device__ __forceinline__ void regroup(uint32_t L, uint32_t M, uint32_t R,
                                        uint32_t (&t)[4]) {
  const uint32_t x01 = __byte_perm(L, M, 0x5140);  // L0 M0 L1 M1
  const uint32_t x23 = __byte_perm(L, M, 0x7362);  // L2 M2 L3 M3
  t[0] = __byte_perm(x01, R, 0x0410);
  t[1] = __byte_perm(x01, R, 0x0532);
  t[2] = __byte_perm(x23, R, 0x0610);
  t[3] = __byte_perm(x23, R, 0x0732);
}

// One block: image blockIdx.x / n_bands, output rows [r0, r0 + rows).
// EXPAND: q1 holds unsigned codes of the expand; otherwise q1 is the block
// input (signed). Each warp owns UPW project units, a unit being one
// 16-pixel m-tile and NTG n-tiles of 8 output channels; the accumulators
// stay in registers across the chunks. The chunk loop is pipelined: step k
// expands chunk k, runs the dw of chunk k - 1 and the project of chunk
// k - 2 (without an expand: the dw of k and the project of k - 1), with
// one barrier per step; q1 and q2 have two buffers each, and the records
// a ring of RING, the next one in flight.
template <bool EXPAND, int UPW, int NTG>
__global__ void __launch_bounds__(THREADS, 2)
mbconv_fused_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L(EXPAND, a.R, a.H, a.W, a.CI, a.CE, a.CO);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.x / a.n_bands;
  const int r0 = (blockIdx.x - b * a.n_bands) * a.R;
  const int H = a.H, W = a.W, W2 = W + 2, CI = a.CI, CO = a.CO;
  const int rows = min(a.R, H - r0);
  const int ir0 = max(r0 - 1, 0), ir1 = min(r0 + rows + 1, H);
  const int n_in = ir1 - ir0;              // staged input rows
  const int lr0 = ir0 - (r0 - 1);          // their first row in q1
  const FastDiv divW(W);
  const uint32_t s0 = (uint32_t)__cvta_generic_to_shared(smem);
  const int8_t* const xb = a.x + ((size_t)b * H + ir0) * W * CI;

  // zero q1 (its border, the rows off the image, the pad channels) and the
  // staged tile's pad bytes, then stage the input and the first record
  {
    const int n16 = (L.off_q1 + (EXPAND ? 2 : L.NCH) * L.q1_chunk) / 16;
    uint4* z = reinterpret_cast<uint4*>(smem);
    for (int i = tid; i < n16; i += THREADS) z[i] = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();
  {
    const int cp = CI % 16 == 0 ? 16 : CI % 8 == 0 ? 8 : 4;
    const int wpp = CI / cp;
    const FastDiv divw(wpp);
    const int n = n_in * W * wpp;
    for (int i = tid; i < n; i += THREADS) {
      const int p = divw(i), q = i - p * wpp;
      uint32_t dst;
      if (EXPAND) {
        dst = s0 + p * L.CIs + q * cp;
      } else {
        const int pr = divW(p), col = p - pr * W;
        const int ch = q * cp;
        dst = s0 + (((ch >> 5) * (a.R + 2) + lr0 + pr) * W2 + col + 1) * NC +
              (ch & 31);
      }
      cp_async(dst, xb + (size_t)p * CI + q * cp, cp);
    }
  }
  auto fetch = [&](int c) {
    const unsigned char* src = a.chunks + (size_t)c * L.CB;
    const uint32_t dst = s0 + L.off_w + (c % RING) * L.CB;
    for (int i = tid; i < L.CB / 16; i += THREADS)
      cp_async(dst + i * 16, src + i * 16, 16);
  };
  fetch(0);
  cp_commit();
  auto record = [&](int c) { return smem + L.off_w + (c % RING) * L.CB; };

  const float hi_e = __ldg(a.qp), hi_d = __ldg(a.qp + 1);
  // this band's project m-tiles and the warp's units
  const int n_px = rows * W;
  const int MT = (n_px + 15) / 16;
  const int ntg = (L.NT + a.G - 1) / a.G;
  int u_mt[UPW], u_n0[UPW];
#pragma unroll
  for (int i = 0; i < UPW; ++i) {
    const int u = warp + WARPS * i;
    u_mt[i] = u < MT * a.G ? u / a.G : -1;
    u_n0[i] = (u - (u / a.G) * a.G) * ntg;
  }
  int acc[UPW][NTG][4];
#pragma unroll
  for (int i = 0; i < UPW; ++i)
#pragma unroll
    for (int j = 0; j < NTG; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  // expand: m-tiles of the staged pixels, whole (32 channels), or in
  // halves (16) where there are fewer tiles than warps
  const int n_e = n_in * W;
  const int MTe = (n_e + 15) / 16;
  const int eh = EXPAND && MTe < WARPS ? 2 : 1;
  // a warp's units all have the same half (units step by WARPS)
  const int nh = eh == 2 ? warp & 1 : 0;
  const int ch0 = 8 * t + 4 * nh;     // thread t's first channel in q1
  auto expand = [&](int c) {
    const unsigned char* rec = record(c);
    const float* AE = reinterpret_cast<const float*>(rec + L.off_ae);
    unsigned char* const q1 = smem + L.off_q1 + (c & 1) * L.q1_chunk;
    // thread t holds channels ch0 + 2j + e of pixel rows g and g + 8
    float A[8], B[8];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (h < 2 / eh) {
        const float4 a4 = *reinterpret_cast<const float4*>(AE + ch0 + 4 * h);
        const float4 b4 =
            *reinterpret_cast<const float4*>(AE + NC + ch0 + 4 * h);
        A[4 * h] = a4.x; A[4 * h + 1] = a4.y;
        A[4 * h + 2] = a4.z; A[4 * h + 3] = a4.w;
        B[4 * h] = b4.x; B[4 * h + 1] = b4.y;
        B[4 * h + 2] = b4.z; B[4 * h + 3] = b4.w;
      }
    }
    for (int u = warp; u < MTe * eh; u += WARPS) {
      const int mt = eh == 2 ? u >> 1 : u;
      int d[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) d[j][e] = MAGIC_I;
      const int arow =
          min(mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8, n_e - 1);
      const uint32_t aaddr = s0 + arow * L.CIs + (lane >> 4) * 16;
      for (int ks = 0; ks < L.KS; ++ks) {
        uint32_t af[4];
        ldmatrix_x4(aaddr + ks * 32, af);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (j < 4 / eh) {
            const uint2 bf = *reinterpret_cast<const uint2*>(
                rec + L.off_we + ((ks * 4 + nh * 2 + j) * 32 + lane) * 8);
            mma_s8s8(d[j], af, bf);
          }
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = mt * 16 + g + 8 * h;
        if (m >= n_e) continue;
        uint32_t w[2];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          if (jj < 2 / eh) {
            const int j0 = 2 * jj, j1 = 2 * jj + 1;
            w[jj] = pack4(
                code_of(d[j0][2 * h], A[2 * j0], B[2 * j0], 0.f, hi_e),
                code_of(d[j0][2 * h + 1], A[2 * j0 + 1], B[2 * j0 + 1], 0.f,
                        hi_e),
                code_of(d[j1][2 * h], A[2 * j1], B[2 * j1], 0.f, hi_e),
                code_of(d[j1][2 * h + 1], A[2 * j1 + 1], B[2 * j1 + 1], 0.f,
                        hi_e));
          }
        }
        const int pr = divW(m), col = m - pr * W;
        unsigned char* dst = q1 + ((lr0 + pr) * W2 + col + 1) * NC + ch0;
        if (eh == 1)
          *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
        else
          *reinterpret_cast<uint32_t*>(dst) = w[0];
      }
    }
  };

  // depthwise 3x3 over a q1 chunk (zero border) into q2: items of (4-channel
  // group, column, segment of S rows), about half as many items as threads
  // (each segment re-reads two rows), one per thread at 7x7
  const int per = W < 8 ? THREADS : THREADS / 2;
  const int nseg0 = min(a.R, (per + 8 * W - 1) / (8 * W));
  const int S = (a.R + nseg0 - 1) / nseg0;
  const int n_items = 8 * W * ((rows + S - 1) / S);
  auto dw = [&](int c) {
    const unsigned char* rec = record(c);
    const int* WD = reinterpret_cast<const int*>(rec + L.off_wd);
    const float* AD = reinterpret_cast<const float*>(rec + L.off_ad);
    const unsigned char* q1c =
        smem + L.off_q1 + (EXPAND ? c & 1 : c) * L.q1_chunk;
    unsigned char* const q2 = smem + L.off_q2 + (c & 1) * L.q2_chunk;
    for (int it = tid; it < n_items; it += THREADS) {
      const int cg = it & 7, rest = it >> 3;
      const int seg = divW(rest), col = rest - seg * W;
      const int sr0 = seg * S, sr1 = min(sr0 + S, rows);
      int w0[4], w1[4], w2[4];
      {
        const int4* wv = reinterpret_cast<const int4*>(WD + 12 * cg);
        const int4 u0 = wv[0], u1 = wv[1], u2 = wv[2];
        const int f[12] = {u0.x, u0.y, u0.z, u0.w, u1.x, u1.y,
                           u1.z, u1.w, u2.x, u2.y, u2.z, u2.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          w0[j] = f[3 * j];
          w1[j] = f[3 * j + 1];
          w2[j] = f[3 * j + 2];
        }
      }
      const float4 a4 = *reinterpret_cast<const float4*>(AD + 4 * cg);
      const float4 b4 = *reinterpret_cast<const float4*>(AD + NC + 4 * cg);
      // q1 rows from sr0, the next one loaded before the current one is
      // used; output row r is pixel p = (sr0 + r) * W + col of q2, whose
      // 16-byte halves are swapped where bit 2 of p differs from cg's
      const unsigned char* rd = q1c + (sr0 * W2 + col) * NC + 4 * cg;
      const int row_step = W2 * NC;
      unsigned char* const q2c = q2 + ((cg & 3) << 2);
      const int swz = (cg >> 2) << 4;
      int p = sr0 * W + col;
      uint32_t wl = *reinterpret_cast<const uint32_t*>(rd);
      uint32_t wm = *reinterpret_cast<const uint32_t*>(rd + NC);
      uint32_t wr = *reinterpret_cast<const uint32_t*>(rd + 2 * NC);
      // the current row regrouped per channel; the next row's words in
      // flight (the row past the segment lies inside shared memory)
      auto next = [&](uint32_t (&tt)[4]) {
        regroup(wl, wm, wr, tt);
        rd += row_step;
        wl = *reinterpret_cast<const uint32_t*>(rd);
        wm = *reinterpret_cast<const uint32_t*>(rd + NC);
        wr = *reinterpret_cast<const uint32_t*>(rd + 2 * NC);
      };
      auto emit = [&](const int (&s)[4]) {
        const uint32_t word = pack4(code_of(s[0], a4.x, b4.x, 0.f, hi_d),
                                    code_of(s[1], a4.y, b4.y, 0.f, hi_d),
                                    code_of(s[2], a4.z, b4.z, 0.f, hi_d),
                                    code_of(s[3], a4.w, b4.w, 0.f, hi_d));
        *reinterpret_cast<uint32_t*>(q2c + p * NC + ((swz ^ (p << 2)) & 16)) =
            word;
        p += W;
      };
      // q1 row i feeds output rows i - 2 (kh 2), i - 1 (kh 1) and i (kh 0);
      // from row 2 on, output row i - 2 is then complete
      uint32_t tt[4];
      int X[4], Y[4], Z[4];
      next(tt);
#pragma unroll
      for (int j = 0; j < 4; ++j) X[j] = dot4<EXPAND>(tt[j], w0[j], MAGIC_I);
      next(tt);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        X[j] = dot4<EXPAND>(tt[j], w1[j], X[j]);
        Y[j] = dot4<EXPAND>(tt[j], w0[j], MAGIC_I);
      }
      auto step = [&](int (&done)[4], int (&mid)[4], int (&fresh)[4]) {
        next(tt);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          done[j] = dot4<EXPAND>(tt[j], w2[j], done[j]);
          mid[j] = dot4<EXPAND>(tt[j], w1[j], mid[j]);
          fresh[j] = dot4<EXPAND>(tt[j], w0[j], MAGIC_I);
        }
        emit(done);
      };
      for (int n = sr1 - sr0; n > 0; n -= 3) {
        step(X, Y, Z);
        if (n == 1) break;
        step(Y, Z, X);
        if (n == 2) break;
        step(Z, X, Y);
      }
    }
  };

  // project: acc += q2 chunk (u8) x wp chunk (s8)
  auto project = [&](int c) {
    const unsigned char* rec = record(c);
    const uint32_t q2 = s0 + L.off_q2 + (c & 1) * L.q2_chunk;
#pragma unroll
    for (int i = 0; i < UPW; ++i) {
      if (u_mt[i] < 0) continue;
      const int row = u_mt[i] * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
      uint32_t af[4];
      ldmatrix_x4(q2 + row * NC + ((((lane >> 4) ^ (row >> 2)) & 1) << 4),
                  af);
#pragma unroll
      for (int j = 0; j < NTG; ++j) {
        const int nt = u_n0[i] + j;
        if (j < ntg && nt < L.NT) {
          const uint2 bf = *reinterpret_cast<const uint2*>(
              rec + L.off_wp + (nt * 32 + lane) * 8);
          mma_u8s8(acc[i][j], af, bf);
        }
      }
    }
  };

  const int lag = EXPAND ? 1 : 0;          // the dw's chunk is k - lag
  for (int k = 0; k < L.NCH + lag + 1; ++k) {
    cp_wait_all();
    __syncthreads();     // record k landed; step k - 1 is done everywhere
    if (k + 1 < L.NCH) fetch(k + 1);
    cp_commit();
    if (EXPAND && k < L.NCH) expand(k);
    const int cd = k - lag;
    if (cd >= 0 && cd < L.NCH) dw(cd);
    if (cd >= 1) project(cd - 1);
  }
  __syncthreads();       // q1, q2 and the records are free for the output

  // epilogue: y = acc * A_p + B_p (+ x * res_scale), clip(floor(y)) -> the
  // band's output tile [pixel][CO] in shared memory
  {
    const float r_s = __ldg(a.qp + 2), lo_o = __ldg(a.qp + 3),
                hi_o = __ldg(a.qp + 4);
    unsigned char* const ot = smem + L.off_out;
#pragma unroll
    for (int i = 0; i < UPW; ++i) {
      if (u_mt[i] < 0) continue;
#pragma unroll
      for (int j = 0; j < NTG; ++j) {
        const int o = (u_n0[i] + j) * 8 + 2 * t;
        if (j >= ntg || o >= CO) continue;
        const float2 ap = __ldg(reinterpret_cast<const float2*>(a.ap + o));
        const float2 bp =
            __ldg(reinterpret_cast<const float2*>(a.ap + CO + o));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = u_mt[i] * 16 + g + 8 * h;
          if (m >= n_px) continue;
          float y0 = __fadd_rn(__fmul_rn((float)acc[i][j][2 * h], ap.x), bp.x);
          float y1 =
              __fadd_rn(__fmul_rn((float)acc[i][j][2 * h + 1], ap.y), bp.y);
          if (a.resid) {
            const int pr = divW(m), col = m - pr * W;
            const int8_t* xr;
            if (EXPAND)
              xr = reinterpret_cast<const int8_t*>(smem) +
                   ((r0 - ir0 + pr) * W + col) * L.CIs + o;
            else
              xr = reinterpret_cast<const int8_t*>(smem) +
                   (((o >> 5) * (a.R + 2) + pr + 1) * W2 + col + 1) * NC +
                   (o & 31);
            y0 = __fadd_rn(y0, __fmul_rn((float)xr[0], r_s));
            y1 = __fadd_rn(y1, __fmul_rn((float)xr[1], r_s));
          }
          const uint32_t c0 =
              __float_as_uint(__fadd_rd(fminf(fmaxf(y0, lo_o), hi_o), MAGIC));
          const uint32_t c1 =
              __float_as_uint(__fadd_rd(fminf(fmaxf(y1, lo_o), hi_o), MAGIC));
          *reinterpret_cast<uint16_t*>(ot + m * CO + o) =
              (uint16_t)__byte_perm(c0, c1, 0x0040);
        }
      }
    }
    __syncthreads();
    // the band's output is one contiguous run of rows * W * CO bytes
    int8_t* const dst = a.out + ((size_t)b * H + r0) * W * CO;
    const int nbytes = n_px * CO;
    if ((((uintptr_t)dst) | (uintptr_t)nbytes) % 16 == 0) {
      for (int i = tid; i < nbytes / 16; i += THREADS)
        reinterpret_cast<uint4*>(dst)[i] =
            reinterpret_cast<const uint4*>(ot)[i];
    } else {
      for (int i = tid; i < nbytes / 4; i += THREADS)
        reinterpret_cast<uint32_t*>(dst)[i] =
            reinterpret_cast<const uint32_t*>(ot)[i];
    }
  }
}

template <bool EXPAND, int UPW, int NTG>
int launch(const Args& a, int B, int smem, cudaStream_t stream) {
  auto kern = mbconv_fused_kernel<EXPAND, UPW, NTG>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<(unsigned)(B * a.n_bands), THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool EXPAND>
int launch_class(const Args& a, int B, int cls, int smem, cudaStream_t s) {
  switch (cls) {
    case 0: return launch<EXPAND, 4, 3>(a, B, smem, s);
    case 1: return launch<EXPAND, 4, 4>(a, B, smem, s);
    case 2: return launch<EXPAND, 1, 12>(a, B, smem, s);
    case 3: return launch<EXPAND, 2, 12>(a, B, smem, s);
    case 4: return launch<EXPAND, 1, 20>(a, B, smem, s);
    case 5: return launch<EXPAND, 8, 2>(a, B, smem, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// R (band rows), cls (the unit class, (units per warp, n-tiles per unit):
// (4, 3), (4, 4), (1, 12), (2, 12), (1, 20) or (8, 2)) and G (n-tile groups) come from the wrapper's launch plan
// (ops/cuda/mbconv.launch_plan), which raises before any launch on a shape
// outside what these checks take.
extern "C" int ssq_mbconv_fused(const void* x, const void* chunks,
                                const void* ap, const void* qp, void* out,
                                int B, int H, int W, int CI, int CE, int CO,
                                int has_expand, int has_residual, int R,
                                int cls, int G, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return 0;
  const bool expand = has_expand != 0;
  if ((!expand && CE != CI) || (has_residual && CO != CI) || CI % 4 != 0 ||
      CO % 4 != 0 || R < 1 || R > H || G < 1 || cls < 0 || cls > 5 ||
      (expand && CI > 256) || (R + 2) * W * W >= (1 << 21) ||
      ((uintptr_t)x | (uintptr_t)chunks | (uintptr_t)out) % 16 != 0 ||
      ((uintptr_t)ap % 8) != 0)
    return (int)cudaErrorInvalidValue;
  const Layout L(expand, R, H, W, CI, CE, CO);
  if (L.smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  Args a;
  a.x = (const int8_t*)x;
  a.chunks = (const unsigned char*)chunks;
  a.ap = (const float*)ap;
  a.qp = (const float*)qp;
  a.out = (int8_t*)out;
  a.H = H;
  a.W = W;
  a.CI = CI;
  a.CE = CE;
  a.CO = CO;
  a.R = R;
  a.G = G;
  a.resid = has_residual != 0;
  a.n_bands = (H + R - 1) / R;
  if ((long long)B * a.n_bands > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return expand ? launch_class<true>(a, B, cls, L.smem, s)
                : launch_class<false>(a, B, cls, L.smem, s);
}
