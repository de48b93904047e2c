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
// units at batch 256 that is about 1.34 GB, 0.40 ms at 3.35 TB/s. The
// second limit is instruction issue: the units write 486.5 M outputs, so
// every instruction per output costs about 16 us over the 132 SMs. The
// design attacks both:
//
// - Staging. A block owns a band of output rows x a tile of output columns
//   x a slab of channels: whole pixels up to 160 channels, else 64-channel
//   slabs, so the copy reads runs of whole 32-byte sectors. It copies the
//   band's input tile, (rows * s + 2) x (cols * s + 2) pixels of the slab,
//   into shared memory once with cp.async (16-byte words where C % 16 == 0,
//   4-byte words otherwise), the pad of 1 being the copy's zero fill, and
//   waits at one barrier.
//   Several blocks are resident on an SM, so one block's copy overlaps the
//   others' arithmetic. Each input code leaves device memory once per band
//   (the band's two halo rows are read again by the band below, from L2).
// - Reuse in registers. A thread owns 4 channels of one output column and
//   keeps three accumulator rows: each staged input row feeds the three
//   output rows it belongs to (stride 1; two at stride 2), so a product is
//   never re-derived from another load.
// - Fewer instructions per output. The weights are packed once at setup as
//   one word per (channel, kernel row): the three taps' codes in bytes 0-2,
//   byte 3 zero. The three input words of a row (4 channels each) are
//   regrouped per channel with six __byte_perm, and one __dp4a per
//   (channel, kernel row) adds the row's three products (the fourth byte
//   meets the zero weight). The epilogue folds relu / relu6 and the grid
//   clip into one clamp and rounds with a magic-number add (below), then
//   three __byte_perm pack four codes into one 4-byte store.
//
// Arithmetic, as the plain version (ops/cuda/depthwise.py): the nine
// products accumulate in int32 (exact); y = acc * scalef + biasf is rounded
// after the multiply and after the add (__fmul_rn, __fadd_rn); the requant
// is q = clip(rint(act(y) * inv) + zp, 0, qmax) - zp with inv = 1/delta_out
// taken once in f32 and rint half to even. For inv > 0 and an integer zp,
// __fmul_rn(., inv) and rint are monotone, so with r = rint(y * inv)
//   q = clamp(r, lo, hi),  lo = max(rint(a_lo * inv), -zp),
//                          hi = min(rint(a_hi * inv), qmax - zp)
// where [a_lo, a_hi] is the activation's range ([0, 6] for relu6); and
// clamp(r, lo, hi) = rint(clamp(y * inv, lo, hi)) for integer lo <= hi.
// The last rint is __fadd_rn(v, 1.5 * 2^23), exact half-to-even for
// |v| < 2^22, whose low float byte is then the int8 code.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_THREADS = 256;
constexpr int WHOLE_C = 160;       // channels a block takes whole, at most
constexpr int SLAB = 64;           // channels per block above WHOLE_C
constexpr int MAX_ROWS = 32;       // output rows per band, at most
constexpr int MAX_SMEM = 48 * 1024;  // band tile bytes, at most
constexpr float MAGIC = 12582912.0f;  // 1.5 * 2^23

struct DwArgs {
  const int8_t* x;
  const int* w;          // (C, 3): taps kw = 0..2 of kernel row kh, bytes
  const float* scalef;
  const float* biasf;
  const float* qp;       // [1/delta_out, zp_out, qmax]
  int8_t* out;
  int H, W, C, Ho, Wo, act;
  int ncg, cb, rb, n_ct;  // channel groups and columns per block, rows per
                          // band, column tiles
};

__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         int bytes, int valid) {
  if (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(valid ? 16 : 0));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
                 "l"(src), "r"(valid ? 4 : 0));
  }
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The four channels' (L, M, R) bytes of one staged input row, regrouped so
// that word j holds channel j's three taps in bytes 0-2.
__device__ __forceinline__ void regroup(uint32_t L, uint32_t M, uint32_t R,
                                        int (&t)[4]) {
  const uint32_t x01 = __byte_perm(L, M, 0x5140);  // L0 M0 L1 M1
  const uint32_t x23 = __byte_perm(L, M, 0x7362);  // L2 M2 L3 M3
  t[0] = (int)__byte_perm(x01, R, 0x0410);
  t[1] = (int)__byte_perm(x01, R, 0x0532);
  t[2] = (int)__byte_perm(x23, R, 0x0610);
  t[3] = (int)__byte_perm(x23, R, 0x0732);
}

__device__ __forceinline__ void dot_add(const int (&t)[4], const int (&w)[4],
                                        int (&acc)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) acc[j] = __dp4a(t[j], w[j], acc[j]);
}

__device__ __forceinline__ void dot_set(const int (&t)[4], const int (&w)[4],
                                        int (&acc)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) acc[j] = __dp4a(t[j], w[j], 0);
}

struct Epilogue {
  float sc[4], bi[4];
  float inv, lo, hi;

  __device__ __forceinline__ uint32_t code(int acc, int j) const {
    const float t =
        __fmul_rn(__fadd_rn(__fmul_rn((float)acc, sc[j]), bi[j]), inv);
    return __float_as_uint(__fadd_rn(fminf(fmaxf(t, lo), hi), MAGIC));
  }

  // four channels' codes, one word
  __device__ __forceinline__ uint32_t word(const int (&acc)[4]) const {
    const uint32_t p01 = __byte_perm(code(acc[0], 0), code(acc[1], 1), 0x0040);
    const uint32_t p23 = __byte_perm(code(acc[2], 2), code(acc[3], 3), 0x0040);
    return __byte_perm(p01, p23, 0x5410);
  }
};

// One block: image blockIdx.z, output rows [oh0, oh0 + rb) with
// oh0 = blockIdx.y * rb, and tile (column tile, channel slab) blockIdx.x.
// threadIdx.x is the thread's 4-channel group in the slab, threadIdx.y its
// output column in the tile. CP is the cp.async word in bytes.
template <int S, int CP>
__global__ void __launch_bounds__(MAX_THREADS)
dw_conv3x3_kernel(const DwArgs a) {
  extern __shared__ __align__(16) unsigned char tile[];
  const int gx = threadIdx.x, gy = threadIdx.y;
  const int tid = gy * a.ncg + gx, nthreads = a.ncg * a.cb;
  const int ct = blockIdx.x % a.n_ct, cs = blockIdx.x / a.n_ct;
  const int b = blockIdx.z;
  const int oh0 = blockIdx.y * a.rb;
  const int nout = min(a.rb, a.Ho - oh0);
  const int nin = (nout - 1) * S + 3;        // staged input rows
  const int slab = a.ncg * 4;                // channels per slab
  const int c0 = cs * slab;
  const int cw = min(slab, a.C - c0);        // channels of this slab
  const int npix = (a.cb - 1) * S + 3;       // staged pixels per row
  const int rowbytes = npix * slab;
  const int ir0 = oh0 * S - 1, px0 = ct * a.cb * S - 1;
  const int wpr = cw / CP;                   // copy words per pixel
  const uint32_t tile0 = (uint32_t)__cvta_generic_to_shared(tile);

  // the band's input tile: [row][pixel][slab channel]. A thread copies the
  // same words of every row, so their addresses are worked out once.
  for (int k = tid; k < npix * wpr; k += nthreads) {
    const int p = k / wpr, q = k - p * wpr;
    const int col = px0 + p;
    const bool col_ok = col >= 0 && col < a.W;
    const int8_t* src =
        a.x + (((size_t)b * a.H + ir0) * a.W + col) * a.C + c0 + q * CP;
    const size_t row_step = (size_t)a.W * a.C;
    const uint32_t dst = tile0 + p * slab + q * CP;
    for (int r = 0; r < nin; ++r) {
      const int ir = ir0 + r;
      const bool ok = col_ok && ir >= 0 && ir < a.H;
      cp_async(dst + r * rowbytes, ok ? src + r * row_step : a.x, CP, ok);
    }
  }
  cp_commit();

  const int c = c0 + 4 * gx;                 // the thread's first channel
  const int ow = ct * a.cb + gy;
  const bool active = 4 * gx < cw && ow < a.Wo;
  int w0[4], w1[4], w2[4];
  Epilogue e;
  {
    const int cl = active ? c : 0;
    const int4* wv = reinterpret_cast<const int4*>(a.w + 3 * cl);
    const int4 u0 = __ldg(wv), u1 = __ldg(wv + 1), u2 = __ldg(wv + 2);
    // (C, 3) words: channel cl + j, kernel row kh at 3 * j + kh
    const int f[12] = {u0.x, u0.y, u0.z, u0.w, u1.x, u1.y,
                       u1.z, u1.w, u2.x, u2.y, u2.z, u2.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      w0[j] = f[3 * j];
      w1[j] = f[3 * j + 1];
      w2[j] = f[3 * j + 2];
    }
    const float4 s4 = __ldg(reinterpret_cast<const float4*>(a.scalef + cl));
    const float4 b4 = __ldg(reinterpret_cast<const float4*>(a.biasf + cl));
    e.sc[0] = s4.x; e.sc[1] = s4.y; e.sc[2] = s4.z; e.sc[3] = s4.w;
    e.bi[0] = b4.x; e.bi[1] = b4.y; e.bi[2] = b4.z; e.bi[3] = b4.w;
    const float inv = __ldg(a.qp), zp = __ldg(a.qp + 1),
                qmax = __ldg(a.qp + 2);
    float lo = -zp, hi = qmax - zp;
    if (a.act != 0) {
      const float alo = rintf(__fmul_rn(0.0f, inv));
      const float ahi =
          a.act == 2 ? rintf(__fmul_rn(6.0f, inv)) : __int_as_float(0x7f800000);
      float l2 = fmaxf(alo, lo), h2 = fminf(ahi, hi);
      if (l2 > h2) l2 = h2 = ahi < lo ? lo : hi;   // disjoint ranges
      lo = l2;
      hi = h2;
    }
    e.inv = inv;
    e.lo = lo;
    e.hi = hi;
  }
  int8_t* const out_col =
      a.out + (((size_t)b * a.Ho + oh0) * a.Wo + ow) * a.C + c;
  const size_t out_row = (size_t)a.Wo * a.C;
  const unsigned char* const rd = tile + gy * S * slab + 4 * gx;

  cp_wait<0>();
  __syncthreads();
  if (!active) return;
  // staged row i, regrouped per channel
  auto next_row = [&](int i, int (&t)[4]) {
    const unsigned char* p = rd + i * rowbytes;
    regroup(*reinterpret_cast<const uint32_t*>(p),
            *reinterpret_cast<const uint32_t*>(p + slab),
            *reinterpret_cast<const uint32_t*>(p + 2 * slab), t);
  };
  auto emit = [&](int j, const int (&acc)[4]) {
    *reinterpret_cast<uint32_t*>(out_col + j * out_row) = e.word(acc);
  };

  int A[4] = {0, 0, 0, 0}, B[4] = {0, 0, 0, 0}, C[4] = {0, 0, 0, 0};
  int t[4];
  if (S == 1) {
    // input row i feeds output rows i - 2 (kh 2), i - 1 (kh 1), i (kh 0);
    // output row i - 2 is then complete. The three accumulators rotate.
    auto step = [&](int i, int (&done)[4], int (&mid)[4], int (&fresh)[4]) {
      next_row(i, t);
      dot_add(t, w2, done);
      dot_add(t, w1, mid);
      dot_set(t, w0, fresh);
      if (i >= 2) emit(i - 2, done);
    };
    for (int i = 0; i < nin; i += 3) {
      step(i, A, B, C);
      if (i + 1 >= nin) break;
      step(i + 1, B, C, A);
      if (i + 2 >= nin) break;
      step(i + 2, C, A, B);
    }
  } else {
    // input row 2j feeds output rows j - 1 (kh 2) and j (kh 0), row 2j + 1
    // feeds row j (kh 1); output row j - 1 is complete after row 2j.
    auto even = [&](int i, int (&done)[4], int (&fresh)[4]) {
      next_row(i, t);
      dot_add(t, w2, done);
      dot_set(t, w0, fresh);
      if (i >= 2) emit(i / 2 - 1, done);
    };
    auto odd = [&](int i, int (&acc)[4]) {
      next_row(i, t);
      dot_add(t, w1, acc);
    };
    for (int i = 0; i < nin; i += 4) {
      even(i, A, B);
      if (i + 1 >= nin) break;
      odd(i + 1, B);
      if (i + 2 >= nin) break;
      even(i + 2, B, A);
      if (i + 3 >= nin) break;
      odd(i + 3, A);
    }
  }
}

template <int S, int CP>
int launch(const DwArgs& a, int B, int n_cs, int n_bands, size_t smem,
           cudaStream_t stream) {
  dim3 grid((unsigned)(a.n_ct * n_cs), (unsigned)n_bands, (unsigned)B);
  dim3 block((unsigned)a.ncg, (unsigned)a.cb);
  dw_conv3x3_kernel<S, CP><<<grid, block, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ssq_dw_conv3x3(const void* x, const void* w,
                              const void* scalef, const void* biasf,
                              const void* qp, void* out, int B, int H, int W,
                              int C, int stride, int act, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0) return 0;
  if ((stride != 1 && stride != 2) || act < 0 || act > 2 || C % 4 != 0 ||
      B > 65535)
    return (int)cudaErrorInvalidValue;
  const int cp = C % 16 == 0 ? 16 : 4;
  if (((uintptr_t)x % cp) != 0 || ((uintptr_t)out % 4) != 0 ||
      (((uintptr_t)w | (uintptr_t)scalef | (uintptr_t)biasf) % 16) != 0)
    return (int)cudaErrorInvalidValue;
  DwArgs a;
  a.x = (const int8_t*)x;
  a.w = (const int*)w;
  a.scalef = (const float*)scalef;
  a.biasf = (const float*)biasf;
  a.qp = (const float*)qp;
  a.out = (int8_t*)out;
  a.H = H;
  a.W = W;
  a.C = C;
  a.Ho = (H - 1) / stride + 1;
  a.Wo = (W - 1) / stride + 1;
  a.act = act;
  // channels: whole pixels, or SLAB-channel slabs (the last one partial)
  const int slab = C <= WHOLE_C ? C : SLAB;
  const int n_cs = (C + slab - 1) / slab;
  a.ncg = slab / 4;
  // columns: the fewest tiles MAX_THREADS allows, evened out
  const int max_cols = MAX_THREADS / a.ncg;
  a.n_ct = (a.Wo + max_cols - 1) / max_cols;
  a.cb = (a.Wo + a.n_ct - 1) / a.n_ct;
  // rows: the fewest bands of at most MAX_ROWS whose tile fits MAX_SMEM
  const int rowbytes = ((a.cb - 1) * stride + 3) * a.ncg * 4;
  int rows = (MAX_SMEM / rowbytes - 3) / stride + 1;
  rows = rows < 1 ? 1 : rows > MAX_ROWS ? MAX_ROWS : rows;
  const int n_bands = (a.Ho + rows - 1) / rows;
  a.rb = (a.Ho + n_bands - 1) / n_bands;
  if ((long long)a.n_ct * n_cs > 0x7fffffffLL || n_bands > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)((a.rb - 1) * stride + 3) * rowbytes;
  const cudaStream_t s = (cudaStream_t)stream;
  if (stride == 1)
    return cp == 16 ? launch<1, 16>(a, B, n_cs, n_bands, smem, s)
                    : launch<1, 4>(a, B, n_cs, n_bands, smem, s);
  return cp == 16 ? launch<2, 16>(a, B, n_cs, n_bands, smem, s)
                  : launch<2, 4>(a, B, n_cs, n_bands, smem, s);
}
