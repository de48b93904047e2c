// Grouped int8 implicit-GEMM convolution on the tensor cores, with the
// scale-table and requant epilogues of int8_conv (int_matmul.cu).
//
// Replaces the grouped convolution the JAX package hands to XLA:
// shiftedscalequantization_tpu/deploy.py:_int_conv with
// feature_group_count > 1 (RegNetX's f.b units, served as grouped int8 or
// bf16_codes); PyTorch has no int8 convolution on CUDA.
//
// ssq_int8_group_conv:  codes (B, H, W, C) int8 NHWC, w (S, N, KH*KW*Cg)
//   int8 in (kh, kw, ic) order, G conv groups of Cg = C / G input and
//   OCg = N / G output channels: output channel n belongs to conv group
//   n / OCg and reads input channels [g*Cg, (g+1)*Cg). S weight groups
//   (shift candidates) share the codes. Per weight group s the int32 sums
//   acc_s, pad_value outside the image, plus acc_offset[s, n] when given.
//   Output, as ssq_int8_conv:
//   - int32 sums (M, N) (S = 1, no scale table);
//   - the f32 scale-table sum 0 + sum_s float(acc_s) * (table[s, n] *
//     delta), each step rounded on its own (__fmul_rn, __fadd_rn) in s
//     order;
//   - with a Requant (requant.cuh), int8 codes: that value (float(acc) at
//     S = 1 without a table) through deploy's quantize_out, and with a
//     residual stage through the block's requant too.
//   The tiling's decisions come from ops/cuda/group_conv.py
//   group_conv_launch_plan as an int array (struct Plan); the entry
//   checks them against the shape and derives the rest (struct Tiling,
//   layout).
//
// Bound on an H100: bytes. RegNetX's grouped units have Cg = OCg = 8 to
// 56; at RegNetX-600M's 24 (K = 216) a code out costs 2 * 216 = 432 int8
// operations against one code read and one written, below the card's 590
// int8 operations per byte. So the products stay on mma.sync m16n8k32 s8:
// a 64-row wgmma tile buys nothing at 24 columns a group and 7 k-steps;
// what counts is moving each byte once with the loads in flight. The
// design, against the five faults of the first version (loads issued one
// at a time, index arithmetic per load, every tap gathered again from
// device memory, the weights reloaded by every block, one scattered store
// per output):
// - a block owns gb conv groups (two Cg = 24 groups are one 48-byte,
//   16-byte-aligned run of a pixel's channels) and one column tile of
//   them, and walks pixel tiles of whole output rows: th rows of one
//   image, or ni whole images where an image is small (7x7, 14x14), so
//   most of the warps' 16-row fragments hold real pixels;
// - a tile's input halo, ((th-1)*SH + KH) x ((Wo-1)*SW + KW) cells of the
//   run, comes into shared memory once, by 16-, 8- or 4-byte cp.async
//   (byte loads only where Cg is not a multiple of 4), the pad value
//   stored into cells outside the image; every tap's A fragment is then a
//   read at a fixed offset from its pixel's cell (tables of pixel and tap
//   offsets, built once per block): no index arithmetic per element. A
//   thread's 8 bytes of a k-step (k positions 4*t4.. and 16 + 4*t4.. of
//   the fragment) are one 8-byte read where they lie in one tap (Cg a
//   multiple of 8), in A and B alike; the cell stride is padded for at
//   most 2-way bank conflicts of those reads;
// - the block's weights for all S groups are staged once, rows padded to
//   32 mod 64 bytes (conflict-free B fragments), and the block walks its
//   tiles with the next tile's halo in flight (cp.async groups, two
//   buffers, one barrier a tile) while the current tile runs its MMAs; a
//   warp takes two 16-row fragments at once where their accumulators fit
//   (frags_per_warp), sharing each B fragment between them;
// - K is KH*KW taps of Cg channels (rounded up to 4 with zero weights),
//   padded to a whole k-step of 32 with ZERO WEIGHTS (never pad_value),
//   so padding adds nothing;
// - the epilogue, per 8*ntw-column chunk of a group: each warp computes
//   its pixels' values in the order of the first version (the column
//   terms in registers) into its own staging rows, then writes each
//   pixel's slice of the chunk in pieces of up to 16 bytes, neighbouring
//   lanes on neighbouring pieces (through the requant, requant.cuh
//   store_chunk, for codes).
// Measured on an H100 (chip_smoke.py phase 23, PERF.md section 6): 2.2x
// faster than the first version over RegNetX-600M's grouped units, yet
// 4-11x its bound per shape: the per-launch set-up, the fragment reads
// and the epilogue's instructions are not hidden at 16 warps an SM.
#include <cuda_runtime.h>
#include <stdint.h>

#include "requant.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int MAX_S = 4;
constexpr int MAX_SMEM = 232448;

// group_conv.LaunchPlan's decisions (group_conv.DECISIONS), field for
// field: all the entry takes of the plan
struct Plan {
  int gb, ctiles, ncols, ntw, nch, cw, cww, cgp, cpix, ni, th, grid_x, ovec,
      sw;
};

// 16-row fragments a warp takes at once: two, sharing each k-step's B
// fragments and tap offsets, where their accumulators (4 registers per
// 8-column MMA tile) stay within ACC_TILES tiles
constexpr int ACC_TILES = 16;
template <int S, int NTW>
__host__ __device__ constexpr int frags_per_warp() {
  return 2 * S * NTW <= ACC_TILES ? 2 : 1;
}

struct GConv {
  const int8_t* x;
  const int8_t* w;
  int B, H, W, C, KH, KW, SH, SW, PH, PW, Ho, Wo;
  int Cg, OCg, N, K;              // K = KH * KW * Cg
  int pad;                        // code outside the image
};

// The plan with what follows from it and the shape (LaunchPlan's other
// fields, which the wrapper does not pass)
struct Tiling : Plan {
  int mt;                         // frags_per_warp
  int hr;                         // halo rows per image
  int hwc;                        // halo cells per row
  int kp;                         // K in shared memory: KH*KW*cgp, to 32
  int tiles;                      // pixel tiles
  int grid_y;                     // sets * column tiles
};

Tiling tiling(const Plan& p, const GConv& cv, int S, int G) {
  Tiling t;
  static_cast<Plan&>(t) = p;
  t.mt = 2 * S * p.ntw <= ACC_TILES ? 2 : 1;
  t.hr = (p.th - 1) * cv.SH + cv.KH;
  t.hwc = (cv.Wo - 1) * cv.SW + cv.KW;
  t.kp = (cv.KH * cv.KW * p.cgp + 31) / 32 * 32;
  t.tiles = (cv.B + p.ni - 1) / p.ni * ((cv.Ho + p.th - 1) / p.th);
  t.grid_y = G / p.gb * p.ctiles;
  return t;
}

enum OutMode { OUT_I32 = 0, OUT_TABLE = 1, OUT_CODES = 2 };

struct Out {
  int mode;
  const float* table;             // (S, N) scale table, or null
  const int32_t* acc_offset;      // (S, N) or null
  const float* delta;             // device scalar
  void* out;
  Requant rq;                     // OUT_CODES
};

__host__ __device__ __forceinline__ int r16(int v) { return (v + 15) & ~15; }

// weight row stride: K' bytes padded to 32 mod 64, so the 8-byte B
// fragment reads of 4 rows (a half-warp) fall in distinct banks
__host__ __device__ __forceinline__ int weight_stride(int kp) {
  return kp % 64 == 32 ? kp : kp + 32;
}

// Byte offsets of the dynamic shared memory's parts (group_conv.smem_bytes
// sums them to plan the tiles): two halo buffers (at 0 and halo), the
// weights, the warps' staging rows, the requant columns, the scale-table
// and offset columns, the tap offsets and the pixel offsets.
struct Layout {
  int halo, wts, stage, req, sd, off, koff, pix, total;
};

__host__ __device__ __forceinline__ Layout layout(const Tiling& p, int S,
                                                  int Wo) {
  const int wbp = (p.gb * p.ncols + 3) & ~3;
  const int mf2 = ((p.ni * p.th * Wo + 15) / 16 + 1) & ~1;   // fragments,
                                                             // even
  Layout l;
  l.halo = r16(p.ni * p.hr * p.hwc * p.cpix);
  l.wts = 2 * l.halo;
  l.stage = l.wts
            + r16(S * p.gb * p.nch * p.ntw * 8 * weight_stride(p.kp));
  l.req = l.stage + r16(WARPS * 16 * p.mt * p.sw * 4);
  l.sd = l.req + r16(16 * wbp);
  l.off = l.sd + r16(4 * S * wbp);
  l.koff = l.off + r16(4 * S * wbp);
  l.pix = l.koff + r16(p.kp);
  l.total = l.pix + r16(64 * mf2);
  return l;
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const int (&a)[4],
                                       int b0, int b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ int lds32(const int8_t* p) {
  return *reinterpret_cast<const int*>(p);
}

__device__ __forceinline__ int2 lds64(const int8_t* p) {
  return *reinterpret_cast<const int2*>(p);
}


// CW bytes global -> shared, asynchronously; zeros where !valid
template <int CW>
__device__ __forceinline__ void cp_async(int8_t* dst, const int8_t* src,
                                         bool valid) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  if constexpr (CW == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 ::"r"(d), "l"(src), "r"(valid ? 16 : 0) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 ::"r"(d), "l"(src), "n"(CW), "r"(valid ? CW : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// CW bytes of the pad code (p4 holds it four times)
template <int CW>
__device__ __forceinline__ void store_pad(int8_t* d, uint32_t p4) {
  if constexpr (CW == 16)
    *reinterpret_cast<uint4*>(d) = make_uint4(p4, p4, p4, p4);
  else if constexpr (CW == 8)
    *reinterpret_cast<uint2*>(d) = make_uint2(p4, p4);
  else if constexpr (CW == 4)
    *reinterpret_cast<uint32_t*>(d) = p4;
  else
    *d = (int8_t)(p4 & 0xffu);
}

// The block's weights, once: row (s * gb + gi) * nch*ntw*8 + j holds output
// column c0 + j of conv group g0 + gi, k' = tap * cgp + ic; zero past the
// group's ncl columns, past Cg and past the taps. CW-byte copies (then
// cgp == Cg), or bytes.
template <int CW>
__device__ __forceinline__ void load_weights(int8_t* wts, const GConv& cv,
                                             const Tiling& p, int S, int g0,
                                             int c0, int ncl) {
  const int ntp8 = p.nch * p.ntw * 8, rs = weight_stride(p.kp);
  const int cpr = p.kp / CW;
  for (int i = threadIdx.x; i < S * p.gb * ntp8 * cpr; i += THREADS) {
    const int row = i / cpr, k = (i - row * cpr) * CW;
    const int sg = row / ntp8, j = row - sg * ntp8;
    const int s = sg / p.gb, gi = sg - s * p.gb;
    const size_t n = (size_t)s * cv.N + (g0 + gi) * cv.OCg + c0 + j;
    int8_t* d = wts + row * rs + k;
    if constexpr (CW == 1) {
      const int tap = k / p.cgp, ic = k - tap * p.cgp;
      const bool ok = j < ncl && tap < cv.KH * cv.KW && ic < cv.Cg;
      *d = ok ? __ldg(cv.w + n * cv.K + tap * cv.Cg + ic) : (int8_t)0;
    } else {
      const bool ok = j < ncl && k < cv.K;
      cp_async<CW>(d, ok ? cv.w + n * cv.K + k : cv.w, ok);
    }
  }
}

// Pixel tile t's input halo into buf: rows (image ni, halo row hr) of hwc
// cells, cpix bytes apart, each the run of gb * Cg channels from cbase;
// cells outside the image (or past B) take the pad code. Warp w takes
// rows w, w + 8, ...; its lanes walk a row's (cell, CW-byte chunk) pairs,
// stepping without a division.
template <int CW>
__device__ __forceinline__ void load_halo(int8_t* buf, const GConv& cv,
                                          const Tiling& p, int t, int cbase,
                                          uint32_t pad4) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nb = (cv.Ho + p.th - 1) / p.th;
  const int bi = t / nb, hb = t - bi * nb;
  const int b0 = bi * p.ni, hi0 = hb * p.th * cv.SH - cv.PH;
  const int cpc = p.gb * cv.Cg / CW;             // chunks per cell
  const int dcol = 32 / cpc, dch = 32 - dcol * cpc;
  const int col0 = lane / cpc, ch0 = lane - col0 * cpc;
  for (int r = warp; r < p.ni * p.hr; r += WARPS) {
    const int ni = r / p.hr, hi = hi0 + r - ni * p.hr, b = b0 + ni;
    const bool row_in = b < cv.B && hi >= 0 && hi < cv.H;
    const int8_t* src = cv.x + cbase
        + (row_in ? ((size_t)b * cv.H + hi) * cv.W * cv.C : 0);
    int8_t* dst = buf + r * p.hwc * p.cpix;
    for (int col = col0, ch = ch0; col < p.hwc;) {
      const int wi = col - cv.PW;
      int8_t* d = dst + col * p.cpix + ch * CW;
      if (row_in && wi >= 0 && wi < cv.W) {
        const int8_t* s = src + (size_t)wi * cv.C + ch * CW;
        if constexpr (CW == 1)
          *d = __ldg(s);
        else
          cp_async<CW>(d, s, true);
      } else {
        store_pad<CW>(d, pad4);
      }
      col += dcol, ch += dch;
      if (ch >= cpc) ch -= cpc, ++col;
    }
  }
}

__device__ __forceinline__ void issue_halo(int8_t* buf, const GConv& cv,
                                           const Tiling& p, int t, int cbase,
                                           uint32_t pad4) {
  switch (p.cw) {
    case 16: load_halo<16>(buf, cv, p, t, cbase, pad4); break;
    case 8: load_halo<8>(buf, cv, p, t, cbase, pad4); break;
    case 4: load_halo<4>(buf, cv, p, t, cbase, pad4); break;
    default: load_halo<1>(buf, cv, p, t, cbase, pad4);
  }
}

// Pass 2 of one warp: its rows of one column chunk staged at st (row
// stride sw floats; tile pixels l0.., those at or past count skipped),
// each row's wch values in OV-element pieces to out columns nb.. (block
// column cb.. for the requant terms), through the requant for codes. The
// lanes walk the pieces in row order, so neighbouring lanes write
// neighbouring pieces.
template <int OV>
__device__ __forceinline__ void store_rows(const float* st, int sw, int wch,
                                           int rows, int l0, int count,
                                           int m0, int nb, int cb, int mode,
                                           const Out& o,
                                           const RequantScalars& rs,
                                           const float* req, int wbp,
                                           int N) {
  const int cpr = wch / OV, lane = threadIdx.x & 31;
  const int dr = 32 / cpr, dc = 32 - dr * cpr;
  int r = lane / cpr, c = lane - r * cpr;
#pragma unroll 1
  while (r < rows && l0 + r < count) {
    float v[OV];
    load_cols<OV, false>(v, st + r * sw + c * OV);
    store_chunk<OV>(v, mode, o.rq, rs, req, wbp, cb + c * OV,
                    (size_t)(m0 + l0 + r) * N + nb + c * OV, o.out);
    r += dr, c += dc;
    if (c >= cpr) c -= cpr, ++r;
  }
}

template <int S, int NTW>
__global__ void __launch_bounds__(THREADS, 2)
group_conv_kernel(GConv cv, Out o, Tiling p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(p, S, cv.Wo);
  int8_t* wts = reinterpret_cast<int8_t*>(smem + L.wts);
  float* req = reinterpret_cast<float*>(smem + L.req);
  float* col_sd = reinterpret_cast<float*>(smem + L.sd);
  int* col_off = reinterpret_cast<int*>(smem + L.off);
  int* koff = reinterpret_cast<int*>(smem + L.koff);
  int* pixoff = reinterpret_cast<int*>(smem + L.pix);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, t4 = lane & 3;
  constexpr int MT = frags_per_warp<S, NTW>();
  float* st = reinterpret_cast<float*>(smem + L.stage)
              + warp * 16 * MT * p.sw;          // the warp's staged values

  const int set = blockIdx.y / p.ctiles, ct = blockIdx.y - set * p.ctiles;
  const int g0 = set * p.gb, c0 = ct * p.ncols;
  const int ncl = min(p.ncols, cv.OCg - c0);     // columns of each group
  const int wb = p.gb * ncl, wbp = (p.gb * p.ncols + 3) & ~3;
  const int n0 = g0 * cv.OCg + c0;               // block column c: n0 + c
  const int cbase = g0 * cv.Cg;
  const int tm = p.ni * p.th * cv.Wo;
  const uint32_t pad4 = (uint32_t)(uint8_t)cv.pad * 0x01010101u;

  switch (p.cww) {
    case 16: load_weights<16>(wts, cv, p, S, g0, c0, ncl); break;
    case 8: load_weights<8>(wts, cv, p, S, g0, c0, ncl); break;
    case 4: load_weights<4>(wts, cv, p, S, g0, c0, ncl); break;
    default: load_weights<1>(wts, cv, p, S, g0, c0, ncl);
  }
  int t = blockIdx.x;
  issue_halo(reinterpret_cast<int8_t*>(smem), cv, p, t, cbase, pad4);
  cp_commit();

  // per-column epilogue terms of the block's columns: table[s, n] * delta,
  // acc_offset[s, n] and the requant's m1, c1, m2, c2 (0 where absent)
  const float delta = o.delta ? *o.delta : 0.0f;
  for (int i = tid; i < S * wbp; i += THREADS) {
    const int s = i / wbp, c = i - s * wbp;
    const size_t n = (size_t)s * cv.N + n0 + c;
    col_sd[i] = c < wb && o.table ? __fmul_rn(o.table[n], delta) : 0.0f;
    col_off[i] = c < wb && o.acc_offset ? o.acc_offset[n] : 0;
  }
  if (o.mode == OUT_CODES) {
    for (int i = tid; i < 4 * wbp; i += THREADS) {
      const int k = i / wbp, c = i - k * wbp;
      const float* q = k == 0 ? o.rq.m1 : k == 1 ? o.rq.c1
                       : k == 2 ? o.rq.m2 : o.rq.c2;
      req[i] = q != nullptr && c < wb ? q[n0 + c] : 0.0f;
    }
  }
  // tap offsets: word k'/4 -> its tap's cell from the pixel's, plus ic
  for (int i = tid; i < p.kp / 4; i += THREADS) {
    const int k = 4 * i, tap = k / p.cgp, ic = k - tap * p.cgp;
    const int kh = tap / cv.KW, kw = tap - kh * cv.KW;
    koff[i] = tap < cv.KH * cv.KW ? (kh * p.hwc + kw) * p.cpix + ic : 0;
  }
  // pixel offsets: tile pixel l -> the cell of its first tap (0 past the
  // tile's pixels, whose rows are never stored), for an even number of
  // fragments
  for (int l = tid; l < ((tm + 15) / 16 + 1) / 2 * 32; l += THREADS) {
    int v = 0;
    if (l < tm) {
      const int per = p.th * cv.Wo, ni = l / per, r = l - ni * per;
      const int th = r / cv.Wo, wo = r - th * cv.Wo;
      v = ((ni * p.hr + th * cv.SH) * p.hwc + wo * cv.SW) * p.cpix;
    }
    pixoff[l] = v;
  }
  RequantScalars rs{};
  if (o.mode == OUT_CODES) rs = requant_scalars(o.rq);

  const int ntp8 = p.nch * NTW * 8, rstride = weight_stride(p.kp);
  const int nks = p.kp / 32;
  const bool wide = p.cgp % 8 == 0;    // a thread's 8 bytes of a k-step
                                       // lie in one tap: one 8-byte read
  const int mode = o.mode == OUT_CODES ? STORE_CODES
                   : o.mode == OUT_I32 ? STORE_I32 : STORE_F32;
  // 16-byte pieces: 16 codes, or 4 sums
  const int ov = o.mode == OUT_CODES ? p.ovec : min(p.ovec, 4);
  const int nb = (cv.Ho + p.th - 1) / p.th;
  for (int it = 0; t < p.tiles; ++it, t += gridDim.x) {
    cp_wait_all();
    __syncthreads();               // tile t's halo is in, and every warp is
                                   // done with the other buffer
    const int8_t* buf =
        reinterpret_cast<const int8_t*>(smem) + (it & 1) * L.halo;
    if (t + (int)gridDim.x < p.tiles) {
      issue_halo(reinterpret_cast<int8_t*>(smem) + ((it + 1) & 1) * L.halo,
                 cv, p, t + gridDim.x, cbase, pad4);
      cp_commit();
    }
    const int bi = t / nb, hb = t - bi * nb;
    const int b0 = bi * p.ni, ho0 = hb * p.th;
    const int count =
        min(p.ni, cv.B - b0) * min(p.th, cv.Ho - ho0) * cv.Wo;
    const int m0 = (b0 * cv.Ho + ho0) * cv.Wo;   // the tile's pixels are
                                                 // m0 .. m0 + count - 1
    for (int f = warp; f * 16 * MT < count; f += WARPS) {
      const int l0 = f * 16 * MT;                // the warp's first pixel
      const int8_t* ap[MT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        ap[mt][0] = buf + pixoff[l0 + mt * 16 + gq];
        ap[mt][1] = buf + pixoff[l0 + mt * 16 + gq + 8];
      }
      for (int gi = 0; gi < p.gb; ++gi) {
        const int goff = gi * cv.Cg;
        for (int chn = 0; chn < p.nch; ++chn) {
          int acc[MT][S][NTW][4];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int s = 0; s < S; ++s)
#pragma unroll
              for (int j = 0; j < NTW; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[mt][s][j][e] = 0;
          // B fragment rows (s * gb + gi) * ntp8 + chn*NTW*8 + j*8 + gq
          const int8_t* bp0 =
              wts + (gi * ntp8 + chn * NTW * 8 + gq) * rstride + t4 * 8;
#pragma unroll 2
          for (int ks = 0; ks < nks; ++ks) {
            // thread t4 takes bytes 8*t4.. of the k-step for k positions
            // 4*t4.. (a0, a1, b0) and 16 + 4*t4.. (a2, a3, b1) of the
            // m16n8k32 fragments, in A (rows gq, gq + 8) and B alike
            const int2 kk = *reinterpret_cast<const int2*>(
                koff + ks * 8 + 2 * t4);
            const int k0 = kk.x + goff, k1 = kk.y + goff;
            int a[MT][4];
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              if (wide) {
                const int2 r0 = lds64(ap[mt][0] + k0);
                const int2 r1 = lds64(ap[mt][1] + k0);
                a[mt][0] = r0.x, a[mt][2] = r0.y;
                a[mt][1] = r1.x, a[mt][3] = r1.y;
              } else {
                a[mt][0] = lds32(ap[mt][0] + k0);
                a[mt][1] = lds32(ap[mt][1] + k0);
                a[mt][2] = lds32(ap[mt][0] + k1);
                a[mt][3] = lds32(ap[mt][1] + k1);
              }
            }
#pragma unroll
            for (int s = 0; s < S; ++s)
#pragma unroll
              for (int j = 0; j < NTW; ++j) {
                const int2 b = lds64(
                    bp0 + (s * p.gb * ntp8 + j * 8) * rstride + ks * 32);
#pragma unroll
                for (int mt = 0; mt < MT; ++mt)
                  mma_s8(acc[mt][s][j], a[mt], b.x, b.y);
              }
          }
          // this lane's columns (chn*NTW + j)*8 + 2*t4 + e of group gi:
          // their scale-table and offset terms, 0 past the group
          float csd[S][NTW][2];
          int coff[S][NTW][2];
#pragma unroll
          for (int s = 0; s < S; ++s)
#pragma unroll
            for (int j = 0; j < NTW; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int cl = (chn * NTW + j) * 8 + 2 * t4 + e;
                const int c = s * wbp + gi * ncl + cl;
                csd[s][j][e] = cl < ncl ? col_sd[c] : 0.0f;
                coff[s][j][e] = cl < ncl ? col_off[c] : 0;
              }
          // pass 1: accumulators 2h, 2h + 1 of tile j are row gq + 8h,
          // columns j*8 + 2*t4 (+1) of the chunk: their values, as the
          // first version computed them, staged in pairs
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int j = 0; j < NTW; ++j)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                float v[2];
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  if (o.table == nullptr) {
                    const int sum = acc[mt][0][j][2 * h + e] + coff[0][j][e];
                    v[e] = o.mode == OUT_I32 ? __int_as_float(sum)
                                             : (float)sum;
                  } else {
                    v[e] = 0.0f;
#pragma unroll
                    for (int s = 0; s < S; ++s)
                      v[e] = __fadd_rn(v[e], __fmul_rn(
                          (float)(acc[mt][s][j][2 * h + e] + coff[s][j][e]),
                          csd[s][j][e]));
                  }
                }
                *reinterpret_cast<float2*>(
                    st + (mt * 16 + gq + 8 * h) * p.sw + j * 8 + 2 * t4) =
                    make_float2(v[0], v[1]);
              }
          __syncwarp();
          // pass 2: the chunk's columns of each pixel, 16 bytes a piece
          const int cb = gi * ncl + chn * NTW * 8;
          const int wch = min(NTW * 8, ncl - chn * NTW * 8);
          switch (ov) {
            case 16: store_rows<16>(st, p.sw, wch, 16 * MT, l0, count, m0,
                                    n0 + cb, cb, mode, o, rs, req, wbp,
                                    cv.N); break;
            case 8: store_rows<8>(st, p.sw, wch, 16 * MT, l0, count, m0,
                                  n0 + cb, cb, mode, o, rs, req, wbp,
                                  cv.N); break;
            case 4: store_rows<4>(st, p.sw, wch, 16 * MT, l0, count, m0,
                                  n0 + cb, cb, mode, o, rs, req, wbp,
                                  cv.N); break;
            default: store_rows<1>(st, p.sw, wch, 16 * MT, l0, count, m0,
                                   n0 + cb, cb, mode, o, rs, req, wbp,
                                   cv.N);
          }
          __syncwarp();            // the rows are out before the next
                                   // chunk overwrites them
        }
      }
    }
  }
}

// The plan's decisions against the shape: what the kernel relies on
bool plan_fits(const Plan& p, const GConv& cv, int S, int G) {
  auto is_w = [](int v) { return v == 16 || v == 8 || v == 4 || v == 1; };
  const int ntc = (p.ncols + 7) / 8;
  const int run = p.gb * cv.Cg;
  if (!(p.gb >= 1 && G % p.gb == 0 && p.ctiles >= 1
        && (p.gb == 1 || p.ctiles == 1)
        && p.ncols >= 1 && p.ncols * p.ctiles >= cv.OCg
        && p.ncols * (p.ctiles - 1) < cv.OCg
        && (p.ctiles == 1 ? p.ncols == cv.OCg : p.ncols % 8 == 0)
        && p.ntw >= 1 && p.ntw <= 4 && p.nch * p.ntw >= ntc
        && is_w(p.cw) && run % p.cw == 0
        && is_w(p.cww) && cv.K % p.cww == 0
        && p.cgp >= cv.Cg && p.cgp % 4 == 0 && p.cgp - cv.Cg < 4
        && (p.gb == 1 || p.cgp == cv.Cg) && (p.cww == 1 || p.cgp == cv.Cg)
        && p.cpix >= p.gb * p.cgp && p.cpix % 4 == 0 && p.cpix % p.cw == 0
        && p.ni >= 1 && p.th >= 1 && p.th <= cv.Ho
        && (p.ni == 1 || p.th == cv.Ho) && p.grid_x >= 1
        && is_w(p.ovec) && cv.N % p.ovec == 0 && cv.OCg % p.ovec == 0
        && p.ncols % p.ovec == 0
        && (uintptr_t)cv.x % p.cw == 0 && (uintptr_t)cv.w % p.cww == 0
        && p.sw % 8 == 0 && p.sw >= 8 * p.ntw
        && (p.nch == 1 || 8 * p.ntw % p.ovec == 0)))
    return false;
  const Tiling t = tiling(p, cv, S, G);
  return p.grid_x <= t.tiles && t.grid_y <= 65535
         && layout(t, S, cv.Wo).total <= MAX_SMEM;
}

template <int S, int NTW>
int launch(const GConv& cv, const Out& o, const Tiling& p,
           cudaStream_t stream) {
  static bool sized = false;
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(&group_conv_kernel<S, NTW>),
        cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  group_conv_kernel<S, NTW><<<dim3(p.grid_x, p.grid_y), THREADS,
                              layout(p, S, cv.Wo).total, stream>>>(cv, o,
                                                                   p);
  return (int)cudaGetLastError();
}

template <int S>
int dispatch_ntw(const GConv& cv, const Out& o, const Tiling& p,
                 cudaStream_t stream) {
  switch (p.ntw) {
    case 1: return launch<S, 1>(cv, o, p, stream);
    case 2: return launch<S, 2>(cv, o, p, stream);
    case 3: return launch<S, 3>(cv, o, p, stream);
    default: return launch<S, 4>(cv, o, p, stream);
  }
}

}  // namespace

extern "C" int ssq_int8_group_conv(const void* x, const void* w,
                                   const void* table, const void* acc_offset,
                                   const void* delta, void* out, int S, int B,
                                   int H, int W, int C, int KH, int KW,
                                   int SH, int SW, int PH, int PW, int N,
                                   int G, int pad, const void* plan,
                                   const void* requant, void* stream) {
  if (S < 1 || S > MAX_S || (table == nullptr && S != 1) || G < 1
      || C % G != 0 || N % G != 0 || plan == nullptr)
    return (int)cudaErrorInvalidValue;
  const int Ho = (H + 2 * PH - KH) / SH + 1, Wo = (W + 2 * PW - KW) / SW + 1;
  if (B <= 0 || Ho <= 0 || Wo <= 0 || N <= 0 || C <= 0) return 0;
  const GConv cv{(const int8_t*)x, (const int8_t*)w, B, H, W, C, KH, KW,
                 SH, SW, PH, PW, Ho, Wo, C / G, N / G, N,
                 KH * KW * (C / G), pad};
  if (!plan_fits(*(const Plan*)plan, cv, S, G))
    return (int)cudaErrorInvalidValue;
  const Tiling p = tiling(*(const Plan*)plan, cv, S, G);
  Out o{};
  o.mode = requant ? OUT_CODES : (table ? OUT_TABLE : OUT_I32);
  o.table = (const float*)table;
  o.acc_offset = (const int32_t*)acc_offset;
  o.delta = (const float*)delta;
  o.out = out;
  if (requant) o.rq = *(const Requant*)requant;
  cudaStream_t st = (cudaStream_t)stream;
  switch (S) {
    case 1: return dispatch_ntw<1>(cv, o, p, st);
    case 2: return dispatch_ntw<2>(cv, o, p, st);
    case 3: return dispatch_ntw<3>(cv, o, p, st);
    default: return dispatch_ntw<4>(cv, o, p, st);
  }
}
