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
// bound. What the card spends is instructions: at 5x5 ten dp4a an output
// channel at the least, on the integer pipe that issues at half the f32
// rate. The first version (one channel a lane, a fixed 8 x 16 tile of 32
// channels, byte reads and stores) ran MNASNet's 11 launches in 3.68 ms
// against a 0.39 ms bound; builds of it without stores, without the
// arithmetic and with the staging alone put 39% of that in the epilogue
// and its byte stores, 35% in the arithmetic (a third of it on outputs
// past the plane's edge) and 26% in staging (PERF.md). The design:
// - One output column and 4 channels a thread, for a band of output rows
//   (as csrc/dw_conv3x3.cu): each input row of the band is read once, as
//   K 4-byte words (4 channels of K columns), and feeds the output rows in
//   flight, whose sums rotate through (K + ST - 1) / ST slots known at
//   compile time. No thread computes a row or a column past the plane.
// - Tiles fitted to the shape (choose_tile, on the host): a slab of cs
//   channels, a tile of cb columns (blocks of at most 128 threads, which
//   left more of them resident than 256-thread ones and ran faster), a
//   band of up to 32 rows; a 7x7 or 14x14 plane is one band and one
//   column tile.
// - Staging by cp.async: the band's halo, (rb - 1) * ST + K rows of (cb -
//   1) * ST + K columns of the slab, lands in shared memory in 16-byte
//   cp.async.cg pieces (C % 16 == 0 and 16-byte aligned codes: every path
//   shape), else 4-byte cp.async.ca pieces, else bytes; pieces outside
//   the image are stored as pad_value words (the copy's zero fill serves
//   pad 0 only). The taps and the epilogue terms are read while it is in
//   flight; several blocks are resident on an SM.
// - dp4a: 8 __byte_perm regroup a row's columns 0-3 to one word per
//   channel, one __dp4a adds taps 0-3 (tap 3's weight byte is 0 at 3x3)
//   and at 5x5 one more adds tap 4 straight from the column-4 word, its
//   weight stored in the channel's byte. The taps are packed once per
//   block from w_mat into shared memory and held in registers at S = 1.
//   Sums stay exact int32.
// - A word-wide epilogue: the per-channel terms (acc offsets, table
//   products, requant columns) in registers, loaded once per thread; an
//   output pixel's 4 channels leave in one 4-byte store of codes (one
//   16-byte store of f32 or int32), through requant.cuh's
//   store_codes_fast (no conversion instruction) where its integer grid
//   bounds allow, else store_chunk_cols; a byte path where C % 4 != 0.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "requant.cuh"

namespace {

constexpr int MAX_THREADS = 128;
// resident blocks an SM, at least: 128 registers a thread at 5x5 (fewer
// spilled and ran slower), 85 at 3x3
constexpr int min_blocks(int K) { return K == 3 ? 6 : 4; }
constexpr int MAX_SMEM = 48 * 1024;     // the halo and the packed taps
constexpr int MAX_ROWS = 32;            // output rows a band, at most
constexpr int MAX_S = 4;

enum Mode { OUT_I32 = 0, OUT_TABLE = 1, OUT_CODES = 2 };

struct Tile {
  int cs;       // channels a block (a multiple of 4)
  int cb;       // output columns a block, one a thread
  int rb;       // output rows a band
  int smem;     // bytes
};

struct DwArgs {
  const int8_t* x;
  const int8_t* w;               // (S, C, K*K)
  const float* table;            // (S, C) or null
  const int32_t* acc_offset;     // (S, C) or null
  const float* delta;            // device scalar, with the table
  void* out;
  int H, W, C, Ho, Wo, pad, mode;
  int cp;                        // staging piece: 16 or 4 bytes, 1: bytes
  int wide;                      // a pixel's 4 channels in one store
  int cs, rb, n_slab, n_ct;      // slab, band rows, slabs, column tiles
  Requant rq;
};

__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         int bytes) {
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
                 "l"(src));
}

// The taps 0-3 of one kernel row for 4 channels: words x0..x3 hold 4
// channels of 4 consecutive input columns; t[j] gets channel j's codes of
// the 4 columns, column 0 in byte 0 (at 3x3, x3 is any word: tap 3's
// weight byte is 0).
__device__ __forceinline__ void transpose4(uint32_t x0, uint32_t x1,
                                           uint32_t x2, uint32_t x3,
                                           uint32_t (&t)[4]) {
  const uint32_t a01 = __byte_perm(x0, x1, 0x5140);  // x0.0 x1.0 x0.1 x1.1
  const uint32_t a23 = __byte_perm(x0, x1, 0x7362);  // x0.2 x1.2 x0.3 x1.3
  const uint32_t b01 = __byte_perm(x2, x3, 0x5140);
  const uint32_t b23 = __byte_perm(x2, x3, 0x7362);
  t[0] = __byte_perm(a01, b01, 0x5410);
  t[1] = __byte_perm(a01, b01, 0x7632);
  t[2] = __byte_perm(a23, b23, 0x5410);
  t[3] = __byte_perm(a23, b23, 0x7632);
}

// One block: image blockIdx.z, output rows [oy0, oy0 + rb) with oy0 =
// blockIdx.y * rb, column tile and channel slab from blockIdx.x (slab
// fastest). threadIdx.x is the thread's 4-channel group g in the slab,
// threadIdx.y its output column in the tile. Shared memory: the slab's
// taps ws[S][K][2][cs] (int; tap 4's word pre-shifted to the channel's
// byte), then the halo xs[row][col][cs] (bytes).
template <int K, int ST, int S>
__global__ void __launch_bounds__(MAX_THREADS, min_blocks(K))
    dw_conv_int8_kernel(const DwArgs a) {
  constexpr int NS = (K + ST - 1) / ST;   // output rows in flight
  constexpr int PER = ST * NS;            // input rows a rotation
  extern __shared__ __align__(16) unsigned char smem[];
  const int cs = a.cs, G = cs / 4, C = a.C;
  int* const ws = reinterpret_cast<int*>(smem);
  unsigned char* const xs = smem + S * K * 2 * cs * 4;
  const int g = threadIdx.x, col = threadIdx.y;
  const int tid = col * G + g, nthr = G * blockDim.y;
  const int slab = blockIdx.x % a.n_slab, ct = blockIdx.x / a.n_slab;
  const int b = blockIdx.z, c0 = slab * cs;
  const int cb = blockDim.y;
  const int oy0 = blockIdx.y * a.rb, ox0 = ct * cb;
  const int nrows = min(a.rb, a.Ho - oy0);
  const int ncols = min(cb, a.Wo - ox0);
  const int nin = (nrows - 1) * ST + K;                 // halo rows
  const int icols = (cb - 1) * ST + K;                  // row stride
  const int ic = (ncols - 1) * ST + K;                  // staged columns
  const int iy0 = oy0 * ST - K / 2, ix0 = ox0 * ST - K / 2;
  const size_t rowstep = (size_t)a.W * C;
  const int rowbytes = icols * cs;

  // the halo, as (row, column, piece) items, pad_value outside the image.
  // Where a row has fewer items than the block has threads, a thread
  // keeps one (column, piece) and takes every rpp-th row; else the
  // threads walk each row.
  {
    const int8_t* img = a.x + (size_t)b * a.H * rowstep;
    const int pw = a.cp, ppp = cs / pw;
    const uint32_t padw = (uint32_t)(uint8_t)a.pad * 0x01010101u;
    const uint32_t xs0 = (uint32_t)__cvta_generic_to_shared(xs);
    auto stage = [&](int r, int x, int q) {
      const int y = iy0 + r, gx = ix0 + x, c = c0 + q * pw;
      const int off = r * rowbytes + x * cs + q * pw;
      const bool inside =
          y >= 0 && y < a.H && gx >= 0 && gx < a.W && c < C;
      const int8_t* src = img + y * rowstep + gx * C + c;
      const uint32_t fill = c < C ? padw : 0u;
      if (pw == 1) {
        xs[off] = inside ? (unsigned char)*src : (unsigned char)fill;
      } else if (inside) {
        cp_async(xs0 + off, src, pw);
      } else if (pw == 16) {
        *reinterpret_cast<uint4*>(xs + off) =
            make_uint4(fill, fill, fill, fill);
      } else {
        *reinterpret_cast<uint32_t*>(xs + off) = fill;
      }
    };
    const int row_items = ic * ppp;
    if (row_items >= nthr) {
      for (int r = 0; r < nin; ++r)
        for (int k = tid; k < row_items; k += nthr) {
          const int x = k / ppp;
          stage(r, x, k - x * ppp);
        }
    } else {
      const int rpp = nthr / row_items, k = tid % row_items;
      const int x = k / ppp, q = k - x * ppp;
      if (tid < rpp * row_items)
        for (int r = tid / row_items; r < nin; r += rpp) stage(r, x, q);
    }
    if (pw != 1) asm volatile("cp.async.commit_group;\n" ::);
  }

  // the slab's taps per (group, kernel row, channel): taps 0-3 in one
  // word (byte j = tap j), tap 4 in a second word at byte cl % 4, the
  // byte of the channel in an input word
  const int dsk = nthr / cs, dcl = nthr % cs;
  for (int sk = tid / cs, cl = tid % cs; sk < S * K;) {
    const int c = c0 + cl, s = sk / K, kr = sk - s * K;
    uint32_t w03 = 0u, w4 = 0u;
    if (c < C) {
      const int8_t* wp = a.w + ((size_t)s * C + c) * (K * K) + kr * K;
#pragma unroll
      for (int j = 0; j < (K < 4 ? K : 4); ++j)
        w03 |= (uint32_t)(uint8_t)wp[j] << (8 * j);
      if (K == 5) w4 = (uint32_t)(uint8_t)wp[4] << (8 * (cl % 4));
    }
    ws[(sk * 2) * cs + cl] = (int)w03;
    ws[(sk * 2 + 1) * cs + cl] = (int)w4;
    cl += dcl, sk += dsk;
    if (cl >= cs) cl -= cs, ++sk;
  }

  // the thread's channels and their epilogue terms
  const int c = c0 + 4 * g;
  const int ox = ox0 + col;
  const bool active = col < ncols && c < C;
  const float delta = a.delta ? __ldg(a.delta) : 0.0f;
  int co[S][4];
  float sd[S][4];
  RegCols<4> rc;
  RequantScalars sc{};
  bool fast = false;
  if (active) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool ok = c + j < C;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        co[s][j] = ok && a.acc_offset ? __ldg(a.acc_offset + s * C + c + j)
                                      : 0;
        sd[s][j] = ok && a.table
                       ? __fmul_rn(__ldg(a.table + s * C + c + j), delta)
                       : 0.0f;
      }
    }
    if (a.mode == OUT_CODES) {
      sc = requant_scalars(a.rq);
      const float* p[4] = {a.rq.m1, a.rq.c1, a.rq.m2, a.rq.c2};
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          rc.t[t][j] = p[t] && c + j < C ? __ldg(p[t] + c + j) : 0.0f;
      // without conversion instructions where that is exact: |acc| <=
      // 25 * 128 * 128 < 2^19, so acc + co stays below 2^22 for |co| <=
      // 2^21
      bool small = true;
#pragma unroll
      for (int j = 0; j < 4; ++j) small = small && abs(co[0][j]) <= (1 << 21);
      fast = a.wide && (a.table != nullptr || small)
             && requant_fast_ok(a.rq, sc);
    }
  }

  if (a.cp != 1) asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
  if (!active) return;

  // the taps of the thread's 4 channels: S = 1 in registers, else read
  // from shared memory as they are used
  int wreg[S == 1 ? K : 1][2][4];
  auto taps = [&](int s, int kr, int (&w03)[4], int (&w4)[4]) {
    const int4 u = *reinterpret_cast<const int4*>(
        ws + ((s * K + kr) * 2) * cs + 4 * g);
    const int4 v = *reinterpret_cast<const int4*>(
        ws + ((s * K + kr) * 2 + 1) * cs + 4 * g);
    w03[0] = u.x, w03[1] = u.y, w03[2] = u.z, w03[3] = u.w;
    w4[0] = v.x, w4[1] = v.y, w4[2] = v.z, w4[3] = v.w;
  };
  if (S == 1) {
#pragma unroll
    for (int kr = 0; kr < K; ++kr) taps(0, kr, wreg[S == 1 ? kr : 0][0],
                                        wreg[S == 1 ? kr : 0][1]);
  }

  const int mode = a.mode == OUT_CODES ? STORE_CODES
                   : a.mode == OUT_I32 ? STORE_I32 : STORE_F32;
  const size_t out_row = (size_t)a.Wo * C;
  const size_t o_col = (((size_t)b * a.Ho + oy0) * a.Wo + ox) * C + c;
  // output row o (of the band) from its sums
  auto emit = [&](auto fast_tag, int o, const int (&acc)[S][4]) {
    constexpr bool F = decltype(fast_tag)::value;
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (a.table != nullptr) {
        v[j] = 0.0f;
#pragma unroll
        for (int s = 0; s < S; ++s)
          v[j] = __fadd_rn(v[j], __fmul_rn((float)(acc[s][j] + co[s][j]),
                                           sd[s][j]));
      } else {
        const int sum = acc[0][j] + co[0][j];
        v[j] = a.mode == OUT_I32 ? __int_as_float(sum)
               : F ? small_int_to_float(sum) : (float)sum;
      }
    }
    const size_t oo = o_col + (size_t)o * out_row;
    if (F) {
      store_codes_fast<4>(v, a.rq, sc, rc, oo, a.out);
    } else if (a.wide) {
      store_chunk_cols<4>(v, mode, a.rq, sc, rc, oo, a.out);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (c + j >= C) break;
        float v1[1] = {v[j]};
        RegCols<1> r1;
#pragma unroll
        for (int k = 0; k < 4; ++k) r1.t[k][0] = rc.t[k][j];
        store_chunk_cols<1>(v1, mode, a.rq, sc, r1, oo + j, a.out);
      }
    }
  };

  // The band's input rows in order. Input row i feeds output rows o =
  // (i - kr) / ST (kr = i - o * ST in 0..K-1); their sums rotate through
  // NS slots, slot o % NS, so with PER = ST * NS rows a turn each slot is
  // known at compile time. Output row o starts at kr = 0 and is complete
  // after kr = K - 1.
  const unsigned char* const rd = xs + col * ST * cs + 4 * g;
  const int last = (nrows - 1) * ST;     // the last row an output starts at
  auto run_rows = [&](auto fast_tag) {
    int acc[NS][S][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int s = 0; s < S; ++s)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[n][s][j] = 0;
    // PER input rows from i0; with CHECK, rows past the halo and kernel
    // rows of output rows outside the band are skipped (a turn with every
    // row inside needs no check)
    auto turn = [&](auto check_tag, int i0) {
      constexpr bool CHECK = decltype(check_tag)::value;
#pragma unroll
      for (int ph = 0; ph < PER; ++ph) {
        const int i = i0 + ph;
        if (CHECK && i >= nin) break;
        const unsigned char* p = rd + i * rowbytes;
        uint32_t x[K < 5 ? 4 : 5];
#pragma unroll
        for (int q = 0; q < K; ++q)
          x[q] = *reinterpret_cast<const uint32_t*>(p + q * cs);
        if (K == 3) x[3] = x[2];
        uint32_t t[4];
        transpose4(x[0], x[1], x[2], x[3], t);
#pragma unroll
        for (int kr = 0; kr < K; ++kr) {
          if ((ph - kr + PER * K) % ST != 0
              || (CHECK && (i < kr || i - kr > last)))
            continue;
          const int n = ((ph - kr + PER * K) / ST) % NS;
#pragma unroll
          for (int s = 0; s < S; ++s) {
            int w03[4], w4[4];
            if (S == 1) {
#pragma unroll
              for (int j = 0; j < 4; ++j)
                w03[j] = wreg[S == 1 ? kr : 0][0][j],
                w4[j] = wreg[S == 1 ? kr : 0][1][j];
            } else {
              taps(s, kr, w03, w4);
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              int v = __dp4a((int)t[j], w03[j], kr == 0 ? 0 : acc[n][s][j]);
              if (K == 5) v = __dp4a((int)x[4], w4[j], v);
              acc[n][s][j] = v;
            }
          }
        }
        // the output row that input row i completes
        if ((ph - (K - 1) + PER * K) % ST == 0 && (!CHECK || i >= K - 1)) {
          const int o = (i - (K - 1)) / ST;
          const int n = ((ph - (K - 1) + PER * K) / ST) % NS;
          if (!CHECK || o < nrows) emit(fast_tag, o, acc[n]);
        }
      }
    };
    for (int i0 = 0; i0 < nin; i0 += PER) {
      if (i0 >= K - 1 && i0 + PER - 1 <= last)
        turn(std::false_type{}, i0);
      else
        turn(std::true_type{}, i0);
    }
  };
  if (fast)
    run_rows(std::true_type{});
  else
    run_rows(std::false_type{});
}

// The block tile for a shape: over slabs cs (multiples of 16 where C %
// 16 == 0, else of 4, up to 256 channels, the last slab partial where cs
// does not divide C), the column tile cb that fills the block to about
// MAX_THREADS threads (one a column and 4 channels; blocks of that size
// left more of them resident than 256-thread ones and ran faster at
// every path shape), evened out over Wo,
// and the band rb (at most MAX_ROWS rows) whose halo fits MAX_SMEM, evened
// out over Ho. Each is scored by what its blocks cost: the halo bytes
// they stage (a re-read band edge and column edge included; a 16-byte
// piece of a 32-byte sector counts whole), per thread slot, idle ones
// included, the input rows it reads, and a fixed cost a block.
Tile make_tile(int cs, int cb, int rb, int K, int ST, int S) {
  return Tile{cs, cb, rb,
              S * K * 2 * cs * 4 + ((rb - 1) * ST + K) * ((cb - 1) * ST + K)
                                       * cs};
}

Tile choose_tile(int Ho, int Wo, int C, int K, int ST, int S, int unit) {
  const int cmax = ((C + unit - 1) / unit) * unit;
  Tile best{};
  double best_cost = 0.0;
  for (int cs = unit; cs <= cmax && cs <= 256; cs += unit) {
    const int G = cs / 4, n_slab = (C + cs - 1) / cs;
    int cb = MAX_THREADS / G;
    cb = cb < 1 ? 1 : cb < Wo ? cb : Wo;
    const int n_ct = (Wo + cb - 1) / cb;
    cb = (Wo + n_ct - 1) / n_ct;
    int rb = Ho < MAX_ROWS ? Ho : MAX_ROWS;
    while (rb > 1 && make_tile(cs, cb, rb, K, ST, S).smem > MAX_SMEM) --rb;
    if (make_tile(cs, cb, rb, K, ST, S).smem > MAX_SMEM) continue;
    const int bands = (Ho + rb - 1) / rb;
    rb = (Ho + bands - 1) / bands;
    const double blocks = (double)bands * n_ct * n_slab;
    const double rows_in = (rb - 1) * ST + K;
    const double staged = rows_in * ((cb - 1) * ST + K)
                          * (cs < 32 ? 32 : cs);
    const double cost = blocks * (staged + G * cb * rows_in * 16.0 + 4096.0);
    if (best.cs == 0 || cost < best_cost)
      best = make_tile(cs, cb, rb, K, ST, S), best_cost = cost;
  }
  return best;
}

template <int K, int ST, int S>
int launch(const DwArgs& a, int B, const Tile& t, cudaStream_t stream) {
  const dim3 grid((unsigned)(a.n_slab * a.n_ct),
                  (unsigned)((a.Ho + t.rb - 1) / t.rb), (unsigned)B);
  const dim3 block((unsigned)(t.cs / 4), (unsigned)t.cb);
  dw_conv_int8_kernel<K, ST, S><<<grid, block, t.smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int K, int ST>
int dispatch(int S, const DwArgs& a, int B, const Tile& t,
             cudaStream_t stream) {
  switch (S) {
    case 1: return launch<K, ST, 1>(a, B, t, stream);
    case 2: return launch<K, ST, 2>(a, B, t, stream);
    case 4: return launch<K, ST, 4>(a, B, t, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

int run(DwArgs& a, int S, int B, int K, int stride, const Tile& t,
        cudaStream_t s) {
  a.cs = t.cs;
  a.rb = t.rb;
  a.n_slab = (a.C + t.cs - 1) / t.cs;
  a.n_ct = (a.Wo + t.cb - 1) / t.cb;
  if (t.smem > MAX_SMEM || (t.cs / 4) * t.cb > MAX_THREADS
      || t.cs % (a.cp == 16 ? 16 : 4) != 0 || B > 65535
      || (long long)a.n_slab * a.n_ct >= (1LL << 31)
      || (a.Ho + t.rb - 1) / t.rb > 65535)
    return (int)cudaErrorInvalidValue;
  if (K == 3)
    return stride == 1 ? dispatch<3, 1>(S, a, B, t, s)
                       : dispatch<3, 2>(S, a, B, t, s);
  return stride == 1 ? dispatch<5, 1>(S, a, B, t, s)
                     : dispatch<5, 2>(S, a, B, t, s);
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
  a.mode = requant ? OUT_CODES : (table ? OUT_TABLE : OUT_I32);
  a.cp = C % 16 == 0 && (uintptr_t)x % 16 == 0  ? 16
         : C % 4 == 0 && (uintptr_t)x % 4 == 0 ? 4 : 1;
  // the output is a fresh allocation; requant.device_args aligns the
  // residual and the columns to 16 bytes
  a.wide = C % 4 == 0 && (uintptr_t)out % 16 == 0;
  if (requant) a.rq = *(const Requant*)requant;
  const Tile t = choose_tile(a.Ho, a.Wo, C, K, stride, S,
                             a.cp == 16 ? 16 : 4);
  return run(a, S, B, K, stride, t, (cudaStream_t)stream);
}
