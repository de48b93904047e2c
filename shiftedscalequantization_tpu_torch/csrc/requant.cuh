// The requant epilogue shared by the integer GEMM kernels (int_matmul.cu's
// int8_conv, packed_qmm.cu, int8_group_conv.cu): the deploy path's
// quantize_out evaluated on the kernel's f32 value v of output (row m,
// column n), in the order the PyTorch route evaluates it, every step
// rounded on its own (__fmul_rn, __fadd_rn: no FMA contraction), so the
// codes are bit-for-bit those of ops/cuda/requant.requant_plain:
//
//   u = v [* m1[n]] [+ c1[n]]
//   q1:  u = clip(floor(u), lo1, hi1) - sub1        codes on the unit's site
//   res: u = clip(floor(u * m2[n] [+ r[m, n] * mr] + c2[n]), lo2, hi2) - sub2
//                                                   codes on the block's site
//   out = int8(u)
//
// The host builds every term with the torch expressions quantize_out uses
// (ops/cuda/requant.py), on the device, so no launch waits for the card.
//
// The kernels stage their output tile through shared memory: pass 1 puts
// each accumulator's f32 value (or int32 sums) in a padded row-major tile,
// pass 2 walks it CW consecutive columns at a time (store_tile, or the
// grouped conv's own walk over its rows, both through store_chunk), so the
// per-column terms, the residual and the output move in 16-byte pieces.
#pragma once
#include <stdint.h>

struct Requant {
  const float* m1;      // (N) or null
  const float* c1;      // (N) or null
  const float* m2;      // (N), stage 2 only
  const float* c2;      // (N), stage 2 only
  const void* r;        // (M, N) residual, int8 or f32, or null
  const float* scal;    // lo1, hi1, sub1, lo2, hi2, sub2, mr
  int q1;               // stage 1 quantizes
  int res;              // 0: no stage 2; 1: stage 2 without residual;
                        // 2: int8 residual; 3: f32 residual
};

struct RequantScalars {
  float lo1, hi1, sub1, lo2, hi2, sub2, mr;
};

__device__ __forceinline__ RequantScalars requant_scalars(const Requant& q) {
  return RequantScalars{q.scal[0], q.scal[1], q.scal[2], q.scal[3],
                        q.scal[4], q.scal[5], q.scal[6]};
}

enum StoreMode { STORE_F32 = 0, STORE_I32 = 1, STORE_CODES = 2 };

// The block's columns n0.. of m1, c1, m2 and c2 into shared memory,
// cols[4][BN] (0 where a term is absent or past N), read at the block's
// start so the epilogue waits on no global load for them.
template <int BN, int THREADS>
__device__ __forceinline__ void load_requant_cols(float* cols,
                                                  const Requant& q, int n0,
                                                  int N) {
  for (int i = threadIdx.x; i < 4 * BN; i += THREADS) {
    const int t = i / BN, n = n0 + i - t * BN;
    const float* p = t == 0 ? q.m1 : t == 1 ? q.c1 : t == 2 ? q.m2 : q.c2;
    cols[i] = (p != nullptr && n < N) ? p[n] : 0.0f;
  }
}

// CW floats at p (shared memory, or with GLOBAL through the read-only
// path), 16 bytes at a time when CW allows
template <int CW, bool GLOBAL>
__device__ __forceinline__ void load_cols(float (&d)[CW], const float* p) {
  if (CW % 4 == 0) {
#pragma unroll
    for (int j = 0; j < CW; j += 4) {
      const float4* q = reinterpret_cast<const float4*>(p + j);
      const float4 f = GLOBAL ? __ldg(q) : *q;
      d[j] = f.x, d[j + 1] = f.y, d[j + 2] = f.z, d[j + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < CW; ++j) d[j] = GLOBAL ? __ldg(p + j) : p[j];
  }
}

// The requant terms of a chunk's CW columns (t = 0..3: m1, c1, m2, c2),
// read by store_chunk_cols through get(d, t): SmemCols from a block's
// columns in shared memory (cols[t * cstride + nn..]; load_requant_cols),
// RegCols from registers a thread loaded once.
struct SmemCols {
  const float* cols;
  int cstride, nn;
  template <int CW>
  __device__ __forceinline__ void get(float (&d)[CW], int t) const {
    load_cols<CW, false>(d, cols + t * cstride + nn);
  }
};

template <int N>
struct RegCols {
  float t[4][N];
  template <int CW>
  __device__ __forceinline__ void get(float (&d)[CW], int k) const {
#pragma unroll
    for (int j = 0; j < CW; ++j) d[j] = t[k][j];
  }
};

// CW consecutive outputs at out + o (row-major (M, N) index o), their
// requant terms from cols: v holds their f32 values (int32 bits for
// STORE_I32), stored as they are or through the requant as int8 codes,
// codes (and an int8 residual's codes) 16, 8 or 4 bytes at a time where
// CW allows (o a multiple of CW, the residual and out 16-byte aligned).
template <int CW, class Cols>
__device__ __forceinline__ void store_chunk_cols(float (&v)[CW], int mode,
                                                 const Requant& q,
                                                 const RequantScalars& s,
                                                 const Cols& cols, size_t o,
                                                 void* out) {
  constexpr bool PACK = CW >= 4;
  if (mode == STORE_F32 || mode == STORE_I32) {
    float* dst = reinterpret_cast<float*>(out) + o;     // int32 bits as is
    if (CW % 4 == 0) {
#pragma unroll
      for (int j = 0; j < CW; j += 4)
        *reinterpret_cast<float4*>(dst + j) =
            make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
    } else {
#pragma unroll
      for (int j = 0; j < CW; ++j) dst[j] = v[j];
    }
    return;
  }
  float t[CW];
  if (q.m1) {
    cols.get(t, 0);
#pragma unroll
    for (int j = 0; j < CW; ++j) v[j] = __fmul_rn(v[j], t[j]);
  }
  if (q.c1) {
    cols.get(t, 1);
#pragma unroll
    for (int j = 0; j < CW; ++j) v[j] = __fadd_rn(v[j], t[j]);
  }
  if (q.q1) {
#pragma unroll
    for (int j = 0; j < CW; ++j)
      v[j] = __fsub_rn(fminf(fmaxf(floorf(v[j]), s.lo1), s.hi1), s.sub1);
  }
  if (q.res) {
    cols.get(t, 2);
#pragma unroll
    for (int j = 0; j < CW; ++j) v[j] = __fmul_rn(v[j], t[j]);
    if (q.res == 2) {
      // CW int8 residual codes, 16, 8 or 4 bytes at a time
      const int8_t* r = reinterpret_cast<const int8_t*>(q.r) + o;
      uint32_t rw[CW >= 4 ? CW / 4 : 1];
      if (CW == 16) {
        const int4 x = __ldg(reinterpret_cast<const int4*>(r));
        rw[0] = x.x, rw[CW >= 8 ? 1 : 0] = x.y;
        rw[CW >= 16 ? 2 : 0] = x.z, rw[CW >= 16 ? 3 : 0] = x.w;
      } else if (CW == 8) {
        const int2 x = __ldg(reinterpret_cast<const int2*>(r));
        rw[0] = x.x, rw[CW >= 8 ? 1 : 0] = x.y;
      } else if (CW == 4) {
        rw[0] = __ldg(reinterpret_cast<const unsigned int*>(r));
      }
#pragma unroll
      for (int j = 0; j < CW; ++j) {
        const int rj = PACK ? (int8_t)(rw[j / 4] >> (8 * (j % 4))) : r[j];
        v[j] = __fadd_rn(v[j], __fmul_rn((float)rj, s.mr));
      }
    } else if (q.res == 3) {
      load_cols<CW, true>(t, reinterpret_cast<const float*>(q.r) + o);
#pragma unroll
      for (int j = 0; j < CW; ++j)
        v[j] = __fadd_rn(v[j], __fmul_rn(t[j], s.mr));
    }
    cols.get(t, 3);
#pragma unroll
    for (int j = 0; j < CW; ++j)
      v[j] = __fsub_rn(fminf(fmaxf(floorf(__fadd_rn(v[j], t[j])), s.lo2),
                            s.hi2), s.sub2);
  }
  int8_t* dst = reinterpret_cast<int8_t*>(out) + o;
  if (PACK) {
    uint32_t w[CW >= 4 ? CW / 4 : 1];
#pragma unroll
    for (int k = 0; k < CW / 4; ++k)
      w[k] = ((uint32_t)(uint8_t)(int)v[4 * k])
             | ((uint32_t)(uint8_t)(int)v[4 * k + 1] << 8)
             | ((uint32_t)(uint8_t)(int)v[4 * k + 2] << 16)
             | ((uint32_t)(uint8_t)(int)v[4 * k + 3] << 24);
    if (CW == 16)
      *reinterpret_cast<uint4*>(dst) =
          make_uint4(w[0], w[CW >= 8 ? 1 : 0], w[CW >= 16 ? 2 : 0],
                     w[CW >= 16 ? 3 : 0]);
    else if (CW == 8)
      *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[CW >= 8 ? 1 : 0]);
    else
      *reinterpret_cast<uint32_t*>(dst) = w[0];
  } else {
#pragma unroll
    for (int j = 0; j < CW; ++j) dst[j] = (int8_t)(int)v[j];
  }
}

// The codes path of store_chunk_cols without a conversion instruction
// (each costs 8 times an f32 add on the card), for CW a multiple of 4
// with the words path's alignment, when requant_fast_ok holds: every grid
// bound and offset an integer of at most 2^21 in magnitude. The same
// codes bit for bit:
// - clip(floor(u), lo, hi) = floor(clip(u, lo, hi)) for integers lo <= hi
//   (NaN and infinities included: fmaxf drops a NaN), and for |x| <= 2^21
//   the float __fadd_rd(x, MAGIC) is MAGIC + floor(x), so its bits less
//   MAGIC's are floor(x);
// - that integer less the offset, cut to its low byte, is the int8 cast
//   of the float that store_chunk_cols casts;
// - an int8 residual code r is float(r) by small_int_to_float.
constexpr float MAGIC = 12582912.0f;       // 1.5 * 2^23
constexpr int MAGIC_BITS = 0x4B400000;     // its bits

// float(i) for |i| < 2^22, exactly
__device__ __forceinline__ float small_int_to_float(int i) {
  return __fsub_rn(__int_as_float(MAGIC_BITS + i), MAGIC);
}

__device__ __forceinline__ bool requant_fast_ok(const Requant& q,
                                                const RequantScalars& s) {
  auto ok = [](float v) { return floorf(v) == v && fabsf(v) <= 2097152.0f; };
  return (q.q1 || q.res)
         && (!q.q1 || (ok(s.lo1) && ok(s.hi1) && ok(s.sub1)))
         && (!q.res || (ok(s.lo2) && ok(s.hi2) && ok(s.sub2)));
}

template <int CW, class Cols>
__device__ __forceinline__ void store_codes_fast(float (&v)[CW],
                                                 const Requant& q,
                                                 const RequantScalars& s,
                                                 const Cols& cols, size_t o,
                                                 void* out) {
  static_assert(CW % 4 == 0, "whole words");
  float t[CW];
  int k[CW];
  if (q.m1) {
    cols.get(t, 0);
#pragma unroll
    for (int j = 0; j < CW; ++j) v[j] = __fmul_rn(v[j], t[j]);
  }
  if (q.c1) {
    cols.get(t, 1);
#pragma unroll
    for (int j = 0; j < CW; ++j) v[j] = __fadd_rn(v[j], t[j]);
  }
  if (q.q1) {
    const int sub = __float_as_int(__fadd_rn(s.sub1, MAGIC)) - MAGIC_BITS;
#pragma unroll
    for (int j = 0; j < CW; ++j) {
      const float r = __fadd_rd(fminf(fmaxf(v[j], s.lo1), s.hi1), MAGIC);
      k[j] = __float_as_int(r) - MAGIC_BITS - sub;
      v[j] = __fsub_rn(__fsub_rn(r, MAGIC), s.sub1);
    }
  }
  if (q.res) {
    cols.get(t, 2);
#pragma unroll
    for (int j = 0; j < CW; ++j) v[j] = __fmul_rn(v[j], t[j]);
    if (q.res == 2) {
      const uint32_t* r = reinterpret_cast<const uint32_t*>(
          reinterpret_cast<const int8_t*>(q.r) + o);
#pragma unroll
      for (int w = 0; w < CW / 4; ++w) {
        const uint32_t rw = __ldg(r + w);
#pragma unroll
        for (int b = 0; b < 4; ++b)
          v[4 * w + b] = __fadd_rn(
              v[4 * w + b],
              __fmul_rn(small_int_to_float((int8_t)(rw >> (8 * b))), s.mr));
      }
    } else if (q.res == 3) {
      load_cols<CW, true>(t, reinterpret_cast<const float*>(q.r) + o);
#pragma unroll
      for (int j = 0; j < CW; ++j)
        v[j] = __fadd_rn(v[j], __fmul_rn(t[j], s.mr));
    }
    cols.get(t, 3);
    const int sub = __float_as_int(__fadd_rn(s.sub2, MAGIC)) - MAGIC_BITS;
#pragma unroll
    for (int j = 0; j < CW; ++j) {
      const float r = __fadd_rd(
          fminf(fmaxf(__fadd_rn(v[j], t[j]), s.lo2), s.hi2), MAGIC);
      k[j] = __float_as_int(r) - MAGIC_BITS - sub;
    }
  }
  uint32_t* dst = reinterpret_cast<uint32_t*>(reinterpret_cast<int8_t*>(out)
                                              + o);
#pragma unroll
  for (int w = 0; w < CW / 4; ++w)
    dst[w] = __byte_perm(__byte_perm(k[4 * w], k[4 * w + 1], 0x0040),
                         __byte_perm(k[4 * w + 2], k[4 * w + 3], 0x0040),
                         0x5410);
}

// store_chunk_cols with the columns nn.. of the block's requant terms in
// shared memory (cols[t * cstride + nn], t = m1, c1, m2, c2;
// load_requant_cols)
template <int CW>
__device__ __forceinline__ void store_chunk(float (&v)[CW], int mode,
                                            const Requant& q,
                                            const RequantScalars& s,
                                            const float* cols, int cstride,
                                            int nn, size_t o, void* out) {
  store_chunk_cols<CW>(v, mode, q, s, SmemCols{cols, cstride, nn}, o, out);
}

// Pass 2: the BM x BN tile staged at st (row stride SP floats) to out
// (M, N) row-major, rows m0.., columns n0..; CW divides N (16, 8 or 1);
// cols holds the block's requant terms (load_requant_cols).
template <int BM, int BN, int SP, int THREADS, int CW>
__device__ __forceinline__ void store_tile_cw(const float* st, int mode,
                                              const Requant& q,
                                              const float* cols, void* out,
                                              int m0, int n0, int M, int N) {
  constexpr int CPR = BN / CW;                 // chunks per row
  RequantScalars s{};
  if (mode == STORE_CODES) s = requant_scalars(q);
#pragma unroll 1
  for (int c = threadIdx.x; c < BM * CPR; c += THREADS) {
    const int rl = c / CPR, nn = (c - rl * CPR) * CW;
    const int m = m0 + rl, n = n0 + nn;
    if (m >= M || n >= N) continue;
    float v[CW];
#pragma unroll
    for (int j = 0; j < CW; ++j) v[j] = st[rl * SP + nn + j];
    store_chunk<CW>(v, mode, q, s, cols, BN, nn, (size_t)m * N + n, out);
  }
}

template <int BM, int BN, int SP, int THREADS>
__device__ __forceinline__ void store_tile(const float* st, int mode,
                                           const Requant& q,
                                           const float* cols, void* out,
                                           int m0, int n0, int M, int N) {
  if (N % 16 == 0)
    store_tile_cw<BM, BN, SP, THREADS, 16>(st, mode, q, cols, out, m0, n0,
                                           M, N);
  else if (N % 8 == 0)
    store_tile_cw<BM, BN, SP, THREADS, 8>(st, mode, q, cols, out, m0, n0, M,
                                          N);
  else
    store_tile_cw<BM, BN, SP, THREADS, 1>(st, mode, q, cols, out, m0, n0, M,
                                          N);
}
