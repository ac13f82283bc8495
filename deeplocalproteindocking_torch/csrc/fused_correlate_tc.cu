// K1 on the tensor cores: fused forward-y/x + channel coupling +
// inverse-x/y correlator for bf16 operands.
//
// Replaces the TPU kernel `_kernel` / `fused_correlate` in
// deeplocalproteindocking_tpu/correlate/pallas_fused.py for T = bf16,
// ligand boxes X, Y <= 128 and even J, I, X', Y' <= 128
// (fused_correlate_tf32.cu keeps float32).  For one (kz frequency k,
// rotation b) it computes
//
//   B^T[c,j,x] = sum_y Wy[y,j]  A[c,x,y]            (forward y)
//   F[c,j,i]   = sum_x B^T[c,j,x] Wx[x,i]           (forward x)
//   G[j,i]     = sum_c H[c,j,i] conj(F[c,j,i])      (coupling)
//   C[j,x']    = sum_i G[j,i]    Ux[i,x']           (inverse x)
//   D[x',y']   = sum_j C[j,x']   Uy[j,y']           (inverse y)
//
// at the TPU kernel's rounding points: B, G and C are rounded to bf16; F
// and D stay float32; H is read as bf16 and upcast.  Every operand of
// the four DFT products is then bf16 and every sum float32, which is
// exactly what `mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32` computes, so
// each complex product runs as four real MMAs,
//   re += Pre Qre + Pim (-Qim),  im += Pre Qim + Pim Qre,
// with the sign flip done exactly on the packed bf16 bits.
//
// What bounds it on the H100: arithmetic.  At the main-path shapes (C=3,
// X=Y=32, J=I=X'=Y'=128) one (k, b) cell is ~50 MFLOP against 12 KB of A
// in and 128 KB of D out, ~350 FLOP per byte: above the card's bf16
// balance (~295), so the tensor cores and not device memory set the
// pace.
//
// What the design does.  One block per (b, k), b the fastest grid axis
// so consecutive blocks share H[k] in L2; J16/16 warps, warp w owning the
// rows j in [16w, 16w+16) through stages 1-3.
//  0. J, I, X' and Y' are padded to multiples of 16 (J16 ...: at L = 120,
//     128) in the kernel: the wrapper's twiddles are zero-padded to those
//     sizes, H is read as 0 at j >= J or i >= I (never copied), so every
//     padded row and column of B^T, F, G and C is an exact 0 -- G_s and C_s
//     are written whole from the accumulators and hold no stale shared
//     memory, which would turn 0 x NaN into NaN -- and D is stored only at
//     x' < X', y' < Y' (float2 stores: Y' even keeps them 8-byte aligned).
//     The rounding points do not move: padded terms add exact zeros.
//     Each box size has two instantiations: kPad = true pads, and
//     kPad = false (J, I, X', Y' all multiples of 16: every grid of the
//     presets) folds every bound and guard back to the unpadded kernel.
//  1. Per channel and x tile, rows [x0, x0+TX) of A[c] (TX = min(P, 64),
//     P = X, Y rounded up to 16) go to shared memory, zero-padded to P
//     columns of y: by cp.async into one of two buffers while the warps
//     work on the tile in the other (plain loads, one buffer, when Y is
//     odd).  The warp forms its rows of B^T for the tile with A
//     as the MMA's B operand, summing over every y in float32, and
//     rounds the accumulators once, straight into bf16 A-operand
//     fragments (the accumulator layout of two 8-wide tiles is the A
//     layout of one 16-deep step): the TPU kernel's rounding point.
//  2. The tile's part of F, sum over its x of B^T Wx, is formed in
//     8-wide tiles of i and folded at once into float32 G accumulators
//     with H read at the fragment's own (j, i) positions.  G is linear in
//     F, so the x tiles' parts add in float32 and G is rounded once, after
//     every channel and x tile: neither F nor a whole G ever exists.  i
//     runs in chunks of IC columns (G in registers), channels and x tiles
//     inside a chunk, so stage 1 is repeated once per chunk.  Each chunk
//     of G is rounded into G_s.
//     Boxes above 64 (two x tiles) keep the registers of a box of 64:
//     B^T for one tile (16 x 64) and the G chunk.  The slab holds the
//     tile's whole y range, so B^T's float32 sum over y never leaves the
//     accumulators of one 16-column step.
//  3. C = G Ux for the warp's own rows, G read back from G_s; C is
//     rounded and stored transposed into C_s[x'][j].
//  4. After one __syncthreads the warps own rows x' of D; the j sum runs
//     over C_s, and the float32 accumulators are stored straight to D in
//     device memory.  No D accumulator exists in shared memory.
// Twiddles are read as MMA fragments from device memory (L1/L2-resident)
// in layouts the wrapper prepares: Wy^T [J, P] and Wx^T [I, P]
// zero-padded, Ux^T [X', I], Uy^T [Y', J].  Shared memory at L = 128
// (``fused.tc_smem_bytes``) is 172 KiB at P = 64 (G_s and C_s 68 KiB
// each, A's two buffers 18 KiB each) and 204 KiB at P = 128 (34 KiB
// each): one block of 8 warps per SM either way.  Next step: `wgmma`
// with TMA-fed shared-memory tiles.
#include <cstdint>

#include "common.cuh"
#include "fft.cuh"   // cp_async_commit, cp_async_wait

namespace dlpd {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxThreads = 256;   // J16 <= 128: at most 8 warps
constexpr int kIC = 64;            // i columns of G held in registers
constexpr int kNC = 32;            // x' / y' columns per stage 3-4 pass
constexpr uint32_t kNegBF16x2 = 0x80008000u;

__device__ __forceinline__ uint32_t ldg32(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float2 ldg_bf16x2(const bf16* p) {
  const uint32_t u = ldg32(p);
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

// An accumulator tile's (c0, c1) at p and (c2, c3) at p + 8 ld: its rows
// g and g + 8, rounded to bf16.
__device__ __forceinline__ void store_rows(bf16* p, int ld,
                                           const float (&c)[4]) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16x2(c[0], c[1]);
  *reinterpret_cast<uint32_t*>(p + 8 * ld) = pack_bf16x2(c[2], c[3]);
}

// n rounded up to a multiple of 16 where the launch pads (kPad: some of J,
// I, X', Y' is not a multiple of 16), else n.  A launch that needs no
// padding takes the kPad = false kernel, whose guards all fold away.
template <bool kPad>
__device__ __forceinline__ int up16(int n) {
  return kPad ? (n + 15) & ~15 : n;
}

// An accumulator tile's columns (2t, 2t+1) of rows g and g + 8 into D at
// p (row g) with row stride ld: only rows below `rows` (counted from g),
// and only where the columns lie below Y' (`cols_in`).
__device__ __forceinline__ void store_d(float* p, int ld, int rows,
                                        bool cols_in, const float (&c)[4]) {
  if (!cols_in) return;
  if (rows > 0) *reinterpret_cast<float2*>(p) = make_float2(c[0], c[1]);
  if (rows > 8) {
    *reinterpret_cast<float2*>(p + 8 * ld) = make_float2(c[2], c[3]);
  }
}

// bf16 pair (i, i+1) of H at p, or zeros where the pair lies in the
// padding (in is false).
__device__ __forceinline__ float2 ldg_h(const bf16* p, bool in) {
  return in ? ldg_bf16x2(p) : make_float2(0.f, 0.f);
}

// The A-operand fragment of one 16-deep step from the float32
// accumulators of two 8-wide tiles (the same thread owns the same
// elements), rounded to bf16.
__device__ __forceinline__ void to_a_frag(uint32_t (&a)[4],
                                          const float (&c)[2][4]) {
  a[0] = pack_bf16x2(c[0][0], c[0][1]);
  a[1] = pack_bf16x2(c[0][2], c[0][3]);
  a[2] = pack_bf16x2(c[1][0], c[1][1]);
  a[3] = pack_bf16x2(c[1][2], c[1][3]);
}

// d += a b for one m16n8k16 tile (bf16 operands, float32 accumulators).
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Complex (re, im) += (Pre + i Pim)(Qre + i Qim); pn = -Pim.
__device__ __forceinline__ void cmma(float (&re)[4], float (&im)[4],
                                     const uint32_t (&pr)[4],
                                     const uint32_t (&pi)[4],
                                     const uint32_t (&pn)[4], uint32_t qr0,
                                     uint32_t qr1, uint32_t qi0,
                                     uint32_t qi1) {
  mma(re, pr, qr0, qr1);
  mma(re, pn, qi0, qi1);
  mma(im, pr, qi0, qi1);
  mma(im, pi, qr0, qr1);
}

// A-operand fragment of rows [r0, r0+16) x cols [k0, k0+16) of a
// row-major bf16 matrix with row stride ld (thread: g = lane/4, t = lane%4).
template <bool kGlobal>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* m,
                                       int ld, int r0, int k0, int g,
                                       int t) {
  const bf16* p = m + (r0 + g) * ld + k0 + 2 * t;
  if (kGlobal) {
    a[0] = ldg32(p);
    a[1] = ldg32(p + 8 * ld);
    a[2] = ldg32(p + 8);
    a[3] = ldg32(p + 8 * ld + 8);
  } else {
    a[0] = lds32(p);
    a[1] = lds32(p + 8 * ld);
    a[2] = lds32(p + 8);
    a[3] = lds32(p + 8 * ld + 8);
  }
}

__device__ __forceinline__ void negate(uint32_t (&n)[4],
                                       const uint32_t (&a)[4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) n[r] = a[r] ^ kNegBF16x2;
}

// B-operand fragment (k in [k0, k0+16), n in [n0, n0+8)) of a matrix
// stored n-major: element (k, n) at m[n * ld + k].
__device__ __forceinline__ void load_b(uint32_t& b0, uint32_t& b1,
                                       const bf16* m, int ld, int n0,
                                       int k0, int g, int t) {
  const bf16* p = m + (n0 + g) * ld + k0 + 2 * t;
  b0 = ldg32(p);
  b1 = ldg32(p + 8);
}

// 4 bytes (two bf16) from device to shared memory, asynchronously; zeros
// where !in (src is then not read).
__device__ __forceinline__ void cp_async4(bf16* dst, const bf16* src,
                                          bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

// Rows [x0, x0 + xw) of one channel of A (ar, ai: [X, Y]) into a slab
// [xw][SA], zero-padded to P columns and past row X.  async: cp.async
// copies of element pairs (Y even, so every pair is 4-byte aligned),
// waited for by the caller; else plain loads and stores.
template <int P, int SA>
__device__ __forceinline__ void load_tile(bf16* sre, bf16* sim,
                                          const bf16* ar, const bf16* ai,
                                          int x0, int xw, int X, int Y,
                                          int tid, int nthreads,
                                          bool async) {
  if (async) {
    for (int o = tid; o < xw * (P / 2); o += nthreads) {
      const int x = o / (P / 2), y = 2 * (o % (P / 2));
      const bool in = x0 + x < X && y < Y;   // Y even: y + 1 < Y as well
      const int src = in ? (x0 + x) * Y + y : 0;
      cp_async4(sre + x * SA + y, ar + src, in);
      cp_async4(sim + x * SA + y, ai + src, in);
    }
  } else {
    const bf16 zero = __float2bfloat16_rn(0.f);
    for (int o = tid; o < xw * P; o += nthreads) {
      const int x = o / P, y = o % P;
      const bool in = x0 + x < X && y < Y;
      sre[x * SA + y] = in ? ar[(x0 + x) * Y + y] : zero;
      sim[x * SA + y] = in ? ai[(x0 + x) * Y + y] : zero;
    }
  }
}

template <int PK, bool kPad>
__global__ void __launch_bounds__(kMaxThreads, 1)
fused_correlate_tc_kernel(const bf16* __restrict__ Are,
                          const bf16* __restrict__ Aim,
                          const bf16* __restrict__ Hre,
                          const bf16* __restrict__ Him,
                          const bf16* __restrict__ WyTRe,
                          const bf16* __restrict__ WyTIm,
                          const bf16* __restrict__ WxTRe,
                          const bf16* __restrict__ WxTIm,
                          const bf16* __restrict__ UxTRe,
                          const bf16* __restrict__ UxTIm,
                          const bf16* __restrict__ UyTRe,
                          const bf16* __restrict__ UyTIm,
                          float* __restrict__ Dre, float* __restrict__ Dim,
                          int K, int C, int X, int Y, int J, int I, int Xp,
                          int Yp, int rows_per_group, int async_a) {
  constexpr int P = 16 * PK;      // padded ligand box edge
  constexpr int XK = PK < 4 ? PK : 4;   // 16-row steps of x per tile
  constexpr int TX = 16 * XK;     // x rows per tile (A's slab)
  constexpr int NXT = (PK + XK - 1) / XK;   // x tiles: 1, or 2 above 64
  const int J16 = up16<kPad>(J), I16 = up16<kPad>(I);   // padded
  const int Xp16 = up16<kPad>(Xp), Yp16 = up16<kPad>(Yp);
  constexpr int SA = P + 8;       // row strides in shared memory (+8: no
  const int SG = I16 + 8;         // bank conflicts on fragment loads)
  const int SC = J16 + 8;
  const int bb = blockIdx.x;      // rotation
  const int k = blockIdx.y;       // kz frequency
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int warp = tid >> 5, nwarps = nthreads >> 5;
  const int g = (tid & 31) >> 2, t = tid & 3;
  const int j0 = 16 * warp;

  extern __shared__ __align__(16) unsigned char smem[];
  // Two buffers of A[c]'s x tile, each [TX][SA] re then im: with async_a
  // the next tile is copied into one while the warps read the other.
  bf16* slab = reinterpret_cast<bf16*>(smem);
  bf16* gs_re = slab + 4 * TX * SA;              // G [J16][SG]
  bf16* gs_im = gs_re + J16 * SG;
  bf16* cs_re = gs_im + J16 * SG;                // C^T [Xp16][SC]
  bf16* cs_im = cs_re + Xp16 * SC;

  const size_t a_base = (static_cast<size_t>(bb) * K + k) * C * X * Y;
  // Receptor group of this row: rows [g b/G, (g+1) b/G) share H[g].
  const size_t h_base =
      (static_cast<size_t>(bb / rows_per_group) * K + k) * C * J * I;
  int buf = 0;                     // the buffer holding this tile
  if (async_a) {                   // the first tile: (c, xt) = (0, 0)
    load_tile<P, SA>(slab, slab + TX * SA, Are + a_base, Aim + a_base, 0,
                     NXT > 1 ? TX : P, X, Y, tid, nthreads, true);
    cp_async_commit();
  }

  // ---- stages 1-2: G rows j0.. in chunks of kIC columns ----
  for (int ic = 0; ic < I16; ic += kIC) {
    float gr[kIC / 8][4], gi[kIC / 8][4];
#pragma unroll
    for (int nt = 0; nt < kIC / 8; ++nt) {
#pragma unroll
      for (int r = 0; r < 4; ++r) gr[nt][r] = gi[nt][r] = 0.f;
    }
    for (int c = 0; c < C; ++c) {
      const bf16* hr_c = Hre + h_base + static_cast<size_t>(c) * J * I;
      const bf16* hi_c = Him + h_base + static_cast<size_t>(c) * J * I;
#pragma unroll
      for (int xt = 0; xt < NXT; ++xt) {
        const int x0 = TX * xt;
        const int xw = xt + 1 < NXT ? TX : P - TX * (NXT - 1);   // rows
        __syncthreads();   // every warp is done with the tile it last read
        if (async_a) {
          // The next tile in (ic, c, xt) order, into the other buffer.
          const int nxt = xt + 1 < NXT ? xt + 1 : 0;
          const int nc = xt + 1 < NXT ? c : (c + 1 < C ? c + 1 : 0);
          if (xt + 1 < NXT || c + 1 < C || ic + kIC < I16) {
            const size_t off = a_base + static_cast<size_t>(nc) * X * Y;
            bf16* next = slab + 2 * (buf ^ 1) * TX * SA;
            load_tile<P, SA>(next, next + TX * SA, Are + off, Aim + off,
                             TX * nxt, nxt + 1 < NXT ? TX : P - TX * (NXT - 1),
                             X, Y, tid, nthreads, true);
          }
          cp_async_commit();
          cp_async_wait(1);   // this thread's copies of this tile landed
        } else {
          const size_t off = a_base + static_cast<size_t>(c) * X * Y;
          load_tile<P, SA>(slab, slab + TX * SA, Are + off, Aim + off, x0,
                           xw, X, Y, tid, nthreads, false);
        }
        __syncthreads();   // every thread's part of the tile is in place
        const bf16* as_re = slab + 2 * buf * TX * SA;
        const bf16* as_im = as_re + TX * SA;

        // Stage 1: B^T[j0.., x0 + x] = sum_y WyT[j, y] A[x0 + x, y], 16
        // columns of x at a time, rounded into A-operand fragments bt[xc].
        uint32_t bt_re[XK][4], bt_im[XK][4];
#pragma unroll
        for (int xc = 0; xc < XK; ++xc) {
          if (16 * xc < xw) {
            float sr[2][4] = {}, si[2][4] = {};
#pragma unroll
            for (int yc = 0; yc < PK; ++yc) {
              uint32_t wr[4], wi[4], wn[4];
              load_a<true>(wr, WyTRe, P, j0, 16 * yc, g, t);
              load_a<true>(wi, WyTIm, P, j0, 16 * yc, g, t);
              negate(wn, wi);
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                // B operand (k = y, n = x) = A_s[x][y]: x-major in A_s.
                const int xo = (16 * xc + 8 * h + g) * SA + 16 * yc + 2 * t;
                cmma(sr[h], si[h], wr, wi, wn, lds32(as_re + xo),
                     lds32(as_re + xo + 8), lds32(as_im + xo),
                     lds32(as_im + xo + 8));
              }
            }
            to_a_frag(bt_re[xc], sr);
            to_a_frag(bt_im[xc], si);
          }
        }

        // Stage 2: this tile's F = B^T Wx in 8-wide tiles of i, folded
        // into G with H upcast (0 in the padding): G += H conj(F).
#pragma unroll
        for (int nt = 0; nt < kIC / 8; ++nt) {
          const int i0 = ic + 8 * nt;
          if (i0 < I16) {
            float fr[4] = {}, fi[4] = {};
#pragma unroll
            for (int xc = 0; xc < XK; ++xc) {
              if (16 * xc < xw) {
                uint32_t qr0, qr1, qi0, qi1, bn[4];
                load_b(qr0, qr1, WxTRe, P, i0, x0 + 16 * xc, g, t);
                load_b(qi0, qi1, WxTIm, P, i0, x0 + 16 * xc, g, t);
                negate(bn, bt_im[xc]);
                cmma(fr, fi, bt_re[xc], bt_im[xc], bn, qr0, qr1, qi0, qi1);
              }
            }
            // I even: the pair (i, i + 1) is in or out of H together.
            const int i = i0 + 2 * t;
            const bool in0 = !kPad || (j0 + g < J && i < I);
            const bool in1 = !kPad || (j0 + g + 8 < J && i < I);
            const int h0 = (j0 + g) * I + i, h1 = h0 + 8 * I;
            const float2 hr0 = ldg_h(hr_c + h0, in0);
            const float2 hr1 = ldg_h(hr_c + h1, in1);
            const float2 hi0 = ldg_h(hi_c + h0, in0);
            const float2 hi1 = ldg_h(hi_c + h1, in1);
            const float hr[4] = {hr0.x, hr0.y, hr1.x, hr1.y};
            const float hi[4] = {hi0.x, hi0.y, hi1.x, hi1.y};
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              gr[nt][r] = fmaf(hr[r], fr[r], fmaf(hi[r], fi[r], gr[nt][r]));
              gi[nt][r] = fmaf(hi[r], fr[r], fmaf(-hr[r], fi[r], gi[nt][r]));
            }
          }
        }
        buf ^= async_a;   // the next tile sits in the other buffer
      }
    }
    // This chunk of G, rounded to bf16, into the warp's rows of G_s.
#pragma unroll
    for (int nt = 0; nt < kIC / 8; ++nt) {
      const int i0 = ic + 8 * nt;
      if (i0 < I16) {
        const int o = (j0 + g) * SG + i0 + 2 * t;
        store_rows(gs_re + o, SG, gr[nt]);
        store_rows(gs_im + o, SG, gi[nt]);
      }
    }
  }
  cp_async_wait(0);   // only the last, empty group can be pending
  __syncwarp();   // G_s rows are warp-private: only this warp reads them

  // ---- stage 3: C[j0.., x'] = sum_i G[j, i] Ux[i, x'], stored C^T ----
  for (int nc = 0; nc < Xp16; nc += kNC) {
    float cr[kNC / 8][4] = {}, ci[kNC / 8][4] = {};
    for (int kc = 0; kc < I16; kc += 16) {
      uint32_t pr[4], pi[4], pn[4];
      load_a<false>(pr, gs_re, SG, j0, kc, g, t);
      load_a<false>(pi, gs_im, SG, j0, kc, g, t);
      negate(pn, pi);
#pragma unroll
      for (int nt = 0; nt < kNC / 8; ++nt) {
        const int n0 = nc + 8 * nt;
        if (n0 < Xp16) {
          uint32_t qr0, qr1, qi0, qi1;
          load_b(qr0, qr1, UxTRe, I16, n0, kc, g, t);
          load_b(qi0, qi1, UxTIm, I16, n0, kc, g, t);
          cmma(cr[nt], ci[nt], pr, pi, pn, qr0, qr1, qi0, qi1);
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < kNC / 8; ++nt) {
      const int n0 = nc + 8 * nt;
      if (n0 < Xp16) {
        // Accumulator (row j, col x'): j = j0+g (+8), x' = n0+2t (+1).
        const int o = (n0 + 2 * t) * SC + j0 + g;
        cs_re[o] = __float2bfloat16_rn(cr[nt][0]);
        cs_re[o + SC] = __float2bfloat16_rn(cr[nt][1]);
        cs_re[o + 8] = __float2bfloat16_rn(cr[nt][2]);
        cs_re[o + SC + 8] = __float2bfloat16_rn(cr[nt][3]);
        cs_im[o] = __float2bfloat16_rn(ci[nt][0]);
        cs_im[o + SC] = __float2bfloat16_rn(ci[nt][1]);
        cs_im[o + 8] = __float2bfloat16_rn(ci[nt][2]);
        cs_im[o + SC + 8] = __float2bfloat16_rn(ci[nt][3]);
      }
    }
  }
  __syncthreads();   // C_s complete: the j sum needs every warp's rows

  // ---- stage 4: D[x', y'] = sum_j C[j, x'] Uy[j, y'] -> device memory ----
  const size_t d_base = (static_cast<size_t>(bb) * K + k) * Xp * Yp;
  for (int m0 = 16 * warp; m0 < Xp16; m0 += 16 * nwarps) {
    for (int nc = 0; nc < Yp16; nc += kNC) {
      float dr[kNC / 8][4] = {}, di[kNC / 8][4] = {};
      for (int kc = 0; kc < J16; kc += 16) {
        uint32_t pr[4], pi[4], pn[4];
        load_a<false>(pr, cs_re, SC, m0, kc, g, t);
        load_a<false>(pi, cs_im, SC, m0, kc, g, t);
        negate(pn, pi);
#pragma unroll
        for (int nt = 0; nt < kNC / 8; ++nt) {
          const int n0 = nc + 8 * nt;
          if (n0 < Yp16) {
            uint32_t qr0, qr1, qi0, qi1;
            load_b(qr0, qr1, UyTRe, J16, n0, kc, g, t);
            load_b(qi0, qi1, UyTIm, J16, n0, kc, g, t);
            cmma(dr[nt], di[nt], pr, pi, pn, qr0, qr1, qi0, qi1);
          }
        }
      }
#pragma unroll
      for (int nt = 0; nt < kNC / 8; ++nt) {
        const int n0 = nc + 8 * nt;
        if (n0 < Yp16) {
          const size_t o =
              d_base + static_cast<size_t>(m0 + g) * Yp + n0 + 2 * t;
          // Y' even: the pair (y', y' + 1) is in or out of D together.
          const bool cols_in = !kPad || n0 + 2 * t < Yp;
          const int rows = kPad ? Xp - m0 - g : 16;
          store_d(Dre + o, Yp, rows, cols_in, dr[nt]);
          store_d(Dim + o, Yp, rows, cols_in, di[nt]);
        }
      }
    }
  }
}

// Two buffers of A's x tile [min(P, 64)][P+8], G_s [J16][I16+8] and C_s
// [Xp16][J16+8], each re and im (``fused.tc_smem_bytes``; J16, I16, Xp16
// padded to 16).
size_t smem_bytes(int P, int J, int I, int Xp) {
  const size_t tx = P < 64 ? P : 64;
  return 2 * sizeof(bf16) *
         (2 * tx * (P + 8) + static_cast<size_t>(J) * (I + 8) +
          static_cast<size_t>(Xp) * (J + 8));
}

template <int PK>
int launch(const void* const* in, void* Dre, void* Dim, int b, int K, int C,
           int X, int Y, int J, int I, int Xp, int Yp, int G,
           cudaStream_t stream) {
  const int J16 = (J + 15) & ~15;
  const size_t smem = smem_bytes(16 * PK, J16, (I + 15) & ~15,
                                 (Xp + 15) & ~15);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > static_cast<size_t>(optin)) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const bool pad = (J | I | Xp | Yp) % 16 != 0;
  const auto kernel = pad ? fused_correlate_tc_kernel<PK, true> : fused_correlate_tc_kernel<PK, false>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const bf16* const* p = reinterpret_cast<const bf16* const*>(in);
  // A by cp.async when every element pair is 4-byte aligned.
  const int async_a = Y % 2 == 0 &&
                      reinterpret_cast<uintptr_t>(p[0]) % 4 == 0 &&
                      reinterpret_cast<uintptr_t>(p[1]) % 4 == 0;
  kernel<<<dim3(b, K), 2 * J16, smem, stream>>>(
      p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7], p[8], p[9], p[10],
      p[11], static_cast<float*>(Dre), static_cast<float*>(Dim), K, C, X, Y,
      J, I, Xp, Yp, b / G, async_a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace dlpd

// Returns a cudaError_t: 0 on a successful launch.  Operands are bf16:
// Are/Aim [b, K, C, X, Y], Hre/Him [G, K, C, J, I] with G dividing b
// (G = 1: [K, C, J, I]; row bb reads H[bb / (b/G)]), and the twiddles
// zero-padded (N16: N rounded up to 16; ``fused.tc_operands``): WyT
// [J16, P], WxT [I16, P] (P = max(X, Y) rounded up to 16), UxT [Xp16,
// I16], UyT [Yp16, J16].  Takes X, Y <= 128 and even I, J, Xp, Yp up to
// 128.
extern "C" int dlpd_fused_correlate_tc(
    const void* Are, const void* Aim, const void* Hre, const void* Him,
    const void* WyTRe, const void* WyTIm, const void* WxTRe,
    const void* WxTIm, const void* UxTRe, const void* UxTIm,
    const void* UyTRe, const void* UyTIm, void* Dre, void* Dim, int b, int K,
    int C, int X, int Y, int J, int I, int Xp, int Yp, int G, void* stream) {
  const int P = ((X > Y ? X : Y) + 15) / 16 * 16;
  if (X < 1 || Y < 1 || P > 128 || C < 1 || G < 1 || b % G || K > 65535 ||
      J % 2 || I % 2 || Xp % 2 || Yp % 2 || J > 128 || I > 128 ||
      Xp > 128 || Yp > 128 || J < 2 || I < 2 || Xp < 2 || Yp < 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* in[12] = {Are,   Aim,   Hre,   Him,   WyTRe, WyTIm,
                        WxTRe, WxTIm, UxTRe, UxTIm, UyTRe, UyTIm};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (P / 16) {
    case 1:
      return dlpd::launch<1>(in, Dre, Dim, b, K, C, X, Y, J, I, Xp, Yp, G, s);
    case 2:
      return dlpd::launch<2>(in, Dre, Dim, b, K, C, X, Y, J, I, Xp, Yp, G, s);
    case 3:
      return dlpd::launch<3>(in, Dre, Dim, b, K, C, X, Y, J, I, Xp, Yp, G, s);
    case 4:
      return dlpd::launch<4>(in, Dre, Dim, b, K, C, X, Y, J, I, Xp, Yp, G, s);
    case 5:
      return dlpd::launch<5>(in, Dre, Dim, b, K, C, X, Y, J, I, Xp, Yp, G, s);
    case 6:
      return dlpd::launch<6>(in, Dre, Dim, b, K, C, X, Y, J, I, Xp, Yp, G, s);
    case 7:
      return dlpd::launch<7>(in, Dre, Dim, b, K, C, X, Y, J, I, Xp, Yp, G, s);
    default:
      return dlpd::launch<8>(in, Dre, Dim, b, K, C, X, Y, J, I, Xp, Yp, G, s);
  }
}
