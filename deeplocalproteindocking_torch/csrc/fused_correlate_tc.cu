// K1 on the tensor cores: fused forward-y/x + channel coupling +
// inverse-x/y correlator for bf16 operands.
//
// Replaces the TPU kernel `_kernel` / `fused_correlate` in
// deeplocalproteindocking_tpu/correlate/pallas_fused.py for T = bf16 and
// ligand boxes X, Y <= 64 (fused_correlate.cu keeps float32 and larger
// boxes).  For one (kz frequency k, rotation b) it computes
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
// so consecutive blocks share H[k] in L2; J/16 warps, warp w owning the
// rows j in [16w, 16w+16) through stages 1-3.
//  1. Per channel, A[c] goes to shared memory zero-padded to P x P (P =
//     X, Y rounded up to 16).  The warp forms its rows of B^T with A as
//     the MMA's B operand, and rounds the float32 accumulators straight
//     into bf16 A-operand fragments (the accumulator layout of two
//     8-wide tiles is the A layout of one 16-deep step).
//  2. F is formed in 8-wide tiles of i and folded at once into float32 G
//     accumulators with H read at the fragment's own (j, i) positions:
//     neither F nor a whole G ever exists.  i runs in chunks of IC
//     columns (G in registers), channels inside a chunk, so stage 1 is
//     repeated once per chunk.  Each chunk of G is rounded into G_s.
//  3. C = G Ux for the warp's own rows, G read back from G_s; C is
//     rounded and stored transposed into C_s[x'][j].
//  4. After one __syncthreads the warps own rows x' of D; the j sum runs
//     over C_s, and the float32 accumulators are stored straight to D in
//     device memory.  No D accumulator exists in shared memory.
// Twiddles are read as MMA fragments from device memory (L1/L2-resident)
// in layouts the wrapper prepares: Wy^T [J, P] and Wx^T [I, P]
// zero-padded, Ux^T [X', I], Uy^T [Y', J].  Shared memory at L = 128,
// P = 64 is 154 KiB (G_s and C_s 68 KiB each, A 18 KiB): one block of
// 8 warps per SM.  Next step: `wgmma` with TMA-fed shared-memory tiles.
#include <cstdint>

#include "common.cuh"

namespace dlpd {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxThreads = 256;   // J <= 128: at most 8 warps
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
// g and g + 8, rounded to bf16 or kept float32.
__device__ __forceinline__ void store_rows(bf16* p, int ld,
                                           const float (&c)[4]) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16x2(c[0], c[1]);
  *reinterpret_cast<uint32_t*>(p + 8 * ld) = pack_bf16x2(c[2], c[3]);
}

__device__ __forceinline__ void store_rows(float* p, int ld,
                                           const float (&c)[4]) {
  *reinterpret_cast<float2*>(p) = make_float2(c[0], c[1]);
  *reinterpret_cast<float2*>(p + 8 * ld) = make_float2(c[2], c[3]);
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

template <int PK>
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
                          int Yp, int rows_per_group) {
  constexpr int P = 16 * PK;      // padded ligand box edge
  constexpr int SA = P + 8;       // row strides in shared memory (+8: no
  const int SG = I + 8;           // bank conflicts on fragment loads)
  const int SC = J + 8;
  const int bb = blockIdx.x;      // rotation
  const int k = blockIdx.y;       // kz frequency
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int warp = tid >> 5, nwarps = nthreads >> 5;
  const int g = (tid & 31) >> 2, t = tid & 3;
  const int j0 = 16 * warp;

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* as_re = reinterpret_cast<bf16*>(smem);   // A[c] [P][SA]
  bf16* as_im = as_re + P * SA;
  bf16* gs_re = as_im + P * SA;                  // G [J][SG]
  bf16* gs_im = gs_re + J * SG;
  bf16* cs_re = gs_im + J * SG;                  // C^T [Xp][SC]
  bf16* cs_im = cs_re + Xp * SC;

  const size_t a_base = (static_cast<size_t>(bb) * K + k) * C * X * Y;
  // Receptor group of this row: rows [g b/G, (g+1) b/G) share H[g].
  const size_t h_base =
      (static_cast<size_t>(bb / rows_per_group) * K + k) * C * J * I;
  const bf16 zero = __float2bfloat16_rn(0.f);

  // ---- stages 1-2: G rows j0.. in chunks of kIC columns ----
  for (int ic = 0; ic < I; ic += kIC) {
    float gr[kIC / 8][4], gi[kIC / 8][4];
#pragma unroll
    for (int nt = 0; nt < kIC / 8; ++nt) {
#pragma unroll
      for (int r = 0; r < 4; ++r) gr[nt][r] = gi[nt][r] = 0.f;
    }
    for (int c = 0; c < C; ++c) {
      __syncthreads();   // every warp is done with the previous A[c]
      const bf16* ar = Are + a_base + static_cast<size_t>(c) * X * Y;
      const bf16* ai = Aim + a_base + static_cast<size_t>(c) * X * Y;
      for (int o = tid; o < P * P; o += nthreads) {
        const int x = o / P, y = o % P;
        const bool in = x < X && y < Y;
        as_re[x * SA + y] = in ? ar[x * Y + y] : zero;
        as_im[x * SA + y] = in ? ai[x * Y + y] : zero;
      }
      __syncthreads();

      // Stage 1: B^T[j0.., x] = sum_y WyT[j, y] A[x, y], 16 columns of x
      // at a time, rounded into A-operand fragments bt[xc].
      uint32_t bt_re[PK][4], bt_im[PK][4];
#pragma unroll
      for (int xc = 0; xc < PK; ++xc) {
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

      // Stage 2: F = B^T Wx in 8-wide tiles of i, folded into G with H
      // upcast: G += H conj(F).
      const bf16* hr_c = Hre + h_base + static_cast<size_t>(c) * J * I;
      const bf16* hi_c = Him + h_base + static_cast<size_t>(c) * J * I;
#pragma unroll
      for (int nt = 0; nt < kIC / 8; ++nt) {
        const int i0 = ic + 8 * nt;
        if (i0 < I) {
          float fr[4] = {}, fi[4] = {};
#pragma unroll
          for (int xc = 0; xc < PK; ++xc) {
            uint32_t qr0, qr1, qi0, qi1, bn[4];
            load_b(qr0, qr1, WxTRe, P, i0, 16 * xc, g, t);
            load_b(qi0, qi1, WxTIm, P, i0, 16 * xc, g, t);
            negate(bn, bt_im[xc]);
            cmma(fr, fi, bt_re[xc], bt_im[xc], bn, qr0, qr1, qi0, qi1);
          }
          const int h0 = (j0 + g) * I + i0 + 2 * t, h1 = h0 + 8 * I;
          const float2 hr0 = ldg_bf16x2(hr_c + h0);
          const float2 hr1 = ldg_bf16x2(hr_c + h1);
          const float2 hi0 = ldg_bf16x2(hi_c + h0);
          const float2 hi1 = ldg_bf16x2(hi_c + h1);
          const float hr[4] = {hr0.x, hr0.y, hr1.x, hr1.y};
          const float hi[4] = {hi0.x, hi0.y, hi1.x, hi1.y};
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            gr[nt][r] = fmaf(hr[r], fr[r], fmaf(hi[r], fi[r], gr[nt][r]));
            gi[nt][r] = fmaf(hi[r], fr[r], fmaf(-hr[r], fi[r], gi[nt][r]));
          }
        }
      }
    }
    // This chunk of G, rounded to bf16, into the warp's rows of G_s.
#pragma unroll
    for (int nt = 0; nt < kIC / 8; ++nt) {
      const int i0 = ic + 8 * nt;
      if (i0 < I) {
        const int o = (j0 + g) * SG + i0 + 2 * t;
        store_rows(gs_re + o, SG, gr[nt]);
        store_rows(gs_im + o, SG, gi[nt]);
      }
    }
  }
  __syncwarp();   // G_s rows are warp-private: only this warp reads them

  // ---- stage 3: C[j0.., x'] = sum_i G[j, i] Ux[i, x'], stored C^T ----
  for (int nc = 0; nc < Xp; nc += kNC) {
    float cr[kNC / 8][4] = {}, ci[kNC / 8][4] = {};
    for (int kc = 0; kc < I; kc += 16) {
      uint32_t pr[4], pi[4], pn[4];
      load_a<false>(pr, gs_re, SG, j0, kc, g, t);
      load_a<false>(pi, gs_im, SG, j0, kc, g, t);
      negate(pn, pi);
#pragma unroll
      for (int nt = 0; nt < kNC / 8; ++nt) {
        const int n0 = nc + 8 * nt;
        if (n0 < Xp) {
          uint32_t qr0, qr1, qi0, qi1;
          load_b(qr0, qr1, UxTRe, I, n0, kc, g, t);
          load_b(qi0, qi1, UxTIm, I, n0, kc, g, t);
          cmma(cr[nt], ci[nt], pr, pi, pn, qr0, qr1, qi0, qi1);
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < kNC / 8; ++nt) {
      const int n0 = nc + 8 * nt;
      if (n0 < Xp) {
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
  for (int m0 = 16 * warp; m0 < Xp; m0 += 16 * nwarps) {
    for (int nc = 0; nc < Yp; nc += kNC) {
      float dr[kNC / 8][4] = {}, di[kNC / 8][4] = {};
      for (int kc = 0; kc < J; kc += 16) {
        uint32_t pr[4], pi[4], pn[4];
        load_a<false>(pr, cs_re, SC, m0, kc, g, t);
        load_a<false>(pi, cs_im, SC, m0, kc, g, t);
        negate(pn, pi);
#pragma unroll
        for (int nt = 0; nt < kNC / 8; ++nt) {
          const int n0 = nc + 8 * nt;
          if (n0 < Yp) {
            uint32_t qr0, qr1, qi0, qi1;
            load_b(qr0, qr1, UyTRe, J, n0, kc, g, t);
            load_b(qi0, qi1, UyTIm, J, n0, kc, g, t);
            cmma(dr[nt], di[nt], pr, pi, pn, qr0, qr1, qi0, qi1);
          }
        }
      }
#pragma unroll
      for (int nt = 0; nt < kNC / 8; ++nt) {
        const int n0 = nc + 8 * nt;
        if (n0 < Yp) {
          const size_t o =
              d_base + static_cast<size_t>(m0 + g) * Yp + n0 + 2 * t;
          store_rows(Dre + o, Yp, dr[nt]);
          store_rows(Dim + o, Yp, di[nt]);
        }
      }
    }
  }
}

size_t smem_bytes(int P, int J, int I, int Xp) {
  return 2 * sizeof(bf16) *
         (static_cast<size_t>(P) * (P + 8) + static_cast<size_t>(J) * (I + 8) +
          static_cast<size_t>(Xp) * (J + 8));
}

template <int PK>
int launch(const void* const* in, void* Dre, void* Dim, int b, int K, int C,
           int X, int Y, int J, int I, int Xp, int Yp, int G,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(16 * PK, J, I, Xp);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > static_cast<size_t>(optin)) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  err = cudaFuncSetAttribute(fused_correlate_tc_kernel<PK>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const bf16* const* p = reinterpret_cast<const bf16* const*>(in);
  fused_correlate_tc_kernel<PK><<<dim3(b, K), 32 * (J / 16), smem, stream>>>(
      p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7], p[8], p[9], p[10],
      p[11], static_cast<float*>(Dre), static_cast<float*>(Dim), K, C, X, Y,
      J, I, Xp, Yp, b / G);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace dlpd

// Returns a cudaError_t: 0 on a successful launch.  Operands are bf16:
// Are/Aim [b, K, C, X, Y], Hre/Him [G, K, C, J, I] with G dividing b
// (G = 1: [K, C, J, I]; row bb reads H[bb / (b/G)]), WyT [J, P], WxT [I, P]
// (P = max(X, Y) rounded up to 16, zero-padded), UxT [Xp, I],
// UyT [Yp, J].  Takes X, Y <= 64 and I, J, Xp, Yp multiples of 16 up
// to 128.
extern "C" int dlpd_fused_correlate_tc(
    const void* Are, const void* Aim, const void* Hre, const void* Him,
    const void* WyTRe, const void* WyTIm, const void* WxTRe,
    const void* WxTIm, const void* UxTRe, const void* UxTIm,
    const void* UyTRe, const void* UyTIm, void* Dre, void* Dim, int b, int K,
    int C, int X, int Y, int J, int I, int Xp, int Yp, int G, void* stream) {
  const int P = ((X > Y ? X : Y) + 15) / 16 * 16;
  if (X < 1 || Y < 1 || P > 64 || C < 1 || G < 1 || b % G || K > 65535 ||
      J % 16 ||
      I % 16 || Xp % 16 || Yp % 16 || J > 128 || I > 128 || Xp > 128 ||
      Yp > 128 || J < 16 || I < 16 || Xp < 16 || Yp < 16) {
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
    default:
      return dlpd::launch<4>(in, Dre, Dim, b, K, C, X, Y, J, I, Xp, Yp, G, s);
  }
}
