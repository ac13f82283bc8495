// K1 on the tensor cores in float32: fused forward-y/x + channel coupling
// + inverse-x/y correlator, each real product run as 3xTF32.
//
// Replaces the TPU kernel `_kernel` / `fused_correlate` in
// deeplocalproteindocking_tpu/correlate/pallas_fused.py for T = float32,
// ligand boxes X, Y <= 128 and even J, I, X', Y' <= 128
// (fused_correlate_tc.cu keeps bf16).  For one (kz frequency k, rotation
// b) it computes
//
//   B^T[c,j,x] = sum_y Wy[y,j]  A[c,x,y]            (forward y)
//   F[c,j,i]   = sum_x B^T[c,j,x] Wx[x,i]           (forward x)
//   G[j,i]     = sum_c H[c,j,i] conj(F[c,j,i])      (coupling)
//   C[j,x']    = sum_i G[j,i]    Ux[i,x']           (inverse x)
//   D[x',y']   = sum_j C[j,x']   Uy[j,y']           (inverse y)
//
// in float32 throughout: the TPU kernel's casts are no-ops at T = float32,
// so no stage rounds to a lower type.  The tensor cores take TF32 (10
// mantissa bits), so every float32 operand x is split as
//   hi = cvt.rna.tf32(x),  lo = cvt.rna.tf32(x - hi)
// and each real product P Q runs as three MMAs with float32 sums,
//   Plo Qhi + Phi Qlo + Phi Qhi,
// which drops only Plo Qlo (~2^-22 relative).  A complex product is four
// real ones, twelve `mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32`; a sign
// is bit 31 of both parts.
//
// What bounds it on the H100: arithmetic.  At the bench shapes (C = 3,
// X = Y = 32, J = I = X' = Y' = 128) one (k, b) cell is ~50 MFLOP of
// products against 24 KB of A in and 128 KB of D out; 3xTF32 triples the
// tensor-core work, so the MMA pipe and the twiddle fragments it reads
// from L1/L2, not device memory, set the pace.
//
// What the design does.  One block per (b, k), b the fastest grid axis so
// consecutive blocks share H[g, k] in L2; J16/16 warps, warp w owning the
// rows j in [16w, 16w+16) through stages 1-3.  J, I, X' and Y' are padded
// to multiples of 16 (J16 ...) in the kernel, as in fused_correlate_tc.cu:
// zero-padded twiddles, H read as 0 at j >= J or i >= I, G_s and C_s
// written whole (exact zeros in the padding, never stale shared memory),
// D stored only at x' < X', y' < Y'; kPad = false (every size a multiple
// of 16) compiles to the unpadded kernel.
//
// Fragments.  m16n8k8 holds A as a0 (g, t), a1 (g+8, t), a2 (g, t+4),
// a3 (g+8, t+4), B as b0 (k t, n g), b1 (k t+4, n g), and a tile of sums
// as c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1) (g = lane/4,
// t = lane%4).  Every contraction here puts k = 2t in slot t and
// k = 2t+1 in slot t+4 of its 8-deep step; both operands agree, so the
// sum is the same.  Then (a0, a2) and (b0, b1) are adjacent elements (one
// vector load), and a tile of sums (c0, c2, c1, c3) is the next product's
// A fragment as it stands: B^T goes from stage 1 to stage 2 without a
// shuffle.  Twiddles come from the wrapper in the "split" layout, each
// row's column pair (2q, 2q+1) stored as hi(2q), hi(2q+1), lo(2q),
// lo(2q+1): one float4 is a thread's hi and lo fragment.
//
//  1. Per channel, A[c] zero-padded to P x P (P = X, Y rounded up to 16)
//     is taken in tiles of T x T (T = min(P, 64); above 64, 2 x 2 tiles,
//     the last of each axis P - 64 wide), each split into the same layout
//     in shared memory.  Per x tile the warp forms its 16 rows of B^T (A
//     as the MMA's B operand) into float32 accumulators kept in
//     registers, summed over the y tiles.
//  2. F in chunks of kIC columns of i: the x tile's B^T split at use,
//     Wx^T read from the split layout, and each chunk folded at once into
//     G with H read at the fragment's own (j, i) positions: G += H
//     conj(F).  G is linear in F, so each x tile's part of F is folded as
//     it is formed.  G lives in shared memory (float32, the warp's own
//     rows; each element is read and written by the one thread that owns
//     its fragment position in stages 2 and 3).  F never exists whole;
//     B^T is formed once per channel and x tile.  Nothing is rounded below
//     float32, so the tiles move no rounding point.
//  3. Per chunk of kNC columns x': C = G Ux for the warp's rows, G split
//     at load, C^T split into C_s[x'][j], which aliases A's slab (stages
//     1-2 are done).
//  4. After one __syncthreads the warps share the chunk's x' rows of D by
//     (16-row m tile, 32-column n group); the j sum runs over C_s, and the
//     float32 sums are stored straight to D in device memory.
// Shared memory (``fused.tf32_smem_bytes``): G 2 J16 (I16+8) floats plus
// the larger of A's slab 2 T (2T+16) and C_s 2 kNC (2 J16+16): 212,992 B at
// L = 128, T = 64, under the 232,448 B a block may opt in to, for every
// box the route takes.  Next steps: `wgmma` with the twiddles in shared
// memory, which would stop every warp reading every twiddle fragment.
#include <cstdint>

#include "common.cuh"

namespace dlpd {
namespace {

constexpr int kMaxThreads = 256;   // J16 <= 128: at most 8 warps
constexpr int kIC = 32;            // i columns of F per stage-2 pass
constexpr int kNC = 32;            // x' rows of C^T per stage 3-4 pass
constexpr int kNG = 32;            // y' columns of a stage-4 work item
constexpr uint32_t kSign = 0x80000000u;

// A fragment's four elements as TF32 hi and lo parts.
struct AFrag {
  uint32_t h[4], l[4];
};
// B fragment's two elements as TF32 hi and lo parts.
struct BFrag {
  uint32_t h[2], l[2];
};

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split(float x, uint32_t& h, uint32_t& l) {
  h = to_tf32(x);
  l = to_tf32(x - __uint_as_float(h));
}

template <bool kGlobal>
__device__ __forceinline__ float4 ld4(const float* p) {
  if (kGlobal) return __ldg(reinterpret_cast<const float4*>(p));
  return *reinterpret_cast<const float4*>(p);
}

// A fragment of rows [r0, r0+16) x k in [k0, k0+8) of a matrix in the
// split layout (row stride ld floats): pair k0/2 + t of rows r0+g, r0+g+8.
template <bool kGlobal>
__device__ __forceinline__ AFrag load_a(const float* m, int ld, int r0,
                                        int k0, int g, int t) {
  const float* p = m + (r0 + g) * ld + 2 * k0 + 4 * t;
  const float4 u = ld4<kGlobal>(p), v = ld4<kGlobal>(p + 8 * ld);
  AFrag a;
  a.h[0] = __float_as_uint(u.x);
  a.h[2] = __float_as_uint(u.y);
  a.l[0] = __float_as_uint(u.z);
  a.l[2] = __float_as_uint(u.w);
  a.h[1] = __float_as_uint(v.x);
  a.h[3] = __float_as_uint(v.y);
  a.l[1] = __float_as_uint(v.z);
  a.l[3] = __float_as_uint(v.w);
  return a;
}

// B fragment (k in [k0, k0+8), n in [n0, n0+8)) of a matrix stored
// n-major in the split layout: pair k0/2 + t of row n0 + g.
template <bool kGlobal>
__device__ __forceinline__ BFrag load_b(const float* m, int ld, int n0,
                                        int k0, int g, int t) {
  const float4 u = ld4<kGlobal>(m + (n0 + g) * ld + 2 * k0 + 4 * t);
  BFrag b;
  b.h[0] = __float_as_uint(u.x);
  b.h[1] = __float_as_uint(u.y);
  b.l[0] = __float_as_uint(u.z);
  b.l[1] = __float_as_uint(u.w);
  return b;
}

// A fragment of rows [r0, r0+16) x k in [k0, k0+8) of a row-major
// float32 matrix, split at load.
__device__ __forceinline__ AFrag load_a_f32(const float* m, int ld, int r0,
                                            int k0, int g, int t) {
  const float* p = m + (r0 + g) * ld + k0 + 2 * t;
  const float2 u = *reinterpret_cast<const float2*>(p);
  const float2 v = *reinterpret_cast<const float2*>(p + 8 * ld);
  AFrag a;
  split(u.x, a.h[0], a.l[0]);
  split(u.y, a.h[2], a.l[2]);
  split(v.x, a.h[1], a.l[1]);
  split(v.y, a.h[3], a.l[3]);
  return a;
}

// The A fragment of one 8-deep step from a tile of sums whose columns are
// that step's k (the same thread owns the same elements), split.
__device__ __forceinline__ AFrag from_sums(const float (&c)[4]) {
  AFrag a;
  split(c[0], a.h[0], a.l[0]);
  split(c[2], a.h[1], a.l[1]);
  split(c[1], a.h[2], a.l[2]);
  split(c[3], a.h[3], a.l[3]);
  return a;
}

// d += a b for one m16n8k8 tile (TF32 operands, float32 sums).
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b in 3xTF32, the small products first.
__device__ __forceinline__ void mma3(float (&d)[4], const AFrag& a,
                                     const BFrag& b) {
  mma(d, a.l, b.h[0], b.h[1]);
  mma(d, a.h, b.l[0], b.l[1]);
  mma(d, a.h, b.h[0], b.h[1]);
}

// Complex (re, im) += (Pre + i Pim)(Qre + i Qim).
__device__ __forceinline__ void cmma3(float (&re)[4], float (&im)[4],
                                      const AFrag& pr, const AFrag& pi,
                                      const BFrag& qr, const BFrag& qi) {
  BFrag qn;   // -Qim
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    qn.h[r] = qi.h[r] ^ kSign;
    qn.l[r] = qi.l[r] ^ kSign;
  }
  mma3(re, pr, qr);
  mma3(re, pi, qn);
  mma3(im, pr, qi);
  mma3(im, pi, qr);
}

// Element (r, k) of a split-layout matrix (row stride ld floats) set to
// the split of v.
__device__ __forceinline__ void store_split(float* m, int ld, int r, int k,
                                            float v) {
  uint32_t h, l;
  split(v, h, l);
  float* p = m + r * ld + 4 * (k >> 1) + (k & 1);
  p[0] = __uint_as_float(h);
  p[2] = __uint_as_float(l);
}

// n rounded up to a multiple of 16 where the launch pads (kPad: some of J,
// I, X', Y' is not a multiple of 16), else n.  A launch that needs no
// padding takes the kPad = false kernel, whose guards all fold away.
template <bool kPad>
__device__ __forceinline__ int up16(int n) {
  return kPad ? (n + 15) & ~15 : n;
}

// A tile of sums' (c0, c1) at p and (c2, c3) at p + 8 ld (its rows g and
// g + 8): only rows below `rows` (counted from g), and only where the
// columns lie below Y' (`cols_in`; Y' even keeps float2 stores aligned).
__device__ __forceinline__ void store_d(float* p, int ld, int rows,
                                        bool cols_in, const float (&c)[4]) {
  if (!cols_in) return;
  if (rows > 0) *reinterpret_cast<float2*>(p) = make_float2(c[0], c[1]);
  if (rows > 8) {
    *reinterpret_cast<float2*>(p + 8 * ld) = make_float2(c[2], c[3]);
  }
}

template <int PK, bool kPad>
__global__ void __launch_bounds__(kMaxThreads, 1)
fused_correlate_tf32_kernel(const float* __restrict__ Are,
                            const float* __restrict__ Aim,
                            const float* __restrict__ Hre,
                            const float* __restrict__ Him,
                            const float* __restrict__ WyTRe,
                            const float* __restrict__ WyTIm,
                            const float* __restrict__ WxTRe,
                            const float* __restrict__ WxTIm,
                            const float* __restrict__ UxTRe,
                            const float* __restrict__ UxTIm,
                            const float* __restrict__ UyTRe,
                            const float* __restrict__ UyTIm,
                            float* __restrict__ Dre, float* __restrict__ Dim,
                            int K, int C, int X, int Y, int J, int I, int Xp,
                            int Yp, int rows_per_group) {
  constexpr int P = 16 * PK;      // padded ligand box edge
  constexpr int TK = PK < 4 ? PK : 4;   // 16-wide steps per tile edge
  constexpr int T = 16 * TK;      // tile edge (A's slab is T x T)
  constexpr int NT = (PK + TK - 1) / TK;   // tiles per axis: 1, or 2
  constexpr int NB = T / 8;       // 8-wide steps over a tile
  const int J16 = up16<kPad>(J), I16 = up16<kPad>(I);   // padded
  const int Xp16 = up16<kPad>(Xp), Yp16 = up16<kPad>(Yp);
  constexpr int SA = 2 * T + 16;  // row strides in floats (split rows: 16
  const int SC = 2 * J16 + 16;    // mod 32, float4 loads conflict-free;
  const int SG = I16 + 8;         // float rows: 8 mod 32, float2 loads)
  const int bb = blockIdx.x;      // rotation
  const int k = blockIdx.y;       // kz frequency
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int warp = tid >> 5, nwarps = nthreads >> 5;
  const int g = (tid & 31) >> 2, t = tid & 3;
  const int j0 = 16 * warp;

  extern __shared__ __align__(16) unsigned char smem[];
  float* gs_re = reinterpret_cast<float*>(smem);   // G [J16][SG]
  float* gs_im = gs_re + J16 * SG;
  float* as_re = gs_im + J16 * SG;                 // A[c] tile [T][SA]
  float* as_im = as_re + T * SA;
  float* cs_re = as_re;                            // C^T split [kNC][SC]
  float* cs_im = cs_re + kNC * SC;                 // (aliases A's slab)

  const size_t a_base = (static_cast<size_t>(bb) * K + k) * C * X * Y;
  // Receptor group of this row: rows [g b/G, (g+1) b/G) share H[g].
  const size_t h_base =
      (static_cast<size_t>(bb / rows_per_group) * K + k) * C * J * I;

  // ---- stages 1-2, per channel and x tile: G rows j0.. += H conj(B^T Wx)
  for (int c = 0; c < C; ++c) {
    const float* ar = Are + a_base + static_cast<size_t>(c) * X * Y;
    const float* ai = Aim + a_base + static_cast<size_t>(c) * X * Y;
    const float* hr_c = Hre + h_base + static_cast<size_t>(c) * J * I;
    const float* hi_c = Him + h_base + static_cast<size_t>(c) * J * I;
#pragma unroll
    for (int xt = 0; xt < NT; ++xt) {
      const int x0 = T * xt;
      const int xw = xt + 1 < NT ? T : P - T * (NT - 1);   // x rows

      // Stage 1: B^T[j0.., x0 + x] = sum_y WyT[j, y] A[x0 + x, y], float32
      // sums in 8-wide tiles of x, over the y tiles.
      float btr[NB][4], bti[NB][4];
#pragma unroll
      for (int xc = 0; xc < NB; ++xc) {
#pragma unroll
        for (int r = 0; r < 4; ++r) btr[xc][r] = bti[xc][r] = 0.f;
      }
#pragma unroll
      for (int yt = 0; yt < NT; ++yt) {
        const int y0 = T * yt;
        const int yw = yt + 1 < NT ? T : P - T * (NT - 1);   // y columns
        __syncthreads();   // every warp is done with the previous tile
        for (int o = tid; o < xw * yw / 2; o += nthreads) {
          const int x = o / (yw / 2), y = 2 * (o % (yw / 2));
          const int ax = x0 + x, ay = y0 + y;
          const bool in0 = ax < X && ay < Y, in1 = ax < X && ay + 1 < Y;
          const float v[4] = {in0 ? ar[ax * Y + ay] : 0.f,
                              in1 ? ar[ax * Y + ay + 1] : 0.f,
                              in0 ? ai[ax * Y + ay] : 0.f,
                              in1 ? ai[ax * Y + ay + 1] : 0.f};
          uint32_t h[4], l[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) split(v[r], h[r], l[r]);
          const int s = x * SA + 2 * y;
          *reinterpret_cast<float4*>(as_re + s) =
              make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]),
                          __uint_as_float(l[0]), __uint_as_float(l[1]));
          *reinterpret_cast<float4*>(as_im + s) =
              make_float4(__uint_as_float(h[2]), __uint_as_float(h[3]),
                          __uint_as_float(l[2]), __uint_as_float(l[3]));
        }
        __syncthreads();
#pragma unroll
        for (int yc = 0; yc < NB; ++yc) {
          if (8 * yc < yw) {
            const AFrag wr = load_a<true>(WyTRe, 2 * P, j0, y0 + 8 * yc, g, t);
            const AFrag wi = load_a<true>(WyTIm, 2 * P, j0, y0 + 8 * yc, g, t);
#pragma unroll
            for (int xc = 0; xc < NB; ++xc) {
              if (8 * xc < xw) {
                // B operand (k = y, n = x) = A_s[x][y]: x-major in A_s.
                const BFrag qr = load_b<false>(as_re, SA, 8 * xc, 8 * yc, g, t);
                const BFrag qi = load_b<false>(as_im, SA, 8 * xc, 8 * yc, g, t);
                cmma3(btr[xc], bti[xc], wr, wi, qr, qi);
              }
            }
          }
        }
      }

      // Stage 2: this tile's F = B^T Wx in chunks of kIC columns of i,
      // each folded into G: G += H conj(F), H 0 in the padding.
      for (int ic = 0; ic < I16; ic += kIC) {
        float fr[kIC / 8][4], fi[kIC / 8][4];
#pragma unroll
        for (int nt = 0; nt < kIC / 8; ++nt) {
#pragma unroll
          for (int r = 0; r < 4; ++r) fr[nt][r] = fi[nt][r] = 0.f;
        }
#pragma unroll
        for (int xc = 0; xc < NB; ++xc) {
          if (8 * xc < xw) {
            const AFrag pr = from_sums(btr[xc]);
            const AFrag pi = from_sums(bti[xc]);
#pragma unroll
            for (int nt = 0; nt < kIC / 8; ++nt) {
              const int i0 = ic + 8 * nt;
              if (i0 < I16) {
                const BFrag qr =
                    load_b<true>(WxTRe, 2 * P, i0, x0 + 8 * xc, g, t);
                const BFrag qi =
                    load_b<true>(WxTIm, 2 * P, i0, x0 + 8 * xc, g, t);
                cmma3(fr[nt], fi[nt], pr, pi, qr, qi);
              }
            }
          }
        }
        const bool first = c == 0 && xt == 0;   // G starts here
#pragma unroll
        for (int nt = 0; nt < kIC / 8; ++nt) {
          const int i0 = ic + 8 * nt;
          if (i0 < I16) {
            const int h0 = (j0 + g) * I + i0 + 2 * t;
            const int o = (j0 + g) * SG + i0 + 2 * t;
#pragma unroll
            for (int half = 0; half < 2; ++half) {   // rows g and g + 8
              // I even: the pair (i, i + 1) is in or out of H together.
              const bool in =
                  !kPad || (j0 + g + 8 * half < J && i0 + 2 * t < I);
              const float2 zero = make_float2(0.f, 0.f);
              const float2 hr = in ? __ldg(reinterpret_cast<const float2*>(
                                         hr_c + h0 + 8 * I * half))
                                   : zero;
              const float2 hi = in ? __ldg(reinterpret_cast<const float2*>(
                                         hi_c + h0 + 8 * I * half))
                                   : zero;
              float2* pgr =
                  reinterpret_cast<float2*>(gs_re + o + 8 * SG * half);
              float2* pgi =
                  reinterpret_cast<float2*>(gs_im + o + 8 * SG * half);
              float2 gr = first ? make_float2(0.f, 0.f) : *pgr;
              float2 gi = first ? make_float2(0.f, 0.f) : *pgi;
              const float f_r[2] = {fr[nt][2 * half], fr[nt][2 * half + 1]};
              const float f_i[2] = {fi[nt][2 * half], fi[nt][2 * half + 1]};
              gr.x = fmaf(hr.x, f_r[0], fmaf(hi.x, f_i[0], gr.x));
              gr.y = fmaf(hr.y, f_r[1], fmaf(hi.y, f_i[1], gr.y));
              gi.x = fmaf(hi.x, f_r[0], fmaf(-hr.x, f_i[0], gi.x));
              gi.y = fmaf(hi.y, f_r[1], fmaf(-hr.y, f_i[1], gi.y));
              *pgr = gr;
              *pgi = gi;
            }
          }
        }
      }
    }
  }

  // ---- stages 3-4 per chunk of kNC columns x' ----
  const size_t d_base = (static_cast<size_t>(bb) * K + k) * Xp * Yp;
  for (int nc = 0; nc < Xp16; nc += kNC) {
    __syncthreads();   // A's slab, or the last chunk's C_s, is done with

    // Stage 3: C[j0.., x'] = sum_i G[j, i] Ux[i, x'], stored C^T split.
    float cr[kNC / 8][4], ci[kNC / 8][4];
#pragma unroll
    for (int nt = 0; nt < kNC / 8; ++nt) {
#pragma unroll
      for (int r = 0; r < 4; ++r) cr[nt][r] = ci[nt][r] = 0.f;
    }
    for (int kc = 0; kc < I16; kc += 8) {
      const AFrag pr = load_a_f32(gs_re, SG, j0, kc, g, t);
      const AFrag pi = load_a_f32(gs_im, SG, j0, kc, g, t);
#pragma unroll
      for (int nt = 0; nt < kNC / 8; ++nt) {
        const int n0 = nc + 8 * nt;
        if (n0 < Xp16) {
          const BFrag qr = load_b<true>(UxTRe, 2 * I16, n0, kc, g, t);
          const BFrag qi = load_b<true>(UxTIm, 2 * I16, n0, kc, g, t);
          cmma3(cr[nt], ci[nt], pr, pi, qr, qi);
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < kNC / 8; ++nt) {
      if (nc + 8 * nt < Xp16) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          // Sum r sits at row j = j0+g (+8), column x' = 8nt+2t (+1).
          const int j = j0 + g + 8 * (r >> 1), xr = 8 * nt + 2 * t + (r & 1);
          store_split(cs_re, SC, xr, j, cr[nt][r]);
          store_split(cs_im, SC, xr, j, ci[nt][r]);
        }
      }
    }
    __syncthreads();   // C_s complete: the j sum needs every warp's rows

    // Stage 4: D[x', y'] = sum_j C[j, x'] Uy[j, y'] -> device memory, one
    // (16-row m tile, kNG-column group) item per warp at a time.
    const int mtiles = (Xp16 - nc < kNC ? Xp16 - nc : kNC) / 16;
    const int items = mtiles * ((Yp16 + kNG - 1) / kNG);
    for (int it = warp; it < items; it += nwarps) {
      const int m0 = 16 * (it % mtiles), y0 = kNG * (it / mtiles);
      float dr[kNG / 8][4], di[kNG / 8][4];
#pragma unroll
      for (int nt = 0; nt < kNG / 8; ++nt) {
#pragma unroll
        for (int r = 0; r < 4; ++r) dr[nt][r] = di[nt][r] = 0.f;
      }
      for (int kc = 0; kc < J16; kc += 8) {
        const AFrag pr = load_a<false>(cs_re, SC, m0, kc, g, t);
        const AFrag pi = load_a<false>(cs_im, SC, m0, kc, g, t);
#pragma unroll
        for (int nt = 0; nt < kNG / 8; ++nt) {
          const int n0 = y0 + 8 * nt;
          if (n0 < Yp16) {
            const BFrag qr = load_b<true>(UyTRe, 2 * J16, n0, kc, g, t);
            const BFrag qi = load_b<true>(UyTIm, 2 * J16, n0, kc, g, t);
            cmma3(dr[nt], di[nt], pr, pi, qr, qi);
          }
        }
      }
#pragma unroll
      for (int nt = 0; nt < kNG / 8; ++nt) {
        const int n0 = y0 + 8 * nt;
        if (n0 < Yp16) {
          const size_t o = d_base +
                           static_cast<size_t>(nc + m0 + g) * Yp + n0 + 2 * t;
          const int rows = kPad ? Xp - nc - m0 - g : 16;
          const bool cols_in = !kPad || n0 + 2 * t < Yp;
          store_d(Dre + o, Yp, rows, cols_in, dr[nt]);
          store_d(Dim + o, Yp, rows, cols_in, di[nt]);
        }
      }
    }
  }
}

size_t smem_bytes(int P, int J, int I) {
  const size_t tile = P < 64 ? P : 64;
  const size_t g = 2 * static_cast<size_t>(J) * (I + 8);
  const size_t a = 2 * tile * (2 * tile + 16);
  const size_t c = 2 * static_cast<size_t>(kNC) * (2 * J + 16);
  return sizeof(float) * (g + (a > c ? a : c));
}

template <int PK>
int launch(const void* const* in, void* Dre, void* Dim, int b, int K, int C,
           int X, int Y, int J, int I, int Xp, int Yp, int G,
           cudaStream_t stream) {
  const int J16 = (J + 15) & ~15;
  const size_t smem = smem_bytes(16 * PK, J16, (I + 15) & ~15);
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
  const auto kernel = pad ? fused_correlate_tf32_kernel<PK, true> : fused_correlate_tf32_kernel<PK, false>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* const* p = reinterpret_cast<const float* const*>(in);
  kernel<<<dim3(b, K), 2 * J16, smem, stream>>>(
          p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7], p[8], p[9], p[10],
          p[11], static_cast<float*>(Dre), static_cast<float*>(Dim), K, C, X,
          Y, J, I, Xp, Yp, b / G);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace dlpd

// Returns a cudaError_t: 0 on a successful launch.  Operands are float32:
// Are/Aim [b, K, C, X, Y], Hre/Him [G, K, C, J, I] with G dividing b
// (G = 1: [K, C, J, I]; row bb reads H[bb / (b/G)]; 8-byte aligned), and
// the twiddles zero-padded (N16: N rounded up to 16) in the split layout
// (``fused.tf32_operands``): WyT [J16, 2P], WxT [I16, 2P] (P = max(X, Y)
// rounded up to 16), UxT [Xp16, 2 I16], UyT [Yp16, 2 J16], 16-byte
// aligned.  Takes X, Y <= 128 and even I, J, Xp, Yp up to 128.
extern "C" int dlpd_fused_correlate_tf32(
    const void* Are, const void* Aim, const void* Hre, const void* Him,
    const void* WyTRe, const void* WyTIm, const void* WxTRe,
    const void* WxTIm, const void* UxTRe, const void* UxTIm,
    const void* UyTRe, const void* UyTIm, void* Dre, void* Dim, int b, int K,
    int C, int X, int Y, int J, int I, int Xp, int Yp, int G, void* stream) {
  const int P = ((X > Y ? X : Y) + 15) / 16 * 16;
  if (b < 1 || X < 1 || Y < 1 || P > 128 || C < 1 || G < 1 || b % G ||
      K < 1 || K > 65535 || J % 2 || I % 2 || Xp % 2 || Yp % 2 ||
      J > 128 || I > 128 || Xp > 128 || Yp > 128 || J < 2 || I < 2 ||
      Xp < 2 || Yp < 2) {
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
