// Shared pieces of the FFT kernels (invz_blockmax_fft.cu, idft_fft.cu):
// complex float32 helpers, inverse DFTs of 2, 3, 4, 5, 6, 7, 8, 10, 12, 14
// and 16 points in registers, cp.async copies, and the c2r inverse of
// length L = 16 x Q (Q = 2..8: L = 32, 48, 64, 80, 96, 112, 128) down the
// rows of a shared-memory tile of 32 columns.
#pragma once

#include "common.cuh"

namespace dlpd {
namespace {

constexpr int kCols = 32;   // columns of an FFT tile: one lane each

struct cf {
  float re, im;
};
__device__ __forceinline__ cf operator+(cf a, cf b) {
  return {a.re + b.re, a.im + b.im};
}
__device__ __forceinline__ cf operator-(cf a, cf b) {
  return {a.re - b.re, a.im - b.im};
}
__device__ __forceinline__ cf cmul(cf a, float2 w) {
  return {a.re * w.x - a.im * w.y, a.re * w.y + a.im * w.x};
}
__device__ __forceinline__ cf times_i(cf a) { return {-a.im, a.re}; }
__device__ __forceinline__ cf cconj(cf a) { return {a.re, -a.im}; }

// In-place inverse DFTs (sign +, no scaling), natural order in and out.
// The cube root of unity e^{+2 pi i/3} = -1/2 + i sqrt(3)/2.
constexpr float kSin60 = 0.86602540378443865f;   // sin(pi/3) = sqrt(3)/2

__device__ __forceinline__ void idft3(cf& a0, cf& a1, cf& a2) {
  const cf t = a1 + a2, d = a1 - a2;
  const cf m = {a0.re - 0.5f * t.re, a0.im - 0.5f * t.im};
  const cf s = {-kSin60 * d.im, kSin60 * d.re};   // i sqrt(3)/2 (a1 - a2)
  a0 = a0 + t;
  a1 = m + s;
  a2 = m - s;
}

__device__ __forceinline__ void idft4(cf& a0, cf& a1, cf& a2, cf& a3) {
  const cf t0 = a0 + a2, t1 = a0 - a2, t2 = a1 + a3, t3 = times_i(a1 - a3);
  a0 = t0 + t2;
  a2 = t0 - t2;
  a1 = t1 + t3;
  a3 = t1 - t3;
}

template <int N>
__device__ __forceinline__ void idft(cf* v);

// One butterfly: the c2r's radix-Q pass at L = 32.
template <>
__device__ __forceinline__ void idft<2>(cf* v) {
  const cf a0 = v[0];
  v[0] = a0 + v[1];
  v[1] = a0 - v[1];
}

template <>
__device__ __forceinline__ void idft<3>(cf* v) {
  idft3(v[0], v[1], v[2]);
}

template <>
__device__ __forceinline__ void idft<4>(cf* v) {
  idft4(v[0], v[1], v[2], v[3]);
}

// Odd N = 5 and 7 as direct inverse DFTs over the input pairs: with
// s_n = a_n + a_{N-n} and d_n = a_n - a_{N-n} (n = 1 .. (N-1)/2),
//   y_k = a_0 + sum_n s_n cos(2 pi n k / N) + i sum_n d_n sin(2 pi n k / N)
// and y_{N-k} the same with -i, for k = 1 .. (N-1)/2.  `i * b` is
// {-b.im, b.re}.
__device__ __forceinline__ void pair_out(cf* v, int k, int N, cf a, cf b) {
  v[k] = {a.re - b.im, a.im + b.re};
  v[N - k] = {a.re + b.im, a.im - b.re};
}

template <>
__device__ __forceinline__ void idft<5>(cf* v) {
  constexpr float c1 = 0.30901699437494745f;    // cos(2 pi / 5)
  constexpr float c2 = -0.80901699437494730f;   // cos(4 pi / 5)
  constexpr float s1 = 0.95105651629515350f;    // sin(2 pi / 5)
  constexpr float s2 = 0.58778525229247320f;    // sin(4 pi / 5)
  const cf a0 = v[0];
  const cf s1v = v[1] + v[4], d1 = v[1] - v[4];
  const cf s2v = v[2] + v[3], d2 = v[2] - v[3];
  v[0] = a0 + s1v + s2v;
  pair_out(v, 1, 5,
           {a0.re + c1 * s1v.re + c2 * s2v.re,
            a0.im + c1 * s1v.im + c2 * s2v.im},
           {s1 * d1.re + s2 * d2.re, s1 * d1.im + s2 * d2.im});
  pair_out(v, 2, 5,
           {a0.re + c2 * s1v.re + c1 * s2v.re,
            a0.im + c2 * s1v.im + c1 * s2v.im},
           {s2 * d1.re - s1 * d2.re, s2 * d1.im - s1 * d2.im});
}

template <>
__device__ __forceinline__ void idft<7>(cf* v) {
  constexpr float c1 = 0.62348980185873360f;    // cos(2 pi / 7)
  constexpr float c2 = -0.22252093395631434f;   // cos(4 pi / 7)
  constexpr float c3 = -0.90096886790241900f;   // cos(6 pi / 7)
  constexpr float s1 = 0.78183148246802980f;    // sin(2 pi / 7)
  constexpr float s2 = 0.97492791218182360f;    // sin(4 pi / 7)
  constexpr float s3 = 0.43388373911755823f;    // sin(6 pi / 7)
  const cf a0 = v[0];
  const cf p1 = v[1] + v[6], d1 = v[1] - v[6];
  const cf p2 = v[2] + v[5], d2 = v[2] - v[5];
  const cf p3 = v[3] + v[4], d3 = v[3] - v[4];
  v[0] = a0 + p1 + p2 + p3;
  // k = 1: n k = 1, 2, 3; k = 2: 2, 4 = -3, 6 = -1; k = 3: 3, 6 = -1, 9 = 2.
  pair_out(v, 1, 7,
           {a0.re + c1 * p1.re + c2 * p2.re + c3 * p3.re,
            a0.im + c1 * p1.im + c2 * p2.im + c3 * p3.im},
           {s1 * d1.re + s2 * d2.re + s3 * d3.re,
            s1 * d1.im + s2 * d2.im + s3 * d3.im});
  pair_out(v, 2, 7,
           {a0.re + c2 * p1.re + c3 * p2.re + c1 * p3.re,
            a0.im + c2 * p1.im + c3 * p2.im + c1 * p3.im},
           {s2 * d1.re - s3 * d2.re - s1 * d3.re,
            s2 * d1.im - s3 * d2.im - s1 * d3.im});
  pair_out(v, 3, 7,
           {a0.re + c3 * p1.re + c1 * p2.re + c2 * p3.re,
            a0.im + c3 * p1.im + c1 * p2.im + c2 * p3.im},
           {s3 * d1.re - s1 * d2.re + s2 * d3.re,
            s3 * d1.im - s1 * d2.im + s2 * d3.im});
}

// Two inverse DFTs of 3 (even and odd inputs), then the radix-2 step with
// the twiddles e^{+2 pi i n / 6}: output n and n + 3 from digit n.
template <>
__device__ __forceinline__ void idft<6>(cf* v) {
  cf e0 = v[0], e1 = v[2], e2 = v[4];
  cf o0 = v[1], o1 = v[3], o2 = v[5];
  idft3(e0, e1, e2);
  idft3(o0, o1, o2);
  constexpr float h = kSin60;
  o1 = {0.5f * o1.re - h * o1.im, h * o1.re + 0.5f * o1.im};   // x e^{i pi/3}
  o2 = {-0.5f * o2.re - h * o2.im, h * o2.re - 0.5f * o2.im};  // x e^{2i pi/3}
  v[0] = e0 + o0;
  v[3] = e0 - o0;
  v[1] = e1 + o1;
  v[4] = e1 - o1;
  v[2] = e2 + o2;
  v[5] = e2 - o2;
}

template <>
__device__ __forceinline__ void idft<8>(cf* v) {
  cf e0 = v[0], e1 = v[2], e2 = v[4], e3 = v[6];
  cf o0 = v[1], o1 = v[3], o2 = v[5], o3 = v[7];
  idft4(e0, e1, e2, e3);
  idft4(o0, o1, o2, o3);
  constexpr float r = 0.70710678118654752f;
  o1 = {r * (o1.re - o1.im), r * (o1.re + o1.im)};      // x e^{i pi/4}
  o2 = times_i(o2);                                     // x e^{i pi/2}
  o3 = {-r * (o3.re + o3.im), r * (o3.re - o3.im)};     // x e^{3i pi/4}
  v[0] = e0 + o0;
  v[4] = e0 - o0;
  v[1] = e1 + o1;
  v[5] = e1 - o1;
  v[2] = e2 + o2;
  v[6] = e2 - o2;
  v[3] = e3 + o3;
  v[7] = e3 - o3;
}

// Two inverse DFTs of H (even and odd inputs), then the radix-2 step with
// the twiddles w[n] = e^{+2 pi i n / (2H)}: output n and n + H from digit n.
template <int H>
__device__ __forceinline__ void idft_radix2(cf* v, const float2 (&w)[H]) {
  cf e[H], o[H];
#pragma unroll
  for (int j = 0; j < H; ++j) {
    e[j] = v[2 * j];
    o[j] = v[2 * j + 1];
  }
  idft<H>(e);
  idft<H>(o);
#pragma unroll
  for (int n = 0; n < H; ++n) {
    const cf t = cmul(o[n], w[n]);
    v[n] = e[n] + t;
    v[n + H] = e[n] - t;
  }
}

template <>
__device__ __forceinline__ void idft<10>(cf* v) {
  const float2 w[5] = {{1.f, 0.f},
                       {0.80901699437494750f, 0.58778525229247310f},
                       {0.30901699437494745f, 0.95105651629515350f},
                       {-0.30901699437494734f, 0.95105651629515360f},
                       {-0.80901699437494730f, 0.58778525229247320f}};
  idft_radix2<5>(v, w);
}

template <>
__device__ __forceinline__ void idft<12>(cf* v) {
  constexpr float h = kSin60;
  const float2 w[6] = {{1.f, 0.f}, {h, 0.5f},  {0.5f, h},
                       {0.f, 1.f}, {-0.5f, h}, {-h, 0.5f}};
  idft_radix2<6>(v, w);
}

template <>
__device__ __forceinline__ void idft<14>(cf* v) {
  const float2 w[7] = {{1.f, 0.f},
                       {0.90096886790241910f, 0.43388373911755810f},
                       {0.62348980185873360f, 0.78183148246802980f},
                       {0.22252093395631445f, 0.97492791218182360f},
                       {-0.22252093395631434f, 0.97492791218182360f},
                       {-0.62348980185873350f, 0.78183148246802990f},
                       {-0.90096886790241900f, 0.43388373911755823f}};
  idft_radix2<7>(v, w);
}

template <>
__device__ __forceinline__ void idft<16>(cf* v) {
  constexpr float c1 = 0.92387953251128676f;   // cos(pi/8)
  constexpr float s1 = 0.38268343236508977f;   // sin(pi/8)
  constexpr float r = 0.70710678118654752f;
  const float2 w[8] = {{1.f, 0.f}, {c1, s1}, {r, r},   {s1, c1},
                       {0.f, 1.f}, {-s1, c1}, {-r, r}, {-c1, s1}};
  idft_radix2<8>(v, w);
}

__device__ __forceinline__ void cp_async16(float* smem_dst,
                                           const float* gmem_src) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem_src)
               : "memory");
}
// As cp_async16, but only where `in`: elsewhere it reads nothing (src-size
// 0) and fills the 16 bytes with zeros.  `gmem_src` must be a valid
// address either way.
__device__ __forceinline__ void cp_async16(float* smem_dst,
                                           const float* gmem_src, bool in) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem_src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most `pending` (< 4) of this thread's copy groups are in
// flight.
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory");
  }
}

// e^{+2 pi i j / L} for j < L into `tw`, one sincospif per thread.
template <int L>
__device__ __forceinline__ void fill_twiddles(float2* tw) {
  for (int j = threadIdx.x; j < L; j += blockDim.x) {
    float s, c;
    sincospif(2.0f * j / L, &s, &c);
    tw[j] = make_float2(c, s);
  }
}

// The c2r inverse of length L (16 x Q, Q = 2..8) down the columns of a shared
// tile: rows re/im [L/2 + 1][kCols] hold the half spectrum X[k] of kCols
// sequences, one per lane.  Called by all 8 warps of the block, after a
// barrier that made the rows and `tw` (fill_twiddles<L>) visible.
//
//  1. Pack: the c2r of length L is a complex inverse FFT of length
//     M = L/2 on Z[k] = (X[k] + conj X[M-k]) + i e^{+2 pi i k/L}
//     (X[k] - conj X[M-k]); its output z[n] holds L (s[2n] + i s[2n+1]),
//     s = irfft(X) with its 1/L.  X[0] and X[M] count by their real parts
//     only, as irfft and a dense Hermitian matrix (sine row 0) take them.
//  2. M = P x Q with P = 8: warp k2 (< Q) takes Z[Q k1 + k2] over k1, a
//     radix-8 inverse DFT in registers, then the twiddle
//     e^{+2 pi i k2 n1 / M}; the results go back to shared memory in
//     place (row n1 Q + k2).  Warp n1 then takes the Q entries of row
//     block n1, a radix-Q (2 .. 8) inverse DFT in registers.  Warps
//     k2 >= Q sit out step 2's first half (6 at Q = 2, 5 at Q = 3, 3 at
//     Q = 5, 1 at Q = 7), and the twiddle index 2 k2 n1 <= 14 (Q - 1)
//     stays below L = 16 Q.
//
// On return warp n1 holds u[n2] = z[n1 + 8 n2] for its lane's column; the
// rows are overwritten, and a barrier must precede their next writes.
template <int L>
__device__ __forceinline__ void c2r_columns(float* re, float* im,
                                            const float2* tw,
                                            cf (&u)[L / 16]) {
  constexpr int M = L / 2, P = 8, Q = M / P;
  static_assert(P * Q == M && Q >= 2 && Q <= 8, "L must be 16 x (2 .. 8)");
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;

  cf v[P];
  const int k2 = warp;
  if (k2 < Q) {
#pragma unroll
    for (int k1 = 0; k1 < P; ++k1) {
      const int k = Q * k1 + k2;
      cf a = {re[k * kCols + lane], im[k * kCols + lane]};
      cf m = {re[(M - k) * kCols + lane], im[(M - k) * kCols + lane]};
      if (k == 0) {        // X[0], X[M]: real parts only
        a.im = 0.f;
        m.im = 0.f;
      }
      const cf s = a + cconj(m), d = a - cconj(m);
      v[k1] = s + times_i(cmul(d, tw[k]));
    }
    idft<P>(v);
#pragma unroll
    for (int n1 = 1; n1 < P; ++n1) {
      v[n1] = cmul(v[n1], tw[(2 * k2 * n1) % L]);   // e^{2 pi i k2 n1/M}
    }
  }
  __syncthreads();
  if (k2 < Q) {
#pragma unroll
    for (int n1 = 0; n1 < P; ++n1) {
      re[(n1 * Q + k2) * kCols + lane] = v[n1].re;
      im[(n1 * Q + k2) * kCols + lane] = v[n1].im;
    }
  }
  __syncthreads();

  const int n1 = warp;
#pragma unroll
  for (int j = 0; j < Q; ++j) {
    u[j] = {re[(n1 * Q + j) * kCols + lane], im[(n1 * Q + j) * kCols + lane]};
  }
  idft<Q>(u);
}

}  // namespace
}  // namespace dlpd
