// K2, FFT route: the kz->z c2r inverse as a real FFT + translation mask +
// block max, for L = 64 and 128.
//
// Replaces the TPU kernel `_invz_bmax_kernel` / `_invz_blockmax_call` in
// deeplocalproteindocking_tpu/correlate/pallas_invz_topk.py, computing the
// same function as csrc/invz_blockmax.cu:
//
//   S[b, x, y, :]  = irfft(D[b, :, x, y])     (length L, with its 1/L)
//   bmax[b, x, yb, z] = max over the 32 y of run yb of S[.., y, z] + bias
//
// The TPU kernel's Mz [K, L] contraction is exactly that c2r inverse
// (Hermitian weights 1, 2, ..., 2, 1 and 1/L), so the wrapper
// (correlate/invz_topk.py) routes here only with that Mz, which this
// kernel therefore never reads.  Same bias groups, [b, X, Y/32, Z] layout
// and -inf semantics, so drill_topk is unchanged.
//
// What bounds it on the H100: bytes.  At the main path's chunk (b = 128,
// L = 128) it reads D, 2 x 128 x 65 x 128^2 x 4 B = 1.090 GB, the bias
// (8.4 MB at G = 1) and writes bmax (33.5 MB): 1.13 GB / 3.35 TB/s =
// 0.34 ms.  The FFT does about 5 GFLOP, far below that line; the dense
// contraction of invz_blockmax.cu does 69.8 GFLOP on the float32 CUDA
// cores, above it.
//
// Design.  One block of 8 warps per (32-wide y run, x, pair of rotations).
// Each rotation's D rows [K, 32] (re, im) are copied with cp.async into
// their own 16.6 KB shared buffer, both rotations' copies issued at once;
// lane = y throughout, so every shared access is one 128 B row.
//  1. Pack: the c2r of length L is a complex inverse FFT of length
//     M = L/2 on Z[k] = (X[k] + conj X[M-k]) + i e^{+2 pi i k/L}
//     (X[k] - conj X[M-k]); its output holds S[2n] + i S[2n+1], times
//     1/L.  X[0] and X[M] count by their real parts only, as irfft and
//     the dense Mz (whose sine row is 0 there) take them.
//  2. M = P x Q with P = 8: warp k2 (< Q) takes Z[Q k1 + k2] over k1, a
//     radix-8 inverse DFT in registers, then the twiddle
//     e^{+2 pi i k2 n1 / M}; the results go back to shared memory in
//     place (row n1 Q + k2).  Warp n1 then takes the Q entries of row
//     block n1, a radix-Q (8 or 4) inverse DFT in registers, giving
//     z[n1 + P n2].
//  3. S[y, z] goes to shared memory over the D buffer (rows padded to
//     L + 1 floats: no bank conflicts); each thread owns one z of a y
//     group, adds the bias (read coalesced along z, kept in registers
//     across both rotations when they share a group) and takes the max;
//     the groups' maxima combine through shared memory.
// Twiddles e^{+2 pi i j / L} are computed once per block into shared
// memory (one sincospif per thread) and read as warp-wide broadcasts.
// Float32 throughout, as the TPU kernel casts.
#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace dlpd {
namespace {

constexpr int kYB = 32;         // block width along y: one lane per y
constexpr int kThreads = 256;   // 8 warps
constexpr int kRot = 2;         // rotations per block

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
__device__ __forceinline__ void idft4(cf& a0, cf& a1, cf& a2, cf& a3) {
  const cf t0 = a0 + a2, t1 = a0 - a2, t2 = a1 + a3, t3 = times_i(a1 - a3);
  a0 = t0 + t2;
  a2 = t0 - t2;
  a1 = t1 + t3;
  a3 = t1 - t3;
}

template <int N>
__device__ __forceinline__ void idft(cf* v);

template <>
__device__ __forceinline__ void idft<4>(cf* v) {
  idft4(v[0], v[1], v[2], v[3]);
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

__device__ __forceinline__ void cp_async16(float* smem_dst,
                                           const float* gmem_src) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem_src)
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

template <int L>
__global__ void __launch_bounds__(kThreads)
    invz_blockmax_fft_kernel(const float* __restrict__ Dre,
                             const float* __restrict__ Dim,
                             const float* __restrict__ bias,
                             float* __restrict__ bmax, int b, int X, int Y,
                             int rows_per_group) {
  constexpr int M = L / 2, K = M + 1, P = 8, Q = M / P;
  constexpr int kBuf = 2 * K * kYB;    // floats per rotation: re rows, im rows
  constexpr int kLd = L + 1;           // padded row of the tile S[y][z]
  constexpr int NG = kThreads / L;     // y groups in the epilogue
  constexpr int YPG = kYB / NG;        // y per group
  constexpr int kVec = kYB / 4;        // float4 per D row
  static_assert(Q == 4 || Q == 8, "L must be 64 or 128");
  static_assert(kYB * kLd <= kBuf, "S must fit in the D buffer");
  static_assert(P * kYB == kThreads && NG * L == kThreads, "block shape");

  extern __shared__ __align__(16) float smem[];   // kRot x kBuf
  __shared__ float2 s_tw[L];                       // e^{+2 pi i j / L}
  __shared__ float s_red[kThreads];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int yb = blockIdx.x, x = blockIdx.y, b0 = blockIdx.z * kRot;
  const size_t plane = static_cast<size_t>(X) * Y;
  const size_t col = static_cast<size_t>(x) * Y + yb * kYB;

  // Every rotation's copies at once, one cp.async group per rotation.
#pragma unroll
  for (int r = 0; r < kRot; ++r) {
    if (b0 + r < b) {
      float* buf = smem + r * kBuf;
      for (int o = tid; o < 2 * K * kVec; o += kThreads) {
        const int half = o / (K * kVec), rem = o % (K * kVec);
        const int k = rem / kVec, c = rem % kVec;
        const float* src = (half ? Dim : Dre) +
                           (static_cast<size_t>(b0 + r) * K + k) * plane +
                           col + 4 * c;
        cp_async16(buf + half * K * kYB + k * kYB + 4 * c, src);
      }
    }
    cp_async_commit();
  }
  for (int j = tid; j < L; j += kThreads) {
    float s, c;
    sincospif(2.0f * j / L, &s, &c);
    s_tw[j] = make_float2(c, s);
  }

  // The epilogue's bias: thread (grp, z) reads YPG rows of its group.
  const int z = tid % L, grp = tid / L;
  float bz[YPG];
  int g_loaded = -1;

#pragma unroll 1
  for (int r = 0; r < kRot; ++r) {
    const int bb = b0 + r;
    if (bb >= b) break;                         // uniform over the block
    const int g = bb / rows_per_group;
    if (g != g_loaded) {
      const float* bp = bias + ((static_cast<size_t>(g) * X + x) * Y +
                                yb * kYB + grp * YPG) * L + z;
#pragma unroll
      for (int j = 0; j < YPG; ++j) bz[j] = __ldg(bp + static_cast<size_t>(j) * L);
      g_loaded = g;
    }
    cp_async_wait(kRot - 1 - r);
    __syncthreads();
    float* re = smem + r * kBuf;
    float* im = re + K * kYB;

    // 1-2a. Pack and radix-P pass over k1 for k2 = warp.
    cf v[P];
    const int k2 = warp;
    if (k2 < Q) {
#pragma unroll
      for (int k1 = 0; k1 < P; ++k1) {
        const int k = Q * k1 + k2;
        cf a = {re[k * kYB + lane], im[k * kYB + lane]};
        cf m = {re[(M - k) * kYB + lane], im[(M - k) * kYB + lane]};
        if (k == 0) {        // X[0], X[M]: real parts only
          a.im = 0.f;
          m.im = 0.f;
        }
        const cf s = a + cconj(m), d = a - cconj(m);
        v[k1] = s + times_i(cmul(d, s_tw[k]));
      }
      idft<P>(v);
#pragma unroll
      for (int n1 = 1; n1 < P; ++n1) {
        v[n1] = cmul(v[n1], s_tw[(2 * k2 * n1) % L]);   // e^{2 pi i k2 n1/M}
      }
    }
    __syncthreads();
    if (k2 < Q) {
#pragma unroll
      for (int n1 = 0; n1 < P; ++n1) {
        re[(n1 * Q + k2) * kYB + lane] = v[n1].re;
        im[(n1 * Q + k2) * kYB + lane] = v[n1].im;
      }
    }
    __syncthreads();

    // 2b. Radix-Q pass over k2 for n1 = warp: z[n1 + P n2].
    const int n1 = warp;
    cf u[Q];
#pragma unroll
    for (int j = 0; j < Q; ++j) {
      u[j] = {re[(n1 * Q + j) * kYB + lane], im[(n1 * Q + j) * kYB + lane]};
    }
    idft<Q>(u);
    __syncthreads();
    float* S = re;                              // [kYB][kLd] over the buffer
    constexpr float kScale = 1.0f / L;
#pragma unroll
    for (int n2 = 0; n2 < Q; ++n2) {
      const int n = n1 + P * n2;
      S[lane * kLd + 2 * n] = u[n2].re * kScale;
      S[lane * kLd + 2 * n + 1] = u[n2].im * kScale;
    }
    __syncthreads();

    // 3. Bias, then the max over the 32 y of the run.
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < YPG; ++j) {
      mx = fmaxf(mx, S[(grp * YPG + j) * kLd + z] + bz[j]);
    }
    s_red[tid] = mx;
    __syncthreads();
    if (grp == 0) {
#pragma unroll
      for (int q = 1; q < NG; ++q) mx = fmaxf(mx, s_red[q * L + z]);
      bmax[((static_cast<size_t>(bb) * X + x) * (Y / kYB) + yb) * L + z] = mx;
    }
  }
}

template <int L>
int launch(const float* Dre, const float* Dim, const float* bias, float* out,
           int b, int X, int Y, int G, cudaStream_t stream) {
  constexpr int kBufBytes = 2 * (L / 2 + 1) * kYB * sizeof(float);
  const int smem = kRot * kBufBytes;
  static_assert(kRot <= 4, "cp_async_wait takes up to 3 pending groups");
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        invz_blockmax_fft_kernel<L>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(Y / kYB, X, (b + kRot - 1) / kRot);
  invz_blockmax_fft_kernel<L><<<grid, kThreads, smem, stream>>>(
      Dre, Dim, bias, out, b, X, Y, b / G);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace dlpd

// D [b, L/2+1, X, Y], bias [G, X, Y, L], bmax [b, X, Y/32, L]; all float32,
// contiguous, D 16-byte aligned.  Returns a cudaError_t: 0 on a successful
// launch.
extern "C" int dlpd_invz_blockmax_fft(const void* Dre, const void* Dim,
                                      const void* bias, void* bmax, int b,
                                      int X, int Y, int L, int G,
                                      void* stream) {
  if (Y % dlpd::kYB || G < 1 || b < 1 || b % G || X < 1 || X > 65535 ||
      (b + dlpd::kRot - 1) / dlpd::kRot > 65535 ||
      (reinterpret_cast<uintptr_t>(Dre) | reinterpret_cast<uintptr_t>(Dim)) %
          16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* dre = static_cast<const float*>(Dre);
  const auto* dim = static_cast<const float*>(Dim);
  const auto* bs = static_cast<const float*>(bias);
  auto* out = static_cast<float*>(bmax);
  auto s = static_cast<cudaStream_t>(stream);
  if (L == 128) return dlpd::launch<128>(dre, dim, bs, out, b, X, Y, G, s);
  if (L == 64) return dlpd::launch<64>(dre, dim, bs, out, b, X, Y, G, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
