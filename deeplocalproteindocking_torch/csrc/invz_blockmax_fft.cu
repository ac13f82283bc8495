// K2, FFT route: the kz->z c2r inverse as a real FFT + translation mask +
// block max, for L = 32, 64, 96 and 128 (every L % 32 == 0 that K1 takes,
// so every L that the fused top-K tail reaches).
//
// Replaces the TPU kernel `_invz_bmax_kernel` / `_invz_blockmax_call` in
// deeplocalproteindocking_tpu/correlate/pallas_invz_topk.py, computing the
// same function as the plain version (invz_topk.invz_blockmax_reference):
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
// 0.34 ms.  The FFT does about 5 GFLOP, far below that line (the dense
// contraction as FMA loops would do 69.8 GFLOP on the float32 CUDA cores,
// above it).  At L = 32 (b = 128) the same count is 18.5 MB, 5.5 us: one
// launch of 2,048 blocks, whose latency is of the same order.
//
// Design.  One block of 8 warps per (32-wide y run, x, pair of rotations).
// Each rotation's D rows [K, 32] (re, im) are copied with cp.async into
// their own 16.6 KB shared buffer, both rotations' copies issued at once;
// lane = y throughout, so every shared access is one 128 B row.
//  1-2. The c2r along kz (fft.cuh, c2r_columns): the half spectrum packed
//     into a complex sequence of length M = L/2, a radix-8 pass with
//     twiddles, one in-place exchange through shared memory, a radix-Q
//     (8, 6, 4 or 2) pass; warp n1 ends with z[n1 + 8 n2] = L (S[2n] + i
//     S[2n+1]).  X[0] and X[M] count by their real parts only, as irfft
//     and the dense Mz (whose sine row is 0 there) take them.
//  3. S[y, z] goes to shared memory over the D buffer (rows padded to
//     L + 1 floats: no bank conflicts); each thread owns one z of a y
//     group, adds the bias (read coalesced along z, kept in registers
//     across both rotations when they share a group) and takes the max;
//     the groups' maxima combine through shared memory.  The groups are
//     256 / L of 32 L / 256 y each: 8 x 4 at L = 32, 4 x 8 at L = 64,
//     2 x 16 at 128, and 2 x 16 on 192 threads at L = 96 (which does not
//     divide 256; the other 64 threads sit this step out).
// Twiddles e^{+2 pi i j / L} are computed once per block into shared
// memory (one sincospif per thread) and read as warp-wide broadcasts.
// Float32 throughout, as the TPU kernel casts.
#include <cmath>
#include <cstdint>

#include "fft.cuh"

namespace dlpd {
namespace {

constexpr int kYB = kCols;      // block width along y: one lane per y
constexpr int kThreads = 256;   // 8 warps
constexpr int kRot = 2;         // rotations per block

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
  constexpr bool kAllThreads = NG * L == kThreads;   // L divides 256
  constexpr int kVec = kYB / 4;        // float4 per D row
  static_assert(Q == 2 || Q == 4 || Q == 6 || Q == 8,
                "L must be 32, 64, 96 or 128");
  static_assert(kYB * kLd <= kBuf, "S must fit in the D buffer");
  static_assert(P * kYB == kThreads && NG * YPG == kYB && NG * L <= kThreads,
                "block shape");

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
  fill_twiddles<L>(s_tw);

  // The epilogue's bias: thread (grp, z) reads YPG rows of its group.
  const int z = tid % L, grp = tid / L;
  const bool in_epilogue = kAllThreads || grp < NG;
  float bz[YPG];
  int g_loaded = -1;

#pragma unroll 1
  for (int r = 0; r < kRot; ++r) {
    const int bb = b0 + r;
    if (bb >= b) break;                         // uniform over the block
    const int g = bb / rows_per_group;
    if (in_epilogue && g != g_loaded) {
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

    // 1-2. Pack, then the radix-8 and radix-Q passes: warp n1 holds
    // z[n1 + P n2].
    const int n1 = warp;
    cf u[Q];
    c2r_columns<L>(re, im, s_tw, u);
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
    if (in_epilogue) {
#pragma unroll
      for (int j = 0; j < YPG; ++j) {
        mx = fmaxf(mx, S[(grp * YPG + j) * kLd + z] + bz[j]);
      }
      s_red[tid] = mx;
    }
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
  if (L == 96) return dlpd::launch<96>(dre, dim, bs, out, b, X, Y, G, s);
  if (L == 64) return dlpd::launch<64>(dre, dim, bs, out, b, X, Y, G, s);
  if (L == 32) return dlpd::launch<32>(dre, dim, bs, out, b, X, Y, G, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
