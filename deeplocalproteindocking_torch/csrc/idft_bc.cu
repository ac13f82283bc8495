// K3: passes B and C of the inverse DFT of the correlation spectrum.
//
// Replaces the TPU kernel `_idft_bc_kernel` / `pallas_inverse` in
// deeplocalproteindocking_tpu/correlate/pallas_idft.py.  Pass A (the
// Hermitian-weighted kz -> z contraction) runs before it as a torch
// einsum, as it runs in XLA before the TPU kernel, and leaves the
// complex volume E[b, kx, ky, z].  This kernel computes, in float32,
//
//   f[x, ky, z] = sum_kx Ux[kx, x] E[b, kx, ky, z]              (pass B)
//   S[b, x, y, z] = Re sum_ky Uy[ky, y] f[x, ky, z]             (pass C)
//
// with Ux [kx, x] and Uy [ky, y] the complex inverse twiddles (1/L
// folded in), so the intermediate f never reaches device memory.
//
// What bounds it on the H100: arithmetic.  One rotation at L = 128 is
// 3.2 GFLOP (passes B + C) against 16 MB of E read and 8 MB of S
// written: ~130 FLOP per byte, above the card's float32 CUDA-core
// balance (67 TFLOP/s over 3.35 TB/s = 20).  This first version runs
// plain float32 FMA loops on the CUDA cores; tensor cores are later work.
//
// What the design does about the working set: the TPU kernel kept the
// accumulator d[8, L, L] (512 KB at L = 128) in VMEM and streamed
// [L, 16, L] slabs of E (1 MB); a Hopper block has at most 227 KB of
// shared memory.  So the output is tiled along z as well as x: one block
// per (8-row x tile, 16-wide z tile, rotation), 256 threads.  The block
// walks ky in blocks of 16.  In pass B each thread owns one (ky, z) of
// the ky block and all 8 x rows: it streams its column E[:, ky, z]
// straight from device memory (every E element of the block's slice is
// read by exactly one thread, coalesced along z) against the block's Ux
// columns in shared memory (8 KB), keeping f in 16 registers.  f then
// goes through shared memory (16 KB) to pass C, where each thread owns
// one z and L/16 y values for all 8 x rows, keeping its part of the
// d[8, L, 16] accumulator in registers (64 at L = 128) across the whole
// ky walk, reading Uy through the read-only cache.  The x tile is the
// grid's fastest axis, so the L/8 blocks that read the same E slice
// (b, z tile) run together and share it in L2.
#include <cstdint>

#include "common.cuh"

namespace dlpd {
namespace {

constexpr int kThreads = 256;
constexpr int kTX = 8;      // x rows per block
constexpr int kTZ = 16;     // z columns per block
constexpr int kKYB = 16;    // ky block
constexpr int kMaxL = 128;  // y values per thread = L / 16 <= 8
static_assert(kThreads == kTZ * kKYB, "pass B maps one (ky, z) per thread");

// YPT = L / 16: the y values each thread owns in pass C.
template <int YPT>
__global__ void __launch_bounds__(kThreads)
idft_bc_kernel(const float* __restrict__ Ere, const float* __restrict__ Eim,
               const float* __restrict__ UxRe, const float* __restrict__ UxIm,
               const float* __restrict__ UyRe, const float* __restrict__ UyIm,
               float* __restrict__ S) {
  constexpr int L = YPT * 16;
  const int x0 = blockIdx.x * kTX;
  const int z0 = blockIdx.y * kTZ;
  const size_t b = blockIdx.z;
  const int tz = threadIdx.x % kTZ;
  const int tg = threadIdx.x / kTZ;   // ky within the block (B), y group (C)

  __shared__ __align__(16) float s_uxr[L * kTX];   // [kx][x]
  __shared__ __align__(16) float s_uxi[L * kTX];
  __shared__ float s_fr[kTX * kKYB * kTZ];         // [x][ky][z]
  __shared__ float s_fi[kTX * kKYB * kTZ];

  for (int o = threadIdx.x; o < L * kTX; o += kThreads) {
    const int kx = o / kTX, x = o % kTX;
    s_uxr[o] = UxRe[kx * L + x0 + x];
    s_uxi[o] = UxIm[kx * L + x0 + x];
  }
  __syncthreads();

  float d[kTX][YPT];
#pragma unroll
  for (int x = 0; x < kTX; ++x) {
#pragma unroll
    for (int j = 0; j < YPT; ++j) d[x][j] = 0.f;
  }

  constexpr size_t plane = static_cast<size_t>(L) * L;   // one kx slab
  const float* er_b = Ere + b * L * plane + z0 + tz;
  const float* ei_b = Eim + b * L * plane + z0 + tz;
  const int y0 = tg * YPT;

  for (int ky0 = 0; ky0 < L; ky0 += kKYB) {
    // Pass B: f[x, ky0 + tg, z0 + tz] for the 8 x rows.
    float fr[kTX], fi[kTX];
#pragma unroll
    for (int x = 0; x < kTX; ++x) fr[x] = fi[x] = 0.f;
    const float* er = er_b + static_cast<size_t>(ky0 + tg) * L;
    const float* ei = ei_b + static_cast<size_t>(ky0 + tg) * L;
#pragma unroll 4
    for (int kx = 0; kx < L; ++kx) {
      const float a = __ldg(er + kx * plane);
      const float c = __ldg(ei + kx * plane);
      const float4* ur = reinterpret_cast<const float4*>(s_uxr + kx * kTX);
      const float4* ui = reinterpret_cast<const float4*>(s_uxi + kx * kTX);
      const float4 r0 = ur[0], r1 = ur[1], i0 = ui[0], i1 = ui[1];
      const float uxr[kTX] = {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.z, r1.w};
      const float uxi[kTX] = {i0.x, i0.y, i0.z, i0.w, i1.x, i1.y, i1.z, i1.w};
#pragma unroll
      for (int x = 0; x < kTX; ++x) {
        fr[x] = fmaf(uxr[x], a, fmaf(-uxi[x], c, fr[x]));
        fi[x] = fmaf(uxr[x], c, fmaf(uxi[x], a, fi[x]));
      }
    }
    __syncthreads();   // pass C of the previous ky block is done with s_f
#pragma unroll
    for (int x = 0; x < kTX; ++x) {
      s_fr[(x * kKYB + tg) * kTZ + tz] = fr[x];
      s_fi[(x * kKYB + tg) * kTZ + tz] = fi[x];
    }
    __syncthreads();

    // Pass C: d[x, y0 + j, z0 + tz] += Re Uy[ky, y] f[x, ky, z].
    for (int kk = 0; kk < kKYB; ++kk) {
      const size_t row = static_cast<size_t>(ky0 + kk) * L + y0;
      float uyr[YPT], uyi[YPT];
      if constexpr (YPT % 4 == 0) {
        // 16-byte aligned: L % 16 == 0 and y0 is a multiple of 4.
#pragma unroll
        for (int j = 0; j < YPT; j += 4) {
          const float4 r = __ldg(reinterpret_cast<const float4*>(UyRe + row + j));
          const float4 i = __ldg(reinterpret_cast<const float4*>(UyIm + row + j));
          uyr[j] = r.x; uyr[j + 1] = r.y; uyr[j + 2] = r.z; uyr[j + 3] = r.w;
          uyi[j] = i.x; uyi[j + 1] = i.y; uyi[j + 2] = i.z; uyi[j + 3] = i.w;
        }
      } else {
#pragma unroll
        for (int j = 0; j < YPT; ++j) {
          uyr[j] = __ldg(UyRe + row + j);
          uyi[j] = __ldg(UyIm + row + j);
        }
      }
#pragma unroll
      for (int x = 0; x < kTX; ++x) {
        const float a = s_fr[(x * kKYB + kk) * kTZ + tz];
        const float c = s_fi[(x * kKYB + kk) * kTZ + tz];
#pragma unroll
        for (int j = 0; j < YPT; ++j) {
          d[x][j] = fmaf(uyr[j], a, fmaf(-uyi[j], c, d[x][j]));
        }
      }
    }
  }

#pragma unroll
  for (int x = 0; x < kTX; ++x) {
    float* out = S + ((b * L + x0 + x) * L + y0) * L + z0 + tz;
#pragma unroll
    for (int j = 0; j < YPT; ++j) out[static_cast<size_t>(j) * L] = d[x][j];
  }
}

template <int YPT>
int launch(const float* Ere, const float* Eim, const float* UxRe,
           const float* UxIm, const float* UyRe, const float* UyIm, float* S,
           int B, cudaStream_t stream) {
  constexpr int L = YPT * 16;
  const dim3 grid(L / kTX, L / kTZ, B);
  idft_bc_kernel<YPT><<<grid, kThreads, 0, stream>>>(Ere, Eim, UxRe, UxIm,
                                                     UyRe, UyIm, S);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace dlpd

// Returns a cudaError_t: 0 on a successful launch.  E re/im [B, L, L, L]
// (kx, ky, z), Ux/Uy re/im [L, L] (k, position), S [B, L, L, L] (x, y, z),
// all float32 and contiguous; L a multiple of 16, at most 128.
extern "C" int dlpd_idft_bc(const void* Ere, const void* Eim,
                            const void* UxRe, const void* UxIm,
                            const void* UyRe, const void* UyIm, void* S,
                            int B, int L, void* stream) {
  if (B < 1 || B > 65535 || L < 16 || L % 16 || L > dlpd::kMaxL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* er = static_cast<const float*>(Ere);
  const auto* ei = static_cast<const float*>(Eim);
  const auto* uxr = static_cast<const float*>(UxRe);
  const auto* uxi = static_cast<const float*>(UxIm);
  const auto* uyr = static_cast<const float*>(UyRe);
  const auto* uyi = static_cast<const float*>(UyIm);
  auto* s = static_cast<float*>(S);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (L / 16) {
    case 1: return dlpd::launch<1>(er, ei, uxr, uxi, uyr, uyi, s, B, st);
    case 2: return dlpd::launch<2>(er, ei, uxr, uxi, uyr, uyi, s, B, st);
    case 3: return dlpd::launch<3>(er, ei, uxr, uxi, uyr, uyi, s, B, st);
    case 4: return dlpd::launch<4>(er, ei, uxr, uxi, uyr, uyi, s, B, st);
    case 5: return dlpd::launch<5>(er, ei, uxr, uxi, uyr, uyi, s, B, st);
    case 6: return dlpd::launch<6>(er, ei, uxr, uxi, uyr, uyi, s, B, st);
    case 7: return dlpd::launch<7>(er, ei, uxr, uxi, uyr, uyi, s, B, st);
    case 8: return dlpd::launch<8>(er, ei, uxr, uxi, uyr, uyi, s, B, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
