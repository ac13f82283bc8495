// K2: fused Hermitian kz->z inverse + translation mask + block max.
//
// Replaces the TPU kernel `_invz_bmax_kernel` / `_invz_blockmax_call`
// in deeplocalproteindocking_tpu/correlate/pallas_invz_topk.py.  For one
// rotation b, one x row and one 32-wide run of y it computes
//
//   S[y, z]   = sum_k Dre[b,k,x,y] MzRe[k,z] - Dim[b,k,x,y] MzIm[k,z]
//   S[y, z]  += bias[g, x, y, z]        (0 / -inf; added, never multiplied)
//   bmax[z]   = max over the 32 y of the run
//
// so the score volume never reaches device memory.  Blocks are 32-wide
// y runs at fixed (x, z) and bmax is [b, X, Y/32, Z], exactly the TPU
// kernel's layout, so drill_topk and the canonical flat index
// x*L^2 + y*L + z are unchanged.  A fully masked run gives -inf.
//
// What bounds it on the H100: arithmetic on the CUDA cores.  Per
// rotation at L=128 it reads D (2 x 65 x 128^2 float32 = 8.5 MB) and the
// bias volume (8 MB, shared by all rotations of a group, so
// L2-resident), for 0.55 GFLOP: ~64 FLOP per byte of D, about three
// times the card's float32 CUDA-core balance (67 TFLOP/s over
// 3.35 TB/s).  On tensor cores it would be bound by reading D instead.
// Design: one block of Z threads per (y run, x, b); the block stages
// its [K, 32] slices of Dre/Dim in shared memory (one coalesced read of
// D overall), each thread owns one z and keeps the 32 partial sums of
// its column in registers, reading Mz[k, z] coalesced from L1/L2 and the
// D slices as shared-memory broadcasts (no bank conflicts).
#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace dlpd {
namespace {

constexpr int kYB = 32;   // block width along y

__global__ void invz_blockmax_kernel(const float* __restrict__ Dre,
                                     const float* __restrict__ Dim,
                                     const float* __restrict__ MzRe,
                                     const float* __restrict__ MzIm,
                                     const float* __restrict__ bias,
                                     float* __restrict__ bmax, int K, int X,
                                     int Y, int Z, int rows_per_group) {
  const int yb = blockIdx.x;
  const int x = blockIdx.y;
  const int bb = blockIdx.z;
  const int z = threadIdx.x;

  extern __shared__ float sd[];
  float* s_re = sd;               // [K][kYB]
  float* s_im = sd + K * kYB;
  const size_t plane = static_cast<size_t>(X) * Y;
  const size_t d_base = static_cast<size_t>(bb) * K * plane +
                        static_cast<size_t>(x) * Y + yb * kYB;
  for (int o = threadIdx.x; o < K * kYB; o += blockDim.x) {
    const int kk = o / kYB, yy = o % kYB;
    const size_t idx = d_base + kk * plane + yy;
    s_re[o] = Dre[idx];
    s_im[o] = Dim[idx];
  }
  __syncthreads();
  if (z >= Z) return;

  float acc[kYB];
#pragma unroll
  for (int yy = 0; yy < kYB; ++yy) acc[yy] = 0.f;
  for (int kk = 0; kk < K; ++kk) {
    const float mr = MzRe[kk * Z + z];
    const float mi = MzIm[kk * Z + z];
#pragma unroll
    for (int yy = 0; yy < kYB; ++yy) {
      acc[yy] = fmaf(s_re[kk * kYB + yy], mr,
                     fmaf(-s_im[kk * kYB + yy], mi, acc[yy]));
    }
  }
  const int g = bb / rows_per_group;
  const float* bz = bias + ((static_cast<size_t>(g) * X + x) * Y +
                            static_cast<size_t>(yb) * kYB) * Z + z;
  float m = -INFINITY;
#pragma unroll
  for (int yy = 0; yy < kYB; ++yy) {
    m = fmaxf(m, acc[yy] + bz[static_cast<size_t>(yy) * Z]);
  }
  bmax[((static_cast<size_t>(bb) * X + x) * (Y / kYB) + yb) * Z + z] = m;
}

}  // namespace
}  // namespace dlpd

// Returns a cudaError_t: 0 on a successful launch.
extern "C" int dlpd_invz_blockmax(const void* Dre, const void* Dim,
                                  const void* MzRe, const void* MzIm,
                                  const void* bias, void* bmax, int b, int K,
                                  int X, int Y, int Z, int G, void* stream) {
  if (Y % dlpd::kYB || G < 1 || b % G || Z < 1 || Z > 1024 || X > 65535 ||
      b > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = 2 * sizeof(float) * static_cast<size_t>(K) * dlpd::kYB;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        dlpd::invz_blockmax_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(Y / dlpd::kYB, X, b);
  dlpd::invz_blockmax_kernel<<<grid, Z, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(Dre), static_cast<const float*>(Dim),
      static_cast<const float*>(MzRe), static_cast<const float*>(MzIm),
      static_cast<const float*>(bias), static_cast<float*>(bmax), K, X, Y, Z,
      b / G);
  return static_cast<int>(cudaGetLastError());
}
