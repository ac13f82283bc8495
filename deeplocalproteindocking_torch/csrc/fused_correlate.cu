// K1: fused forward-y/x + channel coupling + inverse-x/y correlator.
//
// Replaces the TPU kernel `_kernel` / `fused_correlate` in
// deeplocalproteindocking_tpu/correlate/pallas_fused.py.  For one
// (kz frequency k, rotation b) it computes, with complex products as
// four real products accumulated in float32:
//
//   B[c,x,j]  = sum_y A[c,x,y]  Wy[y,j]              (forward y)
//   F[c,j,i]  = sum_x B[c,x,j]  Wx[x,i]              (forward x)
//   G[j,i]    = sum_c H[c,j,i] conj(F[c,j,i])        (coupling)
//   C[j,x']   = sum_i G[j,i]    Ux[i,x']             (inverse x)
//   D[x',y']  = sum_j C[j,x']   Uy[j,y']             (inverse y)
//
// and keeps the TPU kernel's rounding points: B, G and C are rounded to
// the operand type T (float or bf16); F and D stay float32; H is read as
// T and upcast.  H holds G receptor spectra [G, K, C, J, I] (G = 1: the
// single-complex form); row b correlates against H[b / (b_total / G)],
// so one launch serves a batched sweep step of G complexes.
//
// What bounds it on the H100: arithmetic.  At the main-path shapes
// (C=3, X=Y=32, J=I=X'=Y'=128) one (k, b) cell is ~50 MFLOP against
// 12 KB (bf16) of A in and 128 KB of D out: ~350 FLOP per byte, above
// the card's balance even for its bf16 tensor cores (~295).  This first version runs the products as plain
// float32 FMA loops on the CUDA cores (no tensor cores), so it is bound
// by FMA issue and shared-memory operand reads.
//
// What the design does about the working set: the TPU held the whole
// per-channel spectrum F (C x 128 x 128 complex f32 = 393 KB at C=3) in
// VMEM; a block has at most 227 KB of shared memory.  So one block per
// (b, k) walks over tiles of JT rows of j: for each tile it forms
// B[c,x,jt] and F[c,jt,:] per channel, folds F straight into per-thread
// G accumulators in registers (F never exists as a whole), rounds G into
// shared memory, forms C[jt,:], and adds C[jt,:]^T Uy[jt,:] into a D
// accumulator that lives in dynamic shared memory (re + im float32,
// 128 KB at L=128).  The ligand slab A[c] (X*Y elements) is read by the
// forward-y loop straight from device memory through the read-only cache,
// not staged, so shared memory does not grow with the box: at L = 128 it
// is 131,072 + 2 * elt * (8 X + 3 * 8 * 128) B, at most 163,840 B (float32,
// X = 128), under the 232,448 B a block may opt in to, for every box in
// both types.  Twiddles and the H slice of the current k are read from
// global memory, where they stay L2-resident across the grid: the grid's
// fastest axis is b, so consecutive blocks share H[g, k].
#include <cstdint>

#include "common.cuh"

namespace dlpd {
namespace {

constexpr int kThreads = 256;
constexpr int kJT = 8;         // j rows per tile
constexpr int kMaxI = 128;     // I (= L) limit of the register G tile
constexpr int kGPerThread = kJT * kMaxI / kThreads;

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_correlate_kernel(const T* __restrict__ Are, const T* __restrict__ Aim,
                       const T* __restrict__ Hre, const T* __restrict__ Him,
                       const T* __restrict__ WyRe, const T* __restrict__ WyIm,
                       const T* __restrict__ WxRe, const T* __restrict__ WxIm,
                       const T* __restrict__ UxRe, const T* __restrict__ UxIm,
                       const T* __restrict__ UyRe, const T* __restrict__ UyIm,
                       float* __restrict__ Dre, float* __restrict__ Dim,
                       int K, int C, int X, int Y, int J, int I, int Xp,
                       int Yp, int rows_per_group) {
  const int bb = blockIdx.x;   // rotation
  const int k = blockIdx.y;    // kz frequency
  const int tid = threadIdx.x;

  extern __shared__ __align__(16) unsigned char smem[];
  float* d_re = reinterpret_cast<float*>(smem);      // [Xp*Yp]
  float* d_im = d_re + Xp * Yp;
  T* b_re = reinterpret_cast<T*>(d_im + Xp * Yp);    // [X*kJT]
  T* b_im = b_re + X * kJT;
  T* g_re = b_im + X * kJT;                          // [kJT*I]
  T* g_im = g_re + kJT * I;
  T* c_re = g_im + kJT * I;                          // [kJT*Xp]
  T* c_im = c_re + kJT * Xp;
  T* uy_re = c_im + kJT * Xp;                        // [kJT*Yp]
  T* uy_im = uy_re + kJT * Yp;

  const size_t a_base = (static_cast<size_t>(bb) * K + k) * C * X * Y;
  const size_t h_base =
      (static_cast<size_t>(bb / rows_per_group) * K + k) * C * J * I;

  for (int o = tid; o < Xp * Yp; o += kThreads) {
    d_re[o] = 0.f;
    d_im[o] = 0.f;
  }

  for (int j0 = 0; j0 < J; j0 += kJT) {
    const int jn = min(kJT, J - j0);
    float gr[kGPerThread], gi[kGPerThread];
#pragma unroll
    for (int r = 0; r < kGPerThread; ++r) gr[r] = gi[r] = 0.f;

    for (int c = 0; c < C; ++c) {
      __syncthreads();  // b_s of the previous channel is consumed
      const T* ar = Are + a_base + static_cast<size_t>(c) * X * Y;
      const T* ai = Aim + a_base + static_cast<size_t>(c) * X * Y;
      // Forward y: B[x, jj] = sum_y A[x, y] Wy[y, j0 + jj], rounded to T;
      // A through the read-only cache (the kJT threads of one x share
      // each element).
      for (int o = tid; o < X * jn; o += kThreads) {
        const int x = o / jn, jj = o % jn;
        float sr = 0.f, si = 0.f;
        for (int y = 0; y < Y; ++y) {
          const float p = ldg_f32(ar + x * Y + y);
          const float q = ldg_f32(ai + x * Y + y);
          const float wr = to_f32(WyRe[y * J + j0 + jj]);
          const float wi = to_f32(WyIm[y * J + j0 + jj]);
          sr = fmaf(p, wr, fmaf(-q, wi, sr));
          si = fmaf(p, wi, fmaf(q, wr, si));
        }
        b_re[x * kJT + jj] = from_f32<T>(sr);
        b_im[x * kJT + jj] = from_f32<T>(si);
      }
      __syncthreads();
      // Forward x, then fold into G: F[jj, i] = sum_x B[x, jj] Wx[x, i];
      // G[jj, i] += H[c, j0+jj, i] conj(F[jj, i]) with H upcast.
#pragma unroll
      for (int r = 0; r < kGPerThread; ++r) {
        const int o = tid + r * kThreads;
        if (o < jn * I) {
          const int jj = o / I, i = o % I;
          float fr = 0.f, fi = 0.f;
          for (int x = 0; x < X; ++x) {
            const float p = to_f32(b_re[x * kJT + jj]);
            const float q = to_f32(b_im[x * kJT + jj]);
            const float wr = to_f32(WxRe[x * I + i]);
            const float wi = to_f32(WxIm[x * I + i]);
            fr = fmaf(p, wr, fmaf(-q, wi, fr));
            fi = fmaf(p, wi, fmaf(q, wr, fi));
          }
          const size_t h = h_base + (static_cast<size_t>(c) * J + j0 + jj) * I + i;
          const float hr = to_f32(Hre[h]);
          const float hi = to_f32(Him[h]);
          gr[r] = fmaf(hr, fr, fmaf(hi, fi, gr[r]));
          gi[r] = fmaf(hi, fr, fmaf(-hr, fi, gi[r]));
        }
      }
    }
    // G rounded to T; the Uy rows of this tile.
#pragma unroll
    for (int r = 0; r < kGPerThread; ++r) {
      const int o = tid + r * kThreads;
      if (o < jn * I) {
        g_re[o] = from_f32<T>(gr[r]);
        g_im[o] = from_f32<T>(gi[r]);
      }
    }
    for (int o = tid; o < jn * Yp; o += kThreads) {
      uy_re[o] = UyRe[static_cast<size_t>(j0) * Yp + o];
      uy_im[o] = UyIm[static_cast<size_t>(j0) * Yp + o];
    }
    __syncthreads();
    // Inverse x: C[jj, x'] = sum_i G[jj, i] Ux[i, x'], rounded to T.
    for (int o = tid; o < jn * Xp; o += kThreads) {
      const int jj = o / Xp, xp = o % Xp;
      float sr = 0.f, si = 0.f;
      for (int i = 0; i < I; ++i) {
        const float p = to_f32(g_re[jj * I + i]);
        const float q = to_f32(g_im[jj * I + i]);
        const float ur = to_f32(UxRe[i * Xp + xp]);
        const float ui = to_f32(UxIm[i * Xp + xp]);
        sr = fmaf(p, ur, fmaf(-q, ui, sr));
        si = fmaf(p, ui, fmaf(q, ur, si));
      }
      c_re[o] = from_f32<T>(sr);
      c_im[o] = from_f32<T>(si);
    }
    __syncthreads();
    // Inverse y: D[x', y'] += sum_jj C[jj, x'] Uy[jj, y'] (float32).
    for (int o = tid; o < Xp * Yp; o += kThreads) {
      const int xp = o / Yp, yp = o % Yp;
      float sr = d_re[o], si = d_im[o];
      for (int jj = 0; jj < jn; ++jj) {
        const float p = to_f32(c_re[jj * Xp + xp]);
        const float q = to_f32(c_im[jj * Xp + xp]);
        const float ur = to_f32(uy_re[jj * Yp + yp]);
        const float ui = to_f32(uy_im[jj * Yp + yp]);
        sr = fmaf(p, ur, fmaf(-q, ui, sr));
        si = fmaf(p, ui, fmaf(q, ur, si));
      }
      d_re[o] = sr;
      d_im[o] = si;
    }
    // The next tile's first __syncthreads (top of the channel loop)
    // orders these reads of c_s / uy_s before their next writes.
  }

  const size_t d_base = (static_cast<size_t>(bb) * K + k) * Xp * Yp;
  for (int o = tid; o < Xp * Yp; o += kThreads) {
    Dre[d_base + o] = d_re[o];
    Dim[d_base + o] = d_im[o];
  }
}

// Mirrored by fused.simt_smem_bytes in Python.
size_t smem_bytes(int X, int I, int Xp, int Yp, size_t elt) {
  return 2 * sizeof(float) * static_cast<size_t>(Xp) * Yp +
         2 * elt * static_cast<size_t>(kJT) * (X + I + Xp + Yp);
}

template <typename T>
int launch(const void* Are, const void* Aim, const void* Hre, const void* Him,
           const void* WyRe, const void* WyIm, const void* WxRe,
           const void* WxIm, const void* UxRe, const void* UxIm,
           const void* UyRe, const void* UyIm, void* Dre, void* Dim, int b,
           int K, int C, int X, int Y, int J, int I, int Xp, int Yp, int G,
           cudaStream_t stream) {
  if (I > kMaxI || K > 65535 || C < 1 || G < 1 || b % G) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = smem_bytes(X, I, Xp, Yp, sizeof(T));
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > static_cast<size_t>(optin)) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  err = cudaFuncSetAttribute(fused_correlate_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(b, K);
  fused_correlate_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(Are), static_cast<const T*>(Aim),
      static_cast<const T*>(Hre), static_cast<const T*>(Him),
      static_cast<const T*>(WyRe), static_cast<const T*>(WyIm),
      static_cast<const T*>(WxRe), static_cast<const T*>(WxIm),
      static_cast<const T*>(UxRe), static_cast<const T*>(UxIm),
      static_cast<const T*>(UyRe), static_cast<const T*>(UyIm),
      static_cast<float*>(Dre), static_cast<float*>(Dim), K, C, X, Y, J, I,
      Xp, Yp, b / G);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace dlpd

// Returns a cudaError_t: 0 on a successful launch.  H is [G, K, C, J, I]
// with G dividing b (G = 1: [K, C, J, I]).
extern "C" int dlpd_fused_correlate(int dtype, const void* Are,
                                    const void* Aim, const void* Hre,
                                    const void* Him, const void* WyRe,
                                    const void* WyIm, const void* WxRe,
                                    const void* WxIm, const void* UxRe,
                                    const void* UxIm, const void* UyRe,
                                    const void* UyIm, void* Dre, void* Dim,
                                    int b, int K, int C, int X, int Y, int J,
                                    int I, int Xp, int Yp, int G,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == dlpd::kFloat32) {
    return dlpd::launch<float>(Are, Aim, Hre, Him, WyRe, WyIm, WxRe, WxIm,
                               UxRe, UxIm, UyRe, UyIm, Dre, Dim, b, K, C, X,
                               Y, J, I, Xp, Yp, G, s);
  }
  if (dtype == dlpd::kBFloat16) {
    return dlpd::launch<__nv_bfloat16>(Are, Aim, Hre, Him, WyRe, WyIm, WxRe,
                                       WxIm, UxRe, UxIm, UyRe, UyIm, Dre, Dim,
                                       b, K, C, X, Y, J, I, Xp, Yp, G, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* dlpd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
