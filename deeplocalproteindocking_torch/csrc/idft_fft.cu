// K3, FFT route: passes B and C of the inverse DFT as a complex FFT along
// ky and a c2r along kx, for L = 16, 32, 48, 64, 80, 96, 112 and 128
// (every L that the dft_pallas engine takes: a multiple of 16 up to 128).
//
// Replaces the TPU kernel `_idft_bc_kernel` / `pallas_inverse` in
// deeplocalproteindocking_tpu/correlate/pallas_idft.py, computing the same
// function as the plain version (idft.idft_bc_reference) on the same
// inputs and output:
//
//   S[b, x, y, z] = Re sum_kx sum_ky Ux[kx, x] Uy[ky, y] E[b, kx, ky, z]
//
// with Ux = Uy the inverse DFT matrix (1/L) e^{+2 pi i k x / L}, i.e.
// S = Re ifft2(E) over (kx, ky).  The wrapper (correlate/idft.py) routes
// here only with that matrix, which this kernel therefore never reads.
//
// Why two passes compute it.  Pass 1 takes the complex inverse FFT along
// ky, g[kx, y] = (1/L) sum_ky e^{+2 pi i ky y / L} E[kx, ky], and folds
// each kx with L - kx: h[kx] = (g[kx] + conj g[L - kx]) / 2 for kx <= L/2.
// h is Hermitian along kx and its c2r along kx is Re ifft_kx(g), so pass 2
// is a c2r of length L along kx (fft.cuh, the core of K2's FFT route) with
// no bias and no max, writing all L rows of S.
//
// What bounds it on the H100: bytes.  At the dft_pallas path's chunk
// (b = 128, L = 128) the function reads E (2.147 GB) and writes S
// (1.074 GB): 3.22 GB / 3.35 TB/s = 0.962 ms; done as FFTs it is 18.8
// GFLOP, 0.28 ms at the float32 peak.  This design also writes h and reads
// it back (1.091 GB each way): 5.40 GB, 1.61 ms.  (The function as two
// dense contractions would be 412 GFLOP on the CUDA cores.)  At L = 32 the
// same count is 50 MB (15 us; with h's round trip 86 MB, 26 us), at L = 16
// 6.3 MB (1.9 us): there a launch's latency, a few microseconds, bounds it
// more than the bytes do, so L = 16 runs in one launch (below).
//
// Design.  Both passes keep lane = z (32-wide runs of the contiguous axis),
// so every global and shared access is one 128 B row per warp and the FFTs
// run down the columns of shared-memory tiles.
//  Pass 1: one block of 8 warps per (z run, kx pair {kx, L - kx},
//   rotation): 4 x 65 x b blocks at L = 128.  Both kx planes' [ky][32]
//   rows (re, im; 64 KB at L = 128) arrive by cp.async.  L = P x Q with
//   (P, Q) = (16, 8) at L = 128 and P = 8 below (Q = 4, 6, 8, 10, 12, 14
//   at L = 32, 48, 64, 80, 96, 112): a task
//   (plane, k2) takes rows Q k1 + k2 over k1, a radix-P inverse DFT in
//   registers, the twiddle e^{+2 pi i k2 n1 / L}, and writes back in place
//   (row Q n1 + k2: the task's own rows, so tasks need no barrier between
//   them).  After one barrier warp w takes row blocks n1 = w (and w + 8) of
//   both planes, a radix-Q inverse DFT each giving g[n1 + P n2], folds the
//   two planes in registers and stores h rows.  kx = 0 and L/2 fold with
//   themselves (one plane, one FFT).  At L = 96 the split is 8 x 12 and not
//   12 x 8: 24 tasks of radix 8 give each warp 3, and the 8 row blocks of
//   radix 12 one each, where 12 x 8 would leave warps 4-7 one row block
//   against warps 0-3's two.  For the same reason L = 80 is 8 x 10 and
//   not 16 x 5 (20 radix-8 tasks, 3 or 2 a warp, then one radix-10 row
//   block each, where 16 x 5 would give warps 0-1 two radix-16 tasks
//   against the others' one, then two radix-5 blocks each), and L = 112
//   is 8 x 14 (28 tasks, 4 or 3 a warp, one radix-14 row block each);
//   L = 48 is 8 x 6 (12 tasks, 2 or 1 a warp).  L = 32 is 8 x 4: 8
//   radix-8 tasks and 8 radix-4 row blocks, one of each a warp, where
//   4 x 8 would give each warp two radix-4 tasks and then leave warps
//   4-7 idle beside four radix-8 row blocks.  The pass-1 block needs 512 L bytes of dynamic shared memory: at L = 96 and 112
//   (48 KB and 56 KB) that, with the twiddles, passes the 48 KB default.
//  Pass 2: one block per (z run, y, pair of rotations), as K2's FFT route:
//   both rotations' h rows [L/2 + 1][32] (33 KB) by cp.async at once; the
//   c2r leaves z[n] = L (S[2n] + i S[2n+1]) in warp n % 8, stored straight
//   from registers as 128 B rows of S.
// z runs.  At L = 48, 80 and 112, L mod 32 = 16: both passes launch
//   ceil(L / 32) runs and the last one is half full.  Its cp.async copies
//   read only the 16-byte chunks below L and fill the others with zeros,
//   and every store of h and S is guarded by z0 + lane < L.  The masked
//   run was chosen over 16-column tiles (two half-warp columns a warp):
//   it keeps every FFT, shared-memory layout and index of the whole runs,
//   and idles only 1/6 (L = 48, 80) or 1/8 (L = 112) of the lanes, where
//   half-warp tiles would halve every access's width at every L.
// L = 16: one pass, one block per rotation.  A rotation's whole E is 32 KB
//   and its h would be 9 KB, so the two passes (which took 11 us at
//   b = 128, two launches and h's round trip) become one block of
//   16 x 16 threads that copies the rotation's E into shared memory by
//   cp.async, takes the complex inverse DFT along ky in place (thread
//   (kx, z): one idft<16> down its column), then along kx (thread (y, z)),
//   and stores the real part: no scratch, no fold, no z run to mask.  Each
//   kx plane of the tile is padded from 256 to 272 floats, so the two
//   planes a warp reads at once fall on different banks.
// Scaling: 1/(2L) in pass 1 (the ky inverse and the fold's half), 1/L in
// pass 2.  Twiddles e^{+2 pi i j / L} are computed once per block into
// shared memory and read as warp-wide broadcasts.  Float32 throughout, as
// the TPU kernel takes E and its twiddles.
#include <cstdint>

#include "fft.cuh"

namespace dlpd {
namespace {

constexpr int kThreads = 256;         // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kRot = 2;               // rotations per pass-2 block
constexpr int kVec = kCols / 4;       // float4 per 32-float row

// Chunk c (4 floats) of a z run starting at z0 of a row of L floats into
// shared memory: only the chunks below L where the run is half full (L mod
// 32 = 16), zeros for the others; the whole runs of the other L copy
// every chunk, with no test.
template <int L>
__device__ __forceinline__ void copy_chunk(float* dst, const float* row,
                                           int z0, int c) {
  if constexpr (L % kCols == 0) {
    cp_async16(dst, row + 4 * c);
  } else {
    const bool in = z0 + 4 * c < L;               // L % 16 == 0: whole chunks
    cp_async16(dst, in ? row + 4 * c : row, in);
  }
}

// Whether lane's column z0 + lane of a z run lies below L.
template <int L>
__device__ __forceinline__ bool in_run(int z0, int lane) {
  return L % kCols == 0 || z0 + lane < L;
}

template <int L>
__global__ void __launch_bounds__(kThreads)
    idft_ky_fold_kernel(const float* __restrict__ Ere,
                        const float* __restrict__ Eim,
                        float* __restrict__ Hre, float* __restrict__ Him) {
  constexpr int K = L / 2 + 1;
  constexpr int P = L == 128 ? 16 : 8;    // first radix
  constexpr int Q = L / P;                // second radix: 4 .. 14
  constexpr int kPlane = 2 * L * kCols;   // floats per plane: re, im rows
  static_assert(P * Q == L && Q % 2 == 0 && Q >= 4 && Q <= 14,
                "L must be 32, 48, 64, 80, 96, 112 or 128");

  extern __shared__ __align__(16) float smem[];   // 2 x kPlane
  __shared__ float2 s_tw[L];                       // e^{+2 pi i j / L}

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int z0 = blockIdx.x * kCols, kx = blockIdx.y;
  const size_t b = blockIdx.z;
  const int kx_pair = (L - kx) % L;
  const int planes = kx_pair == kx ? 1 : 2;       // uniform over the block
  const bool z_in = in_run<L>(z0, lane);          // this lane's column

  for (int p = 0; p < planes; ++p) {
    const size_t base = (b * L + (p ? kx_pair : kx)) * L * L + z0;
    float* buf = smem + p * kPlane;
    for (int o = threadIdx.x; o < 2 * L * kVec; o += kThreads) {
      const int half = o / (L * kVec), rem = o % (L * kVec);
      const int ky = rem / kVec, c = rem % kVec;
      copy_chunk<L>(buf + half * L * kCols + ky * kCols + 4 * c,
                    (half ? Eim : Ere) + base + static_cast<size_t>(ky) * L,
                    z0, c);
    }
  }
  cp_async_commit();
  fill_twiddles<L>(s_tw);
  cp_async_wait(0);
  __syncthreads();

  // Radix-P pass: task (plane, k2) over rows Q k1 + k2, in place.
  for (int t = warp; t < planes * Q; t += kWarps) {
    float* re = smem + (t / Q) * kPlane;
    float* im = re + L * kCols;
    const int k2 = t % Q;
    cf v[P];
#pragma unroll
    for (int k1 = 0; k1 < P; ++k1) {
      const int at = (Q * k1 + k2) * kCols + lane;
      v[k1] = {re[at], im[at]};
    }
    idft<P>(v);
#pragma unroll
    for (int n1 = 0; n1 < P; ++n1) {
      const cf w = n1 ? cmul(v[n1], s_tw[k2 * n1]) : v[0];   // k2 n1 < L
      const int at = (Q * n1 + k2) * kCols + lane;
      re[at] = w.re;
      im[at] = w.im;
    }
  }
  __syncthreads();

  // Radix-Q pass on both planes: g[n1 + P n2]; then the fold.
  const float* re0 = smem;
  const float* im0 = re0 + L * kCols;
  const float* re1 = smem + (planes - 1) * kPlane;
  const float* im1 = re1 + L * kCols;
  constexpr float kScale = 0.5f / L;
  const size_t out = (b * K + kx) * L * L + z0 + lane;
  for (int n1 = warp; n1 < P; n1 += kWarps) {
    cf g0[Q], g1[Q];
#pragma unroll
    for (int j = 0; j < Q; ++j) {
      const int at = (n1 * Q + j) * kCols + lane;
      g0[j] = {re0[at], im0[at]};
      g1[j] = {re1[at], im1[at]};
    }
    idft<Q>(g0);
    idft<Q>(g1);
#pragma unroll
    for (int n2 = 0; n2 < Q; ++n2) {
      const size_t at = out + static_cast<size_t>(n1 + P * n2) * L;
      const cf h = g0[n2] + cconj(g1[n2]);
      if (z_in) {
        Hre[at] = h.re * kScale;
        Him[at] = h.im * kScale;
      }
    }
  }
}

template <int L>
__global__ void __launch_bounds__(kThreads)
    idft_kx_c2r_kernel(const float* __restrict__ Hre,
                       const float* __restrict__ Him, float* __restrict__ S,
                       int b) {
  constexpr int K = L / 2 + 1, Q = L / 16;
  constexpr int kBuf = 2 * K * kCols;    // floats per rotation: re, im rows
  constexpr size_t kPlane = static_cast<size_t>(L) * L;

  extern __shared__ __align__(16) float smem[];   // kRot x kBuf
  __shared__ float2 s_tw[L];

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int z0 = blockIdx.x * kCols, y = blockIdx.y;
  const int b0 = blockIdx.z * kRot;

  // Every rotation's copies at once, one cp.async group per rotation.
#pragma unroll
  for (int r = 0; r < kRot; ++r) {
    if (b0 + r < b) {
      float* buf = smem + r * kBuf;
      for (int o = threadIdx.x; o < 2 * K * kVec; o += kThreads) {
        const int half = o / (K * kVec), rem = o % (K * kVec);
        const int k = rem / kVec, c = rem % kVec;
        copy_chunk<L>(buf + half * K * kCols + k * kCols + 4 * c,
                      (half ? Him : Hre) +
                          (static_cast<size_t>(b0 + r) * K + k) * kPlane +
                          y * L + z0,
                      z0, c);
      }
    }
    cp_async_commit();
  }
  fill_twiddles<L>(s_tw);

  constexpr float kScale = 1.0f / L;
#pragma unroll 1
  for (int r = 0; r < kRot; ++r) {
    const int bb = b0 + r;
    if (bb >= b) break;                           // uniform over the block
    cp_async_wait(kRot - 1 - r);
    __syncthreads();
    float* re = smem + r * kBuf;
    cf u[Q];
    c2r_columns<L>(re, re + K * kCols, s_tw, u);
    float* out = S + static_cast<size_t>(bb) * L * kPlane + y * L + z0 + lane;
    if (in_run<L>(z0, lane)) {
#pragma unroll
      for (int n2 = 0; n2 < Q; ++n2) {
        const int n = warp + 8 * n2;
        out[2 * n * kPlane] = u[n2].re * kScale;
        out[(2 * n + 1) * kPlane] = u[n2].im * kScale;
      }
    }
  }
}

// L = 16 in one pass: block b takes rotation b (see the note at the head).
__global__ void __launch_bounds__(kThreads)
    idft16_kernel(const float* __restrict__ Ere,
                  const float* __restrict__ Eim, float* __restrict__ S) {
  constexpr int L = 16, kVol = L * L * L;
  constexpr int kPad = L * L + 16;   // floats per kx plane of the tile
  constexpr int kChunks = kVol / 4;  // 16-byte chunks of one part
  static_assert(L * L == kThreads, "one thread per (kx or y, z)");
  __shared__ __align__(16) float s_re[L * kPad];
  __shared__ __align__(16) float s_im[L * kPad];

  const size_t base = static_cast<size_t>(blockIdx.x) * kVol;
  for (int o = threadIdx.x; o < 2 * kChunks; o += kThreads) {
    const int half = o / kChunks, c = o % kChunks;
    const int kx = c / (L * L / 4), rem = 4 * c % (L * L);
    cp_async16((half ? s_im : s_re) + kx * kPad + rem,
               (half ? Eim : Ere) + base + 4 * c);
  }
  cp_async_commit();
  cp_async_wait(0);
  __syncthreads();

  const int a = threadIdx.x / L, z = threadIdx.x % L;
  cf v[L];
  // Along ky, in place: thread (kx = a, z).
#pragma unroll
  for (int k = 0; k < L; ++k) {
    v[k] = {s_re[a * kPad + k * L + z], s_im[a * kPad + k * L + z]};
  }
  idft<L>(v);
#pragma unroll
  for (int y = 0; y < L; ++y) {
    s_re[a * kPad + y * L + z] = v[y].re;
    s_im[a * kPad + y * L + z] = v[y].im;
  }
  __syncthreads();
  // Along kx: thread (y = a, z); the real part, with both inverses' 1/L.
#pragma unroll
  for (int k = 0; k < L; ++k) {
    v[k] = {s_re[k * kPad + a * L + z], s_im[k * kPad + a * L + z]};
  }
  idft<L>(v);
  constexpr float kScale = 1.0f / (L * L);
  float* out = S + base + a * L + z;
#pragma unroll
  for (int x = 0; x < L; ++x) out[x * L * L] = v[x].re * kScale;
}

// Opts the kernel in to `bytes` of dynamic shared memory where that and
// its `static_bytes` pass the 48 KB that need no opt-in.
template <typename Kernel>
int allow_smem(Kernel kernel, int bytes, int static_bytes) {
  if (bytes + static_bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

template <int L>
int launch(const float* Ere, const float* Eim, float* Hre, float* Him,
           float* S, int B, cudaStream_t stream) {
  constexpr int K = L / 2 + 1;
  constexpr int smem1 = 2 * 2 * L * kCols * sizeof(float);
  constexpr int smem2 = kRot * 2 * K * kCols * sizeof(float);
  static_assert(kRot <= 4, "cp_async_wait takes up to 3 pending groups");
  constexpr int tw_bytes = L * sizeof(float2);    // each kernel's s_tw
  int err = allow_smem(idft_ky_fold_kernel<L>, smem1, tw_bytes);
  if (err != 0) return err;
  err = allow_smem(idft_kx_c2r_kernel<L>, smem2, tw_bytes);
  if (err != 0) return err;
  constexpr int runs = (L + kCols - 1) / kCols;   // the last may be half
  idft_ky_fold_kernel<L><<<dim3(runs, K, B), kThreads, smem1, stream>>>(
      Ere, Eim, Hre, Him);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  idft_kx_c2r_kernel<L>
      <<<dim3(runs, L, (B + kRot - 1) / kRot), kThreads, smem2,
         stream>>>(Hre, Him, S, B);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace dlpd

// E re/im [B, L, L, L] (kx, ky, z), S [B, L, L, L] (x, y, z), and the
// scratch h re/im [B, L/2+1, L, L] (kx, y, z; not used at L = 16); all
// float32, contiguous, E and h 16-byte aligned; L = 16, 32, 48, 64, 80,
// 96, 112 or 128.
// Returns a cudaError_t: 0 on successful launches.
extern "C" int dlpd_idft_fft(const void* Ere, const void* Eim, void* Hre,
                             void* Him, void* S, int B, int L, void* stream) {
  if (B < 1 || B > 65535 ||
      (reinterpret_cast<uintptr_t>(Ere) | reinterpret_cast<uintptr_t>(Eim) |
       reinterpret_cast<uintptr_t>(Hre) | reinterpret_cast<uintptr_t>(Him)) %
          16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* er = static_cast<const float*>(Ere);
  const auto* ei = static_cast<const float*>(Eim);
  auto* hr = static_cast<float*>(Hre);
  auto* hi = static_cast<float*>(Him);
  auto* s = static_cast<float*>(S);
  auto st = static_cast<cudaStream_t>(stream);
  switch (L) {
    case 16:
      dlpd::idft16_kernel<<<B, dlpd::kThreads, 0, st>>>(er, ei, s);
      return static_cast<int>(cudaGetLastError());
    case 32: return dlpd::launch<32>(er, ei, hr, hi, s, B, st);
    case 48: return dlpd::launch<48>(er, ei, hr, hi, s, B, st);
    case 64: return dlpd::launch<64>(er, ei, hr, hi, s, B, st);
    case 80: return dlpd::launch<80>(er, ei, hr, hi, s, B, st);
    case 96: return dlpd::launch<96>(er, ei, hr, hi, s, B, st);
    case 112: return dlpd::launch<112>(er, ei, hr, hi, s, B, st);
    case 128: return dlpd::launch<128>(er, ei, hr, hi, s, B, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
