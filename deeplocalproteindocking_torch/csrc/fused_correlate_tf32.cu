// K1 on the tensor cores in float32: fused forward-y/x + channel coupling
// + inverse-x/y correlator, each real product run as 3xTF32 on `wgmma`.
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
// (the twiddles by the wrapper, the rest here) and each real product P Q
// runs as three products with float32 sums, Plo Qhi + Phi Qlo + Phi Qhi,
// which drops only Plo Qlo (~2^-22 relative).  A complex product is four
// real ones: twelve `wgmma.mma_async.m64nNk8.f32.tf32.tf32`, the minus
// sign as the instruction's scale of A.
//
// What bounds it on the H100: the tensor cores' TF32 rate, and feeding
// them.  At the full-sweep shape (b = 128, C = 16, P = 48, L = 128) a
// block is 21.5 M complex MACs, 258 M TF32 products as 3xTF32: 8.7 ms a
// launch of 8,320 blocks at the 495 TFLOP/s dense peak.  The twiddles
// (~0.75 MB, in L2) are the operand traffic: the mma.sync kernel this
// replaced had each of its eight warps load every Wx^T fragment from L2
// (~170 GB a launch, 58 ms); here each step of them crosses once per
// block (3.6 MB), and the launch takes 18.2 ms (PERF.md).
//
// What the design does.  One block per (b, k), b the fastest grid axis so
// consecutive blocks share H[g, k] in L2.  All of J, I, X', Y' are padded
// to kL = 64 or 128 (the template argument): kL / 64 consumer warpgroups,
// warpgroup w owning rows [64w, 64w+64) of j (stages 1-3) and of x'
// (stage 4), plus a producer warpgroup (one thread issues its copies;
// setmaxnreg gives its registers to the consumers).  Every twiddle
// reaches shared memory once per block and step, by TMA (`cp.async.bulk`),
// into a ring of kRing slots of 8-deep k steps guarded by full/empty
// mbarriers; the producer walks the same sequence of steps as the
// consumers.  The twiddles come from the wrapper as the slots' images
// (``fused.tf32_operands``): per step, a hi and a lo tile of N rows x 8 k,
// each 8-row group two 8 x 16-byte core matrices (k 0-3, k 4-7), the
// `wgmma` K-major layout without swizzle.  Every product is `wgmma` with A
// in registers (split at use) and B the slot's tile:
//
//  1. Per channel, A[c] zero-padded to P x P in tiles of T x T (T =
//     min(P, 64); above 64, 2 x 2 tiles, the last of each axis P - 64
//     wide), split by the consumers into hi and lo tiles in shared memory
//     (the B operand, N = x).  B^T's 64 x T tile per warpgroup is summed
//     over the y steps (A = Wy^T's fragments read from the slot) and the
//     y tiles, in float32 registers.
//  2. B^T, split, is the A operand of F = B^T Wx (its sums are the next
//     product's A fragments as they stand: each step's k = x puts 2t in
//     slot t and 2t+1 in slot t+4, and Wx^T's image stores the x of its
//     steps in that order).  F in chunks of kNI columns of i, each folded
//     at once into G with H read at the fragment's own (j, i): G += H
//     conj(F), H 0 in the padding.  G (float32, [kL][kL], an XOR swizzle
//     of 8-column groups by row) lives in shared memory; each element is
//     read and written by the one thread that holds it in stages 2 and 3.
//  3. C = G Ux for all x' at once (N = kL; G split at load, i in slot
//     order), kept in registers until every warp has read G, then stored
//     as C^T[x'][j] in G's place.
//  4. D = C^T Uy: warpgroup w's 64 rows of x' (C^T split at load, j in
//     slot order), all y' at once; the float32 sums stored to D where
//     x' < X', y' < Y'.
// Shared memory (``fused.tf32_smem_bytes``): G 8 kL^2 B, A's tile 16 T^2,
// the ring kRing x 128 kL, its barriers: 217,136 B at the full-sweep
// shape (kRing 3); kL = 64 launches fit two blocks an SM.
#include <cstdint>

#include "common.cuh"
#include "wgmma_tf32.cuh"

namespace dlpd {
namespace {

// The tile plan of a launch: PK = P / 16, kL the padded grid edge.
template <int PK, int kL>
struct Plan {
  static constexpr int P = 16 * PK;          // padded ligand box edge
  static constexpr int TK = PK < 4 ? PK : 4;
  static constexpr int T = 16 * TK;          // A's tile edge
  static constexpr int NT = (PK + TK - 1) / TK;   // tiles per axis: 1 or 2
  static constexpr int NWG = kL / 64;        // consumer warpgroups
  static constexpr int kCons = 128 * NWG;    // consumer threads
  static constexpr int kThreads = kCons + 128;  // + the producer warpgroup
  // Registers a thread after setmaxnreg: the producer's 40 go to the
  // consumers (65,536 an SM: one block of 384 threads, or two of 256).
  static constexpr int kConsRegs = kL == 128 ? 232 : 216;
  // Columns of i per stage-2 chunk: F's sums and B^T's split fragments
  // share the registers, so the widest tiles take the narrowest chunks.
  static constexpr int kNI = (kL == 128 && TK < 4) ? 64 : 32;
  static constexpr int kSlot = 16 * kL;      // floats in half (re or im) a slot
  static constexpr int kSteps2 = kSlot / (16 * kNI);   // x steps a Wx slot
  static constexpr int kRing = T == 64 ? 2 : (T == 48 && kL == 128) ? 3 : 4;
  static constexpr size_t kSmem =
      sizeof(float) * (2 * kL * kL + 4 * T * T + 2 * kRing * kSlot) +
      2 * kRing * sizeof(uint64_t);
};

struct Frag {   // an A fragment's four elements as TF32 hi and lo parts
  uint32_t h[4], l[4];
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Descriptor of a K-major tile: 8-row groups 256 B apart (stride byte
// offset), each two core matrices 128 B apart (leading byte offset).
__device__ __forceinline__ uint64_t tile_desc(const float* p) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>(256 >> 4) << 32);
}

// Float offset of element (r, k < 8) in such a tile.
__device__ __forceinline__ int tile_at(int r, int k) {
  return (((r >> 3) * 2 + (k >> 2)) * 8 + (r & 7)) * 4 + (k & 3);
}

// Element (r, c) of a [*][ld] float32 matrix whose 8-column groups are
// XOR-swizzled by row: rows g and g+1..3 of a fragment hit other banks.
__device__ __forceinline__ int swz(int r, int c, int ld) {
  return r * ld + (c ^ ((r & 3) << 3));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(count));
}

// Spins until the phase of `bar` with this parity has completed (the loop
// inside the asm, so the compiler sees no divergent branch among the
// wgmma instructions).
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// An arrival on `bar` where `on` is nonzero (predicated, not branched).
__device__ __forceinline__ void bar_arrive_if(uint64_t* bar, int on) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(
          smem_u32(bar)),
      "r"(on)
      : "memory");
}

// One thread: expect `bytes` on `bar` and copy them from global `src` to
// shared `dst` by TMA, completing on `bar`.
__device__ __forceinline__ void bulk_load(float* dst, const float* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void expect_bytes(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// The consumer warpgroups alone (the producer warpgroup never joins).
template <int kCons>
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kCons) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Orders the compiler's reads of `d` after the last wgmma_wait.
template <int N>
__device__ __forceinline__ void keep(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N, int SA>
__device__ __forceinline__ void mma(float* d, const uint32_t (&a)[4],
                                    uint64_t b) {
  if constexpr (N == 16) {
    wgmma_rs16<SA>(*reinterpret_cast<float(*)[8]>(d), a, b);
  } else if constexpr (N == 32) {
    wgmma_rs32<SA>(*reinterpret_cast<float(*)[16]>(d), a, b);
  } else if constexpr (N == 48) {
    wgmma_rs48<SA>(*reinterpret_cast<float(*)[24]>(d), a, b);
  } else if constexpr (N == 64) {
    wgmma_rs64<SA>(*reinterpret_cast<float(*)[32]>(d), a, b);
  } else {
    static_assert(N == 128, "wgmma widths: 16, 32, 48, 64, 128");
    wgmma_rs128<SA>(*reinterpret_cast<float(*)[64]>(d), a, b);
  }
}

// (re, im) += (Pr + i Pi)(Qr + i Qi) in 3xTF32, the small products first:
// P from registers, Q from the hi and lo tiles at qr and qi (lo `lo`
// floats after hi).
template <int N>
__device__ __forceinline__ void cmma(float* re, float* im, const Frag& pr,
                                     const Frag& pi, const float* qr,
                                     const float* qi, int lo) {
  const uint64_t rh = tile_desc(qr), rl = tile_desc(qr + lo);
  const uint64_t ih = tile_desc(qi), il = tile_desc(qi + lo);
  mma<N, 1>(re, pr.l, rh);
  mma<N, 1>(re, pr.h, rl);
  mma<N, 1>(re, pr.h, rh);
  mma<N, -1>(re, pi.l, ih);
  mma<N, -1>(re, pi.h, il);
  mma<N, -1>(re, pi.h, ih);
  mma<N, 1>(im, pr.l, ih);
  mma<N, 1>(im, pr.h, il);
  mma<N, 1>(im, pr.h, ih);
  mma<N, 1>(im, pi.l, rh);
  mma<N, 1>(im, pi.h, rl);
  mma<N, 1>(im, pi.h, rh);
}

// The A fragment of one 8-deep step from a tile of sums whose columns are
// that step's k in slot order (the same thread holds the same elements).
__device__ __forceinline__ Frag from_sums(const float* c) {
  Frag a;
  split(c[0], a.h[0], a.l[0]);
  split(c[2], a.h[1], a.l[1]);
  split(c[1], a.h[2], a.l[2]);
  split(c[3], a.h[3], a.l[3]);
  return a;
}

// A fragment of rows [r0, r0+16) x k in [k0, k0+8) of a swizzled float32
// matrix (row stride ld), k in slot order, split at load.
__device__ __forceinline__ Frag load_f32(const float* m, int ld, int r0,
                                         int k0, int g, int t) {
  const float2 u =
      *reinterpret_cast<const float2*>(m + swz(r0 + g, k0 + 2 * t, ld));
  const float2 v =
      *reinterpret_cast<const float2*>(m + swz(r0 + g + 8, k0 + 2 * t, ld));
  Frag a;
  split(u.x, a.h[0], a.l[0]);
  split(u.y, a.h[2], a.l[2]);
  split(v.x, a.h[1], a.l[1]);
  split(v.y, a.h[3], a.l[3]);
  return a;
}

// A fragment of rows [r0, r0+16) of an 8-deep step's hi tile at m (lo
// tile `lo` floats later), k in natural order.
__device__ __forceinline__ Frag load_tile(const float* m, int lo, int r0,
                                          int g, int t) {
  const float* p = m + (r0 >> 3) * 64 + 4 * g + t;
  Frag a;
#pragma unroll
  for (int e = 0; e < 4; ++e) {   // a0, a1, a2, a3: +0, +64, +32, +96
    const int o = 64 * (e & 1) + 32 * (e >> 1);
    a.h[e] = __float_as_uint(p[o]);
    a.l[e] = __float_as_uint(p[lo + o]);
  }
  return a;
}

// The consumers' side of the ring: take step n's slot, and release each
// slot once the wgmma groups that read it are done.
template <int kRing, int kSlot>
struct Ring {
  float* slots;
  uint64_t* full;
  uint64_t* empty;
  uint32_t n = 0;   // steps taken
  int held = -1;    // slot read by the last committed group
  bool lead;        // lane 0 of its warp: arrives for the warp

  __device__ __forceinline__ const float* take() {
    const int s = n % kRing;
    bar_wait(&full[s], (n / kRing) & 1);
    ++n;
    return slots + 2 * kSlot * s;
  }
  // After a commit: the group before it is done; its slot goes back.
  __device__ __forceinline__ void step_done() {
    wgmma_wait<1>();
    bar_arrive_if(&empty[held < 0 ? 0 : held], held >= 0 && lead);
    held = (n - 1) % kRing;
  }
  __device__ __forceinline__ void flush() {
    wgmma_wait<0>();
    bar_arrive_if(&empty[held < 0 ? 0 : held], held >= 0 && lead);
    held = -1;
  }
};

// Stage 1 over `n` y steps (n even): acc += Wy^T's rows [r0, r0+16) from
// the ring times A's tile (hi and lo tiles of N rows of x at `a_re`,
// `a_im`, the lo `lo` floats after the hi, a step `step` floats later).
// Two steps a turn, their fragments in two sets of registers: a step's
// wgmma group is done (one group may stay in flight) before its
// registers are written again.
template <int N, int kL, class R>
__device__ __forceinline__ void forward_y(float* re, float* im, R& ring,
                                          const float* a_re,
                                          const float* a_im, int lo,
                                          int step, int n, int r0, int g,
                                          int t) {
  constexpr int kSlot = 16 * kL;
#pragma unroll 1
  for (int q = 0; q < n; q += 2) {
    const float* s0 = ring.take();
    const Frag ar = load_tile(s0, 8 * kL, r0, g, t);
    const Frag ai = load_tile(s0 + kSlot, 8 * kL, r0, g, t);
    wgmma_fence();
    cmma<N>(re, im, ar, ai, a_re + q * step, a_im + q * step, lo);
    wgmma_commit();
    ring.step_done();
    const float* s1 = ring.take();
    const Frag br = load_tile(s1, 8 * kL, r0, g, t);
    const Frag bi = load_tile(s1 + kSlot, 8 * kL, r0, g, t);
    wgmma_fence();
    cmma<N>(re, im, br, bi, a_re + (q + 1) * step, a_im + (q + 1) * step,
            lo);
    wgmma_commit();
    ring.step_done();
  }
  ring.flush();
}

// Stages 3 and 4: acc += M[rows r0.., :] U over kL/8 ring steps, M a
// swizzled float32 [kL][kL] (re, im) split at load, k in slot order; two
// steps a turn as in forward_y.
template <int kL, class R>
__device__ __forceinline__ void inverse(float* re, float* im, R& ring,
                                        const float* m_re, const float* m_im,
                                        int r0, int g, int t) {
  constexpr int kSlot = 16 * kL;
#pragma unroll 1
  for (int k0 = 0; k0 < kL; k0 += 16) {
    const float* s0 = ring.take();
    const Frag ar = load_f32(m_re, kL, r0, k0, g, t);
    const Frag ai = load_f32(m_im, kL, r0, k0, g, t);
    wgmma_fence();
    cmma<kL>(re, im, ar, ai, s0, s0 + kSlot, 8 * kL);
    wgmma_commit();
    ring.step_done();
    const float* s1 = ring.take();
    const Frag br = load_f32(m_re, kL, r0, k0 + 8, g, t);
    const Frag bi = load_f32(m_im, kL, r0, k0 + 8, g, t);
    wgmma_fence();
    cmma<kL>(re, im, br, bi, s1, s1 + kSlot, 8 * kL);
    wgmma_commit();
    ring.step_done();
  }
  ring.flush();
}

template <int PK, int kL>
__global__ void __launch_bounds__(Plan<PK, kL>::kThreads, kL == 64 ? 2 : 1)
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
  using Pl = Plan<PK, kL>;
  constexpr int P = Pl::P, T = Pl::T, NT = Pl::NT, kNI = Pl::kNI;
  constexpr int kSlot = Pl::kSlot, kRing = Pl::kRing, kCons = Pl::kCons;
  constexpr int kSteps2 = Pl::kSteps2, kChunks = kL / kNI;
  constexpr int kLast = P - T * (NT - 1);   // the last tile's edge
  const int bb = blockIdx.x;      // rotation
  const int k = blockIdx.y;       // kz frequency
  const int tid = threadIdx.x;

  extern __shared__ __align__(128) unsigned char smem[];
  float* gs_re = reinterpret_cast<float*>(smem);   // G, later C^T [kL][kL]
  float* gs_im = gs_re + kL * kL;
  float* ts = gs_im + kL * kL;          // A's tile: re hi, re lo, im hi, im lo
  float* slots = ts + 4 * T * T;        // the ring: [kRing][re, im][kSlot]
  uint64_t* full = reinterpret_cast<uint64_t*>(slots + 2 * kRing * kSlot);
  uint64_t* empty = full + kRing;
  if (tid == 0) {
    for (int s = 0; s < kRing; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], kCons / 32);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The warpgroup, made warp-uniform for the compiler.
  const int role = __shfl_sync(0xffffffff, tid / 128, 0);
  if (role == Pl::NWG) {
    // ---- the producer: one thread walks the consumers' steps ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid != kCons) return;
    uint32_t n = 0;
    auto load = [&](const float* re, const float* im, uint32_t bytes) {
      const int s = n % kRing;
      bar_wait(&empty[s], ((n / kRing) & 1) ^ 1);
      float* dst = slots + 2 * kSlot * s;
      expect_bytes(&full[s], 2 * bytes);
      bulk_load(dst, re, bytes, &full[s]);
      bulk_load(dst + kSlot, im, bytes, &full[s]);
      ++n;
    };
    constexpr uint32_t kStepBytes = sizeof(float) * kSlot;
    for (int c = 0; c < C; ++c) {
#pragma unroll
      for (int xt = 0; xt < NT; ++xt) {
        const int xw = xt + 1 < NT ? T : kLast;
#pragma unroll
        for (int yt = 0; yt < NT; ++yt) {
          const int yw = yt + 1 < NT ? T : kLast;
          for (int ky = 0; ky < yw / 8; ++ky) {
            const size_t o = static_cast<size_t>(T * yt / 8 + ky) * kSlot;
            load(WyTRe + o, WyTIm + o, kStepBytes);
          }
        }
        for (int ic = 0; ic < kChunks; ++ic) {
          for (int q0 = 0; q0 < xw / 8; q0 += kSteps2) {
            const int nq = xw / 8 - q0 < kSteps2 ? xw / 8 - q0 : kSteps2;
            const size_t o =
                (static_cast<size_t>(ic) * (P / 8) + T * xt / 8 + q0) * 16 *
                kNI;
            load(WxTRe + o, WxTIm + o, sizeof(float) * 16 * kNI * nq);
          }
        }
      }
    }
    for (int ki = 0; ki < kL / 8; ++ki) {
      load(UxTRe + static_cast<size_t>(ki) * kSlot,
           UxTIm + static_cast<size_t>(ki) * kSlot, kStepBytes);
    }
    for (int kj = 0; kj < kL / 8; ++kj) {
      load(UyTRe + static_cast<size_t>(kj) * kSlot,
           UyTIm + static_cast<size_t>(kj) * kSlot, kStepBytes);
    }
    return;
  }

  // ---- the consumers ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(Pl::kConsRegs));
  const int warp = tid >> 5;
  const int g = (tid & 31) >> 2, t = tid & 3;
  const int r0 = 16 * warp;       // the warp's first row (j; x' in stage 4)
  Ring<kRing, kSlot> ring{slots, full, empty};
  ring.lead = (tid & 31) == 0;

  const size_t a_base = (static_cast<size_t>(bb) * K + k) * C * X * Y;
  // Receptor group of this row: rows [g b/G, (g+1) b/G) share H[g].
  const size_t h_base =
      (static_cast<size_t>(bb / rows_per_group) * K + k) * C * J * I;

  // ---- stages 1-2, per channel and x tile: G += H conj(B^T Wx) ----
  for (int c = 0; c < C; ++c) {
    const float* ar = Are + a_base + static_cast<size_t>(c) * X * Y;
    const float* ai = Aim + a_base + static_cast<size_t>(c) * X * Y;
    const float* hr_c = Hre + h_base + static_cast<size_t>(c) * J * I;
    const float* hi_c = Him + h_base + static_cast<size_t>(c) * J * I;
#pragma unroll
    for (int xt = 0; xt < NT; ++xt) {
      const int x0 = T * xt;
      const int xw = xt + 1 < NT ? T : kLast;
      // Stage 1: B^T[rows, x0 + x] = sum_y WyT[j, y] A[x0 + x, y] over the
      // y tiles; N = the tile's width.
      float btr[T / 2], bti[T / 2];
#pragma unroll
      for (int e = 0; e < T / 2; ++e) btr[e] = bti[e] = 0.f;
#pragma unroll
      for (int yt = 0; yt < NT; ++yt) {
        const int y0 = T * yt;
        const int yw = yt + 1 < NT ? T : kLast;
        consumer_sync<kCons>();   // every warpgroup is done with the last tile
        // xw, yw multiples of 16: every thread takes the same count.
#pragma unroll 1
        for (int e = tid; e < xw * yw; e += kCons) {
          const int kk = e & 3, r = e >> 2;
          const int x = r % xw, yc = r / xw, y = 4 * yc + kk;
          const int ax = x0 + x, ay = y0 + y;
          const bool in = ax < X && ay < Y;
          uint32_t h[2], l[2];
          split(in ? ar[ax * Y + ay] : 0.f, h[0], l[0]);
          split(in ? ai[ax * Y + ay] : 0.f, h[1], l[1]);
          const int o = (yc >> 1) * 8 * T + tile_at(x, 4 * (yc & 1) + kk);
          ts[o] = __uint_as_float(h[0]);
          ts[T * T + o] = __uint_as_float(l[0]);
          ts[2 * T * T + o] = __uint_as_float(h[1]);
          ts[3 * T * T + o] = __uint_as_float(l[1]);
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        consumer_sync<kCons>();
        if (xt + 1 < NT) {   // the wgmma's N: the tile's width
          forward_y<T, kL>(btr, bti, ring, ts, ts + 2 * T * T, T * T, 8 * T,
                           yw / 8, r0, g, t);
        } else {
          forward_y<kLast, kL>(btr, bti, ring, ts, ts + 2 * T * T, T * T,
                               8 * T, yw / 8, r0, g, t);
        }
      }
      keep(btr);
      keep(bti);

      // Stage 2: this tile's F = B^T Wx in chunks of kNI columns of i,
      // each folded into G: G += H conj(F), H 0 in the padding.
      constexpr int kQ = T / 8;   // x steps of a full tile
      Frag bq_r[kQ], bq_i[kQ];
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        bq_r[q] = from_sums(btr + 4 * q);
        bq_i[q] = from_sums(bti + 4 * q);
      }
      const int nq = xw / 8;
      const bool first = c == 0 && xt == 0;   // G starts here
      for (int ic = 0; ic < kChunks; ++ic) {
        float fr[kNI / 2], fi[kNI / 2];
#pragma unroll
        for (int e = 0; e < kNI / 2; ++e) fr[e] = fi[e] = 0.f;
        wgmma_fence();
#pragma unroll
        for (int q0 = 0; q0 < kQ; q0 += kSteps2) {
          if (q0 < nq) {
            const float* slot = ring.take();
#pragma unroll
            for (int q = q0; q < q0 + kSteps2 && q < kQ; ++q) {
              if (q < nq) {
                const float* b = slot + (q - q0) * 16 * kNI;
                cmma<kNI>(fr, fi, bq_r[q], bq_i[q], b, b + kSlot, 8 * kNI);
              }
            }
            wgmma_commit();
            ring.step_done();
          }
        }
        ring.flush();
        keep(fr);
        keep(fi);
#pragma unroll
        for (int nb = 0; nb < kNI / 8; ++nb) {
          const int i = ic * kNI + 8 * nb + 2 * t;
#pragma unroll
          for (int half = 0; half < 2; ++half) {   // rows g and g + 8
            const int j = r0 + g + 8 * half;
            // I even: the pair (i, i + 1) is in or out of H together.
            const bool in = j < J && i < I;
            const float2 zero = make_float2(0.f, 0.f);
            const float2 hr =
                in ? __ldg(reinterpret_cast<const float2*>(hr_c + j * I + i))
                   : zero;
            const float2 hi =
                in ? __ldg(reinterpret_cast<const float2*>(hi_c + j * I + i))
                   : zero;
            float2* pgr = reinterpret_cast<float2*>(gs_re + swz(j, i, kL));
            float2* pgi = reinterpret_cast<float2*>(gs_im + swz(j, i, kL));
            float2 gr = first ? zero : *pgr;
            float2 gi = first ? zero : *pgi;
            const float f_r[2] = {fr[4 * nb + 2 * half],
                                  fr[4 * nb + 2 * half + 1]};
            const float f_i[2] = {fi[4 * nb + 2 * half],
                                  fi[4 * nb + 2 * half + 1]};
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

  // ---- stage 3: C[rows, x'] = sum_i G[j, i] Ux[i, x'], all x' ----
  float cr[kL / 2], ci[kL / 2];
#pragma unroll
  for (int e = 0; e < kL / 2; ++e) cr[e] = ci[e] = 0.f;
  inverse<kL>(cr, ci, ring, gs_re, gs_im, r0, g, t);
  keep(cr);
  keep(ci);
  consumer_sync<kCons>();   // every warp has read G
#pragma unroll
  for (int e = 0; e < kL / 2; ++e) {   // C^T[x'][j] in G's place
    const int j = r0 + g + 8 * ((e >> 1) & 1);
    const int xq = 8 * (e >> 2) + 2 * t + (e & 1);
    gs_re[swz(xq, j, kL)] = cr[e];
    gs_im[swz(xq, j, kL)] = ci[e];
  }
  consumer_sync<kCons>();   // C^T complete: the j sum needs every warp's rows

  // ---- stage 4: D[rows x', y'] = sum_j C^T[x', j] Uy[j, y'] ----
  float dr[kL / 2], di[kL / 2];
#pragma unroll
  for (int e = 0; e < kL / 2; ++e) dr[e] = di[e] = 0.f;
  inverse<kL>(dr, di, ring, gs_re, gs_im, r0, g, t);
  keep(dr);
  keep(di);
  const size_t d_base = (static_cast<size_t>(bb) * K + k) * Xp * Yp;
#pragma unroll
  for (int e = 0; e < kL / 2; e += 2) {
    const int xq = r0 + g + 8 * ((e >> 1) & 1);
    const int yq = 8 * (e >> 2) + 2 * t;
    if (xq < Xp && yq < Yp) {   // Y' even: a pair is in or out together
      const size_t o = d_base + static_cast<size_t>(xq) * Yp + yq;
      *reinterpret_cast<float2*>(Dre + o) = make_float2(dr[e], dr[e + 1]);
      *reinterpret_cast<float2*>(Dim + o) = make_float2(di[e], di[e + 1]);
    }
  }
}

template <int PK, int kL>
int launch(const void* const* in, void* Dre, void* Dim, int b, int K, int C,
           int X, int Y, int J, int I, int Xp, int Yp, int G,
           cudaStream_t stream) {
  using Pl = Plan<PK, kL>;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (Pl::kSmem > static_cast<size_t>(optin)) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const auto kernel = fused_correlate_tf32_kernel<PK, kL>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(Pl::kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* const* p = reinterpret_cast<const float* const*>(in);
  kernel<<<dim3(b, K), Pl::kThreads, Pl::kSmem, stream>>>(
      p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7], p[8], p[9], p[10],
      p[11], static_cast<float*>(Dre), static_cast<float*>(Dim), K, C, X, Y,
      J, I, Xp, Yp, b / G);
  return static_cast<int>(cudaGetLastError());
}

// The instantiation for P = 16 pk: PK 1..8 at kL = 128, 1..4 at kL = 64.
template <int kL, int PK = 1>
int launch_box(int pk, const void* const* in, void* Dre, void* Dim, int b,
               int K, int C, int X, int Y, int J, int I, int Xp, int Yp,
               int G, cudaStream_t s) {
  if constexpr (PK < (kL == 64 ? 4 : 8)) {
    if (pk > PK) {
      return launch_box<kL, PK + 1>(pk, in, Dre, Dim, b, K, C, X, Y, J, I,
                                    Xp, Yp, G, s);
    }
  }
  return launch<PK, kL>(in, Dre, Dim, b, K, C, X, Y, J, I, Xp, Yp, G, s);
}

}  // namespace
}  // namespace dlpd

// Returns a cudaError_t: 0 on a successful launch.  Operands are float32:
// Are/Aim [b, K, C, X, Y], Hre/Him [G, K, C, J, I] with G dividing b
// (G = 1: [K, C, J, I]; row bb reads H[bb / (b/G)]; 8-byte aligned), and
// the twiddles as the ring's step images (``fused.tf32_operands``, with
// P = max(X, Y) and kL = max(J, I, X', Y') rounded up to 16 and 64): WyT
// P/8 steps of kL rows, WxT kL/kNI chunks of P/8 steps of kNI rows, UxT
// and UyT kL/8 steps of kL rows; 16-byte aligned.  Takes X, Y <= 128 and
// even I, J, Xp, Yp up to 128.
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
  // kL = 128 past 64 (and for boxes above 64, whose tiles take the
  // registers a kL = 64 block gives up for its second block an SM).
  if (J > 64 || I > 64 || Xp > 64 || Yp > 64 || P > 64) {
    return dlpd::launch_box<128>(P / 16, in, Dre, Dim, b, K, C, X, Y, J, I,
                                 Xp, Yp, G, s);
  }
  return dlpd::launch_box<64>(P / 16, in, Dre, Dim, b, K, C, X, Y, J, I, Xp,
                              Yp, G, s);
}
