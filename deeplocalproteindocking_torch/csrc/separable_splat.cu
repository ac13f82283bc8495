// The splat of a batch of rotated atom sets (grids/voxelize.py,
// separable_splat) as one fused kernel, in place of the float32 bmm of its
// plain version (voxelize._contract).
//
// Replaces no TPU kernel: the JAX package splats with an XLA einsum
// (deeplocalproteindocking_tpu/grids/voxelize.py, separable_splat), which the
// plain version ports as one bmm over a one-hot.  That bmm writes
// W[a, (x, t)] = px[a, x] onehot(type_a)[t] and U[a, (y, z)] = py[a, y]
// pz[a, z] to device memory and multiplies every atom into every type: 10 of
// every 11 products meet a zero of the one-hot.  This kernel computes
//
//   D[b, y, z, x, t] = sum over the atoms a of row b with type t and
//                      mask != 0 of (py[a, y] pz[a, z]) (px[a, x] mask[a])
//
// in ascending atom order, each factor rounded as the plain version rounds
// its U and W entries and each term added by one FMA, so it differs from the
// bmm in the order of the float32 sum alone (all terms are positive).  Types
// below 0 and masked atoms add nothing; types above T - 1 count as T - 1, as
// the plain version clamps them.
//
// What bounds it on the H100: float32 FMAs on the CUDA cores.  Each atom adds
// to the L^3 voxels of its own type: at the serve config's ligand box (L = 72,
// 2,176 atoms) that is 812 M FMAs a rotation, 3.1 ms of a 128-rotation chunk
// at 67 TFLOP/s; the output, 2.1 GB a chunk, takes 0.64 ms at 3.35 TB/s.
// An FMA's operands come from shared memory, which hands one float to each
// lane of one warp a cycle while the SM issues four warps' FMAs: a thread
// has to use each operand it loads about four times.
//
// Design.  A block owns one row b, one type t and a tile of Yb y x Zb z x Xb x
// voxels (voxelize.splat_tile; Yb even, Zb a multiple of 4, Xb of 8): the
// type's sums over the tile fill its registers, and the tile's T blocks run
// side by side.  Holding all T types of a tile on chip instead would leave
// room for about 4,600 voxels an SM, too few for four-fold operand reuse.
//  1. Selection, on the device: the row's atoms are scanned in segments of up
//     to 4,096; warp w takes a contiguous run of them in groups of 32
//     (coalesced loads, four groups in flight, one ballot a group), a scan
//     over the warps places each warp's atoms of type t (mask != 0), and
//     their indices land in shared memory in ascending order.
//  2. Profiles: for 64 of those atoms at a time the block computes, with
//     accurate expf and _contract's formula, px * mask over the tile's Xb x,
//     pz over its Zb z and py over its Yb y into one of two shared buffers
//     (blockDim / 64 threads an atom), while the FMAs read the other.  Each
//     thread's atom (coordinates, weight) is fetched a chunk ahead.
//  3. FMAs: thread (ty, tz, tx) holds 2 y x 4 z x 8 x accumulators in
//     registers; an atom costs it 14 loads (2 py, 4 pz, 8 v), 8 products
//     u = py pz and 64 FMAs, the next atom's loads in flight meanwhile.
//  4. The tile's output is Yb Zb runs D[b, y, z, x0 : x0 + Xb, :] of Xb T
//     contiguous floats.  The block stores its sums into them as plane t of
//     the order [t][x] (whole 32-byte sectors where L is a multiple of 8),
//     then counts itself done on the tile's counter.  The last of the tile's
//     T blocks reads the runs back, two values of y a round, and rewrites
//     each in D's order [x][t] (streaming stores: nothing rereads them).
// No U, W or profile reaches device memory, no product with a zero of the
// one-hot is formed, no block waits for another, and the kernel needs no
// memory but its output and one counter a tile.  Float32 throughout; no
// tensor cores.
//
// Measured on an H100 (700 W) at the serve config's chunk (128 rotations,
// box 72, 2,176 atoms): 9.1 ms, 32% of the FMA peak, against the bmm's
// 48.8 ms.  Of a block's time, the FMAs take about half; the selection,
// the first chunk's profiles and the last block's rewrite (its reads come
// back from DRAM as often as from L2) take most of the rest.
#include <algorithm>
#include <cstdint>

#include "common.cuh"

namespace dlpd {
namespace {

constexpr int kRY = 2, kRZ = 4, kRX = 8;   // a thread's voxels
constexpr int kKC = 64;                    // atoms a profile chunk
constexpr int kMaxThreads = 256;           // threads a block, at most
constexpr int kMaxSeg = 4096;              // atoms listed at once
constexpr int kSelect = 4;                 // groups of 32 atoms in flight
constexpr int kMaxTypes = 16;
constexpr int kSlabs = 2;                  // y a round of the last block
constexpr int kBatch = 16;                 // its reads in flight a thread

struct SplatArgs {
  const float* coords;   // [B, n, 3]
  const int* types;      // [B / types_rows_per, n]
  const float* mask;     // [B / mask_rows_per, n], or null: every atom 1
  float* out;            // [B, L, L, L, T]: (y, z, x, t)
  unsigned* done;        // [B, tiles]: blocks of the tile done (zeroed)
  int n, L, T, Yb, Zb, Xb, seg, nz, nx, types_rows_per, mask_rows_per;
  float origin, inv_res, res, inv_two_s2;
};

// One entry of an axis profile: _contract's formula, each operation rounded
// as PyTorch's CUDA kernels round it (a division by a Python scalar is a
// product with its float32 reciprocal there):
//   g = (c - origin) / res - 0.5,  d = (g - i) res,  exp(-(d d) / (2 s^2)).
__device__ __forceinline__ float voxel_centre(float c, const SplatArgs& p) {
  return __fsub_rn(__fmul_rn(__fsub_rn(c, p.origin), p.inv_res), 0.5f);
}

__device__ __forceinline__ float profile(float g, int i, const SplatArgs& p) {
  const float d = __fmul_rn(__fsub_rn(g, static_cast<float>(i)), p.res);
  return expf(-__fmul_rn(__fmul_rn(d, d), p.inv_two_s2));
}

// Whether atom a of a row counts for type t: mask != 0 and its type, clamped
// to T - 1, is t (types below 0 never count).
__device__ __forceinline__ bool of_type(const int* trow, const float* mrow,
                                        int a, int t, int T) {
  const int ti = trow[a];
  const float w = mrow ? mrow[a] : 1.0f;        // loaded beside the type
  return (ti >= 0) & (min(ti, T - 1) == t) & (w != 0.0f);
}

// One atom's operands for thread (ty, tz, tx): v = px * mask at x 8 tx ..
// 8 tx + 7, pz at z 4 tz .. 4 tz + 3, py at y 2 ty, 2 ty + 1.  A profile row
// holds v [Xb], pz [Zb], py [Yb].
struct Operands {
  float4 v0, v1, pz;
  float2 py;
};

__device__ __forceinline__ Operands load_operands(const float* row, int tx,
                                                  int tz, int ty, int Xb,
                                                  int Zb) {
  Operands o;
  o.v0 = *reinterpret_cast<const float4*>(row + kRX * tx);
  o.v1 = *reinterpret_cast<const float4*>(row + kRX * tx + 4);
  o.pz = *reinterpret_cast<const float4*>(row + Xb + kRZ * tz);
  o.py = *reinterpret_cast<const float2*>(row + Xb + Zb + kRY * ty);
  return o;
}

// The atom's 64 terms (py pz) (px mask), each added by one FMA.
__device__ __forceinline__ void accumulate(const Operands& o,
                                           float (&acc)[kRY][kRZ][kRX]) {
  const float v[kRX] = {o.v0.x, o.v0.y, o.v0.z, o.v0.w,
                        o.v1.x, o.v1.y, o.v1.z, o.v1.w};
  const float py[kRY] = {o.py.x, o.py.y};
  const float pz[kRZ] = {o.pz.x, o.pz.y, o.pz.z, o.pz.w};
#pragma unroll
  for (int i = 0; i < kRY; ++i) {
#pragma unroll
    for (int k = 0; k < kRZ; ++k) {
      const float u = __fmul_rn(py[i], pz[k]);
#pragma unroll
      for (int j = 0; j < kRX; ++j) {
        acc[i][k][j] = __fmaf_rn(u, v[j], acc[i][k][j]);
      }
    }
  }
}

__global__ void __launch_bounds__(kMaxThreads, 2)
    separable_splat_kernel(const SplatArgs p) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_scan[kMaxThreads / 32];
  __shared__ unsigned s_bits[kMaxSeg / 32 + kMaxThreads / 32];
  __shared__ int s_count;
  __shared__ bool s_last;
  const int T = p.T, Yb = p.Yb, Zb = p.Zb, Xb = p.Xb, L = p.L;
  const int S = Xb + Zb + Yb;                  // profile entries an atom
  const int Sp = (S + 3) & ~3;                 // a row, 16-byte aligned
  const int chunk = kKC * Sp;
  // Two profile chunks [kKC][Sp], or in a tile's last block the staging
  // [kSlabs][Zb][Xb][T]; the last block's table of a run [Xb T]; the list
  // of atoms [seg].
  float* prof = smem;
  int* where = reinterpret_cast<int*>(
      smem + max(2 * chunk, kSlabs * Zb * Xb * T));
  auto* list = reinterpret_cast<unsigned short*>(where + Xb * T);

  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
  const int mx = Xb / kRX, mz = Zb / kRZ;
  const bool active = tid < (Yb / kRY) * mz * mx;   // owns a micro tile
  const int tx = active ? tid % mx : 0;
  const int tz = active ? (tid / mx) % mz : 0;
  const int ty = active ? tid / (mx * mz) : 0;

  // blockIdx.x = tile * T + t: a tile's T blocks run side by side.
  const int t = blockIdx.x % T, tile = blockIdx.x / T;
  const int tiles = gridDim.x / T;
  const int xt = tile % p.nx, zt = (tile / p.nx) % p.nz;
  const int yt = tile / (p.nx * p.nz);
  const int x0 = xt * Xb, y0 = yt * Yb, z0 = zt * Zb;
  const int b = blockIdx.y;
  const float* crow = p.coords + static_cast<int64_t>(b) * p.n * 3;
  const int* trow =
      p.types + static_cast<int64_t>(b / p.types_rows_per) * p.n;
  const float* mrow =
      p.mask ? p.mask + static_cast<int64_t>(b / p.mask_rows_per) * p.n
             : nullptr;
  const int64_t row = static_cast<int64_t>(L) * T;        // floats a (y, z)

  // Profile phase: G threads an atom; thread (pk, pj) computes entries
  // pj, pj + G, ... of the chunk's atom pk.
  const int G = nt / kKC;
  const int pk = tid / G, pj = tid - pk * G;    // pk >= kKC: no atom

  float acc[kRY][kRZ][kRX];
#pragma unroll
  for (int i = 0; i < kRY; ++i) {
#pragma unroll
    for (int k = 0; k < kRZ; ++k) {
#pragma unroll
      for (int j = 0; j < kRX; ++j) acc[i][k][j] = 0.0f;
    }
  }

  for (int s0 = 0; s0 < p.n; s0 += p.seg) {
    const int sn = min(p.seg, p.n - s0);
    // 1. Stable compaction of type t: warp w takes the atoms [w per, (w+1)
    // per) of the segment in groups of 32 (coalesced loads, kSelect groups
    // in flight, one ballot a group, kept in shared memory); a scan over the
    // warps places each warp's atoms.
    const int per = (sn + 32 * nwarps - 1) / (32 * nwarps) * 32;
    const int lo = s0 + min(warp * per, sn);
    const int hi = s0 + min(warp * per + per, sn);
    const int groups = (hi - lo + 31) / 32;
    unsigned* bits = s_bits + warp * (per / 32);
    int cnt = 0;
    for (int g0 = 0; g0 < groups; g0 += kSelect) {
      bool m[kSelect];
#pragma unroll
      for (int u = 0; u < kSelect; ++u) {
        const int a = lo + 32 * (g0 + u) + lane;
        m[u] = a < hi && of_type(trow, mrow, a, t, T);
      }
#pragma unroll
      for (int u = 0; u < kSelect; ++u) {
        if (g0 + u < groups) {
          const unsigned bal = __ballot_sync(0xffffffffu, m[u]);
          if (lane == 0) bits[g0 + u] = bal;
          cnt += __popc(bal);
        }
      }
    }
    __syncthreads();                 // the last segment's list is read
    if (lane == 0) s_scan[warp] = cnt;
    __syncthreads();
    if (warp == 0) {
      const int w = lane < nwarps ? s_scan[lane] : 0;
      int wi = w;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, wi, o);
        if (lane >= o) wi += v;
      }
      if (lane < nwarps) s_scan[lane] = wi - w;
      if (lane == 31) s_count = wi;
    }
    __syncthreads();
    int pos = s_scan[warp];
    for (int g = 0; g < groups; ++g) {
      const unsigned bal = bits[g];
      if ((bal >> lane) & 1u) {
        list[pos + __popc(bal & ((1u << lane) - 1u))] =
            static_cast<unsigned short>(lo + 32 * g + lane - s0);
      }
      pos += __popc(bal);
    }
    __syncthreads();
    const int count = s_count;

    // 2. Profiles of a chunk from this thread's atom of it (coordinates and
    // weight, fetched a chunk ahead), into one of two buffers.
    float cx = 0.0f, cy = 0.0f, cz = 0.0f, cw = 0.0f;
    auto fetch = [&](int c0) {
      if (pk < kKC && c0 + pk < count) {
        const int a = s0 + list[c0 + pk];
        cx = crow[3 * a];
        cy = crow[3 * a + 1];
        cz = crow[3 * a + 2];
        cw = mrow ? mrow[a] : 1.0f;
      }
    };
    auto profiles = [&](float* buf, int c0) {
      if (pk < min(kKC, count - c0)) {
        const float gx = voxel_centre(cx, p), gy = voxel_centre(cy, p);
        const float gz = voxel_centre(cz, p);
#pragma unroll 4
        for (int s = pj; s < S; s += G) {
          const bool is_x = s < Xb, is_z = !is_x && s < Xb + Zb;
          const float g = is_x ? gx : (is_z ? gz : gy);
          const int i = is_x ? x0 + s : (is_z ? z0 + s - Xb
                                              : y0 + s - Xb - Zb);
          const float e = profile(g, i, p);
          buf[pk * Sp + s] = is_x ? __fmul_rn(e, cw) : e;
        }
      }
    };
    fetch(0);
    profiles(prof, 0);
    fetch(kKC);
    __syncthreads();
    // 3. Chunk c's FMAs read buffer c % 2 while chunk c + 1's profiles go
    // to the other (and chunk c + 2's atoms are fetched): warps in one phase
    // cover the others' latency, one barrier a chunk.
    for (int c0 = 0, c = 0; c0 < count; c0 += kKC, ++c) {
      const int kc = min(kKC, count - c0);
      if (c0 + kKC < count) {
        profiles(prof + ((c + 1) & 1) * chunk, c0 + kKC);
        fetch(c0 + 2 * kKC);
      }
      if (active) {
        // Two operand sets in turn: the next atom's loads are in flight
        // while this atom's FMAs run.
        const float* pa = prof + (c & 1) * chunk;
        Operands A = load_operands(pa, tx, tz, ty, Xb, Zb), B;
        int k = 0;
        for (; k + 1 < kc; k += 2) {
          B = load_operands(pa + Sp, tx, tz, ty, Xb, Zb);
          accumulate(A, acc);
          pa = k + 2 < kc ? pa + 2 * Sp : pa;
          A = load_operands(pa, tx, tz, ty, Xb, Zb);
          accumulate(B, acc);
        }
        if (k < kc) accumulate(A, acc);
      }
      __syncthreads();
    }
  }

  // 4. This type's plane goes into the tile's own output runs, in the order
  // [t][x] (a run is D[b, y, z, x0 : x0 + xn, :], xn T floats); then the
  // tile's count.
  const int yn = min(Yb, L - y0), zn = min(Zb, L - z0), xn = min(Xb, L - x0);
  const int run = xn * T;
  float* tile_out = p.out +
                    (static_cast<int64_t>(b) * L * L +
                     static_cast<int64_t>(y0) * L + z0) * row +
                    static_cast<int64_t>(x0) * T;
  const int64_t tile_id = static_cast<int64_t>(b) * tiles + tile;
  if (active && kRX * tx < xn) {
    const bool vec = row % 4 == 0 && xn % 4 == 0 && kRX * tx + kRX <= xn;
#pragma unroll
    for (int i = 0; i < kRY; ++i) {
#pragma unroll
      for (int k = 0; k < kRZ; ++k) {
        const int yy = kRY * ty + i, zz = kRZ * tz + k;
        if (yy >= yn || zz >= zn) continue;
        float* dst = tile_out + (static_cast<int64_t>(yy) * L + zz) * row +
                     t * xn + kRX * tx;
        if (vec) {
          reinterpret_cast<float4*>(dst)[0] = make_float4(
              acc[i][k][0], acc[i][k][1], acc[i][k][2], acc[i][k][3]);
          reinterpret_cast<float4*>(dst)[1] = make_float4(
              acc[i][k][4], acc[i][k][5], acc[i][k][6], acc[i][k][7]);
        } else {
#pragma unroll
          for (int j = 0; j < kRX; ++j) {
            if (kRX * tx + j < xn) dst[j] = acc[i][k][j];
          }
        }
      }
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(p.done + tile_id, 1u) == T - 1u;
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  // The tile's last block turns each run from [t][x] into [x][t], kSlabs
  // values of y a round: the runs go through shared memory as
  // [kSlabs][Zb][Xb][T], a table giving each word of a run its place there;
  // the reads go out kBatch at a time a thread.
  float* stage = prof;
  for (int f = tid; f < run; f += nt) where[f] = (f % xn) * T + f / xn;
  const bool vec = row % 4 == 0 && run % 4 == 0;
  const int width = vec ? 4 : 1;               // floats a read
  const int words = run / width;
  const int dr = nt / words, dw = nt - dr * words;   // a step of nt reads
  const int dys = dr / zn, dzz = dr - dys * zn;
  for (int yy0 = 0; yy0 < yn; yy0 += kSlabs) {
    const int ys = min(kSlabs, yn - yy0), total = ys * zn * words;
    const float* runs = tile_out + static_cast<int64_t>(yy0) * L * row;
    __syncthreads();            // the table is made; the last round is out
    int r = tid / words, w = tid - r * words;
    int ysub = r / zn, zz = r - ysub * zn;
    for (int q0 = tid; q0 < total; q0 += kBatch * nt) {
      float4 v[kBatch];
      int at[kBatch], f[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        at[u] = -1;
        if (q0 + u * nt < total) {
          const float* src =
              runs + (static_cast<int64_t>(ysub) * L + zz) * row + w * width;
          v[u] = vec ? __ldcs(reinterpret_cast<const float4*>(src))
                     : make_float4(__ldcs(src), 0.0f, 0.0f, 0.0f);
          at[u] = (ysub * Zb + zz) * Xb * T;
          f[u] = w * width;
        }
        w += dw;
        zz += dzz;
        ysub += dys;
        if (w >= words) {
          w -= words;
          ++zz;
        }
        if (zz >= zn) {
          zz -= zn;
          ++ysub;
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (at[u] < 0) continue;
        stage[at[u] + where[f[u]]] = v[u].x;
        if (vec) {
          stage[at[u] + where[f[u] + 1]] = v[u].y;
          stage[at[u] + where[f[u] + 2]] = v[u].z;
          stage[at[u] + where[f[u] + 3]] = v[u].w;
        }
      }
    }
    __syncthreads();
    for (int q = warp; q < ys * zn; q += nwarps) {
      const int yq = q / zn, zq = q - yq * zn;
      const float* src = stage + (yq * Zb + zq) * Xb * T;
      float* dst = tile_out + (static_cast<int64_t>(yy0 + yq) * L + zq) * row;
      if (vec) {
        for (int i = lane; i < run / 4; i += 32) {
          __stcs(reinterpret_cast<float4*>(dst) + i,
                 reinterpret_cast<const float4*>(src)[i]);
        }
      } else {
        for (int i = lane; i < run; i += 32) __stcs(dst + i, src[i]);
      }
    }
  }
}

size_t smem_bytes(int Yb, int Zb, int Xb, int T, int seg) {
  const size_t prof = 2 * static_cast<size_t>(kKC) * ((Xb + Zb + Yb + 3) & ~3);
  const size_t stage = static_cast<size_t>(kSlabs) * Zb * Xb * T;
  return sizeof(float) * (prof > stage ? prof : stage) +
         sizeof(int) * Xb * T + sizeof(unsigned short) * seg;
}

}  // namespace
}  // namespace dlpd

// Returns a cudaError_t: 0 on a successful launch.  coords [B, n, 3] float32;
// types int32 and mask float32 (or null) [B / rows_per, n], row b reading row
// b / rows_per; out [B, L, L, L, T] float32, in (y, z, x, t) order; done
// uint32 [B, tiles] scratch (zeroed here), where tiles = ceil(L / Yb)
// ceil(L / Zb) ceil(L / Xb).  Tiles of Yb x Zb x Xb (Yb
// even, Zb a multiple of 4, Xb of 8, (Yb / 2) (Zb / 4) (Xb / 8) <= 256
// threads); seg atoms listed at once (1 to 4,096).  origin, inv_res = 1 /
// res, res and inv_two_s2 = 1 / (2 sigma^2) are the float32 constants of
// _contract's profiles.  Takes T <= 16 and B <= 65,535.
extern "C" int dlpd_separable_splat(const void* coords, const void* types,
                                    const void* mask, void* out, void* done,
                                    int B, int n, int L, int T,
                                    int types_rows_per, int mask_rows_per,
                                    int Yb, int Zb, int Xb, int seg,
                                    float origin, float inv_res, float res,
                                    float inv_two_s2, void* stream) {
  using dlpd::kRX;
  using dlpd::kRY;
  using dlpd::kRZ;
  if (B < 1 || B > 65535 || n < 0 || L < 1 || T < 1 ||
      T > dlpd::kMaxTypes || Yb < kRY || Yb % kRY || Zb < kRZ || Zb % kRZ ||
      Xb < kRX || Xb % kRX ||
      (Yb / kRY) * (Zb / kRZ) * (Xb / kRX) > dlpd::kMaxThreads || seg < 1 ||
      seg > dlpd::kMaxSeg || types_rows_per < 1 || B % types_rows_per ||
      mask_rows_per < 1 || B % mask_rows_per) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int ny = (L + Yb - 1) / Yb, nz = (L + Zb - 1) / Zb;
  const int nx = (L + Xb - 1) / Xb;
  const int64_t tiles = static_cast<int64_t>(ny) * nz * nx;
  const int64_t blocks = tiles * T;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = dlpd::smem_bytes(Yb, Zb, Xb, T, seg);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem + 1024 > static_cast<size_t>(optin)) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  err = cudaFuncSetAttribute(dlpd::separable_splat_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dlpd::SplatArgs p;
  p.coords = static_cast<const float*>(coords);
  p.types = static_cast<const int*>(types);
  p.mask = static_cast<const float*>(mask);
  p.out = static_cast<float*>(out);
  p.done = static_cast<unsigned*>(done);
  p.n = n;
  p.L = L;
  p.T = T;
  p.Yb = Yb;
  p.Zb = Zb;
  p.Xb = Xb;
  p.seg = seg;
  p.nz = nz;
  p.nx = nx;
  p.types_rows_per = types_rows_per;
  p.mask_rows_per = mask_rows_per;
  p.origin = origin;
  p.inv_res = inv_res;
  p.res = res;
  p.inv_two_s2 = inv_two_s2;
  // Whole warps, and at least one thread for each atom of a chunk.
  const int threads =
      std::max(dlpd::kKC,
               ((Yb / kRY) * (Zb / kRZ) * (Xb / kRX) + 31) / 32 * 32);
  err = cudaMemsetAsync(done, 0, sizeof(unsigned) * B * tiles,
                        static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  dlpd::separable_splat_kernel<<<dim3(static_cast<unsigned>(blocks), B),
                                 threads, smem,
                                 static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
