// Tiled all-pairs gravitational accelerations for Hopper (sm_90a).
//
// Replaces: spatialsim_tpu/ops/allpairs.py, _allpairs_kernel (the Pallas
// kernel behind allpairs_accel).  Same physics per pair:
//     d = p_j - p_i,  r2 = |d|^2 + eps^2,
//     a_i += (G m_j) * rsqrt(r2)^3 * d      only where r2 > eps^2
// (the gate drops self and coincident pairs) and only for j < n (the
// j-padding mask of the TPU kernel).
//
// What bounds it on this card: instruction issue.  A pair is ~15 issued
// instructions (3 FADD, 3 FFMA for r2, MUFU.RSQ, 3 FMUL, FSETP + FSEL for
// the gate, 3 FFMA for the sums) and reads nothing from device memory:
// sources come from shared memory as a broadcast.  N <= 32,768 on the
// all-pairs engine's path, and 10,000-20,000 for the presets.
//
// Design:
//   * T targets a thread (a template argument, 2, 4 or 8) in registers;
//     a block of 64-128 threads holds threads * T targets.  Sources are
//     staged per tile of kTile as float4 [x y z G*m], so G*m is multiplied
//     once at staging, and one broadcast LDS.128 feeds T pairs.  The last
//     tile is padded with zero-mass sources at 1e18, which add exactly 0
//     (w underflows to 0, and 0 * m): no loop bound inside a tile.
//   * r2 is one FFMA chain seeded with eps^2 and the rsqrt is MUFU.RSQ
//     alone (window_tile::rsqrt_mufu, shared with the window-eval
//     kernels); the gate is a select.
//   * The source axis is split over S blocks (S = gridDim.y <= 8) so that
//     the grid fills the card at 10,000-32,768 bodies: slice s sums tiles
//     [s * tiles_per_slice, (s + 1) * tiles_per_slice).  The S blocks of a
//     target block form one thread-block cluster; each leaves its partial
//     sums in its shared memory, and rank 0 adds the others' through
//     distributed shared memory in rank order.  One launch, no scratch,
//     no atomics: the sum is the same from run to run, bit for bit.
//   * Sums keep two levels before the split: each tile into its own
//     partial, the partial into the slice's total (one f32 accumulator
//     over 32K terms drifts ~1e-5 of max|a|, two levels stay ~1e-7).
// Layout is the JAX package's component-major (3, N).
//
// The targets-and-sources mode (spatialsim_allpairs_at): the same pair
// sum at k targets from n other sources, the function of _allpairs_kernel
// with distinct pos_i and pos_j blocks.  It is the direct-sum oracle of
// the accuracy tools (k = 1,024-4,096 sampled bodies against n up to 5e7
// sources) and a ring hop of parallel/sharded.py (a rank's block against
// a visiting block).  Bound by issue as above: 19 operations a pair over
// k * n pairs.  Few targets against many sources: 4,096 targets are only
// 16 target blocks, so the parallelism comes from the source axis, split
// over S slices (gridDim.y, up to thousands), each block writing its
// (3, k) partial into a scratch of (S, 3, k).  A second pass adds the
// partials in slice order in float64 and writes float32: no atomics, so
// two calls agree bit for bit.  The staging and the tile sum are the
// single-array kernel's (stage_tile, sum_tile).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "window_eval_tile.cuh"

namespace cg = cooperative_groups;

namespace {

using window_tile::rsqrt_mufu;

constexpr int kTile = 256;     // sources staged a tile
constexpr int kMaxThreads = 128;
constexpr int kMaxSlices = 8;  // the portable cluster size
constexpr float kFar = 1e18f;  // padding sources, with zero mass
constexpr int kSumRows = 8;    // slices a column of the second pass splits

// Stage tile `tl` of the n sources as float4 [x y z G*m], padded past n.
__device__ __forceinline__ void stage_tile(float4* s_src,
                                           const float* __restrict__ pos,
                                           const float* __restrict__ mass,
                                           int n, int tl, float G, int t,
                                           int nthr) {
  for (int k = t; k < kTile; k += nthr) {
    const size_t j = static_cast<size_t>(tl) * kTile + k;
    s_src[k] = j < static_cast<size_t>(n)
                   ? make_float4(pos[j], pos[n + j],
                                 pos[2 * static_cast<size_t>(n) + j],
                                 G * mass[j])
                   : make_float4(kFar, kFar, kFar, 0.f);
  }
}

// Add one staged tile's pairs with the thread's T targets into its sums,
// through a partial of the tile's own.
template <int T>
__device__ __forceinline__ void sum_tile(const float4* s_src,
                                         const float* x, const float* y,
                                         const float* z, float* ax,
                                         float* ay, float* az,
                                         float soft_sq) {
  // Sources an iteration of the source loop: 16 pairs a thread at every T,
  // so the loop's code stays ~250 instructions.
  constexpr int kUnroll = 16 / T;
  float tx[T], ty[T], tz[T];
#pragma unroll
  for (int j = 0; j < T; ++j) tx[j] = ty[j] = tz[j] = 0.f;
#pragma unroll 1
  for (int k = 0; k < kTile; k += kUnroll) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const float4 src = s_src[k + u];
#pragma unroll
      for (int j = 0; j < T; ++j) {
        const float dx = src.x - x[j];
        const float dy = src.y - y[j];
        const float dz = src.z - z[j];
        const float r2 = fmaf(dx, dx, fmaf(dy, dy, fmaf(dz, dz, soft_sq)));
        const float inv = rsqrt_mufu(r2);
        const float w = (r2 > soft_sq) ? src.w * (inv * inv * inv) : 0.f;
        tx[j] = fmaf(w, dx, tx[j]);
        ty[j] = fmaf(w, dy, ty[j]);
        tz[j] = fmaf(w, dz, tz[j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < T; ++j) {
    ax[j] += tx[j];
    ay[j] += ty[j];
    az[j] += tz[j];
  }
}

template <int T>
__global__ void __launch_bounds__(kMaxThreads) allpairs_kernel(
    const float* __restrict__ pos, const float* __restrict__ mass,
    float* __restrict__ out, int n, int tiles_per_slice, float G,
    float soft_sq) {
  __shared__ float4 s_src[kTile];
  extern __shared__ float s_part[];  // 3 * T * nthr partials, S > 1 only
  const int nthr = blockDim.x;
  const int t = threadIdx.x;
  const size_t i0 = static_cast<size_t>(blockIdx.x) * nthr * T + t;

  float x[T], y[T], z[T], ax[T], ay[T], az[T];
#pragma unroll
  for (int j = 0; j < T; ++j) {
    const size_t i = i0 + static_cast<size_t>(j) * nthr;
    const bool live = i < static_cast<size_t>(n);
    x[j] = live ? pos[i] : 0.f;
    y[j] = live ? pos[n + i] : 0.f;
    z[j] = live ? pos[2 * static_cast<size_t>(n) + i] : 0.f;
    ax[j] = ay[j] = az[j] = 0.f;
  }

  const int ntiles = (n + kTile - 1) / kTile;
  const int tile0 = blockIdx.y * tiles_per_slice;
  const int tile1 = min(tile0 + tiles_per_slice, ntiles);
  for (int tl = tile0; tl < tile1; ++tl) {
    __syncthreads();  // the previous tile is consumed
    stage_tile(s_src, pos, mass, n, tl, G, t, nthr);
    __syncthreads();
    sum_tile<T>(s_src, x, y, z, ax, ay, az, soft_sq);
  }

  if (gridDim.y > 1) {  // the cluster's slices, summed in rank order
    cg::cluster_group cluster = cg::this_cluster();
    const int tn = T * nthr;
#pragma unroll
    for (int j = 0; j < T; ++j) {
      s_part[j * nthr + t] = ax[j];
      s_part[tn + j * nthr + t] = ay[j];
      s_part[2 * tn + j * nthr + t] = az[j];
    }
    cluster.sync();
    const unsigned rank = cluster.block_rank();
    if (rank == 0) {
      for (unsigned r = 1; r < gridDim.y; ++r) {
        const float* rp = cluster.map_shared_rank(s_part, r);
#pragma unroll
        for (int j = 0; j < T; ++j) {
          ax[j] += rp[j * nthr + t];
          ay[j] += rp[tn + j * nthr + t];
          az[j] += rp[2 * tn + j * nthr + t];
        }
      }
    }
    cluster.sync();  // the others' shared memory stays until rank 0 read it
    if (rank != 0) return;
  }
#pragma unroll
  for (int j = 0; j < T; ++j) {
    const size_t i = i0 + static_cast<size_t>(j) * nthr;
    if (i < static_cast<size_t>(n)) {
      out[i] = ax[j];
      out[n + i] = ay[j];
      out[2 * static_cast<size_t>(n) + i] = az[j];
    }
  }
}

// Targets-and-sources mode, first pass: block (x, y) sums source slice y
// (tiles [y * tiles_per_slice, ...)) at its threads * T targets and writes
// the slice's (3, k) partial into part[y].
template <int T>
__global__ void __launch_bounds__(kMaxThreads) allpairs_at_kernel(
    const float* __restrict__ tgt, const float* __restrict__ pos,
    const float* __restrict__ mass, float* __restrict__ part, int k, int n,
    int tiles_per_slice, float G, float soft_sq) {
  __shared__ float4 s_src[kTile];
  const int nthr = blockDim.x;
  const int t = threadIdx.x;
  const size_t i0 = static_cast<size_t>(blockIdx.x) * nthr * T + t;

  float x[T], y[T], z[T], ax[T], ay[T], az[T];
#pragma unroll
  for (int j = 0; j < T; ++j) {
    const size_t i = i0 + static_cast<size_t>(j) * nthr;
    const bool live = i < static_cast<size_t>(k);
    x[j] = live ? tgt[i] : 0.f;
    y[j] = live ? tgt[k + i] : 0.f;
    z[j] = live ? tgt[2 * static_cast<size_t>(k) + i] : 0.f;
    ax[j] = ay[j] = az[j] = 0.f;
  }

  const int ntiles = (n + kTile - 1) / kTile;
  const int tile0 = blockIdx.y * tiles_per_slice;
  const int tile1 = min(tile0 + tiles_per_slice, ntiles);
  for (int tl = tile0; tl < tile1; ++tl) {
    __syncthreads();  // the previous tile is consumed
    stage_tile(s_src, pos, mass, n, tl, G, t, nthr);
    __syncthreads();
    sum_tile<T>(s_src, x, y, z, ax, ay, az, soft_sq);
  }

  float* slab = part + static_cast<size_t>(blockIdx.y) * 3 * k;
#pragma unroll
  for (int j = 0; j < T; ++j) {
    const size_t i = i0 + static_cast<size_t>(j) * nthr;
    if (i < static_cast<size_t>(k)) {
      slab[i] = ax[j];
      slab[k + i] = ay[j];
      slab[2 * static_cast<size_t>(k) + i] = az[j];
    }
  }
}

// Second pass: out[c] = sum over s of part[s][c], for the 3k components c,
// in float64 and a fixed order.  A block holds 32 columns (threadIdx.x) by
// kSumRows rows (threadIdx.y); row r adds slices r, r + kSumRows, ... in
// order, then row 0 adds the rows' sums in row order.
__global__ void __launch_bounds__(32 * kSumRows) allpairs_at_sum_kernel(
    const float* __restrict__ part, float* __restrict__ out, int k3,
    int slices) {
  __shared__ double s_row[kSumRows][32];
  const size_t c = static_cast<size_t>(blockIdx.x) * 32 + threadIdx.x;
  double acc = 0.0;
  if (c < static_cast<size_t>(k3)) {
#pragma unroll 4
    for (int s = threadIdx.y; s < slices; s += kSumRows) {
      acc += static_cast<double>(part[static_cast<size_t>(s) * k3 + c]);
    }
  }
  s_row[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && c < static_cast<size_t>(k3)) {
    double total = s_row[0][threadIdx.x];
#pragma unroll
    for (int r = 1; r < kSumRows; ++r) total += s_row[r][threadIdx.x];
    out[c] = static_cast<float>(total);
  }
}

using AtKernelFn = void (*)(const float*, const float*, const float*,
                            float*, int, int, int, float, float);

AtKernelFn at_kernel_for(int T) {
  switch (T) {
    case 2: return allpairs_at_kernel<2>;
    case 4: return allpairs_at_kernel<4>;
    case 8: return allpairs_at_kernel<8>;
    default: return nullptr;
  }
}

using KernelFn = void (*)(const float*, const float*, float*, int, int,
                          float, float);

KernelFn kernel_for(int T) {
  switch (T) {
    case 2: return allpairs_kernel<2>;
    case 4: return allpairs_kernel<4>;
    case 8: return allpairs_kernel<8>;
    default: return nullptr;
  }
}

bool valid(int threads, int slices) {
  return threads >= 32 && threads <= kMaxThreads && threads % 32 == 0 &&
         slices >= 1 && slices <= kMaxSlices;
}

size_t part_bytes(int threads, int T, int slices) {
  return slices > 1 ? 3 * sizeof(float) * T * threads : 0;
}

}  // namespace

// Accelerations of n bodies: `threads` threads a block of `targets` (T)
// targets each, the sources split over `slices` (S) blocks of a cluster.
extern "C" int spatialsim_allpairs(const float* pos, const float* mass,
                                   float* out, int n, float G, float soft_sq,
                                   int threads, int targets, int slices,
                                   void* stream) {
  const KernelFn kernel = kernel_for(targets);
  if (kernel == nullptr || n < 1 || !valid(threads, slices)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int ntiles = (n + kTile - 1) / kTile;
  const int per_slice = (ntiles + slices - 1) / slices;
  const long long per_block = static_cast<long long>(threads) * targets;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((n + per_block - 1) / per_block),
                     slices, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = part_bytes(threads, targets, slices);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = slices;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, pos, mass, out, n,
                                             per_slice, G, soft_sq);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks per SM, registers a thread and threads a block of one
// instance, into out[0..2] (the calculator's figure for lone blocks).
extern "C" int spatialsim_allpairs_occupancy(int threads, int targets,
                                             int slices, int* out) {
  const KernelFn kernel = kernel_for(targets);
  if (kernel == nullptr || !valid(threads, slices)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(window_tile::occupancy(
      kernel, threads, part_bytes(threads, targets, slices), out));
}

// Accelerations at k targets (3, k) from n sources (3, n) and their
// masses: `threads` threads a block of `targets` (T) targets each, the
// source tiles split into slices of `tiles_per_slice`; `part` holds
// (ceil(tiles / tiles_per_slice), 3, k) floats of scratch.  Two launches
// on `stream`: the slices' partials, then their sum in slice order.
extern "C" int spatialsim_allpairs_at(const float* tgt, const float* pos,
                                      const float* mass, float* part,
                                      float* out, int k, int n, float G,
                                      float soft_sq, int threads,
                                      int targets, int tiles_per_slice,
                                      void* stream) {
  const AtKernelFn kernel = at_kernel_for(targets);
  if (kernel == nullptr || k < 1 || n < 1 || tiles_per_slice < 1 ||
      !valid(threads, 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int ntiles = (n + kTile - 1) / kTile;
  const int slices = (ntiles + tiles_per_slice - 1) / tiles_per_slice;
  const long long per_block = static_cast<long long>(threads) * targets;
  const long long tblocks = (k + per_block - 1) / per_block;
  if (slices > 65535 || 3LL * k > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  kernel<<<dim3(static_cast<unsigned>(tblocks), slices, 1), threads, 0,
           st>>>(tgt, pos, mass, part, k, n, tiles_per_slice, G, soft_sq);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long k3 = 3LL * k;
  allpairs_at_sum_kernel<<<static_cast<unsigned>((k3 + 31) / 32),
                           dim3(32, kSumRows, 1), 0, st>>>(
      part, out, static_cast<int>(k3), slices);
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks per SM, registers a thread and threads a block of one
// instance of the targets-and-sources mode's first pass, into out[0..2].
extern "C" int spatialsim_allpairs_at_occupancy(int threads, int targets,
                                                int* out) {
  const AtKernelFn kernel = at_kernel_for(targets);
  if (kernel == nullptr || !valid(threads, 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(window_tile::occupancy(kernel, threads, 0, out));
}
