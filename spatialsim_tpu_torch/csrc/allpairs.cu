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

template <int T>
__global__ void __launch_bounds__(kMaxThreads) allpairs_kernel(
    const float* __restrict__ pos, const float* __restrict__ mass,
    float* __restrict__ out, int n, int tiles_per_slice, float G,
    float soft_sq) {
  // Sources an iteration of the source loop: 16 pairs a thread at every T,
  // so the loop's code stays ~250 instructions.
  constexpr int kUnroll = 16 / T;
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
    for (int k = t; k < kTile; k += nthr) {
      const size_t j = static_cast<size_t>(tl) * kTile + k;
      s_src[k] = j < static_cast<size_t>(n)
                     ? make_float4(pos[j], pos[n + j],
                                   pos[2 * static_cast<size_t>(n) + j],
                                   G * mass[j])
                     : make_float4(kFar, kFar, kFar, 0.f);
    }
    __syncthreads();
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
          const float r2 =
              fmaf(dx, dx, fmaf(dy, dy, fmaf(dz, dz, soft_sq)));
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
