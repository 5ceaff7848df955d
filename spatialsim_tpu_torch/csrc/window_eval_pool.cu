// Windowed Barnes-Hut force evaluation over the pooled far lists, for
// Hopper (sm_90a).  The window engine's every-step kernel.
//
// Replaces: spatialsim_tpu/ops/bh_eval_kernel.py, _eval_kernel_pool (the
// Pallas kernel behind pallas_window_eval_pool).  For each Morton group g
// of gsz sorted bodies it sums
//   * the near field: every body of the 2*wg+1 window groups g-wg..g+wg
//     (groups past either end contribute nothing -- the TPU kernel reads
//     zero position and zero mass there);
//   * the far field: the group's first far_n[g] pool entries, in tiles
//     from pstart[g].  A tile is (16, tile) floats, rows [com3, vel3,
//     mass, acc3, range halves 4, 0, 0]; each entry is advanced to now as
//     com + vel*tau + acc*coef2 (tau and the clamped quadratic coefficient
//     coef2 come from the host).  The TPU loops whole tiles; the slots
//     past far_n hold zero mass (the pool finish fills unused slots from a
//     zero column) and add exactly 0, so looping to exactly far_n, as
//     here, is the same function.
// Pair law: w = m * rsqrt(r2)^3 with r2 = |d|^2 + eps^2, gated on
// r2 > eps^2; G multiplies the sum once at the end.
//
// What bounds it on this card: instruction issue.  At 1M bodies a step is
// 3,907 groups x 256 targets x (1,280 window + ~1,140 far) sources, 2.4e9
// pairs of ~15 issued instructions each, while the bytes read are ~12 MB
// of bodies plus the live pool entries -- far under the 3.35 TB/s line.
//
// Design (window_eval_tile.cuh): one block per group of gsz / T threads,
// each holding T targets in registers.  Sources go through shared memory
// as float4 (x, y, z, m) in batches of one per thread, double-buffered
// with one barrier a batch: a window batch is a slice of a window group,
// a far batch the next entries of the group's tiles, advanced on their
// way from registers to shared memory.  The tile index is clamped to the
// pool's last tile, as on the TPU: an out-of-bounds read must never
// happen even if a build overflowed.  `order` (optional) maps block i to
// group order[i], so the wrapper can launch heavy groups first.

#include <cuda_runtime.h>

#include "window_eval_tile.cuh"

namespace {

using window_tile::Targets;
using window_tile::round_up8;

constexpr int kPoolRows = 16;

template <int T>
__global__ void __launch_bounds__(1024 / T) window_eval_pool_kernel(
    const float* __restrict__ pos, const float* __restrict__ mass,
    const float* __restrict__ pool, const int* __restrict__ pstart,
    const int* __restrict__ far_n, const int* __restrict__ order,
    float* __restrict__ out, int npad, int ng, int wg, int ct, int tile,
    float soft_sq, float G, float tau, float coef2) {
  extern __shared__ float4 sh4[];
  const int nthr = blockDim.x;
  const int stride = round_up8(nthr);
  const int tid = threadIdx.x;
  const int gsz = nthr * T;
  const int g = order ? order[blockIdx.x] : blockIdx.x;

  // Slots past nthr (when nthr is not a multiple of 8) stay zero.
  for (int s = nthr + tid; s < 2 * stride; s += nthr) {
    sh4[s] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  Targets<T> t;
  const size_t b0 = static_cast<size_t>(g) * gsz + tid;
  t.load(pos, npad, b0, nthr);

  const int lo = max(g - wg, 0);
  const int n_win = (min(g + wg, ng - 1) - lo + 1) * T;   // window batches
  const int n = max(far_n[g], 0);
  const int nb = n_win + (n + nthr - 1) / nthr;
  const int t0 = pstart[g];

  // One source a thread a batch, raw in registers: (x, y, z, m) of a
  // body, or an entry's com3, vel3, mass, acc3.
  float r[10];
  auto fetch = [&](int b) {
    if (b < n_win) {
      const size_t s = static_cast<size_t>(lo + b / T) * gsz
                       + (b % T) * nthr + tid;
      r[0] = pos[s];
      r[1] = pos[npad + s];
      r[2] = pos[2 * static_cast<size_t>(npad) + s];
      r[3] = mass[s];
    } else {
      const int e = (b - n_win) * nthr + tid;
      if (e < n) {
        const int ti = e / tile;
        const int src = max(0, min(t0 + ti, ct - 1));
        const float* tp = pool + static_cast<size_t>(src) * kPoolRows * tile
                          + (e - ti * tile);
#pragma unroll
        for (int k = 0; k < 10; ++k) r[k] = tp[k * tile];
      } else {
#pragma unroll
        for (int k = 0; k < 10; ++k) r[k] = 0.f;
      }
    }
  };
  auto stage = [&](int b, float4* buf) {
    if (b < n_win) {
      buf[tid] = make_float4(r[0], r[1], r[2], r[3]);
    } else {
      buf[tid] = make_float4(r[0] + r[3] * tau + r[7] * coef2,
                             r[1] + r[4] * tau + r[8] * coef2,
                             r[2] + r[5] * tau + r[9] * coef2, r[6]);
    }
  };

  fetch(0);
  stage(0, sh4);
  __syncthreads();
  for (int b = 0; b < nb; ++b) {
    const bool more = b + 1 < nb;
    if (more) fetch(b + 1);
    const int cnt = b < n_win ? nthr : min(nthr, n - (b - n_win) * nthr);
    t.sum_mono(sh4 + (b & 1) * stride, round_up8(cnt), soft_sq);
    if (more) stage(b + 1, sh4 + ((b + 1) & 1) * stride);
    __syncthreads();
  }
  t.store(out, npad, b0, nthr, G);
}

// Dispatch on T; `op` is called with the kernel instance.
template <typename Op>
cudaError_t with_t(int T, Op op) {
  switch (T) {
    case 1: return op(window_eval_pool_kernel<1>);
    case 2: return op(window_eval_pool_kernel<2>);
    default: return op(window_eval_pool_kernel<4>);
  }
}

// T in {1, 2, 4} dividing gsz.
bool valid(int gsz, int T) {
  return gsz >= 1 && gsz <= 1024 && (T == 1 || T == 2 || T == 4)
         && gsz % T == 0;
}

size_t smem_bytes(int nthr) { return 2 * round_up8(nthr) * sizeof(float4); }

}  // namespace

extern "C" int spatialsim_window_eval_pool(
    const float* pos, const float* mass, const float* pool, const int* pstart,
    const int* far_n, const int* order, float* out, int npad, int ng,
    int gsz, int T, int wg, int ct, int tile, float soft_sq, float G,
    float tau, float coef2, void* stream) {
  if (!valid(gsz, T) || tile < 1 || ct < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int nthr = gsz / T;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(with_t(T, [&](auto kernel) {
    kernel<<<ng, nthr, smem_bytes(nthr), s>>>(
        pos, mass, pool, pstart, far_n, order, out, npad, ng, wg, ct, tile,
        soft_sq, G, tau, coef2);
    return cudaGetLastError();
  }));
}

// Resident blocks per SM, registers a thread and threads of a launch at
// (gsz, T), into out[0..2].
extern "C" int spatialsim_window_eval_pool_occupancy(int gsz, int T,
                                                     int* out) {
  if (!valid(gsz, T)) return static_cast<int>(cudaErrorInvalidValue);
  const int nthr = gsz / T;
  return static_cast<int>(with_t(T, [&](auto kernel) {
    return window_tile::occupancy(kernel, nthr, smem_bytes(nthr), out);
  }));
}
