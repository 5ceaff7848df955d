// The dense window eval's column form, for Hopper (sm_90a): the same
// monopole function as window_eval.cu, summed into 8 interleaved partial
// sums per target.
//
// Replaces: spatialsim_tpu/ops/bh_eval_kernel.py, _eval_kernel_cols (the
// use_cols body of pallas_window_eval).  For each Morton group g of gsz
// sorted bodies and monopole far rows (R = 8: [com3, vel3, mass, pad];
// R = 10 adds acc3) it sums
//   * the 2*wg+1 window groups g-wg..g+wg (groups past either end read the
//     TPU kernel's zero block: nothing), then the K near groups near[g, :]
//     (an id < 0 or >= ng is the zero block);
//   * whole tiles of tile = min(far_tile, L) far entries up to far_n[g]
//     (rounded up to a tile, clamped to L), each advanced to now as com +
//     vel*tau (+ acc*coef2).  Slots past far_n inside the last tile are
//     read as stored; the build leaves them zero.
// Pair law w = m * rsqrt(r2)^3, r2 = |d|^2 + eps^2, gated on r2 > eps^2,
// as in the row form.  The TPU kernel puts sources on sublanes: source k
// of every staged block adds into partial sum k mod 8.  Here source k of a
// staged batch adds into partial k mod 8 (the same partial as in the TPU
// kernel when gsz / T is a multiple of 8, as the wrapper's plan keeps it),
// so gsz, L and the tile must be multiples of 8.  The TPU kernel and the
// plain version add the 8 partials once at the end of the group; here
// each batch's 8 partials fold into the running sums (the tile's two-level
// summation, which the float32 sums over ~10K sources need).  The order of
// the adds differs, the terms do not: the kernel stays within 1e-4 of
// max|a| of the plain version.
//
// What bounds it on this card: instruction issue, as for the row form
// (~15 issued instructions and one MUFU.RSQ a pair; the bodies and the
// far tiles are read once per group, far under the 3.35 TB/s line).
//
// Design (window_eval_tile.cuh, as window_eval.cu): one block per group
// of gsz / T threads, each holding T targets in registers; one 16-byte
// broadcast load of a staged source (x, y, z, m) feeds T pairs; r2 one
// FFMA chain seeded with eps^2; rsqrt as MUFU.RSQ alone; sources staged in
// batches of one per thread, double-buffered in shared memory behind one
// barrier a batch, the next batch prefetched into registers; far entries
// advanced on their way to shared memory; `order` (optional) launches
// heavy groups first.  The 8 partials are the form's own instruction-level
// parallelism (8 independent FMA chains a component and target) and its
// cost in registers: 24 T accumulators a thread (Targets::sum_cols).  The
// call modes (ng groups from source group g0 of ngs) are window_eval.cu's.

#include <cuda_runtime.h>

#include "window_eval_tile.cuh"

namespace {

using window_tile::Targets;
using window_tile::round_up8;

// Bytes of dynamic shared memory: two buffers of float4 (x, y, z, m), then
// the source-group list.
size_t smem_bytes(int nthr, int wg, int K) {
  return 2 * round_up8(nthr) * sizeof(float4)
         + (2 * wg + 2 + K) * sizeof(int);
}

template <int R, int T>
__global__ void __launch_bounds__(1024 / T) window_eval_cols_kernel(
    const float* __restrict__ pos, const float* __restrict__ mass,
    const float* __restrict__ far, const int* __restrict__ far_n,
    const int* __restrict__ near, const int* __restrict__ order,
    float* __restrict__ out, int ng, int g0, int ngs, int wg, int K, int L,
    int tile, float soft_sq, float G, float tau, float coef2) {
  constexpr int kAcc = (R == 10) ? 7 : -1;
  constexpr int kRaw = 7 + (kAcc >= 0 ? 3 : 0);
  extern __shared__ float4 sh4[];
  const int nthr = blockDim.x;
  const int stride = round_up8(nthr);
  const int tid = threadIdx.x;
  const int gsz = nthr * T;
  const int g = order ? order[blockIdx.x] : blockIdx.x;
  const int gs = g + g0;                               // its source group
  const size_t npad = static_cast<size_t>(ngs) * gsz;  // source slots
  int* groups = reinterpret_cast<int*>(sh4 + 2 * stride);

  // Slots past nthr (when nthr is not a multiple of 8) stay zero.
  for (int s = nthr + tid; s < 2 * stride; s += nthr) {
    sh4[s] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  // The window groups in range, then the valid near ids.
  if (tid == 0) {
    int c = 0;
    for (int h = max(gs - wg, 0); h <= min(gs + wg, ngs - 1); ++h) {
      groups[1 + c++] = h;
    }
    for (int k = 0; k < K; ++k) {
      const int h = near[static_cast<size_t>(g) * K + k];
      if (h >= 0 && h < ngs) groups[1 + c++] = h;
    }
    groups[0] = c;
  }

  Targets<T> t;
  t.load(pos, npad, static_cast<size_t>(gs) * gsz + tid, nthr);
  const int n0 = min(max(far_n[g], 0), L);
  const int n = min((n0 + tile - 1) / tile * tile, L);   // whole tiles
  const float* fg = far + static_cast<size_t>(g) * R * L;
  __syncthreads();
  const int n_win = groups[0] * T;                     // window, near batches
  const int nb = n_win + (n + nthr - 1) / nthr;

  // One source a thread a batch, raw in registers: (x, y, z, m) of a body,
  // or an entry's rows 0..kRaw-1: com3, vel3, mass (then acc3).
  float r[kRaw];
  auto fetch = [&](int b) {
    if (b < n_win) {
      const size_t s = static_cast<size_t>(groups[1 + b / T]) * gsz
                       + (b % T) * nthr + tid;
      r[0] = pos[s];
      r[1] = pos[npad + s];
      r[2] = pos[2 * npad + s];
      r[3] = mass[s];
    } else {
      const int e = (b - n_win) * nthr + tid;
#pragma unroll
      for (int k = 0; k < kRaw; ++k) {
        r[k] = e < n ? fg[static_cast<size_t>(k) * L + e] : 0.f;
      }
    }
  };
  auto stage = [&](int b, int p) {
    const int s = p * stride + tid;
    if (b < n_win) {
      sh4[s] = make_float4(r[0], r[1], r[2], r[3]);
      return;
    }
    float x = r[0] + r[3] * tau;
    float y = r[1] + r[4] * tau;
    float z = r[2] + r[5] * tau;
    if constexpr (kAcc >= 0) {
      x += r[kAcc] * coef2;
      y += r[kAcc + 1] * coef2;
      z += r[kAcc + 2] * coef2;
    }
    sh4[s] = make_float4(x, y, z, r[6]);
  };

  fetch(0);
  stage(0, 0);
  __syncthreads();
  for (int b = 0; b < nb; ++b) {
    const bool more = b + 1 < nb;
    if (more) fetch(b + 1);
    const int p = (b & 1) * stride;
    const int cnt8 = b < n_win
        ? stride : round_up8(min(nthr, n - (b - n_win) * nthr));
    t.sum_cols(sh4 + p, cnt8, soft_sq);
    if (more) stage(b + 1, (b + 1) & 1);
    __syncthreads();
  }
  t.store(out, static_cast<size_t>(ng) * gsz,
          static_cast<size_t>(g) * gsz + tid, nthr, G);
}

// Dispatch on (R, T); `op` is called with the kernel instance.
template <int R, typename Op>
cudaError_t with_t(int T, Op op) {
  switch (T) {
    case 1: return op(window_eval_cols_kernel<R, 1>);
    case 2: return op(window_eval_cols_kernel<R, 2>);
    default: return op(window_eval_cols_kernel<R, 4>);
  }
}

template <typename Op>
cudaError_t with_rt(int R, int T, Op op) {
  switch (R) {
    case 8: return with_t<8>(T, op);
    case 10: return with_t<10>(T, op);
    default: return cudaErrorInvalidValue;
  }
}

// T in {1, 2, 4} dividing gsz; gsz a multiple of 8.
bool valid(int gsz, int T, int wg, int K) {
  return gsz >= 8 && gsz <= 1024 && gsz % 8 == 0 && wg >= 0 && K >= 0
         && (T == 1 || T == 2 || T == 4) && gsz % T == 0;
}

}  // namespace

extern "C" int spatialsim_window_eval_cols(
    const float* pos, const float* mass, const float* far, const int* far_n,
    const int* near, const int* order, float* out, int ng, int g0, int ngs,
    int gsz, int T, int wg, int K, int R, int L, int tile, float soft_sq,
    float G, float tau, float coef2, void* stream) {
  if (!valid(gsz, T, wg, K) || L % 8 || tile < 8 || tile % 8
      || (K > 0 && near == nullptr)
      || !window_tile::valid_range(ng, g0, ngs)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int nthr = gsz / T;
  const size_t smem = smem_bytes(nthr, wg, K);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(with_rt(R, T, [&](auto kernel) {
    const cudaError_t err = window_tile::allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<ng, nthr, smem, s>>>(pos, mass, far, far_n, near, order, out,
                                  ng, g0, ngs, wg, K, L, tile, soft_sq, G,
                                  tau, coef2);
    return cudaGetLastError();
  }));
}

// Resident blocks per SM, registers a thread and threads of a launch at
// (R, gsz, T) with window and near sizes (wg, K), into out[0..2].
extern "C" int spatialsim_window_eval_cols_occupancy(int R, int gsz, int T,
                                                     int wg, int K,
                                                     int* out) {
  if (!valid(gsz, T, wg, K)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int nthr = gsz / T;
  const size_t smem = smem_bytes(nthr, wg, K);
  return static_cast<int>(with_rt(R, T, [&](auto kernel) {
    return window_tile::occupancy(kernel, nthr, smem, out);
  }));
}
