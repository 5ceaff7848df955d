// Register tiles of targets for the window-eval kernels
// (window_eval_pool.cu, window_eval.cu), for Hopper (sm_90a).  The
// all-pairs kernel (allpairs.cu) shares rsqrt_mufu, and it and the boids
// kernel (boids_window.cu) share allow_smem and occupancy.
//
// What bounds those kernels on this card is instruction issue: a pair
// costs ~15 FP32 instructions and one MUFU.RSQ, while the bytes they read
// are far under the 3.35 TB/s line.  So a pair must cost as few issued
// instructions as it can:
//   * each thread holds T targets (positions and sums in registers), so
//     one 16-byte broadcast load of a staged source (x, y, z, m) feeds T
//     pairs instead of four 4-byte loads feeding one;
//   * r2 is one FFMA chain seeded with eps^2;
//   * rsqrt is MUFU.RSQ alone (rsqrt.approx.ftz.f32): rsqrtf() built
//     without -ftz wraps it in a denormal range fix-up (a compare and two
//     predicated multiplies).  Both give the same value for every normal
//     r2, and r2 >= eps^2; with eps = 0 a denormal r2 gives inf either way;
//   * the gate r2 > eps^2 stays: it is part of the function (it zeroes the
//     self pair and coincident bodies).
// Sources are staged by the block in batches, double-buffered in shared
// memory (one barrier a batch): batch k+1 is loaded into registers while
// batch k is summed.  Each batch sums into its own partials before the
// running sums (two-level summation, as the plain versions' accuracy
// needs over ~10K terms).  A batch's count is rounded up to 8 with
// zero-mass slots, which add exactly 0 (the gate, or 0 * a finite w).

#pragma once

#include <cuda_runtime.h>

namespace window_tile {

__device__ __forceinline__ float rsqrt_mufu(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__host__ __device__ __forceinline__ int round_up8(int n) {
  return (n + 7) & ~7;
}

// T targets of one thread: targets tid + j * nthr of the group, j < T.
template <int T>
struct Targets {
  float x[T], y[T], z[T];
  float ax[T], ay[T], az[T];

  __device__ __forceinline__ void load(const float* __restrict__ pos,
                                       size_t npad, size_t b0, int nthr) {
#pragma unroll
    for (int j = 0; j < T; ++j) {
      const size_t b = b0 + static_cast<size_t>(j) * nthr;
      x[j] = pos[b];
      y[j] = pos[npad + b];
      z[j] = pos[2 * npad + b];
      ax[j] = ay[j] = az[j] = 0.f;
    }
  }

  __device__ __forceinline__ void store(float* __restrict__ out, size_t npad,
                                        size_t b0, int nthr, float G) const {
#pragma unroll
    for (int j = 0; j < T; ++j) {
      const size_t b = b0 + static_cast<size_t>(j) * nthr;
      out[b] = ax[j] * G;
      out[npad + b] = ay[j] * G;
      out[2 * npad + b] = az[j] * G;
    }
  }

  // Monopole pairs with the cnt8 staged sources s[0..cnt8) (x, y, z, m):
  // w = m * rsqrt(r2)^3, gated on r2 > eps^2.
  __device__ __forceinline__ void sum_mono(const float4* __restrict__ s,
                                           int cnt8, float soft_sq) {
    float tx[T], ty[T], tz[T];
#pragma unroll
    for (int j = 0; j < T; ++j) tx[j] = ty[j] = tz[j] = 0.f;
    for (int k = 0; k < cnt8; k += 8) {
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const float4 src = s[k + u];
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

  // Monopole + traceless-quadrupole pairs (_pair_accum_quad): a += m d/r^3
  // - Q.d/r^5 + 2.5 (d^T Q d) d/r^7, the gate on 1/r^3.  q4 holds (qxx,
  // qyy, qzz, qxy), q2 (qxz, qyz).
  __device__ __forceinline__ void sum_quad(const float4* __restrict__ s,
                                           const float4* __restrict__ q4,
                                           const float2* __restrict__ q2,
                                           int cnt8, float soft_sq) {
    float tx[T], ty[T], tz[T];
#pragma unroll
    for (int j = 0; j < T; ++j) tx[j] = ty[j] = tz[j] = 0.f;
    for (int k = 0; k < cnt8; k += 8) {
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const float4 src = s[k + u];
        const float4 qa = q4[k + u];
        const float2 qb = q2[k + u];
#pragma unroll
        for (int j = 0; j < T; ++j) {
          const float dx = src.x - x[j];
          const float dy = src.y - y[j];
          const float dz = src.z - z[j];
          const float r2 = fmaf(dx, dx, fmaf(dy, dy, fmaf(dz, dz, soft_sq)));
          const float inv = rsqrt_mufu(r2);
          const float inv2 = inv * inv;
          const float inv3 = (r2 > soft_sq) ? inv * inv2 : 0.f;
          const float qdx = qa.x * dx + qa.w * dy + qb.x * dz;
          const float qdy = qa.w * dx + qa.y * dy + qb.y * dz;
          const float qdz = qb.x * dx + qb.y * dy + qa.z * dz;
          const float dqd = dx * qdx + dy * qdy + dz * qdz;
          const float inv5 = inv3 * inv2;
          const float cw = src.w * inv3 + 2.5f * dqd * inv5 * inv2;
          tx[j] += cw * dx - inv5 * qdx;
          ty[j] += cw * dy - inv5 * qdy;
          tz[j] += cw * dz - inv5 * qdz;
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
};

// Opt a kernel in to `smem` bytes of dynamic shared memory where that is
// above the default 48 KB (the quadrupole buffers at 1,024 threads).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// Resident blocks per SM, registers a thread and threads of a kernel
// launched with `threads` threads and `smem` bytes of dynamic shared
// memory, into out[0..2].
template <typename Kernel>
cudaError_t occupancy(Kernel kernel, int threads, size_t smem, int* out) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], kernel,
                                                      threads, smem);
  out[1] = attr.numRegs;
  out[2] = threads;
  return err;
}

}  // namespace window_tile
