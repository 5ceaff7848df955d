// Register tiles of targets for the window-eval kernels
// (window_eval_pool.cu, window_eval.cu, window_eval_cols.cu, and the
// matrix form's window_eval_mxu.cu through Centred), for Hopper (sm_90a).
// The all-pairs kernel (allpairs.cu) shares rsqrt_mufu, and it and the
// boids kernel (boids_window.cu) share allow_smem and occupancy.
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

// u.v as an FMA chain: fma(uz, vz, fma(uy, vy, ux * vx)), as XLA rounds a
// three-term contraction.
__device__ __forceinline__ float dot3_fma(float ux, float uy, float uz,
                                          float vx, float vy, float vz) {
  return fmaf(uz, vz, fmaf(uy, vy, __fmul_rn(ux, vx)));
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

  // The column form's monopole sums (window_eval_cols.cu): the pairs of
  // sum_mono, with source u of every run of 8 adding into partial u, so
  // each target and component carries 8 independent FMA chains (24 T
  // accumulators a thread).  The batch's 8 partials fold into the running
  // sums in a fixed tree, ((0+1)+(2+3))+((4+5)+(6+7)).
  __device__ __forceinline__ void sum_cols(const float4* __restrict__ s,
                                           int cnt8, float soft_sq) {
    float px[8][T], py[8][T], pz[8][T];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
#pragma unroll
      for (int j = 0; j < T; ++j) px[u][j] = py[u][j] = pz[u][j] = 0.f;
    }
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
          px[u][j] = fmaf(w, dx, px[u][j]);
          py[u][j] = fmaf(w, dy, py[u][j]);
          pz[u][j] = fmaf(w, dz, pz[u][j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < T; ++j) {
      ax[j] += sum8(px, j);
      ay[j] += sum8(py, j);
      az[j] += sum8(pz, j);
    }
  }

  static __device__ __forceinline__ float sum8(const float (&p)[8][T],
                                               int j) {
    return ((p[0][j] + p[1][j]) + (p[2][j] + p[3][j]))
           + ((p[4][j] + p[5][j]) + (p[6][j] + p[7][j]));
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

// The matrix form's rounding (window_eval_mxu.cu), in one place for both
// of its instances.  A target t is held centred as -2 t_c and |t_c|^2.
__device__ __forceinline__ void mxu_target(float x, float y, float z,
                                           float cx, float cy, float cz,
                                           float& nx, float& ny, float& nz,
                                           float& ti) {
  const float tx = __fsub_rn(x, cx);
  const float ty = __fsub_rn(y, cy);
  const float tz = __fsub_rn(z, cz);
  ti = dot3_fma(tx, ty, tz, tx, ty, tz);
  nx = -2.f * tx;
  ny = -2.f * ty;
  nz = -2.f * tz;
}

// w of a target (-2 t_c, |t_c|^2) and a staged source s (x, y, z,
// |s_c|^2) of mass m.
__device__ __forceinline__ float mxu_weight(float nx, float ny, float nz,
                                            float ti, float4 s, float m,
                                            float soft_sq) {
  const float c = dot3_fma(nx, ny, nz, s.x, s.y, s.z);
  const float d2 = __fadd_rn(__fadd_rn(__fadd_rn(ti, s.w), c), soft_sq);
  const float inv = rsqrt_mufu(fmaxf(d2, soft_sq));
  return __fmul_rn(m, __fmul_rn(__fmul_rn(inv, inv), inv));
}

// One component of a = G (sum w s_c - t_c sum w), t_c = -n / 2 exactly.
__device__ __forceinline__ float mxu_accel(float sum_ws, float n,
                                           float sum_w, float G) {
  return __fmul_rn(__fsub_rn(sum_ws, __fmul_rn(-0.5f * n, sum_w)), G);
}

// T targets of one thread for the matrix form (window_eval_mxu.cu):
// targets tid + j * nthr of the group, centred on the group's mean c.
// Its function rounds d2 = ((|t_c|^2 + |s_c|^2) - 2 t_c.s_c) + eps^2 in
// float32, every square and the cross term an FMA chain (dot3_fma), the
// sums _rn; w = m * rsqrt(max(d2, eps^2))^3, no gate; a = G (sum w s_c -
// t_c sum w).  The factor -2 is folded into the target: dot3_fma(-2 t_c,
// s_c) is -2 dot3_fma(t_c, s_c) (a power-of-two scale commutes with every
// rounding of the chain, short of overflow and of products below 2^-126;
// an exact 0 may differ in sign), and x + (-y) is x - y, so d2 is the same
// float bit for bit.  The
// target's t_c is -0.5 times what it holds, exactly.  Sources are staged
// centred as float4 (x, y, z, |s_c|^2) and their masses as floats; a
// batch's count is rounded up to 8 with zero slots (mass 0: w = 0 for eps >
// 0, where d2 >= eps^2 is finite).
template <int T>
struct Centred {
  float nx[T], ny[T], nz[T];          // -2 t_c
  float ti[T];                        // |t_c|^2
  float ax[T], ay[T], az[T], aw[T];   // sum w s_c, sum w

  __device__ __forceinline__ void load(const float* __restrict__ pos,
                                       size_t npad, size_t b0, int nthr,
                                       float cx, float cy, float cz) {
#pragma unroll
    for (int j = 0; j < T; ++j) {
      const size_t b = b0 + static_cast<size_t>(j) * nthr;
      mxu_target(pos[b], pos[npad + b], pos[2 * npad + b], cx, cy, cz, nx[j],
                 ny[j], nz[j], ti[j]);
      ax[j] = ay[j] = az[j] = aw[j] = 0.f;
    }
  }

  __device__ __forceinline__ void store(float* __restrict__ out, size_t npad,
                                        size_t b0, int nthr, float G) const {
#pragma unroll
    for (int j = 0; j < T; ++j) {
      const size_t b = b0 + static_cast<size_t>(j) * nthr;
      out[b] = mxu_accel(ax[j], nx[j], aw[j], G);
      out[npad + b] = mxu_accel(ay[j], ny[j], aw[j], G);
      out[2 * npad + b] = mxu_accel(az[j], nz[j], aw[j], G);
    }
  }

  // The pairs with the cnt8 staged sources s[0..cnt8), masses m: the batch
  // sums into its own partials, then into the running sums.
  __device__ __forceinline__ void sum(const float4* __restrict__ s,
                                      const float* __restrict__ m, int cnt8,
                                      float soft_sq) {
    float px[T], py[T], pz[T], pw[T];
#pragma unroll
    for (int j = 0; j < T; ++j) px[j] = py[j] = pz[j] = pw[j] = 0.f;
    for (int k = 0; k < cnt8; k += 8) {
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const float4 src = s[k + u];
        const float mu = m[k + u];
#pragma unroll
        for (int j = 0; j < T; ++j) {
          const float w =
              mxu_weight(nx[j], ny[j], nz[j], ti[j], src, mu, soft_sq);
          px[j] = fmaf(w, src.x, px[j]);
          py[j] = fmaf(w, src.y, py[j]);
          pz[j] = fmaf(w, src.z, pz[j]);
          pw[j] += w;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < T; ++j) {
      ax[j] += px[j];
      ay[j] += py[j];
      az[j] += pz[j];
      aw[j] += pw[j];
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
