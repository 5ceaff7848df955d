// Windowed Barnes-Hut force evaluation over the dense (ng, R, L) far
// lists, for Hopper (sm_90a).  The every-step kernel of the dense layout:
// N-body runs above 20.5M bodies (monopole, R = 8) and the quadrupole
// option (R = 13/16).
//
// Replaces: spatialsim_tpu/ops/bh_eval_kernel.py, _eval_kernel (the Pallas
// kernel behind pallas_window_eval).  For each Morton group g of gsz
// sorted bodies it sums
//   * the near field: every body of the 2*wg+1 window groups g-wg..g+wg
//     (groups past either end contribute nothing -- the TPU kernel reads a
//     zero-padded block there), then the K near groups near[g, :], where
//     an id < 0 or >= ng is the TPU kernel's zero block;
//   * the far field: entries 0..far_n[g] of the group's (R, L) row, each
//     advanced to now as com + vel*tau (+ acc*coef2 for R = 10/16; tau and
//     the clamped quadratic coefficient coef2 come from the host).  Rows:
//     [com3, vel3, mass] then R = 8: pad; 10: acc3; 13: Q6; 16: Q6, acc3.
//     The TPU loops whole tiles to ceil(far_n/tile); the build leaves every
//     slot past far_n zero (mass and Q), so looping to exactly far_n, as
//     here, is the same function.  far_n is clamped to L.
// Pair law, monopole: w = m * rsqrt(r2)^3 with r2 = |d|^2 + eps^2, gated
// on r2 > eps^2.  Quadrupole entries (_pair_accum_quad): a += m d/r^3 -
// Q.d/r^5 + 2.5 (d^T Q d) d/r^7 with the same gate on 1/r^3.  G multiplies
// the sum once at the end.
//
// What bounds it on this card: arithmetic.  At 50M bodies a step is
// 48,829 groups x 1024 targets x (5 x 1024 window + ~2K far) sources, some
// 3e11 pairs of ~18 FP32 ops and one rsqrt; the quadrupole law is ~49 ops
// a pair.  The bytes read are the bodies (~0.8 GB at 50M) and the live far
// entries (<= 3.2 GB), far under the 3.35 TB/s line.
//
// Design (window_eval_pool.cu's): one block per group, one thread per
// target body (blockDim == gsz), position and accumulators in registers.
// Sources are staged into shared memory blockDim at a time -- a window or
// near group, or a chunk of far entries advanced once, cooperatively, on
// the way in (with Q rows for R = 13/16) -- and every thread reads them as
// broadcasts.  Each staged batch sums into its own partial first: a
// single f32 accumulator over tens of thousands of terms drifts ~1e-5 of
// max|a|.  Templated on R, so the monopole path pays nothing for Q, and on
// the launch bound: blocks above 256 threads compile for <= 64 registers
// (1024 threads x 64 = the SM's 65,536).  Every skipped block (a window
// group past either end, an empty near slot) is skipped by all threads
// alike, so the barriers stay safe.  Offsets into the far tensor are
// size_t (800M floats at 50M).  No TMA, cp.async or tensor cores yet.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ void accumulate_mono(
    const float* sx, const float* sy, const float* sz, const float* sm,
    int cnt, float xi, float yi, float zi, float soft_sq, float& ax,
    float& ay, float& az) {
  float tx = 0.f, ty = 0.f, tz = 0.f;
  for (int k = 0; k < cnt; ++k) {
    const float dx = sx[k] - xi;
    const float dy = sy[k] - yi;
    const float dz = sz[k] - zi;
    const float r2 = dx * dx + dy * dy + dz * dz + soft_sq;
    const float inv = rsqrtf(r2);
    const float w = (r2 > soft_sq) ? sm[k] * (inv * inv * inv) : 0.f;
    tx += w * dx;
    ty += w * dy;
    tz += w * dz;
  }
  ax += tx;
  ay += ty;
  az += tz;
}

// sq holds the six Q rows (qxx, qyy, qzz, qxy, qxz, qyz), stride gsz.
__device__ __forceinline__ void accumulate_quad(
    const float* sx, const float* sy, const float* sz, const float* sm,
    const float* sq, int gsz, int cnt, float xi, float yi, float zi,
    float soft_sq, float& ax, float& ay, float& az) {
  float tx = 0.f, ty = 0.f, tz = 0.f;
  for (int k = 0; k < cnt; ++k) {
    const float dx = sx[k] - xi;
    const float dy = sy[k] - yi;
    const float dz = sz[k] - zi;
    const float r2 = dx * dx + dy * dy + dz * dz + soft_sq;
    const float inv = rsqrtf(r2);
    const float inv2 = inv * inv;
    const float inv3 = (r2 > soft_sq) ? inv * inv2 : 0.f;
    const float qxx = sq[k], qyy = sq[gsz + k], qzz = sq[2 * gsz + k];
    const float qxy = sq[3 * gsz + k], qxz = sq[4 * gsz + k];
    const float qyz = sq[5 * gsz + k];
    const float qdx = qxx * dx + qxy * dy + qxz * dz;
    const float qdy = qxy * dx + qyy * dy + qyz * dz;
    const float qdz = qxz * dx + qyz * dy + qzz * dz;
    const float dqd = dx * qdx + dy * qdy + dz * qdz;
    const float inv5 = inv3 * inv2;
    const float cw = sm[k] * inv3 + 2.5f * dqd * inv5 * inv2;
    tx += cw * dx - inv5 * qdx;
    ty += cw * dy - inv5 * qdy;
    tz += cw * dz - inv5 * qdz;
  }
  ax += tx;
  ay += ty;
  az += tz;
}

template <int R, int kMaxThreads>
__global__ void __launch_bounds__(kMaxThreads) window_eval_kernel(
    const float* __restrict__ pos, const float* __restrict__ mass,
    const float* __restrict__ far, const int* __restrict__ far_n,
    const int* __restrict__ near, float* __restrict__ out, int npad, int ng,
    int wg, int K, int L, float soft_sq, float G, float tau, float coef2) {
  constexpr bool kQuad = (R == 13 || R == 16);
  constexpr int kAcc = (R == 10) ? 7 : (R == 16) ? 13 : -1;
  extern __shared__ float sh[];
  const int gsz = blockDim.x;
  float* sx = sh;
  float* sy = sx + gsz;
  float* sz = sy + gsz;
  float* sm = sz + gsz;
  float* sq = sm + gsz;  // 6 * gsz floats, quadrupole layouts only

  const int g = blockIdx.x;
  const int i = threadIdx.x;
  const size_t b = static_cast<size_t>(g) * gsz + i;
  const float xi = pos[b];
  const float yi = pos[npad + b];
  const float zi = pos[2 * static_cast<size_t>(npad) + b];
  float ax = 0.f, ay = 0.f, az = 0.f;

  // Near field: the Morton window, then the near groups, one per pass.
  for (int k = -wg; k <= wg + K; ++k) {
    int h;
    if (k <= wg) {
      h = g + k;
    } else {
      h = near[static_cast<size_t>(g) * K + (k - wg - 1)];
    }
    if (h < 0 || h >= ng) continue;  // block-uniform
    const size_t s = static_cast<size_t>(h) * gsz + i;
    sx[i] = pos[s];
    sy[i] = pos[npad + s];
    sz[i] = pos[2 * static_cast<size_t>(npad) + s];
    sm[i] = mass[s];
    __syncthreads();
    accumulate_mono(sx, sy, sz, sm, gsz, xi, yi, zi, soft_sq, ax, ay, az);
    __syncthreads();
  }

  // Far field: the group's first far_n entries, gsz per pass.
  const int n = min(max(far_n[g], 0), L);
  const float* fg = far + static_cast<size_t>(g) * R * L;
  for (int e0 = 0; e0 < n; e0 += gsz) {
    const int e = e0 + i;
    if (e < n) {
      float x = fg[e] + fg[3 * L + e] * tau;
      float y = fg[L + e] + fg[4 * L + e] * tau;
      float z = fg[2 * L + e] + fg[5 * L + e] * tau;
      if constexpr (kAcc >= 0) {
        x += fg[kAcc * L + e] * coef2;
        y += fg[(kAcc + 1) * L + e] * coef2;
        z += fg[(kAcc + 2) * L + e] * coef2;
      }
      sx[i] = x;
      sy[i] = y;
      sz[i] = z;
      sm[i] = fg[6 * L + e];
      if constexpr (kQuad) {
#pragma unroll
        for (int r = 0; r < 6; ++r) sq[r * gsz + i] = fg[(7 + r) * L + e];
      }
    }
    __syncthreads();
    const int cnt = min(gsz, n - e0);
    if constexpr (kQuad) {
      accumulate_quad(sx, sy, sz, sm, sq, gsz, cnt, xi, yi, zi, soft_sq, ax,
                      ay, az);
    } else {
      accumulate_mono(sx, sy, sz, sm, cnt, xi, yi, zi, soft_sq, ax, ay, az);
    }
    __syncthreads();
  }

  out[b] = ax * G;
  out[npad + b] = ay * G;
  out[2 * static_cast<size_t>(npad) + b] = az * G;
}

template <int R>
cudaError_t launch(int gsz, const float* pos, const float* mass,
                   const float* far, const int* far_n, const int* near,
                   float* out, int npad, int ng, int wg, int K, int L,
                   float soft_sq, float G, float tau, float coef2,
                   cudaStream_t stream) {
  const size_t shmem = ((R == 13 || R == 16) ? 10 : 4) * gsz * sizeof(float);
  if (gsz <= 256) {
    window_eval_kernel<R, 256><<<ng, gsz, shmem, stream>>>(
        pos, mass, far, far_n, near, out, npad, ng, wg, K, L, soft_sq, G,
        tau, coef2);
  } else {
    window_eval_kernel<R, 1024><<<ng, gsz, shmem, stream>>>(
        pos, mass, far, far_n, near, out, npad, ng, wg, K, L, soft_sq, G,
        tau, coef2);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int spatialsim_window_eval(
    const float* pos, const float* mass, const float* far, const int* far_n,
    const int* near, float* out, int npad, int ng, int gsz, int wg, int K,
    int R, int L, float soft_sq, float G, float tau, float coef2,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (gsz < 1 || gsz > 1024 || K < 0 || (K > 0 && near == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err;
  switch (R) {
    case 8:
      err = launch<8>(gsz, pos, mass, far, far_n, near, out, npad, ng, wg, K,
                      L, soft_sq, G, tau, coef2, s);
      break;
    case 10:
      err = launch<10>(gsz, pos, mass, far, far_n, near, out, npad, ng, wg,
                       K, L, soft_sq, G, tau, coef2, s);
      break;
    case 13:
      err = launch<13>(gsz, pos, mass, far, far_n, near, out, npad, ng, wg,
                       K, L, soft_sq, G, tau, coef2, s);
      break;
    case 16:
      err = launch<16>(gsz, pos, mass, far, far_n, near, out, npad, ng, wg,
                       K, L, soft_sq, G, tau, coef2, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
