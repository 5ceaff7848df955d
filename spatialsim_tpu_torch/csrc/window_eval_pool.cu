// Windowed Barnes-Hut force evaluation over the pooled far lists, for
// Hopper (sm_90a).  The window engine's every-step kernel.
//
// Replaces: spatialsim_tpu/ops/bh_eval_kernel.py, _eval_kernel_pool (the
// Pallas kernel behind pallas_window_eval_pool).  For each Morton group g
// of gsz sorted bodies it sums
//   * the near field: every body of the 2*wg+1 window groups g-wg..g+wg
//     (groups past either end contribute nothing -- the TPU kernel reads
//     zero position and zero mass there);
//   * the far field: the group's ceil(far_n[g]/tile) tiles of the pool,
//     starting at pstart[g].  A tile is (16, tile) floats, rows
//     [com3, vel3, mass, acc3, range halves 4, 0, 0]; each entry is
//     advanced to now as com + vel*tau + acc*coef2 (tau and the clamped
//     quadratic coefficient coef2 come from the host).
// Pair law: w = m * rsqrt(r2)^3 with r2 = |d|^2 + eps^2, gated on
// r2 > eps^2; G multiplies the sum once at the end.
//
// What bounds it on this card: arithmetic.  At 1M bodies a step is
// ~3.9K groups x 256 targets x (1280 window + ~3K far) sources, ~4e9
// pairs of ~20 FP32 ops and one rsqrt each, while the bytes read are
// ~12 MB of bodies plus the ~400 MB pool -- far under the 3.35 TB/s line.
//
// Design: one block per group, one thread per target body (blockDim ==
// gsz), position and accumulators in registers.  Sources are staged into
// shared memory blockDim at a time -- a window group, or a chunk of a
// far tile whose entries are advanced once, cooperatively, on the way in
// -- and every thread then reads them as a broadcast.  The tail of a
// group's last tile past far_n holds zero-mass entries (the pool finish
// fills unused slots from a zero column), so it contributes exactly 0
// and needs no count mask.  The tile index is clamped to the pool's last
// tile, as on the TPU: an out-of-bounds read must never happen even if a
// build overflowed.  No TMA, cp.async or tensor cores yet.

#include <cuda_runtime.h>

namespace {

constexpr int kPoolRows = 16;

__device__ __forceinline__ void accumulate(const float* sx, const float* sy,
                                           const float* sz, const float* sm,
                                           int cnt, float xi, float yi,
                                           float zi, float soft_sq, float& ax,
                                           float& ay, float& az) {
  // One staged batch sums into its own partial first (two-level
  // summation keeps the f32 error of ~4K terms near 1e-7 of max|a|).
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

__global__ void window_eval_pool_kernel(
    const float* __restrict__ pos, const float* __restrict__ mass,
    const float* __restrict__ pool, const int* __restrict__ pstart,
    const int* __restrict__ far_n, float* __restrict__ out, int npad, int ng,
    int wg, int ct, int tile, float soft_sq, float G, float tau,
    float coef2) {
  extern __shared__ float sh[];
  const int gsz = blockDim.x;
  float* sx = sh;
  float* sy = sx + gsz;
  float* sz = sy + gsz;
  float* sm = sz + gsz;

  const int g = blockIdx.x;
  const int i = threadIdx.x;
  const int b = g * gsz + i;
  const float xi = pos[b];
  const float yi = pos[npad + b];
  const float zi = pos[2 * npad + b];
  float ax = 0.f, ay = 0.f, az = 0.f;

  // Near field: the Morton window, one group per pass.
  for (int k = -wg; k <= wg; ++k) {
    const int h = g + k;
    if (h < 0 || h >= ng) continue;  // block-uniform
    const int s = h * gsz + i;
    sx[i] = pos[s];
    sy[i] = pos[npad + s];
    sz[i] = pos[2 * npad + s];
    sm[i] = mass[s];
    __syncthreads();
    accumulate(sx, sy, sz, sm, gsz, xi, yi, zi, soft_sq, ax, ay, az);
    __syncthreads();
  }

  // Far field: the group's pool tiles, gsz entries per pass.
  const int n_t = (far_n[g] + tile - 1) / tile;
  const int t0 = pstart[g];
  for (int t = 0; t < n_t; ++t) {
    const int src = max(0, min(t0 + t, ct - 1));
    const float* tp = pool + static_cast<size_t>(src) * kPoolRows * tile;
    for (int e0 = 0; e0 < tile; e0 += gsz) {
      const int e = e0 + i;
      if (e < tile) {
        sx[i] = tp[e] + tp[3 * tile + e] * tau + tp[7 * tile + e] * coef2;
        sy[i] = tp[tile + e] + tp[4 * tile + e] * tau +
                tp[8 * tile + e] * coef2;
        sz[i] = tp[2 * tile + e] + tp[5 * tile + e] * tau +
                tp[9 * tile + e] * coef2;
        sm[i] = tp[6 * tile + e];
      }
      __syncthreads();
      accumulate(sx, sy, sz, sm, min(gsz, tile - e0), xi, yi, zi, soft_sq, ax,
                 ay, az);
      __syncthreads();
    }
  }

  out[b] = ax * G;
  out[npad + b] = ay * G;
  out[2 * npad + b] = az * G;
}

}  // namespace

extern "C" int spatialsim_window_eval_pool(
    const float* pos, const float* mass, const float* pool, const int* pstart,
    const int* far_n, float* out, int npad, int ng, int gsz, int wg, int ct,
    int tile, float soft_sq, float G, float tau, float coef2, void* stream) {
  window_eval_pool_kernel<<<ng, gsz, 4 * gsz * sizeof(float),
                            static_cast<cudaStream_t>(stream)>>>(
      pos, mass, pool, pstart, far_n, out, npad, ng, wg, ct, tile, soft_sq, G,
      tau, coef2);
  return static_cast<int>(cudaGetLastError());
}
