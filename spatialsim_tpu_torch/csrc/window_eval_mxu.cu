// The dense window eval's matrix form, for Hopper (sm_90a), in plain FP32.
//
// Replaces: spatialsim_tpu/ops/bh_eval_kernel.py, _eval_kernel_mxu (the
// use_mxu body of pallas_window_eval), which routes the pair sums through
// the TPU's matrix unit.  Its function, for each Morton group g of gsz
// sorted bodies and monopole far rows (R = 8 / 10), with the same sources
// as the column form (window_eval_cols.cu: the window, the K near groups,
// whole tiles of far entries advanced to now):
//   c    = the mean of the group's gsz target slots, padding included;
//   t_c  = t - c, s_c = s - c for every target t and source s;
//   d2   = ((|t_c|^2 + |s_c|^2) - 2 t_c.s_c) + eps^2;
//   w    = m * rsqrt(max(d2, eps^2))^3        (no gate);
//   a    = G * (sum w s_c - t_c * sum w).
// The self pair cancels in the last difference.  d2 cancels in float32,
// so this is its own function and not the row form's to 1e-4: its
// rounding is part of it.  |t_c|^2, |s_c|^2 and t_c.s_c are FMA chains,
// fma(z, z', fma(y, y', x x')), as XLA rounds the JAX form's sum and
// contraction; d2's own sums are _rn intrinsics, so nvcc contracts
// nothing else there.  The plain version (window_eval_mxu_reference)
// rounds exactly as this kernel does up to the order of the sums; the
// centre is summed in double and rounded once.
//
// No tensor cores: TF32 keeps about three decimal digits, and the cross
// term cancels against |t_c|^2 + |s_c|^2.  A 3xTF32 mma form of the cross
// term and of the w.S contraction is later work.
//
// What bounds it on this card: arithmetic (~19 FP32 operations and one
// rsqrt a pair; the bodies and the live far entries are read once per
// group).
//
// Design (window_eval.cu's): one block per group, one thread per target
// (blockDim == gsz); the centre by a block reduction in double; sources
// staged through shared memory gsz at a time, centred and squared once on
// the way in (far entries advanced there too), read as broadcasts.  Each
// staged batch sums into its own partials first.  Every skipped block is
// skipped by all threads, so the barriers stay safe.  Blocks above 256
// threads compile for <= 64 registers.

#include <cuda_runtime.h>

namespace {

// u.v as an FMA chain: fma(uz, vz, fma(uy, vy, ux * vx)).
__device__ __forceinline__ float dot3_fma(float ux, float uy, float uz,
                                          float vx, float vy, float vz) {
  return fmaf(uz, vz, fmaf(uy, vy, __fmul_rn(ux, vx)));
}

__device__ __forceinline__ void accumulate_mxu(
    const float* sx, const float* sy, const float* sz, const float* sm,
    const float* sp, int cnt, float tx, float ty, float tz, float ti,
    float soft_sq, float& wx, float& wy, float& wz, float& ws) {
  float px = 0.f, py = 0.f, pz = 0.f, pw = 0.f;
  for (int k = 0; k < cnt; ++k) {
    const float cross = dot3_fma(tx, ty, tz, sx[k], sy[k], sz[k]);
    const float d2 = __fadd_rn(
        __fsub_rn(__fadd_rn(ti, sp[k]), __fmul_rn(2.f, cross)), soft_sq);
    const float inv = rsqrtf(fmaxf(d2, soft_sq));
    const float w = sm[k] * (inv * inv * inv);
    px += w * sx[k];
    py += w * sy[k];
    pz += w * sz[k];
    pw += w;
  }
  wx += px;
  wy += py;
  wz += pz;
  ws += pw;
}

// Stage one centred source into slot i of the shared block.
__device__ __forceinline__ void stage(float* sx, float* sy, float* sz,
                                      float* sm, float* sp, int i, float x,
                                      float y, float z, float m, float cx,
                                      float cy, float cz) {
  const float ux = __fsub_rn(x, cx);
  const float uy = __fsub_rn(y, cy);
  const float uz = __fsub_rn(z, cz);
  sx[i] = ux;
  sy[i] = uy;
  sz[i] = uz;
  sm[i] = m;
  sp[i] = dot3_fma(ux, uy, uz, ux, uy, uz);
}

template <int R, int kMaxThreads>
__global__ void __launch_bounds__(kMaxThreads) window_eval_mxu_kernel(
    const float* __restrict__ pos, const float* __restrict__ mass,
    const float* __restrict__ far, const int* __restrict__ far_n,
    const int* __restrict__ near, float* __restrict__ out, int npad, int ng,
    int wg, int K, int L, int tile, float soft_sq, float G, float tau,
    float coef2) {
  constexpr int kAcc = (R == 10) ? 7 : -1;
  extern __shared__ float sh[];
  __shared__ double red[3][32];
  const int gsz = blockDim.x;
  float* sx = sh;
  float* sy = sx + gsz;
  float* sz = sy + gsz;
  float* sm = sz + gsz;
  float* sp = sm + gsz;

  const int g = blockIdx.x;
  const int i = threadIdx.x;
  const size_t b = static_cast<size_t>(g) * gsz + i;
  const float xi = pos[b];
  const float yi = pos[npad + b];
  const float zi = pos[2 * static_cast<size_t>(npad) + b];

  // The group's centre: the targets summed in double, rounded once.
  double vx = xi, vy = yi, vz = zi;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    vx += __shfl_down_sync(0xffffffffu, vx, off);
    vy += __shfl_down_sync(0xffffffffu, vy, off);
    vz += __shfl_down_sync(0xffffffffu, vz, off);
  }
  const int lane = i & 31, warp = i >> 5, n_warps = (gsz + 31) >> 5;
  if (lane == 0) {
    red[0][warp] = vx;
    red[1][warp] = vy;
    red[2][warp] = vz;
  }
  __syncthreads();
  if (i < 3) {
    double s = 0.0;
    for (int w = 0; w < n_warps; ++w) s += red[i][w];
    red[i][0] = s;
  }
  __syncthreads();
  const float cx = static_cast<float>(red[0][0] / gsz);
  const float cy = static_cast<float>(red[1][0] / gsz);
  const float cz = static_cast<float>(red[2][0] / gsz);

  const float tx = __fsub_rn(xi, cx);
  const float ty = __fsub_rn(yi, cy);
  const float tz = __fsub_rn(zi, cz);
  const float ti = dot3_fma(tx, ty, tz, tx, ty, tz);
  float wx = 0.f, wy = 0.f, wz = 0.f, ws = 0.f;

  // Near field: the Morton window, then the near groups, one per pass.
  for (int k = -wg; k <= wg + K; ++k) {
    const int h = (k <= wg) ? g + k
                            : near[static_cast<size_t>(g) * K + (k - wg - 1)];
    if (h < 0 || h >= ng) continue;  // block-uniform
    const size_t s = static_cast<size_t>(h) * gsz + i;
    stage(sx, sy, sz, sm, sp, i, pos[s], pos[npad + s],
          pos[2 * static_cast<size_t>(npad) + s], mass[s], cx, cy, cz);
    __syncthreads();
    accumulate_mxu(sx, sy, sz, sm, sp, gsz, tx, ty, tz, ti, soft_sq, wx, wy,
                   wz, ws);
    __syncthreads();
  }

  // Far field: whole tiles up to far_n, gsz entries per pass, advanced as
  // the plain version advances them (a multiply, then an add).
  const int n0 = min(max(far_n[g], 0), L);
  const int n = min((n0 + tile - 1) / tile * tile, L);
  const float* fg = far + static_cast<size_t>(g) * R * L;
  for (int e0 = 0; e0 < n; e0 += gsz) {
    const int e = e0 + i;
    if (e < n) {
      float x = __fadd_rn(fg[e], __fmul_rn(fg[3 * L + e], tau));
      float y = __fadd_rn(fg[L + e], __fmul_rn(fg[4 * L + e], tau));
      float z = __fadd_rn(fg[2 * L + e], __fmul_rn(fg[5 * L + e], tau));
      if constexpr (kAcc >= 0) {
        x = __fadd_rn(x, __fmul_rn(fg[kAcc * L + e], coef2));
        y = __fadd_rn(y, __fmul_rn(fg[(kAcc + 1) * L + e], coef2));
        z = __fadd_rn(z, __fmul_rn(fg[(kAcc + 2) * L + e], coef2));
      }
      stage(sx, sy, sz, sm, sp, i, x, y, z, fg[6 * L + e], cx, cy, cz);
    }
    __syncthreads();
    accumulate_mxu(sx, sy, sz, sm, sp, min(gsz, n - e0), tx, ty, tz, ti,
                   soft_sq, wx, wy, wz, ws);
    __syncthreads();
  }

  out[b] = __fsub_rn(wx, __fmul_rn(tx, ws)) * G;
  out[npad + b] = __fsub_rn(wy, __fmul_rn(ty, ws)) * G;
  out[2 * static_cast<size_t>(npad) + b] =
      __fsub_rn(wz, __fmul_rn(tz, ws)) * G;
}

template <int R>
cudaError_t launch(int gsz, const float* pos, const float* mass,
                   const float* far, const int* far_n, const int* near,
                   float* out, int npad, int ng, int wg, int K, int L,
                   int tile, float soft_sq, float G, float tau, float coef2,
                   cudaStream_t stream) {
  const size_t shmem = 5 * gsz * sizeof(float);
  if (gsz <= 256) {
    window_eval_mxu_kernel<R, 256><<<ng, gsz, shmem, stream>>>(
        pos, mass, far, far_n, near, out, npad, ng, wg, K, L, tile, soft_sq,
        G, tau, coef2);
  } else {
    window_eval_mxu_kernel<R, 1024><<<ng, gsz, shmem, stream>>>(
        pos, mass, far, far_n, near, out, npad, ng, wg, K, L, tile, soft_sq,
        G, tau, coef2);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int spatialsim_window_eval_mxu(
    const float* pos, const float* mass, const float* far, const int* far_n,
    const int* near, float* out, int npad, int ng, int gsz, int wg, int K,
    int R, int L, int tile, float soft_sq, float G, float tau, float coef2,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // The centre's warp reduction needs whole warps.
  if (gsz < 32 || gsz > 1024 || gsz % 32 || tile < 1 || K < 0 ||
      (K > 0 && near == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err;
  switch (R) {
    case 8:
      err = launch<8>(gsz, pos, mass, far, far_n, near, out, npad, ng, wg, K,
                      L, tile, soft_sq, G, tau, coef2, s);
      break;
    case 10:
      err = launch<10>(gsz, pos, mass, far, far_n, near, out, npad, ng, wg,
                       K, L, tile, soft_sq, G, tau, coef2, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
