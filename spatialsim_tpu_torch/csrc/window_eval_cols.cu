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
// of every staged block (a window or near group, a far tile) adds into
// partial sum k mod 8, and the 8 partials are added once at the end of the
// group.  Here each thread (one target) keeps those 8 accumulator triples
// in registers, so gsz, L and the tile must be multiples of 8.
//
// What bounds it on this card: arithmetic, as for the row form (~18 FP32
// operations and one rsqrt a pair; the bodies and the live far entries are
// read once per group).  The 8 independent accumulator chains are
// instruction-level parallelism that the row form's single chain lacks.
//
// Design (window_eval.cu's): one block per group, one thread per target
// (blockDim == gsz), sources staged through shared memory gsz at a time
// and read as broadcasts, far entries advanced once on the way in.  Every
// skipped block is skipped by all threads, so the barriers stay safe.
// Blocks above 256 threads compile for <= 64 registers.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ void accumulate_cols(
    const float* sx, const float* sy, const float* sz, const float* sm,
    int cnt, float xi, float yi, float zi, float soft_sq, float (&ax)[8],
    float (&ay)[8], float (&az)[8]) {
  for (int k = 0; k < cnt; k += 8) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float dx = sx[k + j] - xi;
      const float dy = sy[k + j] - yi;
      const float dz = sz[k + j] - zi;
      const float r2 = dx * dx + dy * dy + dz * dz + soft_sq;
      const float inv = rsqrtf(r2);
      const float w = (r2 > soft_sq) ? sm[k + j] * (inv * inv * inv) : 0.f;
      ax[j] += w * dx;
      ay[j] += w * dy;
      az[j] += w * dz;
    }
  }
}

__device__ __forceinline__ float sum8(const float (&a)[8]) {
  return ((a[0] + a[1]) + (a[2] + a[3])) + ((a[4] + a[5]) + (a[6] + a[7]));
}

template <int R, int kMaxThreads>
__global__ void __launch_bounds__(kMaxThreads) window_eval_cols_kernel(
    const float* __restrict__ pos, const float* __restrict__ mass,
    const float* __restrict__ far, const int* __restrict__ far_n,
    const int* __restrict__ near, float* __restrict__ out, int npad, int ng,
    int wg, int K, int L, int tile, float soft_sq, float G, float tau,
    float coef2) {
  constexpr int kAcc = (R == 10) ? 7 : -1;
  extern __shared__ float sh[];
  const int gsz = blockDim.x;
  float* sx = sh;
  float* sy = sx + gsz;
  float* sz = sy + gsz;
  float* sm = sz + gsz;

  const int g = blockIdx.x;
  const int i = threadIdx.x;
  const size_t b = static_cast<size_t>(g) * gsz + i;
  const float xi = pos[b];
  const float yi = pos[npad + b];
  const float zi = pos[2 * static_cast<size_t>(npad) + b];
  float ax[8], ay[8], az[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) ax[j] = ay[j] = az[j] = 0.f;

  // Near field: the Morton window, then the near groups, one per pass.
  for (int k = -wg; k <= wg + K; ++k) {
    const int h = (k <= wg) ? g + k
                            : near[static_cast<size_t>(g) * K + (k - wg - 1)];
    if (h < 0 || h >= ng) continue;  // block-uniform
    const size_t s = static_cast<size_t>(h) * gsz + i;
    sx[i] = pos[s];
    sy[i] = pos[npad + s];
    sz[i] = pos[2 * static_cast<size_t>(npad) + s];
    sm[i] = mass[s];
    __syncthreads();
    accumulate_cols(sx, sy, sz, sm, gsz, xi, yi, zi, soft_sq, ax, ay, az);
    __syncthreads();
  }

  // Far field: whole tiles up to far_n, gsz entries per pass.
  const int n0 = min(max(far_n[g], 0), L);
  const int n = min((n0 + tile - 1) / tile * tile, L);
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
    }
    __syncthreads();
    accumulate_cols(sx, sy, sz, sm, min(gsz, n - e0), xi, yi, zi, soft_sq,
                    ax, ay, az);
    __syncthreads();
  }

  out[b] = sum8(ax) * G;
  out[npad + b] = sum8(ay) * G;
  out[2 * static_cast<size_t>(npad) + b] = sum8(az) * G;
}

template <int R>
cudaError_t launch(int gsz, const float* pos, const float* mass,
                   const float* far, const int* far_n, const int* near,
                   float* out, int npad, int ng, int wg, int K, int L,
                   int tile, float soft_sq, float G, float tau, float coef2,
                   cudaStream_t stream) {
  const size_t shmem = 4 * gsz * sizeof(float);
  if (gsz <= 256) {
    window_eval_cols_kernel<R, 256><<<ng, gsz, shmem, stream>>>(
        pos, mass, far, far_n, near, out, npad, ng, wg, K, L, tile, soft_sq,
        G, tau, coef2);
  } else {
    window_eval_cols_kernel<R, 1024><<<ng, gsz, shmem, stream>>>(
        pos, mass, far, far_n, near, out, npad, ng, wg, K, L, tile, soft_sq,
        G, tau, coef2);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int spatialsim_window_eval_cols(
    const float* pos, const float* mass, const float* far, const int* far_n,
    const int* near, float* out, int npad, int ng, int gsz, int wg, int K,
    int R, int L, int tile, float soft_sq, float G, float tau, float coef2,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (gsz < 8 || gsz > 1024 || gsz % 8 || L % 8 || tile < 8 || tile % 8 ||
      K < 0 || (K > 0 && near == nullptr)) {
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
