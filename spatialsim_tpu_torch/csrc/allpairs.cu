// Tiled all-pairs gravitational accelerations for Hopper (sm_90a).
//
// Replaces: spatialsim_tpu/ops/allpairs.py, _allpairs_kernel (the Pallas
// kernel behind allpairs_accel).  Same physics per pair:
//     d = p_j - p_i,  r2 = |d|^2 + eps^2,
//     a_i += (G m_j) * rsqrt(r2)^3 * d      only where r2 > eps^2
// (the gate drops self and coincident pairs) and only for j < n (the
// j-padding mask of the TPU kernel).
//
// What bounds it on this card: arithmetic.  Each pair is ~20 FP32 ops
// plus one rsqrt and reads nothing from device memory (sources come from
// shared memory as a broadcast: every thread of a warp reads the same
// word), so the kernel runs at the SMs' FP32/SFU rate once enough blocks
// are resident.  N <= 32,768 on this engine's path, i.e. at most 128
// blocks of 256 threads: the grid is a single wave on 132 SMs.
//
// Design: one thread per target body, which keeps its position and three
// accumulators in registers; the sources stream through shared memory in
// tiles of blockDim bodies (the classic CUDA n-body tile).  Each tile is
// summed into its own partial before joining the running total: one f32
// accumulator over 32K terms drifts ~1e-5 of max|a| from the exact sum,
// two levels (256 x 128) stay ~1e-7.  Layout is the
// JAX package's component-major (3, N): x, y, z rows, coalesced loads.
// No tensor cores, TMA or cp.async yet -- right and simple first.

#include <cuda_runtime.h>

namespace {

__global__ void allpairs_kernel(const float* __restrict__ pos,
                                const float* __restrict__ mass,
                                float* __restrict__ out, int n, float G,
                                float soft_sq) {
  extern __shared__ float sh[];
  float* sx = sh;
  float* sy = sx + blockDim.x;
  float* sz = sy + blockDim.x;
  float* sm = sz + blockDim.x;

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  float xi = 0.f, yi = 0.f, zi = 0.f;
  if (i < n) {
    xi = pos[i];
    yi = pos[n + i];
    zi = pos[2 * n + i];
  }
  float ax = 0.f, ay = 0.f, az = 0.f;

  for (int j0 = 0; j0 < n; j0 += blockDim.x) {
    const int j = j0 + threadIdx.x;
    if (j < n) {
      sx[threadIdx.x] = pos[j];
      sy[threadIdx.x] = pos[n + j];
      sz[threadIdx.x] = pos[2 * n + j];
      sm[threadIdx.x] = mass[j];
    } else {  // j-padding: zero mass, and excluded by the loop bound
      sx[threadIdx.x] = 0.f;
      sy[threadIdx.x] = 0.f;
      sz[threadIdx.x] = 0.f;
      sm[threadIdx.x] = 0.f;
    }
    __syncthreads();
    const int cnt = min((int)blockDim.x, n - j0);
    float tx = 0.f, ty = 0.f, tz = 0.f;
    for (int k = 0; k < cnt; ++k) {
      const float dx = sx[k] - xi;
      const float dy = sy[k] - yi;
      const float dz = sz[k] - zi;
      const float r2 = dx * dx + dy * dy + dz * dz + soft_sq;
      const float inv = rsqrtf(r2);
      const float w = (r2 > soft_sq) ? (G * sm[k]) * inv * (inv * inv) : 0.f;
      tx += w * dx;
      ty += w * dy;
      tz += w * dz;
    }
    ax += tx;
    ay += ty;
    az += tz;
    __syncthreads();
  }
  if (i < n) {
    out[i] = ax;
    out[n + i] = ay;
    out[2 * n + i] = az;
  }
}

}  // namespace

extern "C" int spatialsim_allpairs(const float* pos, const float* mass,
                                   float* out, int n, float G, float soft_sq,
                                   void* stream) {
  const int block = 256;
  const int grid = (n + block - 1) / block;
  allpairs_kernel<<<grid, block, 4 * block * sizeof(float),
                    static_cast<cudaStream_t>(stream)>>>(pos, mass, out, n, G,
                                                         soft_sq);
  return static_cast<int>(cudaGetLastError());
}
