// The recorder's frame capture for Hopper (sm_90a): the window engine's
// Morton-sorted state read back in original body order, and the velocity
// colours, each as (n, 3) float32 rows, the layout the frame files and the
// pinned host buffers hold.
//
// Replaces no TPU kernel.  In the JAX package both are plain jnp
// (models/nbody.py `_original`, ops/colors.py `colors_by_velocity`), and
// the port ran them as plain PyTorch: an int64 copy of inv_order and an
// index gather of each (3, n) array, ~83 elementwise launches for the
// colours, then a transpose of each result, about 90 launches a frame.
//
// capture_original (two launches): out_p[i] = pos[:, inv_order[i]] and
// out_v[i] = vel[:, inv_order[i]] for the (3, n) arrays, into fresh (n, 3)
// rows.  Every value is moved, never computed: the rows equal the plain
// gather's bit for bit.
//   What bounds it: bytes.  The sorted side and the rows are contiguous;
//   the other side is random and moves whole 32 B sectors.  The least
//   that must move, pos and vel at 10M bodies: the sorted arrays (240 MB)
//   and an index (40 MB) read, and the rows written at random, 1.25
//   sectors a 12 B row (800 MB): 1.08 GB, 0.32 ms at 3.35 TB/s.
//   Design: a gather straight from the (3, n) arrays reads a sector for
//   each of a body's 6 components, 1.92 GB of sectors at 10M: 1.92 ms on
//   an H100; a scatter of the 12 B rows by order writes partial sectors:
//   3.12 ms.  So the rows are staged first: pass 1 (stage_rows_kernel)
//   writes each body's pos and vel into one 32 B row in sorted order, all
//   coalesced; pass 2 (gather_rows_kernel) reads one whole sector a body
//   by inv_order and writes the (n, 3) rows coalesced, with evict-first
//   stores so the 50 MB L2 keeps the staged rows.  0.68 ms at 10M (a
//   scatter of the staged rows by order, then an ordered pass 2: 0.96).
//   kBodies bodies a thread, each thread's loads issued before its
//   stores.
//
// capture_colors_kernel: the 7-band blue-white-red gradient of
// ops/colors.py `colors_by_velocity_reference` on t = min(|v| / max_speed,
// 1), from any (3, n) strided view (elements v[c * sc + i * si]) into
// fresh (n, 3) rows.  The fast input is the (n, 3) storage behind
// capture_original's rows (sc = 1, si = 3).
//   What bounds it: bytes, 12 B read and 12 B written a body.
//   Arithmetic, for the values PyTorch's CUDA kernels give the plain
//   version on a contiguous (3, n) input: each square rounded on its own
//   and summed as (x^2 + y^2) + z^2 (no FMA contraction); the square root
//   correctly rounded (the plain version's root in double, rounded to
//   float, is the same float); NaN kept through the clamp, as torch.clamp
//   keeps it; a division by a Python number as a multiply by its float32
//   reciprocal, as PyTorch's CUDA true division by a CPU scalar computes
//   it; every constant the float32 nearest the Python double, as PyTorch
//   converts a scalar; the bands taken in `_select`'s first-true order.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBodies = 4;                      // bodies a thread
constexpr long long kBlockBodies = static_cast<long long>(kThreads) * kBodies;

unsigned blocks_for(int n) {
  return static_cast<unsigned>((n + kBlockBodies - 1) / kBlockBodies);
}

// A Python number as PyTorch hands it to a float32 kernel.
#define F(x) static_cast<float>(x)

// Staged rows: 8 floats (one 32 B sector) a body,
// [p.x p.y p.z v.x | v.y v.z - -].
constexpr int kW = 8;

// Pass 1: the sorted arrays, read coalesced, into staged rows in sorted
// order.
__global__ void __launch_bounds__(kThreads)
stage_rows_kernel(const float* __restrict__ p, const float* __restrict__ v,
                  float* __restrict__ stage, int n) {
  const long long first = blockIdx.x * kBlockBodies + threadIdx.x;
  const long long nn = n;
#pragma unroll
  for (int j = 0; j < kBodies; ++j) {
    const long long s = first + j * kThreads;
    if (s >= nn) continue;
    float4* out = reinterpret_cast<float4*>(stage + kW * s);
    const float px = __ldcs(p + s), py = __ldcs(p + nn + s),
                pz = __ldcs(p + 2 * nn + s);
    const float vx = __ldcs(v + s), vy = __ldcs(v + nn + s),
                vz = __ldcs(v + 2 * nn + s);
    out[0] = make_float4(px, py, pz, vx);
    out[1] = make_float4(vy, vz, 0.0f, 0.0f);
  }
}

// Pass 2: a thread an original id i reads its staged row at inv_order[i]
// (the random side: one sector a body) and writes its (n, 3) rows; lane j
// of a warp holds id base + j, so a warp's stores cover 384 contiguous
// bytes of each output.
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const float* __restrict__ stage,
                   const int* __restrict__ inv, float* __restrict__ out_p,
                   float* __restrict__ out_v, int n) {
  const long long first = blockIdx.x * kBlockBodies + threadIdx.x;
  const long long nn = n;
  float4 r[kBodies][2];
#pragma unroll
  for (int j = 0; j < kBodies; ++j) {
    const long long i = first + j * kThreads;
    if (i >= nn) continue;
    const float4* in = reinterpret_cast<const float4*>(
        stage + kW * static_cast<long long>(__ldcs(inv + i)));
    r[j][0] = __ldg(in);
    r[j][1] = __ldg(in + 1);
  }
#pragma unroll
  for (int j = 0; j < kBodies; ++j) {
    const long long i = first + j * kThreads;
    if (i >= nn) continue;
    float* op = out_p + 3 * i;
    __stcs(op, r[j][0].x);
    __stcs(op + 1, r[j][0].y);
    __stcs(op + 2, r[j][0].z);
    float* ov = out_v + 3 * i;
    __stcs(ov, r[j][0].w);
    __stcs(ov + 1, r[j][1].x);
    __stcs(ov + 2, r[j][1].y);
  }
}

// The float32 reciprocals PyTorch multiplies by for t / 0.15, sa / 0.6, ...
struct Inverses {
  float max_speed, b015, b025, b06, b04, b005, b004, b001;
};

__device__ __forceinline__ void colour(float x, float y, float z,
                                       const Inverses& q, float* rgb) {
  const float ss = __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                             __fmul_rn(z, z));
  float t = __fmul_rn(__fsqrt_rn(ss), q.max_speed);
  if (!isnan(t)) t = fminf(t, 1.0f);
  float r = 1.0f, g, bl = 0.0f;
  if (t < F(0.15)) {
    const float s = __fmul_rn(t, q.b015);
    r = __fsub_rn(F(0.4), __fmul_rn(F(0.2), s));
    g = __fadd_rn(F(0.2), __fmul_rn(F(0.2), s));
    bl = __fadd_rn(F(0.8), __fmul_rn(F(0.1), s));
  } else if (t < F(0.30)) {
    const float s = __fmul_rn(__fsub_rn(t, F(0.15)), q.b015);
    r = __fadd_rn(F(0.2), __fmul_rn(F(0.1), s));
    g = __fadd_rn(F(0.4), __fmul_rn(F(0.1), s));
    bl = __fadd_rn(F(0.9), __fmul_rn(F(0.05), s));
  } else if (t < F(0.45)) {
    const float sa = __fmul_rn(__fsub_rn(t, F(0.30)), q.b025);
    const float s = __fmul_rn(sa, q.b06);
    r = __fsub_rn(F(0.3), __fmul_rn(F(0.1), s));
    g = __fadd_rn(F(0.5), __fmul_rn(F(0.3), s));
    bl = __fadd_rn(F(0.95), __fmul_rn(F(0.05), s));
  } else if (t < F(0.55)) {
    const float sa = __fmul_rn(__fsub_rn(t, F(0.30)), q.b025);
    const float s = __fmul_rn(__fsub_rn(sa, F(0.6)), q.b04);
    r = __fadd_rn(F(0.2), __fmul_rn(F(0.8), s));
    g = __fadd_rn(F(0.8), __fmul_rn(F(0.2), s));
    bl = 1.0f;
  } else if (t < F(0.90)) {
    g = 1.0f;
    bl = 1.0f;
  } else if (t < F(0.95)) {
    const float s = __fmul_rn(__fsub_rn(t, F(0.90)), q.b005);
    g = __fsub_rn(1.0f, __fmul_rn(F(0.05), s));
    bl = __fsub_rn(1.0f, s);
  } else if (t < F(0.99)) {
    const float s = __fmul_rn(__fsub_rn(t, F(0.95)), q.b004);
    g = __fsub_rn(F(0.95), __fmul_rn(F(0.45), s));
  } else {                                      // t >= 0.99, or NaN
    const float s = __fmul_rn(__fsub_rn(t, F(0.99)), q.b001);
    g = __fsub_rn(F(0.5), __fmul_rn(F(0.5), s));
  }
  rgb[0] = r;
  rgb[1] = g;
  rgb[2] = bl;
}

__global__ void __launch_bounds__(kThreads)
capture_colors_kernel(const float* __restrict__ v, long long sc,
                      long long si, float* __restrict__ out, int n,
                      float max_speed) {
  const Inverses q{__frcp_rn(max_speed), __frcp_rn(F(0.15)),
                   __frcp_rn(F(0.25)),  __frcp_rn(F(0.6)),
                   __frcp_rn(F(0.4)),   __frcp_rn(F(0.05)),
                   __frcp_rn(F(0.04)),  __frcp_rn(F(0.01))};
  const long long first = blockIdx.x * kBlockBodies + threadIdx.x;
  const long long nn = n;
  float in[kBodies][3];
#pragma unroll
  for (int j = 0; j < kBodies; ++j) {
    const long long i = first + j * kThreads;
    if (i >= nn) continue;
#pragma unroll
    for (int c = 0; c < 3; ++c) in[j][c] = __ldcs(v + c * sc + i * si);
  }
#pragma unroll
  for (int j = 0; j < kBodies; ++j) {
    const long long i = first + j * kThreads;
    if (i >= nn) continue;
    float rgb[3];
    colour(in[j][0], in[j][1], in[j][2], q, rgb);
#pragma unroll
    for (int c = 0; c < 3; ++c) __stcs(out + 3 * i + c, rgb[c]);
  }
}

}  // namespace

// Rows of pos and vel in original order: staged in sorted order into
// `stage` (n rows of 8 floats), then gathered by inv_order (n ids) into
// out_p / out_v (n rows of 3 floats each).
extern "C" int spatialsim_capture_original(const float* pos,
                                           const float* vel, const int* inv,
                                           float* stage, float* out_p,
                                           float* out_v, int n,
                                           void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  stage_rows_kernel<<<blocks_for(n), kThreads, 0, s>>>(pos, vel, stage, n);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gather_rows_kernel<<<blocks_for(n), kThreads, 0, s>>>(stage, inv, out_p,
                                                        out_v, n);
  return static_cast<int>(cudaGetLastError());
}

// Colours of n bodies whose velocity components sit at v[c * sc + i * si]
// (strides in elements), into n rows of 3 floats.
extern "C" int spatialsim_capture_colors(const float* v, float* out, int n,
                                         int sc, int si, float max_speed,
                                         void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  capture_colors_kernel<<<blocks_for(n), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      v, sc, si, out, n, max_speed);
  return static_cast<int>(cudaGetLastError());
}
