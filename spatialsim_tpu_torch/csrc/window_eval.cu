// Windowed Barnes-Hut force evaluation over the dense (ng, R, L) far
// lists, for Hopper (sm_90a).  The every-step kernel of the dense layout:
// N-body runs above 20.5M bodies (monopole, R = 8) and the quadrupole and
// near-group options (R = 10/13/16).
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
// What bounds it on this card: instruction issue.  At 50M bodies a step is
// 48,829 groups x 1024 targets x (5 x 1024 window + ~300 far) sources,
// 2.7e11 pairs of ~15 issued instructions and one MUFU.RSQ each; the
// quadrupole law is ~35 a pair.  The bytes read are the bodies (~0.8 GB
// at 50M) and the live far entries, far under the 3.35 TB/s line.
//
// Design (window_eval_tile.cuh, as window_eval_pool.cu): one block per
// group of gsz / T threads, each holding T targets in registers.  Sources
// go through shared memory in batches of one per thread, double-buffered
// with one barrier a batch: a batch is a slice of a window or near group,
// or the next far entries, advanced on their way from registers to
// shared memory (with their Q rows, as a float4 and a float2, for
// R = 13/16).  The block's source groups (window, then valid near ids)
// are listed once in shared memory.  Templated on R, so the monopole path
// pays nothing for Q, and on T.  Offsets into the far tensor are size_t
// (800M floats at 50M).  `order` (optional) maps block i to group
// order[i], so the wrapper can launch heavy groups first.
//
// Call modes (pallas_window_eval's haloed and local_slice): the kernel
// evaluates ng groups of a source of ngs groups, and group g reads source
// group g + g0 as its targets and g + g0 - wg .. g + g0 + wg as its window
// (clipped to the source, as above).  far, far_n, near and order are
// indexed by g, and the output is (3, ng * gsz).  The whole state is g0 = 0,
// ngs = ng; a haloed shard g0 = wg, ngs = ng + 2 wg; a local slice g0 =
// its first group of the global state.  The modes take no near groups.
//
// Stage ablation (pallas_window_eval's `dbg`, read by _eval_kernel only):
// the kAblate instances read a flags word that the default instances
// never see, so those compile as before.  kNoWin drops the window groups
// from the block's source list (the near groups and the far list stay);
// kNoTgt reads no target and sets every one to (0, 0, 0.5); kNoUttr
// writes, for each block of `iblk` targets of a group (the TPU kernel's
// default: the group, or 256 above 512), G times the block's sum of
// ax + ay + az into all three rows of every target in the block.  The
// TPU kernel's `nostage` skips a copy into a scratch only its window
// loop reads; here window sources are staged by the same batches as far
// entries, so it has no stage of its own (the wrapper takes it only with
// `nowin`).

#include <cuda_runtime.h>

#include "window_eval_tile.cuh"

namespace {

using window_tile::Targets;
using window_tile::round_up8;

__host__ __device__ constexpr bool quad_rows(int R) {
  return R == 13 || R == 16;
}

// Bytes of dynamic shared memory: two buffers of float4 (x, y, z, m), with
// a float4 and a float2 of Q for R = 13/16, then the source-group list.
size_t smem_bytes(int R, int nthr, int wg, int K) {
  const size_t per = sizeof(float4) + (quad_rows(R) ? sizeof(float4)
                                        + sizeof(float2) : 0);
  return 2 * round_up8(nthr) * per + (2 * wg + 2 + K) * sizeof(int);
}

// The ablation flags (spatialsim_window_eval's `flags`).
constexpr int kNoWin = 1;
constexpr int kNoTgt = 2;
constexpr int kNoUttr = 4;

// The TPU kernel's default target block of the `nouttr` sums.
__host__ __device__ constexpr int ablate_block(int gsz) {
  return gsz <= 512 ? gsz : 256;
}

template <int R, int T, bool kAblate>
__global__ void __launch_bounds__(1024 / T) window_eval_kernel(
    const float* __restrict__ pos, const float* __restrict__ mass,
    const float* __restrict__ far, const int* __restrict__ far_n,
    const int* __restrict__ near, const int* __restrict__ order,
    float* __restrict__ out, int ng, int g0, int ngs, int wg, int K, int L,
    float soft_sq, float G, float tau, float coef2, int flags) {
  constexpr bool kQuad = quad_rows(R);
  constexpr int kAcc = (R == 10) ? 7 : (R == 16) ? 13 : -1;
  constexpr int kRaw = 7 + (kQuad ? 6 : 0) + (kAcc >= 0 ? 3 : 0);
  extern __shared__ float4 sh4[];
  const int nthr = blockDim.x;
  const int stride = round_up8(nthr);
  const int tid = threadIdx.x;
  const int gsz = nthr * T;
  const int g = order ? order[blockIdx.x] : blockIdx.x;
  const int gs = g + g0;                               // its source group
  const size_t npad = static_cast<size_t>(ngs) * gsz;  // source slots
  float4* q4 = sh4 + 2 * stride;                       // quadrupole only
  float2* q2 = reinterpret_cast<float2*>(q4 + (kQuad ? 2 * stride : 0));
  int* groups = reinterpret_cast<int*>(q2 + (kQuad ? 2 * stride : 0));

  // Slots past nthr (when nthr is not a multiple of 8) stay zero.
  for (int s = nthr + tid; s < 2 * stride; s += nthr) {
    sh4[s] = make_float4(0.f, 0.f, 0.f, 0.f);
    if constexpr (kQuad) {
      q4[s] = make_float4(0.f, 0.f, 0.f, 0.f);
      q2[s] = make_float2(0.f, 0.f);
    }
  }
  // The window groups in range, then the valid near ids.
  if (tid == 0) {
    int c = 0;
    bool win = true;
    if constexpr (kAblate) win = !(flags & kNoWin);
    for (int h = max(gs - wg, 0); win && h <= min(gs + wg, ngs - 1); ++h) {
      groups[1 + c++] = h;
    }
    for (int k = 0; k < K; ++k) {
      const int h = near[static_cast<size_t>(g) * K + k];
      if (h >= 0 && h < ngs) groups[1 + c++] = h;
    }
    groups[0] = c;
  }

  Targets<T> t;
  bool tgt = true;
  if constexpr (kAblate) tgt = !(flags & kNoTgt);
  if (tgt) {
    t.load(pos, npad, static_cast<size_t>(gs) * gsz + tid, nthr);
  } else {
    // kNoTgt: the targets are not read.
#pragma unroll
    for (int j = 0; j < T; ++j) {
      t.x[j] = 0.f;
      t.y[j] = 0.f;
      t.z[j] = 0.5f;
      t.ax[j] = t.ay[j] = t.az[j] = 0.f;
    }
  }
  const int n = min(max(far_n[g], 0), L);
  const float* fg = far + static_cast<size_t>(g) * R * L;
  __syncthreads();
  const int n_win = groups[0] * T;                     // window, near batches
  const int nb = n_win + (n + nthr - 1) / nthr;

  // One source a thread a batch, raw in registers: (x, y, z, m) of a body,
  // or an entry's rows 0..kRaw-1: com3, vel3, mass (then Q6, then acc3).
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
      x += r[kRaw - 3] * coef2;
      y += r[kRaw - 2] * coef2;
      z += r[kRaw - 1] * coef2;
    }
    sh4[s] = make_float4(x, y, z, r[6]);
    if constexpr (kQuad) {
      q4[s] = make_float4(r[7], r[8], r[9], r[10]);
      q2[s] = make_float2(r[11], r[12]);
    }
  };

  fetch(0);
  stage(0, 0);
  __syncthreads();
  for (int b = 0; b < nb; ++b) {
    const bool more = b + 1 < nb;
    if (more) fetch(b + 1);
    const int p = (b & 1) * stride;
    if (b < n_win) {
      t.sum_mono(sh4 + p, round_up8(nthr), soft_sq);
    } else {
      const int cnt8 = round_up8(min(nthr, n - (b - n_win) * nthr));
      if constexpr (kQuad) {
        t.sum_quad(sh4 + p, q4 + p, q2 + p, cnt8, soft_sq);
      } else {
        t.sum_mono(sh4 + p, cnt8, soft_sq);
      }
    }
    if (more) stage(b + 1, (b + 1) & 1);
    __syncthreads();
  }
  if constexpr (kAblate) {
    if (flags & kNoUttr) {
      // The staging buffers (8 * stride >= gsz floats) are free after the
      // last barrier: target i's ax + ay + az goes to buf[i], each block
      // of iblk is summed by a fixed tree, and its sum lands in the
      // block's first slot.
      float* buf = reinterpret_cast<float*>(sh4);
      const int iblk = ablate_block(gsz);
#pragma unroll
      for (int j = 0; j < T; ++j) {
        buf[tid + j * nthr] = t.ax[j] + t.ay[j] + t.az[j];
      }
      __syncthreads();
      int w = 1;
      while (w < iblk) w <<= 1;
      for (w >>= 1; w >= 1; w >>= 1) {
        for (int p = tid; p < gsz; p += nthr) {
          if (p % iblk < w && p % iblk + w < iblk && p + w < gsz) {
            buf[p] += buf[p + w];
          }
        }
        __syncthreads();
      }
      const size_t nout = static_cast<size_t>(ng) * gsz;
#pragma unroll
      for (int j = 0; j < T; ++j) {
        const int i = tid + j * nthr;
        const float v = buf[i / iblk * iblk] * G;
        const size_t b = static_cast<size_t>(g) * gsz + i;
        out[b] = v;
        out[nout + b] = v;
        out[2 * nout + b] = v;
      }
      return;
    }
  }
  t.store(out, static_cast<size_t>(ng) * gsz,
          static_cast<size_t>(g) * gsz + tid, nthr, G);
}

// Dispatch on T at a fixed R; `op` is called with the kernel instance.
template <int R, bool kAblate, typename Op>
cudaError_t with_t(int T, Op op) {
  switch (T) {
    case 1: return op(window_eval_kernel<R, 1, kAblate>);
    case 2: return op(window_eval_kernel<R, 2, kAblate>);
    default: return op(window_eval_kernel<R, 4, kAblate>);
  }
}

template <bool kAblate = false, typename Op>
cudaError_t with_rt(int R, int T, Op op) {
  switch (R) {
    case 8: return with_t<8, kAblate>(T, op);
    case 10: return with_t<10, kAblate>(T, op);
    case 13: return with_t<13, kAblate>(T, op);
    case 16: return with_t<16, kAblate>(T, op);
    default: return cudaErrorInvalidValue;
  }
}

// T in {1, 2, 4} dividing gsz.
bool valid(int gsz, int T, int wg, int K) {
  return gsz >= 1 && gsz <= 1024 && wg >= 0 && K >= 0
         && (T == 1 || T == 2 || T == 4) && gsz % T == 0;
}

// The launch of either instance set; `flags` reaches only kAblate's.
template <bool kAblate>
int launch(const float* pos, const float* mass, const float* far,
           const int* far_n, const int* near, const int* order, float* out,
           int ng, int g0, int ngs, int gsz, int T, int wg, int K, int R,
           int L, float soft_sq, float G, float tau, float coef2, int flags,
           void* stream) {
  if (!valid(gsz, T, wg, K) || (K > 0 && near == nullptr)
      || !window_tile::valid_range(ng, g0, ngs)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int nthr = gsz / T;
  const size_t smem = smem_bytes(R, nthr, wg, K);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(with_rt<kAblate>(R, T, [&](auto kernel) {
    const cudaError_t err = window_tile::allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<ng, nthr, smem, s>>>(pos, mass, far, far_n, near, order, out,
                                  ng, g0, ngs, wg, K, L, soft_sq, G, tau,
                                  coef2, flags);
    return cudaGetLastError();
  }));
}

}  // namespace

// `flags` is a set of kNoWin, kNoTgt and kNoUttr: 0 launches the default
// instances, any other set the stage-ablation instances.
extern "C" int spatialsim_window_eval(
    const float* pos, const float* mass, const float* far, const int* far_n,
    const int* near, const int* order, float* out, int ng, int g0, int ngs,
    int gsz, int T, int wg, int K, int R, int L, float soft_sq, float G,
    float tau, float coef2, int flags, void* stream) {
  if (flags & ~(kNoWin | kNoTgt | kNoUttr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return flags == 0
      ? launch<false>(pos, mass, far, far_n, near, order, out, ng, g0, ngs,
                      gsz, T, wg, K, R, L, soft_sq, G, tau, coef2, 0, stream)
      : launch<true>(pos, mass, far, far_n, near, order, out, ng, g0, ngs,
                     gsz, T, wg, K, R, L, soft_sq, G, tau, coef2, flags,
                     stream);
}

// Resident blocks per SM, registers a thread and threads of a launch at
// (R, gsz, T) with window and near sizes (wg, K), into out[0..2].
extern "C" int spatialsim_window_eval_occupancy(int R, int gsz, int T,
                                                int wg, int K, int* out) {
  if (!valid(gsz, T, wg, K)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int nthr = gsz / T;
  const size_t smem = smem_bytes(R, nthr, wg, K);
  return static_cast<int>(with_rt(R, T, [&](auto kernel) {
    return window_tile::occupancy(kernel, nthr, smem, out);
  }));
}
