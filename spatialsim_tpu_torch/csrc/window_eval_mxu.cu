// The dense window eval's matrix form, for Hopper (sm_90a): a register
// tile on CUDA cores, and a second instance whose contraction runs on the
// tensor cores in split TF32.
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
//   w    = m * rsqrt(max(d2, eps^2))^3        (no gate; eps > 0);
//   a    = G * (sum w s_c - t_c * sum w).
// The self pair cancels in the last difference.  d2 cancels in float32,
// so this is its own function and not the row form's to 1e-4: its
// rounding is part of it.  |t_c|^2, |s_c|^2 and t_c.s_c are FMA chains
// (window_tile::dot3_fma), as XLA rounds the JAX form's sum and
// contraction; d2's own sums are _rn intrinsics.  The centre is summed in
// double and rounded once.  Both instances compute d2 and w on CUDA cores
// in exactly that rounding (the plain version, window_eval_mxu_reference,
// rounds them alike); they differ only in how the sums w s_c and w are
// taken, so each stays within 1e-4 of max|a| of the plain version.
//
// No part of d2 goes to the tensor cores: a 3xTF32 cross term t_c.s_c is
// not the function's FMA chain, and on clusters ~1,000 from the origin it
// moves a by 4-6e-2 of max|a| (tests/test_torch_mxu_tile.py holds that).
// The contraction sum w [s_c, 1] may: it is a plain sum.
//
// What bounds it on this card: instruction issue (~15 issued
// instructions and one MUFU.RSQ a pair on CUDA cores; the bodies and the
// far tiles are read once per group, far under the 3.35 TB/s line).
//
// Instance "fma" (window_tile::Centred, the shared tile's pattern): one
// block per group of gsz / T threads (a multiple of 32), T targets a
// thread holding -2 t_c and |t_c|^2; sources staged once per block per
// batch of one a thread, centred, squared and advanced on the way in,
// double-buffered with register prefetch and one barrier a batch, read as
// broadcast float4 (x, y, z, |s_c|^2) plus m; rsqrt as MUFU.RSQ alone
// after fmaxf(d2, eps^2); batch partials, then running sums; `order`
// (optional) launches heavy groups first.  15 instructions a pair, plus
// two loads per T pairs.
//
// Instance "mma" (mma.sync.aligned.m16n8k8 .tf32): one block per group, M
// m16 tiles of targets a warp.  In a k8 step, thread (g, q) of a warp
// computes d2 and w on CUDA cores for its A-fragment positions (targets
// g and g + 8 of each tile, sources q and q + 4 of the step; the 2
// sources reused over 2M targets), splits w = w_hi + w_lo (cvt.rna's
// rounding to TF32, then the float32 remainder, which the tensor core
// reads truncated to TF32) and issues two mma into one accumulator.
// Both take the same B: for each source the 8 columns [hi(s_c), 1,
// lo(s_c), 0], staged once per block: column 3 collects sum w, columns
// 0-2 and 4-6 sum w s_c, all four hi/lo products included.  The epilogue
// adds columns 4-6 onto 0-2 with quad shuffles and forms a as above.  The
// contraction's cost a pair drops from 4 FFMA/FADD to the split (an
// integer add, a LOP3, an FADD) and half an HMMA issue slot.
//
// mxu_plan (ops/bh_eval_kernel.py) picks the instance by timing on the
// card: the "mma" instance issues fewer instructions a pair, but at its
// registers fewer warps stay resident and it issues fewer a clock, so
// the tile was the faster (PERF.md, kernel 3c).
//
// Both instances take window_eval.cu's call modes: ng groups from source
// group g0 of ngs, targets, centre and window read at g + g0, the output
// (3, ng * gsz) written at g.

#include <cstdint>

#include <cuda_runtime.h>

#include "window_eval_tile.cuh"

namespace {

using window_tile::Centred;
using window_tile::dot3_fma;
using window_tile::mxu_accel;
using window_tile::mxu_target;
using window_tile::mxu_weight;
using window_tile::round_up8;

// mma.m16n8k8 .tf32 fragments (PTX ISA), lane = 4 g + q, v a register:
//   A (16 targets x 8 sources):  a[v] at row g + kARowStep * (v & 1),
//                                column q + kAColStep * (v >> 1);
//   B (8 sources x 8 columns):   b[v] at row q + kBRowStep * v, column g;
//   C (16 targets x 8 columns):  c[v] at row g + kCRowStep * (v >> 1),
//                                column 2 q + (v & 1).
constexpr int kARowStep = 8;
constexpr int kAColStep = 4;
constexpr int kBRowStep = 4;
constexpr int kCRowStep = 8;
// B's columns for a source: hi(x, y, z) at 0-2, 1 at kBOne, lo(x, y, z) at
// kBLo..kBLo+2, 0 at 7.  Lane q + kLoLane holds the lo columns of lane q's.
constexpr int kBOne = 3;
constexpr int kBLo = 4;
constexpr int kLoLane = 2;

// Bytes of dynamic shared memory: two buffers of `stride` sources --
// float4 (x, y, z, |s_c|^2), for "mma" two float4 of B columns, a float
// mass -- then the source-group list.
size_t smem_bytes(int stride, bool mma, int wg, int K) {
  return 2 * static_cast<size_t>(stride)
             * ((mma ? 3 : 1) * sizeof(float4) + sizeof(float))
         + (2 * wg + 2 + K) * sizeof(int);
}

// The window groups in range, then the valid near ids, into groups[1..];
// their count into groups[0].  One thread.
// Group g's window is source groups gs - wg .. gs + wg (gs = g + g0) in
// [0, ngs); its near ids are near[g, :].
__device__ __forceinline__ void group_list(int* groups, int g, int gs,
                                           int ngs, int wg, int K,
                                           const int* __restrict__ near) {
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

// The group's centre: its gsz target slots from base summed in double
// (thread tid takes slots tid, tid + nthr, ...; then each warp by
// shuffles, then the warps in order), the mean rounded once.  nthr is a
// multiple of 32; every thread calls it (two barriers).
__device__ __forceinline__ float3 group_centre(const float* __restrict__ pos,
                                               size_t npad, size_t base,
                                               int gsz, double (*red)[32]) {
  const int nthr = blockDim.x, tid = threadIdx.x;
  double vx = 0.0, vy = 0.0, vz = 0.0;
  for (int i = tid; i < gsz; i += nthr) {
    vx += pos[base + i];
    vy += pos[npad + base + i];
    vz += pos[2 * npad + base + i];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    vx += __shfl_down_sync(0xffffffffu, vx, off);
    vy += __shfl_down_sync(0xffffffffu, vy, off);
    vz += __shfl_down_sync(0xffffffffu, vz, off);
  }
  if ((tid & 31) == 0) {
    red[0][tid >> 5] = vx;
    red[1][tid >> 5] = vy;
    red[2][tid >> 5] = vz;
  }
  __syncthreads();
  if (tid < 3) {
    double s = 0.0;
    for (int w = 0; w < nthr >> 5; ++w) s += red[tid][w];
    red[tid][0] = s;
  }
  __syncthreads();
  return make_float3(static_cast<float>(red[0][0] / gsz),
                     static_cast<float>(red[1][0] / gsz),
                     static_cast<float>(red[2][0] / gsz));
}

// The sources of one group in batches of nthr, one a thread: each window
// or near group in ceil(gsz / nthr) batches, then the far entries up to n
// (whole tiles).  fetch(b) reads a thread's raw source of batch b into
// registers, centred(b) advances a far entry (a multiply, then an add, as
// the plain version), centres it and squares it; slots past a batch's
// sources are zero (mass 0).
template <int R>
struct Sources {
  static constexpr int kAcc = (R == 10) ? 7 : -1;
  static constexpr int kRaw = 7 + (kAcc >= 0 ? 3 : 0);
  const float* pos;
  const float* mass;
  const float* fg;
  const int* groups;
  size_t npad;
  int gsz, nthr, n_per, n_win, n, L, tid;
  float tau, coef2;
  float r[kRaw];
  bool live;

  __device__ __forceinline__ int batches() const {
    return n_win + (n + nthr - 1) / nthr;
  }

  // Sources in batch b, rounded up to 8.
  __device__ __forceinline__ int cnt8(int b) const {
    return round_up8(b < n_win ? min(nthr, gsz - (b % n_per) * nthr)
                               : min(nthr, n - (b - n_win) * nthr));
  }

  __device__ __forceinline__ void fetch(int b) {
    if (b < n_win) {
      const int j = (b % n_per) * nthr + tid;
      live = j < gsz;
      if (live) {
        const size_t s = static_cast<size_t>(groups[1 + b / n_per]) * gsz + j;
        r[0] = pos[s];
        r[1] = pos[npad + s];
        r[2] = pos[2 * npad + s];
        r[3] = mass[s];
      }
    } else {
      const int e = (b - n_win) * nthr + tid;
      live = e < n;
      if (live) {
#pragma unroll
        for (int k = 0; k < kRaw; ++k) {
          r[k] = fg[static_cast<size_t>(k) * L + e];
        }
      }
    }
  }

  // The fetched source of batch b as (x, y, z, |s_c|^2) and its mass.
  __device__ __forceinline__ float4 centred(int b, float3 c, float& m) const {
    if (!live) {
      m = 0.f;
      return make_float4(0.f, 0.f, 0.f, 0.f);
    }
    float x = r[0], y = r[1], z = r[2];
    if (b < n_win) {
      m = r[3];
    } else {
      x = __fadd_rn(x, __fmul_rn(r[3], tau));
      y = __fadd_rn(y, __fmul_rn(r[4], tau));
      z = __fadd_rn(z, __fmul_rn(r[5], tau));
      if constexpr (kAcc >= 0) {
        x = __fadd_rn(x, __fmul_rn(r[kAcc], coef2));
        y = __fadd_rn(y, __fmul_rn(r[kAcc + 1], coef2));
        z = __fadd_rn(z, __fmul_rn(r[kAcc + 2], coef2));
      }
      m = r[6];
    }
    const float ux = __fsub_rn(x, c.x);
    const float uy = __fsub_rn(y, c.y);
    const float uz = __fsub_rn(z, c.z);
    return make_float4(ux, uy, uz, dot3_fma(ux, uy, uz, ux, uy, uz));
  }
};

// The shared prologue of both instances: block order, group list, centre,
// and the group's sources.
template <int R>
__device__ __forceinline__ Sources<R> prologue(
    const float* __restrict__ pos, const float* __restrict__ mass,
    const float* __restrict__ far, const int* __restrict__ far_n,
    const int* __restrict__ near, int* groups, double (*red)[32], int g,
    int gs, size_t npad, int ngs, int gsz, int wg, int K, int L, int tile,
    float tau, float coef2, float3& c) {
  if (threadIdx.x == 0) group_list(groups, g, gs, ngs, wg, K, near);
  c = group_centre(pos, npad, static_cast<size_t>(gs) * gsz, gsz, red);
  Sources<R> src;
  src.pos = pos;
  src.mass = mass;
  src.fg = far + static_cast<size_t>(g) * R * L;
  src.groups = groups;
  src.npad = npad;
  src.gsz = gsz;
  src.nthr = blockDim.x;
  src.tid = threadIdx.x;
  src.n_per = (gsz + src.nthr - 1) / src.nthr;
  src.n_win = groups[0] * src.n_per;     // visible after group_centre
  const int n0 = min(max(far_n[g], 0), L);
  src.n = min((n0 + tile - 1) / tile * tile, L);   // whole tiles
  src.L = L;
  src.tau = tau;
  src.coef2 = coef2;
  return src;
}

template <int R, int T>
__global__ void __launch_bounds__(1024 / T) window_eval_mxu_tile_kernel(
    const float* __restrict__ pos, const float* __restrict__ mass,
    const float* __restrict__ far, const int* __restrict__ far_n,
    const int* __restrict__ near, const int* __restrict__ order,
    float* __restrict__ out, int ng, int g0, int ngs, int gsz, int wg, int K,
    int L, int tile, float soft_sq, float G, float tau, float coef2) {
  extern __shared__ float4 sh4[];
  __shared__ double red[3][32];
  const int nthr = blockDim.x;              // gsz / T
  const int stride = nthr;                  // a multiple of 32
  const int tid = threadIdx.x;
  const int g = order ? order[blockIdx.x] : blockIdx.x;
  const int gs = g + g0;                    // its source group
  const size_t npad = static_cast<size_t>(ngs) * gsz;   // source slots
  float* shm = reinterpret_cast<float*>(sh4 + 2 * stride);
  int* groups = reinterpret_cast<int*>(shm + 2 * stride);

  float3 c;
  Sources<R> src = prologue<R>(pos, mass, far, far_n, near, groups, red, g,
                               gs, npad, ngs, gsz, wg, K, L, tile, tau,
                               coef2, c);
  Centred<T> t;
  t.load(pos, npad, static_cast<size_t>(gs) * gsz + tid, nthr, c.x, c.y,
         c.z);

  auto stage = [&](int b, int p) {
    float m;
    sh4[p * stride + tid] = src.centred(b, c, m);
    shm[p * stride + tid] = m;
  };
  const int nb = src.batches();
  src.fetch(0);
  stage(0, 0);
  __syncthreads();
  for (int b = 0; b < nb; ++b) {
    const bool more = b + 1 < nb;
    if (more) src.fetch(b + 1);
    const int p = (b & 1) * stride;
    t.sum(sh4 + p, shm + p, src.cnt8(b), soft_sq);
    if (more) stage(b + 1, (b + 1) & 1);
    __syncthreads();
  }
  t.store(out, static_cast<size_t>(ng) * gsz,
          static_cast<size_t>(g) * gsz + tid, nthr, G);
}

// cvt.rna.tf32.f32 of a finite x: the nearest TF32, ties away from zero,
// as (bits + 0x1000) & ~0x1FFF -- an integer add and a LOP3.  The PTX
// instruction compiles to more: a test and a select for NaN and infinity
// besides, which w and s_c never are here.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & ~0x1FFFu;
}

// d += a . b, m16n8k8, TF32 inputs, float32 accumulator.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// M m16 tiles of targets a warp (warp w holds tiles w M .. w M + M - 1 of
// the group; tiles past the group compute on clamped targets and store
// nothing).  kThreads bounds the block for the register allocator.  (A
// minimum of resident blocks at groups of 256, for more warps an SM, made
// ptxas spill and ran slower: PERF.md, kernel 3c.)
template <int R, int M, int kThreads>
__global__ void __launch_bounds__(kThreads) window_eval_mxu_mma_kernel(
    const float* __restrict__ pos, const float* __restrict__ mass,
    const float* __restrict__ far, const int* __restrict__ far_n,
    const int* __restrict__ near, const int* __restrict__ order,
    float* __restrict__ out, int ng, int g0, int ngs, int gsz, int wg, int K,
    int L, int tile, float soft_sq, float G, float tau, float coef2) {
  extern __shared__ float4 sh4[];
  __shared__ double red[3][32];
  const int nthr = blockDim.x;
  const int stride = nthr;                  // a multiple of 32
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, q = lane & 3;
  const int g = order ? order[blockIdx.x] : blockIdx.x;
  const int gs = g + g0;                    // its source group
  const size_t npad = static_cast<size_t>(ngs) * gsz;   // source slots
  const size_t npad_out = static_cast<size_t>(ng) * gsz;
  float4* shb = sh4 + 2 * stride;           // B columns, two float4 a source
  float* shm = reinterpret_cast<float*>(shb + 4 * stride);
  int* groups = reinterpret_cast<int*>(shm + 2 * stride);

  float3 c;
  Sources<R> src = prologue<R>(pos, mass, far, far_n, near, groups, red, g,
                               gs, npad, ngs, gsz, wg, K, L, tile, tau,
                               coef2, c);

  // Targets of rows gq + 8 h of tile i: -2 t_c and |t_c|^2.
  float nx[M][2], ny[M][2], nz[M][2], ti[M][2];
  const size_t base = static_cast<size_t>(gs) * gsz;
#pragma unroll
  for (int i = 0; i < M; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const size_t b =
          base + min((warp * M + i) * 16 + gq + 8 * h, gsz - 1);
      mxu_target(pos[b], pos[npad + b], pos[2 * npad + b], c.x, c.y, c.z,
                 nx[i][h], ny[i][h], nz[i][h], ti[i][h]);
    }
  }
  float acc[M][4];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  }

  auto stage = [&](int b, int p) {
    float m;
    const float4 s = src.centred(b, c, m);
    const int k = p * stride + tid;
    sh4[k] = s;
    shm[k] = m;
    const float hx = __uint_as_float(tf32_rna(s.x));
    const float hy = __uint_as_float(tf32_rna(s.y));
    const float hz = __uint_as_float(tf32_rna(s.z));
    shb[2 * k] = make_float4(hx, hy, hz, 1.f);
    shb[2 * k + 1] = make_float4(__fsub_rn(s.x, hx), __fsub_rn(s.y, hy),
                                 __fsub_rn(s.z, hz), 0.f);
  };

  const int nb = src.batches();
  src.fetch(0);
  stage(0, 0);
  __syncthreads();
  for (int b = 0; b < nb; ++b) {
    const bool more = b + 1 < nb;
    if (more) src.fetch(b + 1);
    const int p = (b & 1) * stride;
    const float4* s4 = sh4 + p;
    const float* sm = shm + p;
    const float* sb = reinterpret_cast<const float*>(shb + 2 * p);
    float part[M][4];
#pragma unroll
    for (int i = 0; i < M; ++i) {
      part[i][0] = part[i][1] = part[i][2] = part[i][3] = 0.f;
    }
    const int cnt8 = src.cnt8(b);
    for (int k0 = 0; k0 < cnt8; k0 += 8) {
      // Sources q and q + 4 of the step (A's columns, B's rows).
      float4 s[2];
      float m[2];
      uint32_t bf[2];
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        s[v] = s4[k0 + q + kAColStep * v];
        m[v] = sm[k0 + q + kAColStep * v];
        bf[v] = __float_as_uint(sb[(k0 + q + kBRowStep * v) * 8 + gq]);
      }
#pragma unroll
      for (int i = 0; i < M; ++i) {
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int h = v & 1;              // row gq + 8 h, source v >> 1
          const float w = mxu_weight(
              nx[i][h], ny[i][h], nz[i][h], ti[i][h], s[v >> 1], m[v >> 1],
              soft_sq);
          hi[v] = tf32_rna(w);
          lo[v] = __float_as_uint(__fsub_rn(w, __uint_as_float(hi[v])));
        }
        mma_tf32(part[i], hi, bf);
        mma_tf32(part[i], lo, bf);
      }
    }
#pragma unroll
    for (int i = 0; i < M; ++i) {
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][v] += part[i][v];
    }
    if (more) stage(b + 1, (b + 1) & 1);
    __syncthreads();
  }

  // Columns kBLo.. onto 0..: lanes q < kLoLane take lane q + kLoLane's.
  // Then lane q = 0 holds columns (0, 1) = (x, y) of rows gq and gq + 8,
  // lane q = 1 columns (2, kBOne) = (z, w); they swap halves so that q = 0
  // writes row gq and q = 1 row gq + 8.
  static_assert(kBOne == 3 && kBLo == 4 && kLoLane == 2, "column layout");
  static_assert(kARowStep == 8 && kCRowStep == 8 && kAColStep == kBRowStep,
                "fragment layout");
#pragma unroll
  for (int i = 0; i < M; ++i) {
    float s[4];
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      s[v] = acc[i][v] + __shfl_xor_sync(0xffffffffu, acc[i][v], kLoLane);
    }
    const float send0 = q == 0 ? s[2] : s[0];
    const float send1 = q == 0 ? s[3] : s[1];
    const float r0 = __shfl_xor_sync(0xffffffffu, send0, 1);
    const float r1 = __shfl_xor_sync(0xffffffffu, send1, 1);
    const int row = (warp * M + i) * 16 + gq + 8 * q;    // q < 2
    if (q < 2 && row < gsz) {
      const float wx = q == 0 ? s[0] : r0;
      const float wy = q == 0 ? s[1] : r1;
      const float wz = q == 0 ? r0 : s[2];
      const float ws = q == 0 ? r1 : s[3];
      const size_t b = static_cast<size_t>(g) * gsz + row;
      // Selects, not an index by q: the targets stay in registers.
      out[b] = mxu_accel(wx, q == 0 ? nx[i][0] : nx[i][1], ws, G);
      out[npad_out + b] =
          mxu_accel(wy, q == 0 ? ny[i][0] : ny[i][1], ws, G);
      out[2 * npad_out + b] =
          mxu_accel(wz, q == 0 ? nz[i][0] : nz[i][1], ws, G);
    }
  }
}

// Threads of a block: "fma" gsz / T, "mma" 32 per M m16 tiles of targets.
int threads(int gsz, bool mma, int n) {
  return mma ? 32 * ((gsz + 16 * n - 1) / (16 * n)) : gsz / n;
}

// "fma": T in {1, 2, 4}, gsz / T a multiple of 32; "mma": M in {2, 4},
// gsz a multiple of 16.
bool valid(int gsz, bool mma, int n, int wg, int K) {
  if (gsz < 16 || gsz > 1024 || wg < 0 || K < 0) return false;
  if (mma) return (n == 2 || n == 4) && gsz % 16 == 0;
  return (n == 1 || n == 2 || n == 4) && gsz % n == 0 && (gsz / n) % 32 == 0;
}

// Dispatch on (R, instance); `op` is called with the kernel.
template <int R, typename Op>
cudaError_t with_instance(bool mma, int n, int nthr, Op op) {
  if (!mma) {
    switch (n) {
      case 1: return op(window_eval_mxu_tile_kernel<R, 1>);
      case 2: return op(window_eval_mxu_tile_kernel<R, 2>);
      default: return op(window_eval_mxu_tile_kernel<R, 4>);
    }
  }
  if (n == 2) {
    return nthr <= 256 ? op(window_eval_mxu_mma_kernel<R, 2, 256>)
                       : op(window_eval_mxu_mma_kernel<R, 2, 1024>);
  }
  return nthr <= 256 ? op(window_eval_mxu_mma_kernel<R, 4, 256>)
                     : op(window_eval_mxu_mma_kernel<R, 4, 512>);
}

template <typename Op>
cudaError_t with_r(int R, bool mma, int n, int nthr, Op op) {
  switch (R) {
    case 8: return with_instance<8>(mma, n, nthr, op);
    case 10: return with_instance<10>(mma, n, nthr, op);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int spatialsim_window_eval_mxu(
    const float* pos, const float* mass, const float* far, const int* far_n,
    const int* near, const int* order, float* out, int ng, int g0, int ngs,
    int gsz, int mma, int n, int wg, int K, int R, int L, int tile,
    float soft_sq, float G, float tau, float coef2, void* stream) {
  if (!valid(gsz, mma != 0, n, wg, K) || tile < 1 || L < 1
      || (K > 0 && near == nullptr)
      || !window_tile::valid_range(ng, g0, ngs)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int nthr = threads(gsz, mma != 0, n);
  const size_t smem = smem_bytes(nthr, mma != 0, wg, K);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(with_r(R, mma != 0, n, nthr, [&](auto kernel) {
    const cudaError_t err = window_tile::allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<ng, nthr, smem, s>>>(pos, mass, far, far_n, near, order, out,
                                  ng, g0, ngs, gsz, wg, K, L, tile, soft_sq,
                                  G, tau, coef2);
    return cudaGetLastError();
  }));
}

// Resident blocks per SM, registers a thread and threads of a launch of
// instance (mma, n) at (R, gsz) with window and near sizes (wg, K), into
// out[0..2].
extern "C" int spatialsim_window_eval_mxu_occupancy(int R, int gsz, int mma,
                                                    int n, int wg, int K,
                                                    int* out) {
  if (!valid(gsz, mma != 0, n, wg, K)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int nthr = threads(gsz, mma != 0, n);
  const size_t smem = smem_bytes(nthr, mma != 0, wg, K);
  return static_cast<int>(with_r(R, mma != 0, n, nthr, [&](auto kernel) {
    return window_tile::occupancy(kernel, nthr, smem, out);
  }));
}
