// Boids Morton-window neighbour accumulation for Hopper (sm_90a).  Both
// window passes of every window-mode boids step.
//
// Replaces: spatialsim_tpu/ops/boids_window_kernel.py, _boids_kernel (the
// Pallas kernel behind boids_window_pallas).  Over the SORTED padded pass
// layout (npad = ng * gsz slots), for each target slot i of group g it
// pairs i with every source slot of groups g-wg .. g+wg and sums
//   * predicate: 1e-4 < d2 < perception^2, d = target - source; in a
//     second pass also |grp_t - grp_s| > prev_wg (pairs inside the
//     previous pass's window were counted there; prev_wg is the previous
//     pass's window_groups, not this pass's);
//   * separation: inside separation^2, d / max(d2, 1e-12), and its count;
//   * sum of source velocities, position offsets p_s - p_t (= -d) and
//     colours, and the count.  The JAX kernel sums positions p_s; the
//     offsets are the same mathematics without the cancellation of
//     sum(p_s) - count * p_t at |p| ~ 500 (ops/boids_ops.py says more).
// Padding slots sit at 1e9 (pass-2 padding groups at -1e9), so they
// never pass the predicate; window groups past either end are skipped,
// which is what the TPU kernel's far-away edge padding amounts to.
// Output: (14, ng * gsz) f32 rows [sep3, align3, coh3, csum3, sep_count,
// nb_count].
//
// Modes (the sharded boids step's halos, which the Pallas kernel does not
// have: "halos are XLA-path only", spatialsim_tpu/ops/boids_ops.py): the
// sources are ngs groups, (3, ngs * gsz), and target group g (of ng) is
// source group g + g0, its window clipped to [0, ngs).  The whole state is
// g0 = 0, ngs = ng; a shard with wg halo groups on each side is g0 = wg,
// ngs = ng + 2 wg (pass 2: its own wg, the dedup still against prev_wg).
// A halo group is a window group like any other: staged, boxed, culled.
//
// What bounds it on this card: instruction issue.  At the default config
// (500K boids, gsz 256, wg 2 then 1) a step has ~1.02e9 window pairs and
// the state is ~18 MB, so bytes do not matter.  At that density (~0.26
// neighbours among a boid's 2,048 candidates at t=0) almost every pair
// fails the predicate: the cost is the distance test, ~10 FP32 operations
// a pair, and the 30-odd operations of a neighbour pair are rare.
//
// Design, to issue fewer instructions a pair and test fewer pairs:
//   * T targets a thread (a template argument; blockDim = 32 * ceil(gsz /
//     32T)).  Warp w holds the 32T consecutive slots w*32T + j*32 + lane
//     (j < T), so a warp's targets are a run of the Morton order.  One
//     broadcast LDS.128 of a staged source [x y z grp] feeds T tests.
//   * The tests of a 32-source chunk set one bit a passing pair in a mask
//     per target (straight-line code: no branch a pair); the neighbour
//     sums then walk each mask's set bits in ascending order.  So each
//     target meets its passing sources in the previous kernel's order,
//     and d2 is rounded as before (__fmul_rn/__fadd_rn, ((x2 + y2) + z2),
//     no FMA): the same pairs pass and every sum is the same, bit for bit.
//   * A warp-uniform box cull (CULL): while a source group is staged, each
//     warp reduces the box of each 32-source chunk it staged by shuffles;
//     each warp holds the box of its own targets.  If the boxes' gap^2,
//     rounded with the same operations as d2 (__fsub_rn per axis, then
//     __fmul_rn and __fadd_rn), is >= perception^2, the warp skips the
//     chunk.  Round-to-nearest is monotonic, so the gap^2 is <= every
//     pair's rounded d2: a skipped pair fails d2 < perception^2 anyway.
//     The decision is the same for every lane: no divergence.  Staged
//     slots past gsz are left out of the boxes (they sit at 1e18 and
//     never pass); padding boids at 1e9 only widen a box.
//   * Pass 2 (DEDUP) keeps the per-pair dedup test.  Ranging the previous
//     pass's group ids per chunk the same way skipped ~1% of pass 2's
//     pairs at 500K and left the test in >99% of the chunks the cull
//     keeps, about what the range tests cost, so it is not done.
//   * Velocities and colours are read only for a passing pair, as before.
// No TMA, cp.async or tensor cores: the work is compares, not products.

#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

#include "window_eval_tile.cuh"

namespace {

constexpr float kFar = 1e18f;  // staged slots past gsz: never a neighbour
constexpr float kInf = INFINITY;

// A chunk's (or a warp's targets') box: lo/hi of x, y, z (w unused).
struct Box {
  float4 lo, hi;
};

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  }
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  }
  return v;
}

// The box of one point a lane (empty lanes pass lo = +inf, hi = -inf).
__device__ __forceinline__ Box warp_box(float4 lo, float4 hi) {
  return Box{make_float4(warp_min(lo.x), warp_min(lo.y), warp_min(lo.z),
                         0.f),
             make_float4(warp_max(hi.x), warp_max(hi.y), warp_max(hi.z),
                         0.f)};
}

// A lower bound of |a - b| over a in [alo, ahi], b in [blo, bhi], rounded
// as the kernel rounds a - b (0 where the ranges overlap).
__device__ __forceinline__ float gap(float alo, float ahi, float blo,
                                     float bhi) {
  return fmaxf(fmaxf(__fsub_rn(blo, ahi), __fsub_rn(alo, bhi)), 0.f);
}

__device__ __forceinline__ float dist_sq(float dx, float dy, float dz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// Accumulators of one target: the 14 output rows.
struct Acc {
  float sepx, sepy, sepz, alx, aly, alz, cox, coy, coz, csx, csy, csz;
  float sep_count, nb_count;
};

template <int T, bool CULL, bool DEDUP>
__global__ void __launch_bounds__(1024 / T) boids_window_kernel(
    const float* __restrict__ pos, const float* __restrict__ vel,
    const float* __restrict__ col, const float* __restrict__ grp,
    float* __restrict__ out, int g0, int ngs, int gsz, int wg,
    float perception_sq, float separation_sq, float prev_wg) {
  extern __shared__ float4 sh[];
  const int nthr = blockDim.x;
  const int slots = nthr * T;  // gsz rounded up to whole warps of T
  const int nchunk = slots / 32;
  float4* s_pg = sh;                                        // x y z grp
  float4* s_vc = sh + slots;                                // vx vy vz cx
  float2* s_cc = reinterpret_cast<float2*>(sh + 2 * slots);  // cy cz
  Box* s_box = reinterpret_cast<Box*>(s_cc + slots);

  const int g = blockIdx.x;
  const int gs = g + g0;  // the target group among the sources
  const size_t nsrc = static_cast<size_t>(ngs) * gsz;  // a source row
  const size_t nout = static_cast<size_t>(gridDim.x) * gsz;  // an out row
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int base = (t >> 5) * 32 * T + lane;  // slot of target j: base + 32j

  float xi[T], yi[T], zi[T], gi[T];
  Acc a[T];
  float4 tlo = make_float4(kInf, kInf, kInf, kInf);
  float4 thi = make_float4(-kInf, -kInf, -kInf, -kInf);
#pragma unroll
  for (int j = 0; j < T; ++j) {
    const int s = base + 32 * j;
    const size_t i = static_cast<size_t>(gs) * gsz + s;
    const bool live = s < gsz;
    xi[j] = live ? pos[i] : kFar;
    yi[j] = live ? pos[nsrc + i] : kFar;
    zi[j] = live ? pos[2 * nsrc + i] : kFar;
    gi[j] = (DEDUP && live) ? grp[i] : 0.f;
    a[j] = Acc{0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f,
               0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (live) {
      tlo = make_float4(fminf(tlo.x, xi[j]), fminf(tlo.y, yi[j]),
                        fminf(tlo.z, zi[j]), 0.f);
      thi = make_float4(fmaxf(thi.x, xi[j]), fmaxf(thi.y, yi[j]),
                        fmaxf(thi.z, zi[j]), 0.f);
    }
  }
  Box tb{};
  if (CULL) tb = warp_box(tlo, thi);

  for (int h = max(gs - wg, 0); h <= min(gs + wg, ngs - 1); ++h) {
    __syncthreads();  // the previous group's sources are consumed
#pragma unroll
    for (int j = 0; j < T; ++j) {
      const int s = j * nthr + t;  // warp w stages chunk j * nthr / 32 + w
      const size_t src = static_cast<size_t>(h) * gsz + s;
      const bool live = s < gsz;
      float4 p = make_float4(kFar, kFar, kFar, 0.f);
      if (live) {
        p = make_float4(pos[src], pos[nsrc + src], pos[2 * nsrc + src],
                        DEDUP ? grp[src] : 0.f);
        s_vc[s] = make_float4(vel[src], vel[nsrc + src], vel[2 * nsrc + src],
                              col[src]);
        s_cc[s] = make_float2(col[nsrc + src], col[2 * nsrc + src]);
      }
      s_pg[s] = p;
      if (CULL) {
        const Box b = warp_box(
            live ? p : make_float4(kInf, kInf, kInf, kInf),
            live ? p : make_float4(-kInf, -kInf, -kInf, -kInf));
        if (lane == 0) s_box[s >> 5] = b;
      }
    }
    __syncthreads();

    for (int c = 0; c < nchunk; ++c) {
      if (CULL) {
        const Box b = s_box[c];
        const float gx = gap(tb.lo.x, tb.hi.x, b.lo.x, b.hi.x);
        const float gy = gap(tb.lo.y, tb.hi.y, b.lo.y, b.hi.y);
        const float gz = gap(tb.lo.z, tb.hi.z, b.lo.z, b.hi.z);
        if (!(dist_sq(gx, gy, gz) < perception_sq)) continue;
      }
      const float4* cs = s_pg + 32 * c;
      uint32_t m[T];
#pragma unroll
      for (int j = 0; j < T; ++j) m[j] = 0u;
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        const float4 p = cs[k];
#pragma unroll
        for (int j = 0; j < T; ++j) {
          const float d2 = dist_sq(xi[j] - p.x, yi[j] - p.y, zi[j] - p.z);
          const bool pass = d2 < perception_sq && d2 > 1e-4f &&
                            !(DEDUP && fabsf(gi[j] - p.w) <= prev_wg);
          m[j] |= pass ? (1u << k) : 0u;
        }
      }
      // The neighbour sums, in ascending source order for each target,
      // with the previous kernel's expressions.
#pragma unroll
      for (int j = 0; j < T; ++j) {
        while (m[j]) {
          const int s = 32 * c + __ffs(m[j]) - 1;
          m[j] &= m[j] - 1u;
          const float4 p = s_pg[s];
          const float dx = xi[j] - p.x;
          const float dy = yi[j] - p.y;
          const float dz = zi[j] - p.z;
          const float d2 = dist_sq(dx, dy, dz);
          const float4 vc = s_vc[s];
          const float2 cc = s_cc[s];
          Acc& q = a[j];
          if (d2 < separation_sq) {
            const float w = 1.f / fmaxf(d2, 1e-12f);
            q.sepx += w * dx;
            q.sepy += w * dy;
            q.sepz += w * dz;
            q.sep_count += 1.f;
          }
          q.alx += vc.x;
          q.aly += vc.y;
          q.alz += vc.z;
          q.cox -= dx;
          q.coy -= dy;
          q.coz -= dz;
          q.csx += vc.w;
          q.csy += cc.x;
          q.csz += cc.y;
          q.nb_count += 1.f;
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < T; ++j) {
    const int s = base + 32 * j;
    if (s >= gsz) continue;
    const size_t i = static_cast<size_t>(g) * gsz + s;
    const Acc& q = a[j];
    const float rows[14] = {q.sepx, q.sepy, q.sepz, q.alx, q.aly, q.alz,
                            q.cox,  q.coy,  q.coz,  q.csx, q.csy, q.csz,
                            q.sep_count, q.nb_count};
#pragma unroll
    for (int r = 0; r < 14; ++r) {
      out[static_cast<size_t>(r) * nout + i] = rows[r];
    }
  }
}

int threads_for(int gsz, int T) {
  return 32 * ((gsz + 32 * T - 1) / (32 * T));
}

size_t smem_for(int gsz, int T) {
  const size_t slots = static_cast<size_t>(threads_for(gsz, T)) * T;
  return slots * (2 * sizeof(float4) + sizeof(float2)) +
         slots / 32 * sizeof(Box);
}

using KernelFn = void (*)(const float*, const float*, const float*,
                          const float*, float*, int, int, int, int, float,
                          float, float);

template <int T>
KernelFn pick(bool cull, bool dedup) {
  if (cull) {
    return dedup ? boids_window_kernel<T, true, true>
                 : boids_window_kernel<T, true, false>;
  }
  return dedup ? boids_window_kernel<T, false, true>
               : boids_window_kernel<T, false, false>;
}

KernelFn kernel_for(int T, bool cull, bool dedup) {
  switch (T) {
    case 1: return pick<1>(cull, dedup);
    case 2: return pick<2>(cull, dedup);
    case 4: return pick<4>(cull, dedup);
    default: return nullptr;
  }
}

}  // namespace

// One window pass over ng target groups, source group g + g0 of ngs for
// target group g: `targets` (T) targets a thread, the box cull on or off
// (`cull`); grp null for a first pass.
extern "C" int spatialsim_boids_window(const float* pos, const float* vel,
                                       const float* col, const float* grp,
                                       float* out, int ng, int g0, int ngs,
                                       int gsz, int wg, float perception_sq,
                                       float separation_sq, float prev_wg,
                                       int targets, int cull, void* stream) {
  const KernelFn kernel = kernel_for(targets, cull != 0, grp != nullptr);
  if (kernel == nullptr || gsz < 1 || gsz > 1024 || wg < 0 ||
      !window_tile::valid_range(ng, g0, ngs)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  kernel<<<ng, threads_for(gsz, targets), smem_for(gsz, targets),
           static_cast<cudaStream_t>(stream)>>>(
      pos, vel, col, grp, out, g0, ngs, gsz, wg, perception_sq,
      separation_sq, prev_wg);
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks per SM, registers a thread and threads a block of one
// instance at group size gsz, into out[0..2].
extern "C" int spatialsim_boids_window_occupancy(int gsz, int targets,
                                                 int cull, int dedup,
                                                 int* out) {
  const KernelFn kernel = kernel_for(targets, cull != 0, dedup != 0);
  if (kernel == nullptr || gsz < 1 || gsz > 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(window_tile::occupancy(
      kernel, threads_for(gsz, targets), smem_for(gsz, targets), out));
}
