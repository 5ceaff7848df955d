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
// which is what the TPU kernel's far-away edge padding amounts to, and
// needs no padded copy of the state.  Output: (14, npad) f32 rows
// [sep3, align3, coh3, csum3, sep_count, nb_count].
//
// What bounds it on this card: operations.  At the default config (500K
// boids, gsz 256, wg 2 then 1) a step evaluates ~1.02e9 pairs, and the
// whole state is ~18 MB, so bytes do not matter.  At that density (500K
// boids in a 1000^3 box, ~0.26 neighbours per boid at t=0) almost every
// pair fails the predicate: the cost is the distance test, ~10 FP32
// operations and one shared-memory broadcast load per pair; the 30-odd
// operations of a neighbour pair are rare and sit behind a branch.
//
// Design: one block per target group, one thread per target (blockDim ==
// gsz), its position, group id and 14 accumulators in registers.  The
// window's sources are staged through shared memory one group at a time
// (40 bytes a source: [x y z grp] and [vx vy vz cx] as float4, [cy cz]
// as float2, 10 KB at gsz 256) and read by every thread as a broadcast.
// d2 is rounded like the plain version's separate multiplies and adds
// (no FMA contraction), so both take the same pairs.  The MXU identity
// transposes and the (16, npad) row packing of the TPU kernel exist only
// for the TPU and are gone.  No TMA, cp.async or tensor cores yet.

#include <cuda_runtime.h>

namespace {

__global__ void boids_window_kernel(const float* __restrict__ pos,
                                    const float* __restrict__ vel,
                                    const float* __restrict__ col,
                                    const float* __restrict__ grp,
                                    float* __restrict__ out, int npad, int wg,
                                    float perception_sq, float separation_sq,
                                    float prev_wg) {
  extern __shared__ float4 sh[];
  const int gsz = blockDim.x;
  float4* s_pg = sh;                                    // x y z grp
  float4* s_vc = sh + gsz;                              // vx vy vz cx
  float2* s_cc = reinterpret_cast<float2*>(sh + 2 * gsz);  // cy cz

  const int ng = gridDim.x;
  const int g = blockIdx.x;
  const int t = threadIdx.x;
  const int i = g * gsz + t;
  const bool dedup = grp != nullptr;
  const float xi = pos[i], yi = pos[npad + i], zi = pos[2 * npad + i];
  const float gi = dedup ? grp[i] : 0.f;

  float sepx = 0.f, sepy = 0.f, sepz = 0.f;
  float alx = 0.f, aly = 0.f, alz = 0.f;
  float cox = 0.f, coy = 0.f, coz = 0.f;
  float csx = 0.f, csy = 0.f, csz = 0.f;
  float sep_count = 0.f, nb_count = 0.f;

  for (int h = max(g - wg, 0); h <= min(g + wg, ng - 1); ++h) {
    const int j = h * gsz + t;
    __syncthreads();  // the previous group's sources are consumed
    s_pg[t] = make_float4(pos[j], pos[npad + j], pos[2 * npad + j],
                          dedup ? grp[j] : 0.f);
    s_vc[t] = make_float4(vel[j], vel[npad + j], vel[2 * npad + j], col[j]);
    s_cc[t] = make_float2(col[npad + j], col[2 * npad + j]);
    __syncthreads();
    for (int s = 0; s < gsz; ++s) {
      const float4 p = s_pg[s];
      const float dx = xi - p.x;
      const float dy = yi - p.y;
      const float dz = zi - p.z;
      const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx),
                                           __fmul_rn(dy, dy)),
                                 __fmul_rn(dz, dz));
      if (d2 < perception_sq && d2 > 1e-4f &&
          !(dedup && fabsf(gi - p.w) <= prev_wg)) {
        const float4 vc = s_vc[s];
        const float2 cc = s_cc[s];
        if (d2 < separation_sq) {
          const float w = 1.f / fmaxf(d2, 1e-12f);
          sepx += w * dx;
          sepy += w * dy;
          sepz += w * dz;
          sep_count += 1.f;
        }
        alx += vc.x;
        aly += vc.y;
        alz += vc.z;
        cox -= dx;
        coy -= dy;
        coz -= dz;
        csx += vc.w;
        csy += cc.x;
        csz += cc.y;
        nb_count += 1.f;
      }
    }
  }
  const float rows[14] = {sepx, sepy, sepz, alx, aly, alz, cox, coy, coz,
                          csx,  csy,  csz,  sep_count, nb_count};
#pragma unroll
  for (int r = 0; r < 14; ++r) {
    out[static_cast<size_t>(r) * npad + i] = rows[r];
  }
}

}  // namespace

extern "C" int spatialsim_boids_window(const float* pos, const float* vel,
                                       const float* col, const float* grp,
                                       float* out, int npad, int gsz, int wg,
                                       float perception_sq,
                                       float separation_sq, float prev_wg,
                                       void* stream) {
  const int ng = npad / gsz;
  const size_t smem = static_cast<size_t>(gsz) * (2 * sizeof(float4) +
                                                  sizeof(float2));
  boids_window_kernel<<<ng, gsz, smem, static_cast<cudaStream_t>(stream)>>>(
      pos, vel, col, grp, out, npad, wg, perception_sq, separation_sq,
      prev_wg);
  return static_cast<int>(cudaGetLastError());
}
