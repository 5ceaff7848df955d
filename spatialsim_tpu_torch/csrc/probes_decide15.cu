// The traversal-primitive probes of scripts/decide15.py for Hopper
// (sm_90a): random row reads, two-row block reads, the reduce round trip,
// the append write, a run-time lane rotate, scalar loads and the 8-value
// cell extraction.  Each kernel computes its TPU probe's FUNCTION (the
// same output for the same inputs, ops/traversal_probes.py holds both to
// it), not the TPU's mechanics.
//
// The TPU probes run on one core walking serially (grid=(1,)), so every
// kernel here is one block: one warp where the TPU worked on a (1, 128)
// vector row, one thread where it worked on scalars.  Their times are
// latencies, not throughputs: a single warp runs on one of the card's 132
// SMs, on one of its four schedulers, and every byte count is tiny, so
// each kernel sits orders of magnitude above its bytes-or-operations
// bound by design.  What bounds them on this card is the dependent-access
// latency: L1/L2 hit latency for reads of a table that stays resident in
// the 50 MB L2 (the TPU's 4 and 12 MB VMEM tables), device-memory latency
// past it, and the shuffle and ALU latency of the reduce chains.
//
// Layout: a table row is 128 float32 = 512 B = 32 lanes x float4, one
// coalesced request a warp.  Lane l holds elements 4l .. 4l+3.
//
// "Chained" forms: the TPU probe's row addresses come from idx, known in
// advance, so on an SM the reads pipeline, where the TPU serialised them.
// A traversal's next cell depends on the row it just read, so each read
// kernel has a chained form whose index is idx[i] + z with
// z = (int)(acc * 0.0f): 0 at run time (acc is finite), but the compiler
// cannot prove it without fast-math, so each read waits on the last add.
// The output is unchanged.
//
// Float sums keep the TPU probe's order (serial f32 chains per lane);
// sums across lanes that the TPU took with jnp.sum run as a butterfly of
// __shfl_xor_sync here, which is exact wherever the probe's partial sums
// are integers below 2^24 (all of them at the probes' inputs).

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float comp(float4 v, int c) {  // v[c], c in 0..3
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// 5a. Replaces scripts/decide15.py:64 bench_row_reads (body :48):
//     out = sum over reps, i of tree[idx[i*W + w]] into W accumulators,
//     then acc[0] + acc[1] + ... .  One warp; W independent chains, so W
//     reads are in flight when the chains are not chained.  SHARED copies
//     the table into dynamic shared memory first (at most 227 KB: 448
//     rows), the placement the TPU's VMEM had; otherwise rows come from
//     device memory through L1/L2.
template <int W, bool CHAINED, bool SHARED>
__global__ void __launch_bounds__(32) row_reads_kernel(
    const float4* __restrict__ tree, const int* __restrict__ idx,
    float4* __restrict__ out, int n_cells, int n_reads, int reps) {
  extern __shared__ float4 sm_rows[];
  const int lane = threadIdx.x;
  const float4* tbl = tree;
  if (SHARED) {
    for (int k = lane; k < n_cells * 32; k += 32) sm_rows[k] = tree[k];
    __syncwarp();
    tbl = sm_rows;
  }
  float4 acc[W];
#pragma unroll
  for (int w = 0; w < W; ++w) acc[w] = make_float4(0.f, 0.f, 0.f, 0.f);
  const int steps = n_reads / W;
  for (int r = 0; r < reps; ++r) {
    for (int i = 0; i < steps; ++i) {
#pragma unroll
      for (int w = 0; w < W; ++w) {
        int c = __ldg(idx + i * W + w);
        if (CHAINED) c += (int)(acc[w].x * 0.0f);
        acc[w] = add4(acc[w], tbl[(size_t)c * 32 + lane]);
      }
    }
  }
  float4 s = acc[0];
#pragma unroll
  for (int w = 1; w < W; ++w) s = add4(s, acc[w]);
  out[lane] = s;
}

// 5b. Replaces decide15.py:101 bench_block_read (body :92):
//     acc = (acc + tree[idx[i]]) + tree[idx[i] + 1], one (2, 128) read.
//     One warp: two float4 loads a lane, 1 KB a step.
template <bool CHAINED>
__global__ void __launch_bounds__(32) block_read_kernel(
    const float4* __restrict__ tree, const int* __restrict__ idx,
    float4* __restrict__ out, int n_reads, int reps) {
  const int lane = threadIdx.x;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int r = 0; r < reps; ++r) {
    for (int i = 0; i < n_reads; ++i) {
      int c = __ldg(idx + i);
      if (CHAINED) c += (int)(acc.x * 0.0f);
      const float4 a = tree[(size_t)c * 32 + lane];
      const float4 b = tree[(size_t)(c + 1) * 32 + lane];
      acc = add4(add4(acc, a), b);
    }
  }
  out[lane] = acc;
}

// 5c. Replaces decide15.py:143 bench_reduce_roundtrip (body :127): the
//     vector-reduce -> scalar -> control-flow round trip.  Per step, BATCH
//     reductions s_b = sum(v * (1 + acc * 1e-20) + b) are issued before
//     any is read, then acc += s_0 + s_1 + ... .  One warp: each reduce is
//     4 values a lane and a shuffle butterfly, after which every lane holds
//     the scalar, so the scalar chain (and any branch on it) is uniform
//     across the warp: the SM's answer to the TPU's vector-to-SMEM trip.
template <int BATCH>
__global__ void __launch_bounds__(32) reduce_roundtrip_kernel(
    const float4* __restrict__ x, float* __restrict__ out, int n_ops,
    int reps) {
  const float4 v = x[threadIdx.x];
  float acc = 0.f;
  for (int r = 0; r < reps; ++r) {
    for (int i = 0; i < n_ops; ++i) {
      const float f = __fadd_rn(1.0f, __fmul_rn(acc, 1e-20f));
      float sb[BATCH];
#pragma unroll
      for (int b = 0; b < BATCH; ++b) {
        const float fb = (float)b;
        float p = __fadd_rn(__fmul_rn(v.x, f), fb);
        p = __fadd_rn(p, __fadd_rn(__fmul_rn(v.y, f), fb));
        p = __fadd_rn(p, __fadd_rn(__fmul_rn(v.z, f), fb));
        p = __fadd_rn(p, __fadd_rn(__fmul_rn(v.w, f), fb));
        sb[b] = warp_sum(p);
      }
      float s = sb[0];
#pragma unroll
      for (int b = 1; b < BATCH; ++b) s = __fadd_rn(s, sb[b]);
      acc = __fadd_rn(acc, s);
    }
  }
  if (threadIdx.x == 0) out[0] = acc;
}

// 5d. Replaces decide15.py:177 bench_row_write (body :166): the append
//     pattern, scr[idx[i]] = 2 * tree[idx[i]], then out = scr[0].  One
//     warp: a 512 B read and a 512 B write a step.  The wrapper allocates
//     scr with torch.zeros, so row 0 is defined even where no idx is 0,
//     and returns scr, which holds every write, beside out.
__global__ void __launch_bounds__(32) row_write_kernel(
    const float4* __restrict__ tree, const int* __restrict__ idx,
    float4* __restrict__ scr, float4* __restrict__ out, int n_ops,
    int reps) {
  const int lane = threadIdx.x;
  for (int r = 0; r < reps; ++r) {
    for (int i = 0; i < n_ops; ++i) {
      const size_t o = (size_t)__ldg(idx + i) * 32 + lane;
      const float4 a = tree[o];
      scr[o] = make_float4(__fmul_rn(a.x, 2.f), __fmul_rn(a.y, 2.f),
                           __fmul_rn(a.z, 2.f), __fmul_rn(a.w, 2.f));
    }
  }
  out[lane] = scr[lane];  // each lane reads back only what it wrote
}

// 5e. Replaces decide15.py:206 bench_roll (body :201): out[j] =
//     x[(j - shift) mod 128], jnp.roll / torch.roll along the row, with
//     the shift known only at run time.  One warp: output element 4l + k
//     comes from source element 4l + k - shift, i.e. component
//     c_k = (k - shift) mod 4 of lane l + floor((k - shift) / 4): each lane
//     selects c_k in registers, then one shuffle per k moves it.
__global__ void __launch_bounds__(32) roll_kernel(
    const float4* __restrict__ x, int shift, float4* __restrict__ out) {
  const int lane = threadIdx.x;
  const float4 v = x[lane];
  const int s = ((shift % 128) + 128) % 128;
  float o[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int t = k - s + 128;  // > 0
    const int c = t & 3;
    const int dl = (t >> 2);    // lane offset, mod 32
    o[k] = __shfl_sync(kFull, comp(v, c), (lane + dl) & 31);
  }
  out[lane] = make_float4(o[0], o[1], o[2], o[3]);
}

// 5f. Replaces decide15.py:239 probe_scalar_load_dynsub (body :232):
//     acc += tree[idx[i], 5].  One thread, a serial chain of 4 B loads;
//     on Hopper a load at a run-time row and a fixed column is a plain
//     load (the TPU's static-lane constraint has no counterpart).
template <bool CHAINED>
__global__ void __launch_bounds__(32) scalar_dynsub_kernel(
    const float* __restrict__ tree, const int* __restrict__ idx,
    float* __restrict__ out, int n_reads, int reps) {
  float acc = 0.f;
  for (int r = 0; r < reps; ++r) {
    for (int i = 0; i < n_reads; ++i) {
      int c = __ldg(idx + i);
      if (CHAINED) c += (int)(acc * 0.0f);
      acc = __fadd_rn(acc, tree[(size_t)c * 128 + 5]);
    }
  }
  out[0] = acc;
}

// 5g. Replaces decide15.py:272 probe_scalar_load_dyn_dyn_retry (body
//     :264): acc += tree[c, (7 c) mod 128], c = idx[i].  Run-time row AND
//     column: also a plain load here (the TPU's dynamic-lane scalar load
//     crashed its compiler; nothing of that carries over).
template <bool CHAINED>
__global__ void __launch_bounds__(32) scalar_dyndyn_kernel(
    const float* __restrict__ tree, const int* __restrict__ idx,
    float* __restrict__ out, int n_reads, int reps) {
  float acc = 0.f;
  for (int r = 0; r < reps; ++r) {
    for (int i = 0; i < n_reads; ++i) {
      int c = __ldg(idx + i);
      if (CHAINED) c += (int)(acc * 0.0f);
      acc = __fadd_rn(acc, tree[(size_t)c * 128 + ((c * 7) & 127)]);
    }
  }
  out[0] = acc;
}

// 5h. Replaces decide15.py:325 bench_extract8 (body :301), both variants:
//     a 16-cells-a-row packed table, visit c reads the 8 floats of cell
//     c mod 16 in row c / 16 and acc += ((x0 + x1) + ...) + x7, the
//     probe's order.
//     * use_roll = false: one thread reads the cell's 8 floats as two 16 B
//       loads -- what Hopper has in place of the TPU's one-hot masks.
//     * use_roll = true: the warp reads the whole row, a run-time shuffle
//       by base/4 lanes aligns the cell to lanes 0-1 (the TPU's roll,
//       translated), and lane 1's four values are shuffled to every lane,
//       which sums the 8 in the probe's order: the same bits as the
//       one-thread form.
template <bool CHAINED>
__global__ void __launch_bounds__(32) extract8_thread_kernel(
    const float4* __restrict__ tree, const int* __restrict__ idx,
    float* __restrict__ out, int n_visits, int reps) {
  float acc = 0.f;
  for (int r = 0; r < reps; ++r) {
    for (int i = 0; i < n_visits; ++i) {
      int c = __ldg(idx + i);
      if (CHAINED) c += (int)(acc * 0.0f);
      const size_t o = (size_t)(c >> 4) * 32 + (size_t)(c & 15) * 2;
      const float4 a = tree[o], b = tree[o + 1];
      float s = __fadd_rn(a.x, a.y);
      s = __fadd_rn(__fadd_rn(s, a.z), a.w);
      s = __fadd_rn(__fadd_rn(s, b.x), b.y);
      s = __fadd_rn(__fadd_rn(s, b.z), b.w);
      acc = __fadd_rn(acc, s);
    }
  }
  out[0] = acc;
}

template <bool CHAINED>
__global__ void __launch_bounds__(32) extract8_warp_kernel(
    const float4* __restrict__ tree, const int* __restrict__ idx,
    float* __restrict__ out, int n_visits, int reps) {
  const int lane = threadIdx.x;
  float acc = 0.f;
  for (int r = 0; r < reps; ++r) {
    for (int i = 0; i < n_visits; ++i) {
      int c = __ldg(idx + i);
      if (CHAINED) c += (int)(acc * 0.0f);
      const float4 row = tree[(size_t)(c >> 4) * 32 + lane];
      const int d = (c & 15) * 2;  // the cell's first lane
      float4 al;                   // the roll by -base: lane l <- l + d
      al.x = __shfl_sync(kFull, row.x, (lane + d) & 31);
      al.y = __shfl_sync(kFull, row.y, (lane + d) & 31);
      al.z = __shfl_sync(kFull, row.z, (lane + d) & 31);
      al.w = __shfl_sync(kFull, row.w, (lane + d) & 31);
      const float a0 = __shfl_sync(kFull, al.x, 0);
      const float a1 = __shfl_sync(kFull, al.y, 0);
      const float a2 = __shfl_sync(kFull, al.z, 0);
      const float a3 = __shfl_sync(kFull, al.w, 0);
      const float b0 = __shfl_sync(kFull, al.x, 1);
      const float b1 = __shfl_sync(kFull, al.y, 1);
      const float b2 = __shfl_sync(kFull, al.z, 1);
      const float b3 = __shfl_sync(kFull, al.w, 1);
      float s = __fadd_rn(a0, a1);
      s = __fadd_rn(__fadd_rn(s, a2), a3);
      s = __fadd_rn(__fadd_rn(s, b0), b1);
      s = __fadd_rn(__fadd_rn(s, b2), b3);
      acc = __fadd_rn(acc, s);
    }
  }
  if (lane == 0) out[0] = acc;
}

template <int W, bool CHAINED>
cudaError_t launch_row_reads(const float4* tree, const int* idx, float4* out,
                             int n_cells, int n_reads, int reps, int shared,
                             cudaStream_t st) {
  if (shared) {
    const int bytes = n_cells * 512;
    auto k = row_reads_kernel<W, CHAINED, true>;
    cudaError_t e = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
    k<<<1, 32, bytes, st>>>(tree, idx, out, n_cells, n_reads, reps);
  } else {
    row_reads_kernel<W, CHAINED, false><<<1, 32, 0, st>>>(
        tree, idx, out, n_cells, n_reads, reps);
  }
  return cudaGetLastError();
}

template <int W>
cudaError_t row_reads_w(const float4* tree, const int* idx, float4* out,
                        int n_cells, int n_reads, int reps, int chained,
                        int shared, cudaStream_t st) {
  return chained ? launch_row_reads<W, true>(tree, idx, out, n_cells,
                                             n_reads, reps, shared, st)
                 : launch_row_reads<W, false>(tree, idx, out, n_cells,
                                              n_reads, reps, shared, st);
}

}  // namespace

extern "C" int spatialsim_probe_row_reads(const void* tree, const int* idx,
                                          void* out, int n_cells, int n_reads,
                                          int reps, int width, int chained,
                                          int shared, void* stream) {
  const float4* t = static_cast<const float4*>(tree);
  float4* o = static_cast<float4*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (width) {
#define RR_CASE(W)                                                        \
    case W:                                                               \
      return row_reads_w<W>(t, idx, o, n_cells, n_reads, reps, chained,   \
                            shared, st);
    RR_CASE(1) RR_CASE(2) RR_CASE(4) RR_CASE(8)  // decide15's widths
#undef RR_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int spatialsim_probe_block_read(const void* tree, const int* idx,
                                           void* out, int n_reads, int reps,
                                           int chained, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float4* t = static_cast<const float4*>(tree);
  float4* o = static_cast<float4*>(out);
  if (chained)
    block_read_kernel<true><<<1, 32, 0, st>>>(t, idx, o, n_reads, reps);
  else
    block_read_kernel<false><<<1, 32, 0, st>>>(t, idx, o, n_reads, reps);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int spatialsim_probe_reduce_roundtrip(const void* x, float* out,
                                                 int n_ops, int reps,
                                                 int batch, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float4* v = static_cast<const float4*>(x);
  switch (batch) {
#define RT_CASE(B)                                                         \
    case B:                                                                \
      reduce_roundtrip_kernel<B><<<1, 32, 0, st>>>(v, out, n_ops, reps);   \
      break;
    RT_CASE(1) RT_CASE(4) RT_CASE(8)  // decide15's batches
#undef RT_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int spatialsim_probe_row_write(const void* tree, const int* idx,
                                          void* scr, void* out, int n_ops,
                                          int reps, void* stream) {
  row_write_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(tree), idx, static_cast<float4*>(scr),
      static_cast<float4*>(out), n_ops, reps);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int spatialsim_probe_roll(const void* x, int shift, void* out,
                                     void* stream) {
  roll_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), shift, static_cast<float4*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int spatialsim_probe_scalar_load(const float* tree, const int* idx,
                                            float* out, int n_reads, int reps,
                                            int dyn_lane, int chained,
                                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto k = dyn_lane ? (chained ? scalar_dyndyn_kernel<true>
                               : scalar_dyndyn_kernel<false>)
                    : (chained ? scalar_dynsub_kernel<true>
                               : scalar_dynsub_kernel<false>);
  k<<<1, 1, 0, st>>>(tree, idx, out, n_reads, reps);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int spatialsim_probe_extract8(const void* tree, const int* idx,
                                         float* out, int n_visits, int reps,
                                         int use_roll, int chained,
                                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float4* t = static_cast<const float4*>(tree);
  auto k = use_roll ? (chained ? extract8_warp_kernel<true>
                               : extract8_warp_kernel<false>)
                    : (chained ? extract8_thread_kernel<true>
                               : extract8_thread_kernel<false>);
  k<<<1, use_roll ? 32 : 1, 0, st>>>(t, idx, out, n_visits, reps);
  return static_cast<int>(cudaGetLastError());
}
