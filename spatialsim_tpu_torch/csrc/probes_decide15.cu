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
// past it, and the shuffle and ALU latency of the reduce chains.  5a-5d and
// 5f-5h also have card-wide instances (beside or below the one-warp and
// one-thread ones), which spread the same reads, writes or steps over every
// SM.
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

// ---- Card-wide instances of 5a and 5b -----------------------------------
//
// The one-warp kernels time one dependent stream of reads.  A per-group
// traversal runs one such stream a group (3,907 groups at 1M) on every SM
// at once, so its design needs the rate at which the card serves many
// streams.  The card-wide instances compute the probe's function over the
// same reads, cut so:
//
// * the reps x used reads (used = (n_reads / W) W) form one stream, read t
//   of row idx[t mod used], cut into P contiguous slices: slice p is
//   [floor(p T / P), floor((p + 1) T / P)), T = reps used.  P is the
//   caller's, not the card's, so the output does not depend on the card.
// * warp p walks slice p with the probe's W accumulators (its j-th read
//   into acc[j mod W]).  Each read is still one 512 B row, one coalesced
//   float4 a lane; no row is merged or skipped, as a traversal cannot
//   merge its visits.  CHAINED: each read waits on its accumulator's last
//   add, so the card holds P dependent chains at once, the shape of a
//   traversal with one warp a group.
// * the warp writes acc[0] + acc[1] + ... to its row of a scratch table,
//   and a second pass sums the P rows serially in warp order, a column
//   at a time.
//   No float atomics: two calls give the same bits, and the plain version
//   (ops/traversal_probes.py, row_reads_card_reference) gives them too.
// * SHARED: each block first copies the table into its shared memory by
//   TMA bulk copies (cp.async.bulk, completing on an mbarrier); 448 rows
//   (229,376 B) leave room for one block an SM.
//
// What bounds them: the L2 (or device-memory) requests the SMs keep in
// flight, at most P W reads, and the second pass's P dependent adds.

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Copies n_bytes (a multiple of 16) from src to dst (both 16 B aligned)
// by TMA bulk copies; every thread of the block calls it and returns once
// the bytes have landed.
__device__ void stage_table(float4* dst, const float4* src, unsigned n_bytes,
                            unsigned long long* bar) {
  constexpr unsigned kChunk = 16384;
  const unsigned b = smem_u32(bar);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(b)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 ::"r"(b), "r"(n_bytes) : "memory");
    for (unsigned o = 0; o < n_bytes; o += kChunk) {
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];"
          ::"r"(smem_u32(reinterpret_cast<char*>(dst) + o)),
            "l"(reinterpret_cast<const char*>(src) + o),
            "r"(min(kChunk, n_bytes - o)), "r"(b)
          : "memory");
    }
  }
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(b) : "memory");
  }
}

// Slice p of a stream of `total` reads cut into `slices`: its first read
// and its length.
__device__ __forceinline__ void slice_of(int p, long long total, int slices,
                                         long long* t0, long long* n) {
  *t0 = (long long)p * total / slices;
  *n = (long long)(p + 1) * total / slices - *t0;
}

// 5a, card-wide: one warp a slice; blockDim.x / 32 warps a block, and the
// grid holds exactly `slices` warps.
template <int W, bool CHAINED, bool SHARED>
__global__ void __launch_bounds__(1024) row_reads_card_kernel(
    const float4* __restrict__ tree, const int* __restrict__ idx,
    float4* __restrict__ partial, int n_cells, int used, long long total,
    int slices) {
  extern __shared__ float4 sm_rows[];
  __shared__ unsigned long long bar;
  const float4* tbl = tree;
  if (SHARED) {
    stage_table(sm_rows, tree, static_cast<unsigned>(n_cells) * 512u, &bar);
    tbl = sm_rows;
  }
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  long long t0, n;
  slice_of(p, total, slices, &t0, &n);
  int pos = used ? static_cast<int>(t0 % used) : 0;
  float4 acc[W];
#pragma unroll
  for (int w = 0; w < W; ++w) acc[w] = make_float4(0.f, 0.f, 0.f, 0.f);
  const long long steps = n / W;
  for (long long k = 0; k < steps; ++k) {
#pragma unroll
    for (int w = 0; w < W; ++w) {
      int c = __ldg(idx + pos);
      if (++pos == used) pos = 0;
      if (CHAINED) c += (int)(acc[w].x * 0.0f);
      acc[w] = add4(acc[w], tbl[(size_t)c * 32 + lane]);
    }
  }
  const int rem = static_cast<int>(n - steps * W);  // the slice's tail
#pragma unroll
  for (int w = 0; w < W - 1; ++w) {
    if (w < rem) {
      int c = __ldg(idx + pos);
      if (++pos == used) pos = 0;
      if (CHAINED) c += (int)(acc[w].x * 0.0f);
      acc[w] = add4(acc[w], tbl[(size_t)c * 32 + lane]);
    }
  }
  float4 s = acc[0];
#pragma unroll
  for (int w = 1; w < W; ++w) s = add4(s, acc[w]);
  partial[(size_t)p * 32 + lane] = s;
}

// 5b, card-wide: the stream of reps x n_reads two-row reads, one warp a
// slice, acc = (acc + tree[c]) + tree[c + 1] as the one-warp kernel.
template <bool CHAINED>
__global__ void __launch_bounds__(1024) block_read_card_kernel(
    const float4* __restrict__ tree, const int* __restrict__ idx,
    float4* __restrict__ partial, int n_reads, long long total,
    int slices) {
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  long long t0, n;
  slice_of(p, total, slices, &t0, &n);
  int pos = n_reads ? static_cast<int>(t0 % n_reads) : 0;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (long long k = 0; k < n; ++k) {
    int c = __ldg(idx + pos);
    if (++pos == n_reads) pos = 0;
    if (CHAINED) c += (int)(acc.x * 0.0f);
    const float4 a = tree[(size_t)c * 32 + lane];
    const float4 b = tree[(size_t)(c + 1) * 32 + lane];
    acc = add4(add4(acc, a), b);
  }
  partial[(size_t)p * 32 + lane] = acc;
}

// The second pass of both: out = ((0 + partial[0]) + partial[1]) + ...,
// element by element.  Each of the 128 elements is one serial chain of P
// float adds, so the chains are spread instead: block b takes float4
// column b (32 blocks on 32 SMs); its threads stage kSumChunk rows of the
// column in shared memory, and while the next chunk's loads are in
// flight, one thread in each of four warps adds one element's chain (four
// schedulers, a load and an add a row each, loads kSumBatch rows ahead).
// What bounds it: P dependent adds, ~4 cycles each.
constexpr int kSumChunk = 512;
constexpr int kSumBatch = 16;

// s + rows[0] + rows[S] + rows[2 S] + ... (n terms; S = 4: one element
// of a float4 column), in order; loads run a batch ahead of the adds.
template <int S = 4>
__device__ __forceinline__ float serial_column(float s, const float* rows,
                                               int n) {
  constexpr int B = kSumBatch;
  int i = 0;
  if (n >= B) {
    float a[B], b[B];
#pragma unroll
    for (int k = 0; k < B; ++k) a[k] = rows[S * k];
    i = B;  // a holds rows [i - B, i), not yet added
    for (; i + 2 * B <= n; i += 2 * B) {
#pragma unroll
      for (int k = 0; k < B; ++k) b[k] = rows[S * (i + k)];
#pragma unroll
      for (int k = 0; k < B; ++k) s = __fadd_rn(s, a[k]);
#pragma unroll
      for (int k = 0; k < B; ++k) a[k] = rows[S * (i + B + k)];
#pragma unroll
      for (int k = 0; k < B; ++k) s = __fadd_rn(s, b[k]);
    }
#pragma unroll
    for (int k = 0; k < B; ++k) s = __fadd_rn(s, a[k]);
  }
  for (; i < n; ++i) s = __fadd_rn(s, rows[S * i]);
  return s;
}

__global__ void __launch_bounds__(kSumChunk) sum_partials_kernel(
    const float4* __restrict__ partial, float* __restrict__ out,
    int slices) {
  __shared__ float4 buf[kSumChunk];
  const int t = threadIdx.x, col = blockIdx.x;
  const int elem = t >> 5;  // lane 0 of warps 0-3 sums elements 0-3
  const bool adder = (t & 31) == 0 && elem < 4;
  float4 nxt = t < slices ? partial[(size_t)t * 32 + col]
                          : make_float4(0.f, 0.f, 0.f, 0.f);
  float s = 0.f;
  for (int p0 = 0; p0 < slices; p0 += kSumChunk) {
    __syncthreads();  // the adders are done with the last chunk
    buf[t] = nxt;
    __syncthreads();  // buf holds rows p0 ..
    const int q = p0 + kSumChunk + t;
    if (q < slices) nxt = partial[(size_t)q * 32 + col];  // in flight
    if (adder)
      s = serial_column(s, reinterpret_cast<const float*>(buf) + elem,
                        min(kSumChunk, slices - p0));
  }
  if (adder) out[col * 4 + elem] = s;
}

// The launch floor phase 19 prints beside the card-wide times: a launch
// of `blocks` x `threads` that does nothing.
__global__ void empty_kernel() {}

// 5c. Replaces decide15.py:143 bench_reduce_roundtrip (body :127): the
//     vector-reduce -> scalar -> control-flow round trip.  Per step, BATCH
//     reductions s_b = sum(v * (1 + acc * 1e-20) + b) are issued before
//     any is read, then acc += s_0 + s_1 + ... .  One warp: each reduce is
//     4 values a lane and a shuffle butterfly, after which every lane holds
//     the scalar, so the scalar chain (and any branch on it) is uniform
//     across the warp: the SM's answer to the TPU's vector-to-SMEM trip.
template <int BATCH>
__device__ __forceinline__ float roundtrip_step(float4 v, float acc) {
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
  return __fadd_rn(acc, s);
}

template <int BATCH>
__global__ void __launch_bounds__(32) reduce_roundtrip_kernel(
    const float4* __restrict__ x, float* __restrict__ out, int n_ops,
    int reps) {
  const float4 v = x[threadIdx.x];
  float acc = 0.f;
  for (int r = 0; r < reps; ++r) {
    for (int i = 0; i < n_ops; ++i) acc = roundtrip_step<BATCH>(v, acc);
  }
  if (threadIdx.x == 0) out[0] = acc;
}

// 5c, card-wide.  The reps x n_ops steps form one stream, cut into slices
// by slice_of, one warp a slice (blockDim.x / 32 warps a block, exactly
// `slices` warps).  Each slice runs the probe's chain from acc = 0 over
// its steps, every step reduce_roundtrip_kernel's (f from this step's acc,
// BATCH butterflies, the adds in the same order), and lane 0 writes its
// float32 acc to partial[p]; sum_scalars_kernel adds the partials serially
// in slice order (no float atomics).  One slice is the probe's chain: the
// one-warp kernel's float32 bit for bit.
//
// Nothing leaves a slice's chain: f waits on acc, each product on f, and
// the lane's three adds and the butterfly are the function's order of
// float32 adds, so any other order or a fused multiply-add changes bits.
// The card-wide instance takes no step off the path; it runs P chains at
// once.  What bounds it: each warp's dependent path (18 instructions a
// step at BATCH 1, 5 of them shuffles) times its steps, with 8 warps a
// scheduler interleaved, then the second pass's P dependent adds; at
// BATCH 8 the shuffle throughput (one warp's shuffle a cycle an SM).
//
// ONE_WARP: blocks of one warp (`warps` 1), p = blockIdx.x.  The compiler
// then sees each warp's trip count as uniform and issues the butterflies
// with no divergence check (BRA.DIV) in the loop, as in the one-warp
// kernel; in a block of several warps it cannot, and on an H100 the check
// and the schedule around it cost the chain at one slice 2%, 10% and 18%
// at BATCH 1, 4 and 8.
template <int BATCH, bool ONE_WARP>
__global__ void __launch_bounds__(ONE_WARP ? 32 : 1024)
    reduce_roundtrip_card_kernel(const float4* __restrict__ x,
                                 float* __restrict__ partial,
                                 long long total, int slices) {
  const int p = ONE_WARP ? blockIdx.x
                         : blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const float4 v = x[threadIdx.x & 31];
  long long t0, n;
  slice_of(p, total, slices, &t0, &n);
  float acc = 0.f;
  for (long long k = 0; k < n; ++k) acc = roundtrip_step<BATCH>(v, acc);
  if ((threadIdx.x & 31) == 0) partial[p] = acc;
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

// The 8 floats of cell c & 15 of a 16-cells-a-row table, two 16 B loads,
// summed in the probe's order ((x0 + x1) + ...) + x7.
__device__ __forceinline__ float thread_cell_sum(
    const float4* __restrict__ tree, int c) {
  const size_t o = (size_t)(c >> 4) * 32 + (size_t)(c & 15) * 2;
  const float4 a = tree[o], b = tree[o + 1];
  float s = __fadd_rn(a.x, a.y);
  s = __fadd_rn(__fadd_rn(s, a.z), a.w);
  s = __fadd_rn(__fadd_rn(s, b.x), b.y);
  return __fadd_rn(__fadd_rn(s, b.z), b.w);
}

// The 8 floats of cell c & 15 from a row held as a float4 a lane, summed
// in the probe's order; every lane of the warp returns the sum.
__device__ __forceinline__ float warp_cell_sum(float4 row, int c, int lane) {
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
  return __fadd_rn(__fadd_rn(s, b2), b3);
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
      acc = __fadd_rn(acc, thread_cell_sum(tree, c));
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
      acc = __fadd_rn(acc, warp_cell_sum(row, c, lane));
    }
  }
  if (lane == 0) out[0] = acc;
}

// ---- Card-wide instances of 5d and 5h -----------------------------------
//
// As 5a's and 5b's: the probe's reps x n ops (writes or visits) form one
// stream, op t at idx[t mod n], cut into P contiguous slices by slice_of.
// No op is merged or skipped: a traversal can merge neither its visits nor
// its appends.
//
// * 5h, use_roll = true: one warp a slice, `warps` a block; each visit
//   reads the whole 512 B row and aligns it by shuffles, as the one-warp
//   kernel does (16x the bytes the cell needs).  use_roll = false: one
//   thread a slice, 32 `warps` threads a block (the last block masked);
//   each visit is two 16 B loads, as the one-thread kernel's.  A slice
//   sums its visits serially from 0 in float32, each visit in the probe's
//   order ((x0 + x1) + ...) + x7; its scalar partial goes to partial[p],
//   and sum_scalars_kernel adds the P partials serially in slice order.
//   CHAINED: each visit's row waits on the slice's last add.
// * 5d: one warp a slice; each write is scr[c] = 2 tree[c], one 512 B row
//   read and written, four rows in flight a lane.  Writes to one row from
//   different warps carry the same bits, so the table is the same in any
//   order.  out = scr[0] is read by a second launch, after every write
//   has landed (the one-warp kernel's lanes read back only their own).
//
// No float atomics: two calls give the same bits, and the plain versions
// (ops/traversal_probes.py, extract8_card_reference and
// row_write_card_reference) give them too.  What bounds them: the L2 (or
// device-memory) requests in flight, and for 5h the second pass's P
// dependent adds (~2.3 ns each: ~10 us at P = 4,224).

template <bool CHAINED>
__global__ void __launch_bounds__(1024) extract8_card_warp_kernel(
    const float4* __restrict__ tree, const int* __restrict__ idx,
    float* __restrict__ partial, int n_visits, long long total, int slices) {
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  long long t0, n;
  slice_of(p, total, slices, &t0, &n);
  int pos = n_visits ? static_cast<int>(t0 % n_visits) : 0;
  float acc = 0.f;
  for (long long k = 0; k < n; ++k) {
    int c = __ldg(idx + pos);
    if (++pos == n_visits) pos = 0;
    if (CHAINED) c += (int)(acc * 0.0f);
    const float4 row = tree[(size_t)(c >> 4) * 32 + lane];
    acc = __fadd_rn(acc, warp_cell_sum(row, c, lane));
  }
  if (lane == 0) partial[p] = acc;
}

template <bool CHAINED>
__global__ void __launch_bounds__(1024) extract8_card_thread_kernel(
    const float4* __restrict__ tree, const int* __restrict__ idx,
    float* __restrict__ partial, int n_visits, long long total, int slices) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= slices) return;
  long long t0, n;
  slice_of(p, total, slices, &t0, &n);
  int pos = n_visits ? static_cast<int>(t0 % n_visits) : 0;
  float acc = 0.f;
  for (long long k = 0; k < n; ++k) {
    int c = __ldg(idx + pos);
    if (++pos == n_visits) pos = 0;
    if (CHAINED) c += (int)(acc * 0.0f);
    acc = __fadd_rn(acc, thread_cell_sum(tree, c));
  }
  partial[p] = acc;
}

// The second pass of 5h: out = ((0 + partial[0]) + partial[1]) + ...,
// one serial chain.  One block: its threads stage kScalarChunk partials in
// shared memory, coalesced, and load the next chunk while thread 0 adds
// this one, its loads a batch ahead of its adds (serial_column): the P
// dependent adds, not the loads' latency, set its time.
constexpr int kScalarThreads = 1024;
constexpr int kScalarPer = 4;  // partials a thread stages a chunk
constexpr int kScalarChunk = kScalarThreads * kScalarPer;

__global__ void __launch_bounds__(kScalarThreads) sum_scalars_kernel(
    const float* __restrict__ partial, float* __restrict__ out, int slices) {
  __shared__ float buf[kScalarChunk];
  const int t = threadIdx.x;
  float nxt[kScalarPer];
#pragma unroll
  for (int k = 0; k < kScalarPer; ++k) {
    const int q = k * kScalarThreads + t;
    nxt[k] = q < slices ? partial[q] : 0.f;
  }
  float s = 0.f;
  for (int p0 = 0; p0 < slices; p0 += kScalarChunk) {
    __syncthreads();  // thread 0 is done with the last chunk
#pragma unroll
    for (int k = 0; k < kScalarPer; ++k) buf[k * kScalarThreads + t] = nxt[k];
    __syncthreads();  // buf holds partials p0 ..
#pragma unroll
    for (int k = 0; k < kScalarPer; ++k) {
      const int q = p0 + kScalarChunk + k * kScalarThreads + t;
      if (q < slices) nxt[k] = partial[q];  // in flight
    }
    if (t == 0) s = serial_column<1>(s, buf, min(kScalarChunk, slices - p0));
  }
  if (t == 0) out[0] = s;
}

constexpr int kWriteAhead = 4;  // 5d card-wide: rows in flight a lane

__global__ void __launch_bounds__(1024) row_write_card_kernel(
    const float4* __restrict__ tree, const int* __restrict__ idx,
    float4* __restrict__ scr, int n_ops, long long total, int slices) {
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  long long t0, n;
  slice_of(p, total, slices, &t0, &n);
  int pos = n_ops ? static_cast<int>(t0 % n_ops) : 0;
  long long k = 0;
  for (; k + kWriteAhead <= n; k += kWriteAhead) {
    size_t o[kWriteAhead];
    float4 a[kWriteAhead];
#pragma unroll
    for (int j = 0; j < kWriteAhead; ++j) {
      o[j] = (size_t)__ldg(idx + pos) * 32 + lane;
      if (++pos == n_ops) pos = 0;
    }
#pragma unroll
    for (int j = 0; j < kWriteAhead; ++j) a[j] = tree[o[j]];
#pragma unroll
    for (int j = 0; j < kWriteAhead; ++j)
      scr[o[j]] = make_float4(__fmul_rn(a[j].x, 2.f), __fmul_rn(a[j].y, 2.f),
                              __fmul_rn(a[j].z, 2.f), __fmul_rn(a[j].w, 2.f));
  }
  for (; k < n; ++k) {  // the slice's tail
    const size_t o = (size_t)__ldg(idx + pos) * 32 + lane;
    if (++pos == n_ops) pos = 0;
    const float4 a = tree[o];
    scr[o] = make_float4(__fmul_rn(a.x, 2.f), __fmul_rn(a.y, 2.f),
                         __fmul_rn(a.z, 2.f), __fmul_rn(a.w, 2.f));
  }
}

// 5d's read-back: out = scr[0], launched after every write.
__global__ void __launch_bounds__(32) copy_row_kernel(
    const float4* __restrict__ scr, float4* __restrict__ out) {
  out[threadIdx.x] = scr[threadIdx.x];
}

// ---- Card-wide instances of 5f and 5g -----------------------------------
//
// As 5h's one-hot instance: the reps x n_reads reads form one stream, read
// t at idx[t mod n_reads], cut into P contiguous slices by slice_of, one
// thread a slice, 32 `warps` threads a block (the last block masked).  A
// read is one 4 B load: tree[c, 5] (5f) or tree[c, (7 c) mod 128] (5g).
// A slice sums its reads serially from +0 in float32, in stream order,
// into partial[p]; sum_scalars_kernel adds the P partials in slice order.
// Plain form: the loads do not depend on the sum, so a thread issues its
// next kScalarAhead index loads, then as many table loads, before their
// serial adds: kScalarAhead loads in flight a thread, P times that over the
// card.  The adds stay in order, so the bits do not depend on it.  CHAINED:
// each read's row waits on the slice's last add, one load in flight a
// thread, P over the card.  What bounds them: the loads in flight against
// the L2 (or device-memory) latency, then the second pass's P dependent
// adds.

constexpr int kScalarAhead = 8;  // 1-16 timed alike on an H100

template <bool DYN_LANE>
__device__ __forceinline__ float scalar_at(const float* __restrict__ tree,
                                           int c) {
  return tree[(size_t)c * 128 + (DYN_LANE ? ((c * 7) & 127) : 5)];
}

template <bool DYN_LANE, bool CHAINED>
__global__ void __launch_bounds__(1024) scalar_card_kernel(
    const float* __restrict__ tree, const int* __restrict__ idx,
    float* __restrict__ partial, int n_reads, long long total, int slices) {
  constexpr int U = kScalarAhead;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= slices) return;
  long long t0, n;
  slice_of(p, total, slices, &t0, &n);
  int pos = n_reads ? static_cast<int>(t0 % n_reads) : 0;
  float acc = 0.f;
  long long k = 0;
  if (!CHAINED) {
    for (; k + U <= n; k += U) {
      int c[U];
      float v[U];
#pragma unroll
      for (int j = 0; j < U; ++j) {
        c[j] = __ldg(idx + pos);
        if (++pos == n_reads) pos = 0;
      }
#pragma unroll
      for (int j = 0; j < U; ++j) v[j] = scalar_at<DYN_LANE>(tree, c[j]);
#pragma unroll
      for (int j = 0; j < U; ++j) acc = __fadd_rn(acc, v[j]);
    }
  }
  for (; k < n; ++k) {  // the plain form's tail; every chained read
    int c = __ldg(idx + pos);
    if (++pos == n_reads) pos = 0;
    if (CHAINED) c += (int)(acc * 0.0f);
    acc = __fadd_rn(acc, scalar_at<DYN_LANE>(tree, c));
  }
  partial[p] = acc;
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

template <int W, bool CHAINED>
cudaError_t launch_row_reads_card(const float4* tree, const int* idx,
                                  float4* partial, float4* out, int n_cells,
                                  int used, long long total, int shared,
                                  int slices, int warps, cudaStream_t st) {
  const int blocks = slices / warps, threads = warps * 32;
  if (shared) {
    const int bytes = n_cells * 512;
    auto k = row_reads_card_kernel<W, CHAINED, true>;
    cudaError_t e = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
    k<<<blocks, threads, bytes, st>>>(tree, idx, partial, n_cells, used,
                                      total, slices);
  } else {
    row_reads_card_kernel<W, CHAINED, false><<<blocks, threads, 0, st>>>(
        tree, idx, partial, n_cells, used, total, slices);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  sum_partials_kernel<<<32, kSumChunk, 0, st>>>(
      partial, reinterpret_cast<float*>(out), slices);
  return cudaGetLastError();
}

template <int W>
cudaError_t row_reads_card_w(const float4* tree, const int* idx,
                             float4* partial, float4* out, int n_cells,
                             int used, long long total, int chained,
                             int shared, int slices, int warps,
                             cudaStream_t st) {
  return chained
             ? launch_row_reads_card<W, true>(tree, idx, partial, out,
                                              n_cells, used, total, shared,
                                              slices, warps, st)
             : launch_row_reads_card<W, false>(tree, idx, partial, out,
                                               n_cells, used, total, shared,
                                               slices, warps, st);
}

// The card-wide instances take 1-32 warps a block and a whole number of
// blocks.
bool bad_spread(int slices, int warps) {
  return slices < 1 || warps < 1 || warps > 32 || slices % warps != 0;
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

extern "C" int spatialsim_probe_row_reads_card(
    const void* tree, const int* idx, void* partial, void* out, int n_cells,
    int n_reads, int reps, int width, int chained, int shared, int slices,
    int warps, void* stream) {
  if (bad_spread(slices, warps) || width < 1 || n_reads < 0 || reps < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const float4* t = static_cast<const float4*>(tree);
  float4* pa = static_cast<float4*>(partial);
  float4* o = static_cast<float4*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int used = n_reads / width * width;
  const long long total = (long long)reps * used;
  switch (width) {
#define RC_CASE(W)                                                          \
    case W:                                                                 \
      return row_reads_card_w<W>(t, idx, pa, o, n_cells, used, total,       \
                                 chained, shared, slices, warps, st);
    RC_CASE(1) RC_CASE(2) RC_CASE(4) RC_CASE(8)
#undef RC_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int spatialsim_probe_block_read_card(
    const void* tree, const int* idx, void* partial, void* out, int n_reads,
    int reps, int chained, int slices, int warps, void* stream) {
  if (bad_spread(slices, warps) || n_reads < 0 || reps < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float4* t = static_cast<const float4*>(tree);
  float4* pa = static_cast<float4*>(partial);
  const long long total = (long long)reps * n_reads;
  const int blocks = slices / warps, threads = warps * 32;
  if (chained)
    block_read_card_kernel<true><<<blocks, threads, 0, st>>>(
        t, idx, pa, n_reads, total, slices);
  else
    block_read_card_kernel<false><<<blocks, threads, 0, st>>>(
        t, idx, pa, n_reads, total, slices);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  sum_partials_kernel<<<32, kSumChunk, 0, st>>>(
      pa, static_cast<float*>(out), slices);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int spatialsim_probe_extract8_card(
    const void* tree, const int* idx, float* partial, float* out,
    int n_visits, int reps, int use_roll, int chained, int slices, int warps,
    void* stream) {
  if (bad_spread(slices, warps) || n_visits < 0 || reps < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float4* t = static_cast<const float4*>(tree);
  const long long total = (long long)reps * n_visits;
  const int threads = warps * 32;
  if (use_roll) {  // a warp a slice: exactly `slices` warps
    auto k = chained ? extract8_card_warp_kernel<true>
                     : extract8_card_warp_kernel<false>;
    k<<<slices / warps, threads, 0, st>>>(t, idx, partial, n_visits, total,
                                          slices);
  } else {         // a thread a slice
    auto k = chained ? extract8_card_thread_kernel<true>
                     : extract8_card_thread_kernel<false>;
    k<<<(slices + threads - 1) / threads, threads, 0, st>>>(
        t, idx, partial, n_visits, total, slices);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  sum_scalars_kernel<<<1, kScalarThreads, 0, st>>>(partial, out, slices);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int spatialsim_probe_scalar_load_card(
    const float* tree, const int* idx, float* partial, float* out,
    int n_reads, int reps, int dyn_lane, int chained, int slices, int warps,
    void* stream) {
  if (bad_spread(slices, warps) || n_reads < 0 || reps < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto k = dyn_lane ? (chained ? scalar_card_kernel<true, true>
                               : scalar_card_kernel<true, false>)
                    : (chained ? scalar_card_kernel<false, true>
                               : scalar_card_kernel<false, false>);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = warps * 32;  // a thread a slice
  k<<<(slices + threads - 1) / threads, threads, 0, st>>>(
      tree, idx, partial, n_reads, (long long)reps * n_reads, slices);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  sum_scalars_kernel<<<1, kScalarThreads, 0, st>>>(partial, out, slices);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int spatialsim_probe_row_write_card(
    const void* tree, const int* idx, void* scr, void* out, int n_ops,
    int reps, int slices, int warps, void* stream) {
  if (bad_spread(slices, warps) || n_ops < 0 || reps < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float4* s = static_cast<float4*>(scr);
  row_write_card_kernel<<<slices / warps, warps * 32, 0, st>>>(
      static_cast<const float4*>(tree), idx, s, n_ops,
      (long long)reps * n_ops, slices);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  copy_row_kernel<<<1, 32, 0, st>>>(s, static_cast<float4*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int spatialsim_probe_empty(int blocks, int threads,
                                      void* stream) {
  empty_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
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

extern "C" int spatialsim_probe_reduce_roundtrip_card(
    const void* x, float* partial, float* out, int n_ops, int reps,
    int batch, int slices, int warps, void* stream) {
  if (bad_spread(slices, warps) || n_ops < 0 || reps < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float4* v = static_cast<const float4*>(x);
  const long long total = (long long)reps * n_ops;
  void (*k)(const float4*, float*, long long, int);
  switch (batch) {
#define RTC_CASE(B)                                                        \
    case B:                                                                \
      k = warps == 1 ? reduce_roundtrip_card_kernel<B, true>               \
                     : reduce_roundtrip_card_kernel<B, false>;             \
      break;
    RTC_CASE(1) RTC_CASE(4) RTC_CASE(8)
#undef RTC_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  k<<<slices / warps, warps * 32, 0, st>>>(v, partial, total, slices);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  sum_scalars_kernel<<<1, kScalarThreads, 0, st>>>(partial, out, slices);
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
