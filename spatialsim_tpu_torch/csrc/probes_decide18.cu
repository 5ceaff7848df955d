// The traversal-kernel option probes of scripts/decide18.py for Hopper
// (sm_90a): a child table in on-chip memory read by a dependent scalar
// chain, a gated second reduce, the append row store, and the batched
// iteration core (two-row read, lane alignment, the opening test and the
// decision word).  As in probes_decide15.cu, each kernel computes its TPU
// probe's function, one block on one warp (or one thread) as the TPU ran
// one serial core, so the times are latencies: what bounds them is the
// latency of each chain's dependent step (shared-memory or L1 load,
// shuffle butterfly, ALU), not bytes or operations, which are tiny.
//
// Integer chains wrap in int32 as the TPU's do (added as unsigned), and
// `%` is the floor modulo of jnp (`fmod_floor`), so a negative value
// would take the same residue as on the TPU.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

__device__ __forceinline__ int fmod_floor(int a, int m) {  // m > 0
  const int r = a % m;
  return r < 0 ? r + m : r;
}

__device__ __forceinline__ int fdiv_floor(int a, int m) {  // m > 0
  return (a - fmod_floor(a, m)) / m;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// 6a. Replaces scripts/decide18.py:60 probe_smem_capacity (body :47): an
//     int32 table of n entries in on-chip memory, tbl[997 i mod n] = i for
//     i < 256, then the dependent chain
//       acc += tbl[(idx[i mod 4] + 1009 i + acc mod 7) mod n].
//     SHARED keeps the table in dynamic shared memory (the TPU's SMEM):
//     one block can opt in to at most 227 KB, so the 256 and 512 KB tables
//     of the probe do not fit and the wrapper refuses them before any
//     launch.  Otherwise the table is a device-memory buffer (L1/L2
//     resident at these sizes).  The block zero-fills a shared table (the
//     wrapper allocates the global one with torch.zeros), so every entry
//     the chain reads is defined; one thread then runs the chain.
template <bool SHARED>
__global__ void __launch_bounds__(256) smem_table_kernel(
    const int* __restrict__ idx4, int* __restrict__ gtable,
    int* __restrict__ out, int n, int n_ops, int reps) {
  extern __shared__ int sm_tbl[];
  int* tbl = SHARED ? sm_tbl : gtable;
  if (SHARED) {
    for (int k = threadIdx.x; k < n; k += blockDim.x) tbl[k] = 0;
    __syncthreads();
  }
  if (threadIdx.x != 0) return;
  for (int i = 0; i < 256; ++i) tbl[fmod_floor(i * 997, n)] = i;
  const int i0 = idx4[0], i1 = idx4[1], i2 = idx4[2], i3 = idx4[3];
  int acc = 0;
  for (int r = 0; r < reps; ++r) {
    for (int i = 0; i < n_ops; ++i) {
      const int q = i & 3;
      const int base = q == 0 ? i0 : q == 1 ? i1 : q == 2 ? i2 : i3;
      const int k = fmod_floor(
          wrap_add(wrap_add(base, i * 1009), fmod_floor(acc, 7)), n);
      acc = wrap_add(acc, tbl[k]);
    }
  }
  out[0] = acc;
}

// 6b. Replaces decide18.py:99 probe_gated_reduce (body :82): per step
//       w   = int(sum(v + acc * 1e-20)),
//       hit = (w + i) mod 100 < pct,
//       acc = acc + w + (hit ? int(sum(2 v + acc * 1e-20)) : 0).
//     One warp: each reduce is a shuffle butterfly after which every lane
//     holds the sum, so `hit` is uniform and the gated second reduce is a
//     branch the whole warp takes or skips together (no divergence).
__global__ void __launch_bounds__(32) gated_reduce_kernel(
    const float4* __restrict__ x, int* __restrict__ out, int pct, int n_ops,
    int reps) {
  const float4 v = x[threadIdx.x];
  int acc = 0;
  for (int r = 0; r < reps; ++r) {
    for (int i = 0; i < n_ops; ++i) {
      const float t = __fmul_rn(__int2float_rn(acc), 1e-20f);
      float p = __fadd_rn(v.x, t);
      p = __fadd_rn(p, __fadd_rn(v.y, t));
      p = __fadd_rn(p, __fadd_rn(v.z, t));
      p = __fadd_rn(p, __fadd_rn(v.w, t));
      const int w = __float2int_rz(warp_sum(p));
      int add = 0;
      if (fmod_floor(wrap_add(w, i), 100) < pct) {
        float p2 = __fadd_rn(__fmul_rn(v.x, 2.f), t);
        p2 = __fadd_rn(p2, __fadd_rn(__fmul_rn(v.y, 2.f), t));
        p2 = __fadd_rn(p2, __fadd_rn(__fmul_rn(v.z, 2.f), t));
        p2 = __fadd_rn(p2, __fadd_rn(__fmul_rn(v.w, 2.f), t));
        add = __float2int_rz(warp_sum(p2));
      }
      acc = wrap_add(wrap_add(acc, w), add);
    }
  }
  if (threadIdx.x == 0) out[0] = acc;
}

// 6c. Replaces decide18.py:135 probe_row_store (body :123): the append
//     flush, scr[idx[i]] = iota + i, then out = scr[0].  One warp, a
//     512 B store a step and no read; each lane's stores to one address
//     land in program order, so the last i wins as on the TPU.  The
//     wrapper allocates scr with torch.zeros (row 0 is defined) and
//     returns it beside out.
__global__ void __launch_bounds__(32) row_store_kernel(
    const int* __restrict__ idx, float4* __restrict__ scr,
    float4* __restrict__ out, int n_ops, int reps) {
  const int lane = threadIdx.x;
  const float b = (float)(4 * lane);
  for (int r = 0; r < reps; ++r) {
    for (int i = 0; i < n_ops; ++i) {
      const float fi = (float)i;
      scr[(size_t)__ldg(idx + i) * 32 + lane] =
          make_float4(__fadd_rn(b, fi), __fadd_rn(b + 1.f, fi),
                      __fadd_rn(b + 2.f, fi), __fadd_rn(b + 3.f, fi));
    }
  }
  out[lane] = scr[lane];  // each lane reads back only what it wrote
}

// 6d. Replaces decide18.py:198 probe_iteration_shapes (body :162): the
//     traversal iteration core, K runs a step.  Run q of step i:
//       s     = idx[i K + q] + (acc mod 3)
//       row   = (s div 16) mod (n_cells - 2),  base8 = (s mod 16) * 8
//       al[j] = the 256 values of rows row, row + 1 from base8 + j
//               (the TPU's two rolls by 128 - base8 and a lane select)
//       bsv, bev, cxv = al shifted by 2, 3, 4 lanes
//       em    = bev > bsv  &  bsv > 100  &
//               (al < 0.64 (gx^2 + 1) | bev - bsv <= 1),
//               gx = max(1 - cxv, cxv - 2)
//       word  = sum over cells c < 8 of em[8 c] * 4^c
//     and then acc += word_q mod 5 for each q.  One warp a chain: the K
//     runs' two-row float4 loads are issued together (they depend only on
//     acc mod 3), the alignment is a shuffle by base8 / 4 lanes from each
//     row and a select, the 2/3/4-lane shifts take the next lane's values
//     by one more shuffle, and the decision word is a __ballot_sync of the
//     even lanes 0-14 (lane 2c holds element 8c) masked with 0x5555: bit
//     2c is 4^c, the TPU's weighted f32 sum bit for bit.  The opening test
//     rounds each product and sum separately (no FMA), as the plain
//     version's tensor ops do.  Only element 8c of each cell feeds the
//     word, as in the probe (its weights zero the other lanes), so only
//     that element's decision is computed.
template <int K>
__global__ void __launch_bounds__(32) iteration_core_kernel(
    const float4* __restrict__ tree, const int* __restrict__ idx,
    int* __restrict__ out, int n_cells, int n_iters, int reps) {
  const int lane = threadIdx.x;
  const bool weighted = ((lane & 1) == 0) && lane < 16;
  int acc = 0;
  for (int r = 0; r < reps; ++r) {
    for (int i = 0; i < n_iters; ++i) {
      const int a3 = fmod_floor(acc, 3);
      float4 b0[K], b1[K];
      int d[K];
#pragma unroll
      for (int q = 0; q < K; ++q) {
        const int s = wrap_add(__ldg(idx + i * K + q), a3);
        const int row = fmod_floor(fdiv_floor(s, 16), n_cells - 2);
        d[q] = fmod_floor(s, 16) * 2;  // base8 / 4 lanes
        b0[q] = tree[(size_t)row * 32 + lane];
        b1[q] = tree[(size_t)(row + 1) * 32 + lane];
      }
      int add = 0;
#pragma unroll
      for (int q = 0; q < K; ++q) {
        const int src = lane + d[q];
        const bool first = src < 32;
        const float x0 = __shfl_sync(kFull, b0[q].x, src & 31);
        const float x1 = __shfl_sync(kFull, b1[q].x, src & 31);
        const float z0 = __shfl_sync(kFull, b0[q].z, src & 31);
        const float z1 = __shfl_sync(kFull, b1[q].z, src & 31);
        const float w0 = __shfl_sync(kFull, b0[q].w, src & 31);
        const float w1 = __shfl_sync(kFull, b1[q].w, src & 31);
        const float al = first ? x0 : x1;     // element 4 lane
        const float bsv = first ? z0 : z1;    // element 4 lane + 2
        const float bev = first ? w0 : w1;    // element 4 lane + 3
        const float cxv = __shfl_sync(kFull, al, (lane + 1) & 31);  // + 4
        const float gx = fmaxf(__fsub_rn(1.0f, cxv), __fsub_rn(cxv, 2.0f));
        const float dmin = __fadd_rn(__fmul_rn(gx, gx), 1.0f);
        const bool accept = (al < __fmul_rn(0.64f, dmin)) ||
                            (__fsub_rn(bev, bsv) <= 1.0f);
        const bool em = (bev > bsv) && accept && (bsv > 100.0f);
        const unsigned word = __ballot_sync(kFull, weighted && em) & 0x5555u;
        add = wrap_add(add, static_cast<int>(word % 5u));
      }
      acc = wrap_add(acc, add);
    }
  }
  if (lane == 0) out[0] = acc;
}

}  // namespace

extern "C" int spatialsim_probe_smem_table(const int* idx4, int* gtable,
                                           int* out, int n, int n_ops,
                                           int reps, int shared,
                                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (shared) {
    const int bytes = n * 4;
    cudaError_t e = cudaFuncSetAttribute(
        smem_table_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_table_kernel<true><<<1, 256, bytes, st>>>(idx4, gtable, out, n,
                                                    n_ops, reps);
  } else {
    smem_table_kernel<false><<<1, 32, 0, st>>>(idx4, gtable, out, n, n_ops,
                                                reps);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int spatialsim_probe_gated_reduce(const void* x, int* out, int pct,
                                             int n_ops, int reps,
                                             void* stream) {
  gated_reduce_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), out, pct, n_ops, reps);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int spatialsim_probe_row_store(const int* idx, void* scr,
                                          void* out, int n_ops, int reps,
                                          void* stream) {
  row_store_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      idx, static_cast<float4*>(scr), static_cast<float4*>(out), n_ops, reps);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int spatialsim_probe_iteration_core(const void* tree,
                                               const int* idx, int* out,
                                               int n_cells, int k_runs,
                                               int n_iters, int reps,
                                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float4* t = static_cast<const float4*>(tree);
  switch (k_runs) {
#define IC_CASE(K)                                                         \
    case K:                                                                \
      iteration_core_kernel<K><<<1, 32, 0, st>>>(t, idx, out, n_cells,     \
                                                 n_iters, reps);           \
      break;
    IC_CASE(1) IC_CASE(2) IC_CASE(4)  // decide18's runs a step
#undef IC_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
