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
//
// 6a-6d also have card-wide instances (below the one-warp ones), as 5a-5h
// in probes_decide15.cu: the probe's stores or steps as one stream cut into
// P slices, one warp a slice (6a one thread a slice).

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

// ---- Card-wide instances of 6a-6d -------------------------------------

// Slice p of a stream of `total` stores or steps cut into `slices`: its
// first element and its length (probes_decide15.cu's slice_of).
__device__ __forceinline__ void slice_of(int p, long long total, int slices,
                                         long long* t0, long long* n) {
  *t0 = (long long)p * total / slices;
  *n = (long long)(p + 1) * total / slices - *t0;
}

// 6c, card-wide.  Pass 1: last[r] = the largest i with idx[i] = r, by
// atomicMax into a table set to -1; a maximum does not depend on the
// order the atomics land in.
__global__ void __launch_bounds__(256) last_writer_kernel(
    const int* __restrict__ idx, int* __restrict__ last, int n_ops) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n_ops) atomicMax(last + idx[i], i);
}

constexpr int kStoreAhead = 4;  // 6c card-wide: rows in flight a lane

// Pass 2: the reps x n_ops stores as one stream, store t to row
// r = idx[t mod n_ops], cut into slices by slice_of, one warp a slice
// (blockDim.x / 32 warps a block, exactly `slices` warps).  Every store
// to r writes the bits its last writer writes, iota + last[r] (its 4 B
// read of last from an n_cells-entry table), so the table is the plain
// version's whatever order the stores land in.  What bounds it: the 512 B
// stores (and their index and last reads), kStoreAhead in flight a lane.
__global__ void __launch_bounds__(1024) row_store_card_kernel(
    const int* __restrict__ idx, const int* __restrict__ last,
    float4* __restrict__ scr, int n_ops, long long total, int slices) {
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const float b = (float)(4 * lane);
  long long t0, n;
  slice_of(p, total, slices, &t0, &n);
  int pos = n_ops ? static_cast<int>(t0 % n_ops) : 0;
  long long k = 0;
  for (; k + kStoreAhead <= n; k += kStoreAhead) {
    int r[kStoreAhead];
    float f[kStoreAhead];
#pragma unroll
    for (int j = 0; j < kStoreAhead; ++j) {
      r[j] = __ldg(idx + pos);
      if (++pos == n_ops) pos = 0;
    }
#pragma unroll
    for (int j = 0; j < kStoreAhead; ++j) f[j] = (float)__ldg(last + r[j]);
#pragma unroll
    for (int j = 0; j < kStoreAhead; ++j)
      scr[(size_t)r[j] * 32 + lane] =
          make_float4(__fadd_rn(b, f[j]), __fadd_rn(b + 1.f, f[j]),
                      __fadd_rn(b + 2.f, f[j]), __fadd_rn(b + 3.f, f[j]));
  }
  for (; k < n; ++k) {  // the slice's tail
    const int r = __ldg(idx + pos);
    if (++pos == n_ops) pos = 0;
    const float f = (float)__ldg(last + r);
    scr[(size_t)r * 32 + lane] =
        make_float4(__fadd_rn(b, f), __fadd_rn(b + 1.f, f),
                    __fadd_rn(b + 2.f, f), __fadd_rn(b + 3.f, f));
  }
}

// 6c's read-back: out = scr[0], launched after every store.
__global__ void __launch_bounds__(32) copy_row_kernel(
    const float4* __restrict__ scr, float4* __restrict__ out) {
  out[threadIdx.x] = scr[threadIdx.x];
}

// 6d, card-wide, with its reads off the chain.  The reps x n_iters steps
// form one stream, step t at i = t mod n_iters, cut into slices by
// slice_of, one warp a slice; each slice runs the probe's chain from
// acc = 0 over its steps, each step exactly as iteration_core_kernel's,
// and sum_ints_kernel adds the slices' results.  One slice is the
// probe's function: a redesign of the one-warp kernel's chain.
//
// A step waits on acc only through a3 = acc mod 3, so run q's start is
// one of s0, s0 + 1, s0 + 2 (s0 = idx[i K + q]) and every row it can read
// is known before acc is: rows (s div 16) mod (n_cells - 2) and the row
// after, for those three s.  The warp loads them kIterAhead steps before
// the chain reaches the step (and the step's indices one step before
// that), with no branch: R0, R1 = r0, r0 + 1; R2 = r0 + 2 where s0 + 2
// crosses a multiple of 16, or R2, R3 = r2, r2 + 1 where r2 wraps at
// n_cells - 2 (or s0 + 2 wraps in int32); the loads not needed repeat R0
// and R1 (the same lines).  Start a reads pair p_a, (R0, R1), (R1, R2) or
// (R2, R3); byte a of a run's meta is d_a | p_a << 5, d_a = (s mod 16) 2.
// The modulo by n_cells - 2 is a multiply by a reciprocal taken once a
// thread.  So acc's path holds no load and no division: a3 (a multiply),
// the byte of a3 (PRMT), the row selects, the six alignment shuffles and
// the seventh for cxv, the opening test, the ballot, % 5 (a multiply) and
// the adds.  Only .x, .z and .w of a row are used.
//
// What bounds it: one warp issues in order, so a step costs its
// instructions (~110 at K = 1) and the stalls of that path, and the loads
// only where kIterAhead steps take less than their latency.  K = 4 holds
// three steps of four runs' four rows: 230 registers (K = 1: 74), so at
// most 8 warps a block (the wrapper refuses more).  The selects are PTX
// selp: written as ?: the compiler made some of them divergent branches.
constexpr int kIterWarps = 8;
constexpr int kIterAhead = 2;  // steps whose rows are loaded ahead

__device__ __forceinline__ float fsel(bool c, float a, float b) {
  float r;
  asm("{\n .reg .pred p;\n setp.ne.u32 p, %3, 0;\n selp.f32 %0, %1, %2, p;\n}"
      : "=f"(r) : "f"(a), "f"(b), "r"(static_cast<unsigned>(c)));
  return r;
}

__device__ __forceinline__ int isel(bool c, int a, int b) {
  int r;
  asm("{\n .reg .pred p;\n setp.ne.u32 p, %3, 0;\n selp.b32 %0, %1, %2, p;\n}"
      : "=r"(r) : "r"(a), "r"(b), "r"(static_cast<unsigned>(c)));
  return r;
}

// Floor modulo by m (1 <= m <= 2^26) of f in [-2^27, 2^27): with B a
// multiple of m >= 2^27, n = f + B lies in [0, 2^29), where
// umulhi(n, floor((2^32 - 1) / m)) is floor(n / m) or one less.
struct ModM {
  unsigned m, inv, bias;
};

__device__ __forceinline__ ModM mod_of(int m) {
  ModM d;
  d.m = static_cast<unsigned>(m);
  d.inv = 0xffffffffu / d.m;
  d.bias = d.m * ((0x8000000u + d.m - 1) / d.m);
  return d;
}

__device__ __forceinline__ int mod_m(int f, ModM d) {
  const unsigned n = static_cast<unsigned>(f) + d.bias;
  const unsigned r = n - __umulhi(n, d.inv) * d.m;
  return static_cast<int>(r >= d.m ? r - d.m : r);
}

// fmod_floor(a, 3) without a branch: 2^32 = 1 mod 3.
__device__ __forceinline__ int mod3(int a) {
  const unsigned u = static_cast<unsigned>(a);
  const int r = static_cast<int>(u - 3u * (__umulhi(u, 0xAAAAAAABu) >> 1));
  return isel(a >= 0, r, isel(r == 0, 2, r - 1));
}

template <int K>
struct IterRows {
  float x[K][4], z[K][4], w[K][4];  // this lane's elements of R0-R3
  unsigned meta[K];                 // byte a: d_a | p_a << 5
};

template <int K>
__device__ __forceinline__ void load_step(const float4* __restrict__ tree,
                                          const int (&s0)[K], ModM mm,
                                          int rwrap, int lane,
                                          IterRows<K>& st) {
  const int m = static_cast<int>(mm.m);
#pragma unroll
  for (int q = 0; q < K; ++q) {
    const int s = s0[q];
    const int s1 = wrap_add(s, 1), s2 = wrap_add(s, 2);
    const int f0 = s >> 4, f1 = s1 >> 4, f2 = s2 >> 4;  // floor(s / 16)
    const int r0 = mod_m(f0, mm);
    const int r2 = isel(f2 == f0, r0,
                        isel(f2 == f0 + 1, isel(r0 + 1 == m, 0, r0 + 1),
                             rwrap));
    const int p2 = isel(r2 == r0, 0, isel(r2 == r0 + 1, 1, 2));
    const int p1 = isel(f1 == f0, 0, p2);
    st.meta[q] = static_cast<unsigned>((s & 15) * 2) |
                 static_cast<unsigned>((s1 & 15) * 2 | p1 << 5) << 8 |
                 static_cast<unsigned>((s2 & 15) * 2 | p2 << 5) << 16;
    const int rc = isel(p2 == 1, r0 + 2, isel(p2 == 2, r2, r0));
    const int re = isel(p2 == 2, r2 + 1, r0 + 1);
    const float4 a = __ldg(tree + (r0 * 32 + lane));
    const float4 b = __ldg(tree + ((r0 + 1) * 32 + lane));
    const float4 c = __ldg(tree + (rc * 32 + lane));
    const float4 e = __ldg(tree + (re * 32 + lane));
    st.x[q][0] = a.x; st.z[q][0] = a.z; st.w[q][0] = a.w;
    st.x[q][1] = b.x; st.z[q][1] = b.z; st.w[q][1] = b.w;
    st.x[q][2] = c.x; st.z[q][2] = c.z; st.w[q][2] = c.w;
    st.x[q][3] = e.x; st.z[q][3] = e.z; st.w[q][3] = e.w;
  }
}

__device__ __forceinline__ float pick_row(int p, const float (&v)[4],
                                          int hi) {  // v[p + hi]
  return fsel(p == 0, v[hi], fsel(p == 1, v[1 + hi], v[2 + hi]));
}

// A step's decision chain once a3 is known; returns the sum of its K
// words mod 5.  __shfl_sync takes the source lane mod 32.
template <int K>
__device__ __forceinline__ int decide_step(int lane, bool weighted, int a3,
                                           const IterRows<K>& cur) {
  int add = 0;
#pragma unroll
  for (int q = 0; q < K; ++q) {
    const unsigned byte = __byte_perm(cur.meta[q], 0, a3);
    const int d = byte & 31, p = (byte >> 5) & 3;
    const int src = lane + d;
    const bool first = src < 32;
    const float x0 = __shfl_sync(kFull, pick_row(p, cur.x[q], 0), src);
    const float x1 = __shfl_sync(kFull, pick_row(p, cur.x[q], 1), src);
    const float z0 = __shfl_sync(kFull, pick_row(p, cur.z[q], 0), src);
    const float z1 = __shfl_sync(kFull, pick_row(p, cur.z[q], 1), src);
    const float w0 = __shfl_sync(kFull, pick_row(p, cur.w[q], 0), src);
    const float w1 = __shfl_sync(kFull, pick_row(p, cur.w[q], 1), src);
    const float al = fsel(first, x0, x1);     // element 4 lane
    const float bsv = fsel(first, z0, z1);    // element 4 lane + 2
    const float bev = fsel(first, w0, w1);    // element 4 lane + 3
    const float cxv = __shfl_sync(kFull, al, lane + 1);  // + 4
    // The terms that do not wait on cxv first, combined without branches.
    const bool live = weighted & (bev > bsv) & (bsv > 100.0f);
    const bool near = __fsub_rn(bev, bsv) <= 1.0f;
    const float gx = fmaxf(__fsub_rn(1.0f, cxv), __fsub_rn(cxv, 2.0f));
    const float dmin = __fadd_rn(__fmul_rn(gx, gx), 1.0f);
    const bool em = live & (near | (al < __fmul_rn(0.64f, dmin)));
    const unsigned word = __ballot_sync(kFull, em) & 0x5555u;
    // word % 5 for word < 2^16: 0x33333334 = (2^32 + 4) / 5.
    add = wrap_add(add, static_cast<int>(
                            word - 5u * __umulhi(word, 0x33333334u)));
  }
  return add;
}

template <int K>
__device__ __forceinline__ void next_starts(const int* __restrict__ idx,
                                            int n_iters, int (&nxt)[K],
                                            int& pos) {
#pragma unroll
  for (int q = 0; q < K; ++q) nxt[q] = __ldg(idx + pos * K + q);
  if (++pos == n_iters) pos = 0;
}

template <int K>
__global__ void __launch_bounds__(kIterWarps * 32) iteration_core_card_kernel(
    const float4* __restrict__ tree, const int* __restrict__ idx,
    int* __restrict__ partial, int n_cells, int n_iters, long long total,
    int slices) {
  constexpr int R = kIterAhead + 1;  // row sets: the step's and those ahead
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const bool weighted = ((lane & 1) == 0) && lane < 16;
  const ModM mm = mod_of(n_cells - 2);
  const int rwrap = mod_m(-(1 << 27), mm);  // the row of a wrapped s + 2
  long long t0, n;
  slice_of(p, total, slices, &t0, &n);
  int acc = 0;
  if (n > 0) {
    // Past the slice's end the loads read steps of the stream (i wraps),
    // unused.
    int pos = static_cast<int>(t0 % n_iters);
    int nxt[K];
    IterRows<K> rows[R];
#pragma unroll
    for (int j = 0; j < kIterAhead; ++j) {
      next_starts<K>(idx, n_iters, nxt, pos);
      load_step<K>(tree, nxt, mm, rwrap, lane, rows[j]);
    }
    next_starts<K>(idx, n_iters, nxt, pos);
    // Step t (ring place j, static once unrolled): load step t + R - 1's
    // rows and step t + R's starts, then step t's chain.
    auto step = [&](int j) {
      load_step<K>(tree, nxt, mm, rwrap, lane, rows[(j + kIterAhead) % R]);
      next_starts<K>(idx, n_iters, nxt, pos);
      acc = wrap_add(acc, decide_step<K>(lane, weighted, mod3(acc),
                                         rows[j]));
    };
    long long k = 0;
    for (; k + R <= n; k += R) {
#pragma unroll
      for (int j = 0; j < R; ++j) step(j);
    }
#pragma unroll
    for (int j = 0; j < R - 1; ++j)
      if (k + j < n) step(j);
  }
  if (lane == 0) partial[p] = acc;
}

// 6a's, 6b's and 6d's second pass: out = the slices' results summed with int32
// wrap.  Addition mod 2^32 does not depend on the order, so the block sums
// them in parallel and gives slice order's bits.
__global__ void __launch_bounds__(1024) sum_ints_kernel(
    const int* __restrict__ partial, int* __restrict__ out, int slices) {
  __shared__ unsigned warp_sums[32];
  unsigned s = 0;
  for (int p = threadIdx.x; p < slices; p += blockDim.x)
    s += static_cast<unsigned>(partial[p]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x >= 32) return;
  s = threadIdx.x < (blockDim.x >> 5) ? warp_sums[threadIdx.x] : 0u;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
  if (threadIdx.x == 0) out[0] = static_cast<int>(s);
}

// 6b, card-wide, with its second reduce off the dependent chain.  The
// reps x n_ops steps form one stream, step t at i = t mod n_ops, cut into
// slices by slice_of, one warp a slice; each slice runs the probe's chain
// from acc = 0 over its steps, and sum_ints_kernel adds the slices' int32
// results.  One slice is the probe's function: a redesign of
// gated_reduce_kernel's chain.
//
// The second reduce, sum(2 v + t), waits on t = acc 1e-20 but not on the
// first reduce's word w, so it is issued beside the first on every step:
// the two butterflies' shuffles interleave, and a hit's path gains only
// the select.  The hit (w + i) mod 100 < pct then takes its word with a
// PTX selp (isel), so the loop holds no branch: the words are uniform
// across the warp, but the compiler cannot know it, and a branch or a
// divergent ?: in the loop cost the iteration core's first design its
// gain (iteration_core_card_kernel).  Each word is
// __float2int_rz of the sum (toward zero, saturating, NaN to 0, as XLA's
// convert), and the gate's floor mod 100 of wrap(w + i) holds for every
// int32 w, saturated words included.  What bounds it: one warp issues in
// order, so the second reduce costs its issue slots and shuffles even
// where no step hits; the path a step is t, the four adds of a lane, the
// butterfly, the conversion, the gate, the select and the adds.  ONE_WARP:
// blocks of one warp, p = blockIdx.x, so the compiler sees each warp's trip
// count as uniform and puts no divergence check (BRA.DIV) in the loop (as
// probes_decide15.cu's reduce_roundtrip_card_kernel): on an H100, 124.6 ns
// a step at one slice against 134.4 with the check.
template <bool ONE_WARP>
__global__ void __launch_bounds__(ONE_WARP ? 32 : 1024)
    gated_reduce_card_kernel(const float4* __restrict__ x,
                             int* __restrict__ partial, int pct, int n_ops,
                             long long total, int slices) {
  const int p = ONE_WARP ? blockIdx.x
                         : blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const float4 v = x[threadIdx.x & 31];
  const float4 v2 = make_float4(__fmul_rn(v.x, 2.f), __fmul_rn(v.y, 2.f),
                                __fmul_rn(v.z, 2.f), __fmul_rn(v.w, 2.f));
  long long t0, n;
  slice_of(p, total, slices, &t0, &n);
  int i = n_ops ? static_cast<int>(t0 % n_ops) : 0;
  int acc = 0;
  for (long long k = 0; k < n; ++k) {
    const float t = __fmul_rn(__int2float_rn(acc), 1e-20f);
    float a = __fadd_rn(v.x, t), b = __fadd_rn(v2.x, t);
    a = __fadd_rn(a, __fadd_rn(v.y, t));
    b = __fadd_rn(b, __fadd_rn(v2.y, t));
    a = __fadd_rn(a, __fadd_rn(v.z, t));
    b = __fadd_rn(b, __fadd_rn(v2.z, t));
    a = __fadd_rn(a, __fadd_rn(v.w, t));
    b = __fadd_rn(b, __fadd_rn(v2.w, t));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float sa = __shfl_xor_sync(kFull, a, o);
      const float sb = __shfl_xor_sync(kFull, b, o);
      a = __fadd_rn(a, sa);
      b = __fadd_rn(b, sb);
    }
    const int w = __float2int_rz(a), w2 = __float2int_rz(b);
    const int add = isel(fmod_floor(wrap_add(w, i), 100) < pct, w2, 0);
    acc = wrap_add(wrap_add(acc, w), add);
    i = isel(i + 1 == n_ops, 0, i + 1);
  }
  if ((threadIdx.x & 31) == 0) partial[p] = acc;
}

// 6a, card-wide, with the modulo by n off the dependent chain.  The reps x
// n_ops steps form one stream, step t at i = t mod n_ops, cut into slices by
// slice_of, one thread a slice (32 `warps` threads a block, the last block
// masked): the chain is a scalar, so a warp a slice would idle 31 lanes.
// Each slice runs the probe's chain from acc = 0 and sum_ints_kernel adds
// the slices' int32 results.  One slice is the probe's function: a redesign
// of smem_table_kernel's chain.  SHARED: each block builds its own table in
// dynamic shared memory, zero-filled, then the 256 writes; else one table in
// device memory, built before the chain by smem_table_fill_kernel.
//
// A step's index (s + acc mod 7) mod n, s = wrap(idx[i mod 4] + 1009 i),
// waits on acc only through r = acc mod 7, in [0, 6].  So b = s mod n is
// formed a step ahead (table_step: a multiply by a reciprocal of n) and
// acc's path holds r (a multiply), an add, one select, one conditional
// subtract as an unsigned min, the load and the add (table_index).  Where
// s + r passes INT32_MAX, the one-thread kernel's int32 add wraps to s + r
// - 2^32, whose residue is (b2 + r) mod n, b2 = (b - 2^32 mod n) mod n: the
// select takes b2 where r > lim = INT32_MAX - s.  b + r < 2n needs n > 6;
// the entry point refuses smaller n.  tests/test_torch_probes.py mirrors
// table_step and table_index in Python ints and holds them to the floor
// modulo over the int32 edges.  The selects are PTX selp (isel), so the
// loop holds no branch but its own.  What bounds it: the path's latency a
// step at one slice; card-wide, the launches, each block's table staging
// and the second pass (~19 steps a slice at P 4,224).

struct ModN {
  unsigned n, inv, c;  // inv = floor((2^32 - 1) / n), c = 2^32 mod n
};

__device__ __forceinline__ ModN mod_n_of(int n) {  // 7 <= n < 2^31
  ModN d;
  d.n = static_cast<unsigned>(n);
  d.inv = 0xffffffffu / d.n;
  d.c = (0xffffffffu - d.inv * d.n + 1u) % d.n;
  return d;
}

// (x - c) mod n for x, c in [0, n): where x < c, x - c wraps past 2^32 - n
// and the min takes x - c + n.
__device__ __forceinline__ unsigned sub_mod(unsigned x, unsigned c,
                                            unsigned n) {
  return min(x - c, x - c + n);
}

struct TableStep {
  unsigned b, b2;  // s mod n; b2 = (b - 2^32 mod n) mod n
  int lim;         // min(INT32_MAX - s, 7): s + r wraps where r > lim
};

// umulhi(u, inv) is floor(u / n) or one less for every u < 2^32, so r lies
// in [0, 2n) and the min takes u mod n; s < 0 is u - 2^32.
__device__ __forceinline__ TableStep table_step(int s, ModN d) {
  const unsigned u = static_cast<unsigned>(s);
  const unsigned r = u - __umulhi(u, d.inv) * d.n;
  const unsigned bu = min(r, r - d.n);
  TableStep t;
  t.b = static_cast<unsigned>(
      isel(s < 0, static_cast<int>(sub_mod(bu, d.c, d.n)),
           static_cast<int>(bu)));
  t.b2 = sub_mod(t.b, d.c, d.n);
  t.lim = static_cast<int>(min(0x7fffffffu - u, 7u));
  return t;
}

// The step's index (s + acc mod 7) mod n from acc, without a branch.
// acc mod 7 (floor) is v + s7: x = acc, or -1 - acc where acc < 0, lies
// below 2^31, where umulhi(x, 0x92492493) >> 2 is floor(x / 7); v is x mod
// 7, or -1 - (x mod 7) where acc < 0, and s7 = 7 there (the floor residue
// of -1 - x is 6 - (x mod 7)).  s7 is known from acc's sign bit, so the
// compare r > lim (as v > lim - s7) and the adds b + s7 + v wait on v
// alone; then a select and one conditional subtract as an unsigned min.
__device__ __forceinline__ int table_index(const TableStep& t, int acc,
                                           unsigned n) {
  const int sg = acc >> 31;
  const unsigned x = static_cast<unsigned>(acc ^ sg);
  const int v =
      static_cast<int>(x - 7u * (__umulhi(x, 0x92492493u) >> 2)) ^ sg;
  const int s7 = sg & 7;
  const unsigned r7 = static_cast<unsigned>(s7), rv = static_cast<unsigned>(v);
  const unsigned k = static_cast<unsigned>(
      isel(v > t.lim - s7, static_cast<int>(t.b2 + r7 + rv),
           static_cast<int>(t.b + r7 + rv)));
  return static_cast<int>(min(k, k - n));
}

// The probe's writes tbl[997 i mod n] = i (i < 256) over a zeroed table,
// by the block's threads in any order: writers i < i' collide where n
// divides 997 (i' - i), that is where n / gcd(n, 997) divides i' - i (997
// is prime), so only the last, i + n / gcd(n, 997) >= 256, writes.
__device__ __forceinline__ void write_table(int* tbl, int n) {
  const int period = n % 997 == 0 ? n / 997 : n;
  for (int i = threadIdx.x; i < 256; i += blockDim.x)
    if (i + period >= 256) tbl[i * 997 % n] = i;
}

__global__ void __launch_bounds__(256) smem_table_fill_kernel(
    int* __restrict__ tbl, int n) {
  write_table(tbl, n);
}

template <bool SHARED>
__global__ void __launch_bounds__(1024) smem_table_card_kernel(
    const int* __restrict__ idx4, const int* __restrict__ gtable,
    int* __restrict__ partial, int n, int n_ops, long long total,
    int slices) {
  extern __shared__ int4 sm_tbl4[];
  __shared__ int s_idx[4];
  int* sm = reinterpret_cast<int*>(sm_tbl4);
  if (SHARED) {
    for (int k = threadIdx.x; k < n / 4; k += blockDim.x)
      sm_tbl4[k] = make_int4(0, 0, 0, 0);
    for (int k = n / 4 * 4 + threadIdx.x; k < n; k += blockDim.x) sm[k] = 0;
    __syncthreads();
    write_table(sm, n);
  }
  if (threadIdx.x < 4) s_idx[threadIdx.x] = idx4[threadIdx.x];
  __syncthreads();
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= slices) return;
  const ModN d = mod_n_of(n);
  long long t0, cnt;
  slice_of(p, total, slices, &t0, &cnt);
  int i = n_ops ? static_cast<int>(t0 % n_ops) : 0;
  auto step_at = [&](int j) {
    return table_step(
        wrap_add(s_idx[j & 3], static_cast<int>(static_cast<unsigned>(j) *
                                                1009u)),
        d);
  };
  TableStep cur = step_at(i);
  int acc = 0;
  for (long long k = 0; k < cnt; ++k) {
    i = isel(i + 1 == n_ops, 0, i + 1);
    const TableStep nxt = step_at(i);  // the next step's, off the path
    const int at = table_index(cur, acc, d.n);
    acc = wrap_add(acc, SHARED ? sm[at] : gtable[at]);
    cur = nxt;
  }
  partial[p] = acc;
}

// The card-wide instances take 1-32 warps a block (6d 1-kIterWarps) and a
// whole number of blocks.
bool bad_spread(int slices, int warps, int most) {
  return slices < 1 || warps < 1 || warps > most || slices % warps != 0;
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

extern "C" int spatialsim_probe_smem_table_card(const int* idx4, int* gtable,
                                                int* partial, int* out, int n,
                                                int n_ops, int reps,
                                                int shared, int slices,
                                                int warps, void* stream) {
  if (bad_spread(slices, warps, 32) || n < 7 || n_ops < 0 || reps < 0 ||
      (shared && n > (1 << 20)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = warps * 32;  // a thread a slice
  const int blocks = (slices + threads - 1) / threads;
  const long long total = (long long)reps * n_ops;
  cudaError_t e;
  if (shared) {
    const int bytes = n * 4;
    e = cudaFuncSetAttribute(smem_table_card_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_table_card_kernel<true><<<blocks, threads, bytes, st>>>(
        idx4, gtable, partial, n, n_ops, total, slices);
  } else {
    e = cudaMemsetAsync(gtable, 0, (size_t)n * 4, st);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_table_fill_kernel<<<1, 256, 0, st>>>(gtable, n);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_table_card_kernel<false><<<blocks, threads, 0, st>>>(
        idx4, gtable, partial, n, n_ops, total, slices);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  sum_ints_kernel<<<1, 1024, 0, st>>>(partial, out, slices);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int spatialsim_probe_gated_reduce(const void* x, int* out, int pct,
                                             int n_ops, int reps,
                                             void* stream) {
  gated_reduce_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), out, pct, n_ops, reps);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int spatialsim_probe_gated_reduce_card(const void* x, int* partial,
                                                  int* out, int pct,
                                                  int n_ops, int reps,
                                                  int slices, int warps,
                                                  void* stream) {
  if (bad_spread(slices, warps, 32) || n_ops < 0 || reps < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto k = warps == 1 ? gated_reduce_card_kernel<true>
                      : gated_reduce_card_kernel<false>;
  k<<<slices / warps, warps * 32, 0, st>>>(static_cast<const float4*>(x),
                                           partial, pct, n_ops,
                                           (long long)reps * n_ops, slices);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  sum_ints_kernel<<<1, 1024, 0, st>>>(partial, out, slices);
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

extern "C" int spatialsim_probe_row_store_card(const int* idx, int* last,
                                               void* scr, void* out,
                                               int n_cells, int n_ops,
                                               int reps, int slices,
                                               int warps, void* stream) {
  if (bad_spread(slices, warps, 32) || n_cells < 1 || n_ops < 0 || reps < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float4* s = static_cast<float4*>(scr);
  cudaError_t e = cudaMemsetAsync(last, 0xff, (size_t)n_cells * 4, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (n_ops > 0 && reps > 0)
    last_writer_kernel<<<(n_ops + 255) / 256, 256, 0, st>>>(idx, last,
                                                             n_ops);
  row_store_card_kernel<<<slices / warps, warps * 32, 0, st>>>(
      idx, last, s, n_ops, (long long)reps * n_ops, slices);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  copy_row_kernel<<<1, 32, 0, st>>>(s, static_cast<float4*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int spatialsim_probe_iteration_core_card(
    const void* tree, const int* idx, int* partial, int* out, int n_cells,
    int k_runs, int n_iters, int reps, int slices, int warps, void* stream) {
  if (bad_spread(slices, warps, kIterWarps) || n_cells < 3 ||
      n_cells > (1 << 26) || n_iters < 0 || reps < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float4* t = static_cast<const float4*>(tree);
  const long long total = (long long)reps * n_iters;
  switch (k_runs) {
#define ICC_CASE(K)                                                          \
    case K:                                                                  \
      iteration_core_card_kernel<K><<<slices / warps, warps * 32, 0, st>>>( \
          t, idx, partial, n_cells, n_iters, total, slices);                 \
      break;
    ICC_CASE(1) ICC_CASE(2) ICC_CASE(4)
#undef ICC_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  sum_ints_kernel<<<1, 1024, 0, st>>>(partial, out, slices);
  return static_cast<int>(cudaGetLastError());
}
