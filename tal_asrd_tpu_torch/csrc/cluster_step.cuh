// The cluster kernel of both fused decoder steps: n_layers ReZero decoder
// layers (decode_step.cuh) for one new token per lane, in one launch, at the
// rounding points of K1 (layer_step.cu, n_layers = 1) or K3 (stacked_step.cu).
//
// What bounds it on an H100: bytes. A 2x layer (D = 512, B = 32, S = 340)
// reads 7.3 MB of bf16 weights, 22 MB of cross K/V and the live self cache,
// and does about 2 operations per weight byte per lane.
//
// Design: thread-block clusters. A cluster of C CTAs of 384 threads (16, a
// non-portable size, or 8) owns G <= 8 consecutive lanes; the plan (G, C,
// clusters) comes from the host (ops/cuda_decode.py::stacked_launch_plan): on
// an H100, which holds 7 clusters of 16, 7 x 16 = 112 CTAs at B = 32. Each
// layer runs in eight phases, split across the C CTAs and separated by
// cluster barriers:
//   P1 QKV   P2 self-attention   P3 self out-proj   P4 cross query
//   P5 cross-attention   P6 cross out-proj   P7 FF1   P8 FF2
// - A weight product splits its OUTPUT columns, in 16-column tiles, across the
//   CTAs; each CTA applies its slice to all G lanes, so a weight is read once
//   per cluster, not once per lane. In bf16 the product is out^T = W^T x^T on
//   the tensor cores (mma.sync m16n8k16: the columns are M, the lanes N,
//   padded to 8); the weights are stored at construction in the order of the
//   A fragment (ops/cuda_decode.py::fragment_order), so a thread's fragment
//   is one coalesced 16-byte load, under w8 16 int8 values that become bf16 in
//   registers (exact for -127..127); the B fragments are read from the f32
//   lane vectors and rounded to bf16 in registers. The f32 storage mode keeps
//   the same split with FMAs on the CUDA cores (TF32 would round its inputs).
//   Warps split the K dimension when a CTA has fewer tiles than warps; the
//   partial sums are added in a fixed order.
// - The attentions split by (lane, head) items, item i on CTA i % C; a CTA
//   with two items runs them at once, half the block each. The CTA of a
//   self-attention item writes the new cache row for its lane and head and
//   then reads it back (a barrier of the item's threads orders the two).
// - Every phase's output (q/k/v, attention outputs, the residual stream, the
//   FF hidden) is pushed into the shared memory of every CTA of the cluster
//   (distributed shared memory); the cluster barrier's release/acquire makes
//   it visible. Two buffers alternate, so no phase writes what another CTA may
//   still read. Nothing between the input and the outputs goes through
//   global memory, and no grid-wide sync exists.
// - attn: each item accumulates p_h / (H * n_layers) over the layers in its
//   own row; at the end the lane's CTA adds the H rows in head order. No
//   float atomics anywhere: two launches on the same inputs give equal bits.
// - Cache hints: weights load with an L2 evict-last policy (a 2x decoder's
//   29.4 MB in bf16 can stay in the 50 MB L2 across tokens); the cross K/V,
//   read once a step, streams with evict-first loads.
// - Registers bound the loads a thread keeps in flight: at 384 threads a CTA
//   has 170 registers a thread and spills none (at 512, 128 registers, the
//   spilled load destinations serialised the loads and the kernel ran slower).
#pragma once

#include <cooperative_groups.h>

#include "decode_step.cuh"

namespace cg = cooperative_groups;

namespace {

// Where a kernel rounds (decode_step.cuh): K3 keeps the queries and the
// probabilities f32 and dequantizes int8 K/V inside the products; K1 rounds
// the scaled query and the probabilities to T, and under kv8 folds the K
// scale into the query and multiplies the V scale onto the PV sum.
enum class Points { K3, K1 };

constexpr int CTA_THREADS = 384;
constexpr int CTA_WARPS = CTA_THREADS / 32;
constexpr int MAX_GROUP = 8;      // the N = 8 of mma.m16n8k16
constexpr int MAX_CLUSTER = 16;

template <typename T>
__host__ __device__ constexpr bool tensor_cores() {
  return std::is_same<T, __nv_bfloat16>::value;
}

// ---- loads ------------------------------------------------------------------
__device__ __forceinline__ uint64_t evict_last_policy() {
  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(pol));
  return pol;
}

__device__ __forceinline__ uint4 ld_weight(const void* p, uint64_t pol) {
  uint4 v;
  asm volatile("ld.global.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p), "l"(pol));
  return v;
}

// STREAM: read once per step (cross K/V), evict-first; otherwise a plain load
// (the self cache, whose new row this CTA has just written).
template <bool STREAM>
__device__ __forceinline__ uint4 ld_row(const void* p) {
  if (STREAM) return __ldcs(reinterpret_cast<const uint4*>(p));
  return *reinterpret_cast<const uint4*>(p);
}

// The two halves of a cluster barrier: arrive releases this thread's writes
// (local and distributed shared memory, global memory); wait returns once
// every thread of the cluster has arrived, and acquires their writes.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// Not volatile: independent products may be reordered around each other.
__device__ __forceinline__ void mma_bf16(float* d, unsigned a0, unsigned a1, unsigned a2,
                                         unsigned a3, unsigned b0, unsigned b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// ---- shared-memory plan (floats), the same on host and device ---------------
struct ClusterDims {
  int G, C, D, F, H, L, S;
};

__host__ __device__ inline int ncols_max(const ClusterDims& k) {
  const int tiles = imax(3 * k.D, k.F) / 16;
  return (tiles + k.C - 1) / k.C * 16;       // columns of the widest product a CTA owns
}

__host__ __device__ inline int items_max(const ClusterDims& k) {
  return (k.G * k.H + k.C - 1) / k.C;        // attention items a CTA owns
}

// Row strides of the lane buffers, in floats: + 8 makes the B-fragment loads
// of a half-warp (4 lanes x 4 threads, 8 bytes each) hit 32 different banks.
__host__ __device__ inline int ldx_of(const ClusterDims& k) { return k.D + 8; }
__host__ __device__ inline int lda_of(const ClusterDims& k) { return imax(3 * k.D, k.F) + 8; }

struct ClusterSmem {
  int ldx, lda;   // row strides of xs and bufb, and of bufa
  float* xs;      // [G, ldx]  residual stream (f32; T-valued between layers)
  float* bufa;    // [G, lda]  qkv, cross query, FF hidden
  float* bufb;    // [G, ldx]  attention outputs
  float* stage;   // [max(G * ncols_max, 2D)]  a phase's output before the push
  float* part;    // partial sums of products and of PV
  float* att;     // [2, max(L, S)]  logits -> probabilities of two items
  float* q;       // [2, D]  the queries of two items (dh used)
  float* red;     // [4 * CTA_WARPS]  group reductions (two groups)
  float* apart;   // [items_max, S]  attn of each item, summed over layers
};

template <typename T, typename TW, typename TKV>
__host__ __device__ inline size_t part_floats(const ClusterDims& k) {
  const int vec = max_vec<T, TW, TKV>();
  const size_t prod = (size_t)8 * imax(CTA_THREADS, ncols_max(k));
  const size_t pv = (size_t)CTA_THREADS * vec;
  return prod > pv ? prod : pv;
}

template <typename T, typename TW, typename TKV>
__host__ __device__ inline size_t smem_floats(const ClusterDims& k, size_t* offs) {
  const size_t sizes[9] = {
      (size_t)k.G * ldx_of(k),
      (size_t)k.G * lda_of(k),
      (size_t)k.G * ldx_of(k),
      (size_t)imax(k.G * ncols_max(k), 2 * k.D),
      part_floats<T, TW, TKV>(k),
      (size_t)2 * imax(k.L, k.S),
      (size_t)2 * k.D,
      (size_t)4 * CTA_WARPS,
      (size_t)items_max(k) * k.S};
  size_t total = 0;
  for (int i = 0; i < 9; ++i) {
    offs[i] = total;
    total += (sizes[i] + 3) / 4 * 4;         // 16-byte aligned sections
  }
  return total;
}

template <typename T, typename TW, typename TKV>
__device__ inline ClusterSmem smem_plan(float* base, const ClusterDims& k) {
  size_t o[9];
  smem_floats<T, TW, TKV>(k, o);
  ClusterSmem m;
  m.ldx = ldx_of(k);
  m.lda = lda_of(k);
  m.xs = base + o[0];
  m.bufa = base + o[1];
  m.bufb = base + o[2];
  m.stage = base + o[3];
  m.part = base + o[4];
  m.att = base + o[5];
  m.q = base + o[6];
  m.red = base + o[7];
  m.apart = base + o[8];
  return m;
}

// ---- thread groups and their reductions (fixed order: deterministic) ---------
// The threads [base, base + n) of the block that work on one attention item,
// with their own named barrier (0, the whole block, when n = CTA_THREADS).
struct Group {
  int tid, n, bar;
  __device__ void sync() const {
    asm volatile("bar.sync %0, %1;\n" ::"r"(bar), "r"(n) : "memory");
  }
};

__device__ inline float group_max(float v, float* red, const Group& gr) {
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  if ((gr.tid & 31) == 0) red[gr.tid >> 5] = v;
  gr.sync();
  float m = red[0];
  for (int w = 1; w < gr.n / 32; ++w) m = fmaxf(m, red[w]);
  return m;
}

__device__ inline float group_sum(float v, float* red, const Group& gr) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if ((gr.tid & 31) == 0) red[CTA_WARPS + (gr.tid >> 5)] = v;
  gr.sync();
  float s = red[CTA_WARPS];
  for (int w = 1; w < gr.n / 32; ++w) s += red[CTA_WARPS + w];
  return s;
}

// ---- the pieces of a phase ------------------------------------------------------
// This CTA's place: rank of C in a cluster owning lanes [b0, b0 + G).
struct CtaCtx {
  int G, C, rank, b0;
};

// Columns [c0, c0 + ncols) of an N-column product, in 16-column tiles: CTA
// `rank` of C owns tiles [rank * nt / C, (rank + 1) * nt / C).
__device__ inline void cta_columns(int N, int rank, int C, int* c0, int* ncols) {
  const int nt = N / 16;
  const int t0 = rank * nt / C, t1 = (rank + 1) * nt / C;
  *c0 = t0 * 16;
  *ncols = (t1 - t0) * 16;
}

constexpr int W_BATCH = 8;        // weight fragments a warp has in flight

// Rows a thread has in flight in an attention pass over rows of type TR (12
// for bf16 spills registers at 384 threads, and the 2x step ran slower).
template <typename TR>
__host__ __device__ constexpr int att_unroll() {
  return Elem<TR>::VEC == 16 ? 6 : 8;
}

// The unit (tile, K slice) of a warp in a tensor-core product of this CTA's
// `nt` tiles: warps split K into `ks` slices when there are fewer tiles than
// warps.
struct MmaSplit {
  int nt, ks, nkp;
  __device__ MmaSplit(int K, int ncols, int kpack) {
    nt = ncols / 16;
    ks = nt > 0 ? imax(1, CTA_WARPS / nt) : 1;
    nkp = K / (16 * kpack);                  // 16-byte loads along K per tile
  }
  __device__ void unit(int u, int* tl, int* kp0, int* kp1) const {
    *tl = u / ks;
    const int sl = u - *tl * ks;
    *kp0 = sl * nkp / ks;
    *kp1 = (sl + 1) * nkp / ks;
  }
};

// Tensor-core product of this CTA's columns for G lanes. The B fragments are
// read from the f32 input rows src[g * lds + k] (g < G, k < K) and rounded to
// bf16 in registers; mma columns G..7 repeat lane G - 1 and are not used.
// Even and odd k-steps go to two accumulators, added at the end. Writes
// part[(slice * ncols + jj) * 8 + n] (n: lane) and returns the number of K
// slices. Ends with a block barrier.
template <typename TW>
__device__ int product_mma(const TW* W, int K, int c0, int ncols, const float* src, int lds,
                           const CtaCtx& c, const ClusterSmem& m) {
  constexpr bool W8 = std::is_same<TW, int8_t>::value;
  constexpr int KPACK = W8 ? 2 : 1;          // k-steps of 16 in one 16-byte load
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const MmaSplit sp(K, ncols, KPACK);
  const int g = lane >> 2, t = lane & 3;
  const float* brow = src + (size_t)min(g, c.G - 1) * lds + 2 * t;   // this thread's lane
  const uint64_t pol = evict_last_policy();
  for (int u = warp; u < sp.nt * sp.ks; u += CTA_WARPS) {
    int tl, kp0, kp1;
    sp.unit(u, &tl, &kp0, &kp1);
    const uint4* wp = reinterpret_cast<const uint4*>(W) +
                      ((size_t)(c0 / 16 + tl) * sp.nkp) * 32 + lane;
    float d[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    for (int kp = kp0; kp < kp1; kp += W_BATCH) {
      uint4 raw[W_BATCH];
#pragma unroll
      for (int r = 0; r < W_BATCH; ++r)
        if (kp + r < kp1) raw[r] = ld_weight(wp + (size_t)(kp + r) * 32, pol);
#pragma unroll
      for (int r = 0; r < W_BATCH; ++r) {
        if (kp + r >= kp1) break;
        unsigned a8[2 * KPACK][2];           // W8: the 16 values as 8 bf16 pairs
        if constexpr (W8) {
          float w[16];
          Elem<int8_t>::unpack(raw[r], w);
#pragma unroll
          for (int e = 0; e < 8; ++e) a8[e / 2][e % 2] = pack_bf16(w[2 * e], w[2 * e + 1]);
        }
#pragma unroll
        for (int h = 0; h < KPACK; ++h) {
          const int kstep = (kp + r) * KPACK + h;
          unsigned a[4];
          if constexpr (W8) {
#pragma unroll
            for (int e = 0; e < 4; ++e) a[e] = a8[2 * h + e / 2][e % 2];
          } else {
            a[0] = raw[r].x; a[1] = raw[r].y; a[2] = raw[r].z; a[3] = raw[r].w;
          }
          const float2 x0 = *reinterpret_cast<const float2*>(brow + kstep * 16);
          const float2 x1 = *reinterpret_cast<const float2*>(brow + kstep * 16 + 8);
          mma_bf16(d[KPACK == 2 ? h : r & 1], a[0], a[1], a[2], a[3], pack_bf16(x0.x, x0.y),
                   pack_bf16(x1.x, x1.y));
        }
      }
    }
    float* pp = m.part + ((size_t)(u % sp.ks) * ncols + tl * 16) * 8;
    pp[g * 8 + 2 * t] = d[0][0] + d[1][0];
    pp[g * 8 + 2 * t + 1] = d[0][1] + d[1][1];
    pp[(g + 8) * 8 + 2 * t] = d[0][2] + d[1][2];
    pp[(g + 8) * 8 + 2 * t + 1] = d[0][3] + d[1][3];
  }
  __syncthreads();
  return sp.ks;
}

// CUDA-core product (f32 storage): the same split, W [K, N] row-major in TW.
template <typename TW>
__device__ int product_fma(const TW* W, int K, int N, int c0, int ncols, const float* src,
                           int lds, const CtaCtx& c, const ClusterSmem& m) {
  const int ks = ncols > 0 ? imax(1, CTA_THREADS / ncols) : 1;
  for (int u = threadIdx.x; u < ncols * ks; u += CTA_THREADS) {
    const int sl = u / ncols, jj = u - sl * ncols;
    const int k0 = sl * K / ks, k1 = (sl + 1) * K / ks;
    float acc[MAX_GROUP];
#pragma unroll
    for (int g = 0; g < MAX_GROUP; ++g) acc[g] = 0.f;
    const TW* wp = W + c0 + jj;
    for (int k = k0; k < k1; ++k) {
      const float w = (float)wp[(size_t)k * N];
#pragma unroll
      for (int g = 0; g < MAX_GROUP; ++g)
        if (g < c.G) acc[g] = fmaf(src[g * lds + k], w, acc[g]);
    }
    float* pp = m.part + ((size_t)sl * ncols + jj) * 8;
#pragma unroll
    for (int g = 0; g < MAX_GROUP; ++g) pp[g] = acc[g];
  }
  __syncthreads();
  return ks;
}

// Copies stage[g * ncols + jj] (g < rows, jj < ncols) into
// dst[g * ldd + c0 + jj] of every CTA of the cluster, 16 bytes at a time, by
// `nthreads` threads.
__device__ inline void push(const float* stage, int rows, int ncols, float* dst, int ldd,
                            int c0, int C, cg::cluster_group& cluster, int tid = threadIdx.x,
                            int nthreads = CTA_THREADS) {
  const int n4 = ncols / 4;
  const int per_rank = rows * n4;
  for (int i = tid; i < C * per_rank; i += nthreads) {
    const int r = i / per_rank, rem = i - r * per_rank;
    const int g = rem / n4, q = rem - g * n4;
    const float4 v = *reinterpret_cast<const float4*>(stage + g * ncols + 4 * q);
    float* remote = cluster.map_shared_rank(dst, r);
    *reinterpret_cast<float4*>(remote + g * ldd + c0 + 4 * q) = v;
  }
}

enum Op { OP_QKV, OP_SO, OP_CQ, OP_CO, OP_F1, OP_F2 };

// One weight product phase: this CTA's columns of (input @ W) * s + b for the
// G lanes, its epilogue `op`, and the push of the result to every CTA. It
// starts by waiting for the cluster barrier the previous phase arrived at
// and ends by arriving at the next. The last layer's FF2 writes x_out
// instead of pushing.
template <typename T, typename TW, typename TKV, int OP>
__device__ void product_phase(const TW* W, int K, int N, const float* bias, const float* scale,
                              float rwv, const float* src, int lds, float* dst, int ldd,
                              const CtaCtx& c, const ClusterSmem& m, const ClusterDims& kd,
                              T* x_out, cg::cluster_group& cluster) {
  constexpr bool W8 = std::is_same<TW, int8_t>::value;
  int c0, ncols;
  cta_columns(N, c.rank, c.C, &c0, &ncols);
  // the first epilogue output's bias and scale, loaded while the product runs
  float b_pre = 0.f, s_pre = 1.f;
  if ((int)threadIdx.x < c.G * ncols) {
    const int j = c0 + (int)threadIdx.x / c.G;
    b_pre = bias[j];
    if (W8) s_pre = scale[j];
  }
  cluster_wait();
  int ns;
  if constexpr (tensor_cores<T>()) {
    ns = product_mma<TW>(W, K, c0, ncols, src, lds, c, m);
  } else {
    ns = product_fma<TW>(W, K, N, c0, ncols, src, lds, c, m);
  }
  for (int i = threadIdx.x; i < c.G * ncols; i += CTA_THREADS) {
    const int jj = i / c.G, g = i - jj * c.G, j = c0 + jj;
    float acc = 0.f;
    for (int s = 0; s < ns; ++s) acc += m.part[((size_t)s * ncols + jj) * 8 + g];
    const bool first = i == (int)threadIdx.x;
    const float y = (W8 ? acc * (first ? s_pre : scale[j]) : acc) + (first ? b_pre : bias[j]);
    float v;
    if (OP == OP_QKV || OP == OP_CQ) v = y;
    else if (OP == OP_F1) v = fmaxf(y, 0.f);
    else if (OP == OP_F2) v = Elem<T>::round(m.xs[g * m.ldx + j] + y * rwv);
    else v = m.xs[g * m.ldx + j] + y * rwv;    // OP_SO, OP_CO
    m.stage[g * ncols + jj] = v;
    if (OP == OP_F2 && x_out != nullptr)
      x_out[(size_t)(c.b0 + g) * kd.D + j] = Elem<T>::from_f(v);
  }
  __syncthreads();
  if (!(OP == OP_F2 && x_out != nullptr))
    push(m.stage, c.G, ncols, dst, ldd, c0, c.C, cluster);
  cluster_arrive();
}

// One attention item over n rows of the item's head, by the thread group gr:
// rows[r * D + c] for c < dh. q_s holds the scaled f32 query; bias_row (or
// null) an additive bias per row; kscale / vscale (SCALED) per-channel scales
// of the rows. The probabilities are rounded to TP (float: not rounded)
// before the PV sum; acc_row (or null) gets the f32 p / attn_div added.
// Writes out[c] (c < dh). att, part and red are the group's scratch. A pass
// loads att_unroll<TR>() rows per thread (and their biases with them); the
// first V pass is issued before the softmax. Ends with a group barrier.
template <typename TR, typename TP, bool SCALED, bool STREAM>
__device__ void attend(const float* q_s, const TR* krows, const TR* vrows, int n, int D,
                       int dh, const float* bias_row, const float* kscale,
                       const float* vscale, float* acc_row, float attn_div, const Group& gr,
                       float* att, float* part, float* red, float* out) {
  using E = Elem<TR>;
  constexpr int VEC = E::VEC;
  constexpr int ATT_UNROLL = att_unroll<TR>();
  const int lph = dh / VEC;                  // threads per row (power of two <= 32)
  const int rpp = gr.n / lph;                // rows per pass
  const int cc = gr.tid % lph, ro = gr.tid / lph;
  float q[VEC], ks[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    q[i] = q_s[cc * VEC + i];
    ks[i] = SCALED ? kscale[cc * VEC + i] : 1.f;
  }
  uint4 raw[ATT_UNROLL];
  for (int r0 = 0; r0 < n; r0 += rpp * ATT_UNROLL) {
    float bv[ATT_UNROLL];
#pragma unroll
    for (int u = 0; u < ATT_UNROLL; ++u) {
      const int r = r0 + ro + u * rpp;
      bv[u] = 0.f;
      if (r < n) {
        raw[u] = ld_row<STREAM>(krows + (size_t)r * D + cc * VEC);
        if (bias_row != nullptr && cc == 0) bv[u] = bias_row[r];
      }
    }
#pragma unroll
    for (int u = 0; u < ATT_UNROLL; ++u) {
      float kv[VEC];
      E::unpack(raw[u], kv);
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc = fmaf(q[i], SCALED ? kv[i] * ks[i] : kv[i], acc);
      for (int off = lph >> 1; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      const int r = r0 + ro + u * rpp;
      if (cc == 0 && r < n) att[r] = acc + bv[u];
    }
  }
  // the first V pass flies during the softmax
#pragma unroll
  for (int u = 0; u < ATT_UNROLL; ++u) {
    const int r = ro + u * rpp;
    if (r < n) raw[u] = ld_row<STREAM>(vrows + (size_t)r * D + cc * VEC);
  }
  gr.sync();

  // softmax over the n logits
  float mx = -INFINITY;
  for (int r = gr.tid; r < n; r += gr.n) mx = fmaxf(mx, att[r]);
  mx = group_max(mx, red, gr);
  float sum = 0.f;
  for (int r = gr.tid; r < n; r += gr.n) {
    const float e = expf(att[r] - mx);
    att[r] = e;
    sum += e;
  }
  sum = group_sum(sum, red, gr);
  for (int r = gr.tid; r < n; r += gr.n) {
    const float p = att[r] / sum;
    att[r] = Elem<TP>::round(p);
    if (acc_row) acc_row[r] += p / attn_div;
  }
  gr.sync();

  // out[c] = sum_r p[r] * v[r][c]: threads along the channels, slices of rows
  float vs[VEC], acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    vs[i] = SCALED ? vscale[cc * VEC + i] : 1.f;
    acc[i] = 0.f;
  }
  for (int r0 = 0; r0 < n; r0 += rpp * ATT_UNROLL) {
    if (r0 > 0) {
#pragma unroll
      for (int u = 0; u < ATT_UNROLL; ++u) {
        const int r = r0 + ro + u * rpp;
        if (r < n) raw[u] = ld_row<STREAM>(vrows + (size_t)r * D + cc * VEC);
      }
    }
#pragma unroll
    for (int u = 0; u < ATT_UNROLL; ++u) {
      const int r = r0 + ro + u * rpp;
      if (r >= n) break;
      float v[VEC];
      E::unpack(raw[u], v);
      const float p = att[r];
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] = fmaf(p, SCALED ? v[i] * vs[i] : v[i], acc[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < VEC; ++i) part[ro * dh + cc * VEC + i] = acc[i];
  gr.sync();
  // the slices of channel j: tpc consecutive threads (the largest power of two
  // that fits) each add every tpc-th slice, then a shuffle tree joins them.
  // tpc * dh is a power of two >= 16, so whole warps take part or sit out.
  int tpc = 1;
  while (2 * tpc * dh <= gr.n) tpc *= 2;
  if (gr.tid < tpc * dh) {
    const int j = gr.tid / tpc, sub = gr.tid % tpc;
    float s = 0.f;
    for (int sl = sub; sl < rpp; sl += tpc) s += part[sl * dh + j];
    for (int off = tpc >> 1; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (sub == 0) out[j] = s;
  }
  gr.sync();
}

// The items of an attention phase: this CTA's items i = rank + j * C, two
// at a time, each by half of the block (a lone item by the whole block).
// item(i, gr, scratch slot) runs one item.
template <typename Item>
__device__ inline void attention_items(const CtaCtx& c, int n_items, Item item) {
  const int n_mine = c.rank < n_items ? (n_items - 1 - c.rank) / c.C + 1 : 0;
  for (int j0 = 0; j0 < n_mine; j0 += 2) {
    const bool pair = j0 + 1 < n_mine;
    const int half = pair && threadIdx.x >= CTA_THREADS / 2 ? 1 : 0;
    const Group gr = pair ? Group{(int)threadIdx.x - half * CTA_THREADS / 2, CTA_THREADS / 2,
                                  1 + half}
                          : Group{(int)threadIdx.x, CTA_THREADS, 0};
    item(c.rank + (j0 + half) * c.C, gr, half);
  }
}

template <Points P, typename T, typename TW, typename TKV>
__global__ void __launch_bounds__(CTA_THREADS, 1)
cluster_step_kernel(const StepParams<T, TW, TKV> p, const int group) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  constexpr bool KV8 = std::is_same<TKV, int8_t>::value;
  constexpr bool K1 = P == Points::K1;
  using TP = typename std::conditional<K1, T, float>::type;   // probabilities' rounding
  constexpr bool DEQUANT = KV8 && !K1;       // K/V scales inside the products (K3)
  const StepDims& dm = p.dims;
  const int D = dm.D, F = dm.F, H = dm.H, S = dm.S, L = dm.L, B = dm.B;
  const int dh = D / H;
  // cluster k of n owns lanes [k * B / n, (k + 1) * B / n): at most `group`
  CtaCtx c;
  c.C = (int)cluster.num_blocks();
  c.rank = (int)cluster.block_rank();
  const int n_clusters = (int)gridDim.x / c.C, cid = (int)blockIdx.x / c.C;
  c.b0 = cid * B / n_clusters;
  c.G = (cid + 1) * B / n_clusters - c.b0;
  const ClusterDims kd = {group, c.C, D, F, H, L, S};
  const ClusterSmem m = smem_plan<T, TW, TKV>(smem, kd);
  const int tid = threadIdx.x;
  const float attn_div = (float)(H * dm.n_layers);
  const int n_items = c.G * H;
  const int n_rows = items_max(kd);
  // the scaled query of an item, rounded to T at K1's points
  auto query = [&](float v) { return K1 ? Elem<T>::round(v * dm.scale) : v * dm.scale; };

  for (int i = tid; i < c.G * D; i += CTA_THREADS)
    m.xs[(i / D) * m.ldx + i % D] = Elem<T>::to_f(p.x[(size_t)c.b0 * D + i]);
  for (int i = tid; i < n_rows * S; i += CTA_THREADS) m.apart[i] = 0.f;
  // Every phase waits at its start for the barrier the previous one arrived
  // at; this first arrival also tells every CTA that all have started, before
  // any distributed shared memory is touched.
  cluster_arrive();

  for (int l = 0; l < dm.n_layers; ++l) {
    const LayerOperands<T, TW, TKV>& a0 = p.op;
    // weight product i of layer l: weights, bias, scale (read only under w8)
    auto wt = [&](int i, size_t size) { return a0.w[i] + l * size; };
    auto bias = [&](int i, int n) { return a0.b[i] + l * n; };
    auto scale = [&](int i, int n) { return a0.s[i] ? a0.s[i] + l * n : nullptr; };
    const float rw = a0.rw[2 * l], rw_src = a0.rw[2 * l + 1];
    const size_t slab = (size_t)l * B;
    const TKV* mk = a0.mk + slab * S * D;
    const TKV* mv = a0.mv + slab * S * D;

    // P1: qkv = x @ Wqkv
    product_phase<T, TW, TKV, OP_QKV>(wt(0, (size_t)3 * D * D), D, 3 * D, bias(0, 3 * D),
                                      scale(0, 3 * D), 0.f, m.xs, m.ldx, m.bufa, m.lda, c, m, kd,
                                      nullptr, cluster);
    // P2: self-attention items; each writes its lane's new cache row first
    const int LS = imax(L, S);
    cluster_wait();
    attention_items(c, n_items, [&](int i, const Group& gr, int slot) {
      const int g = i / H, h = i - g * H;
      const int b = c.b0 + g;
      const float* qkv = m.bufa + (size_t)g * m.lda;
      float* q = m.q + slot * D;
      T* ck = a0.ck + (slab + b) * L * D + (size_t)h * dh;
      T* cv = a0.cv + (slab + b) * L * D + (size_t)h * dh;
      for (int d = gr.tid; d < dh; d += gr.n) {
        q[d] = query(qkv[h * dh + d]);
        ck[(size_t)dm.index * D + d] = Elem<T>::from_f(qkv[D + h * dh + d]);
        cv[(size_t)dm.index * D + d] = Elem<T>::from_f(qkv[2 * D + h * dh + d]);
      }
      gr.sync();   // the row just written is read below
      float* out = m.stage + slot * D;
      attend<T, TP, false, false>(q, ck, cv, dm.index + 1, D, dh, nullptr, nullptr, nullptr,
                                  nullptr, 0.f, gr, m.att + slot * LS,
                                  m.part + slot * (CTA_THREADS / 2) * Elem<T>::VEC,
                                  m.red + slot * 2 * CTA_WARPS, out);
      push(out, 1, dh, m.bufb + (size_t)g * m.ldx, m.ldx, h * dh, c.C, cluster, gr.tid, gr.n);
    });
    cluster_arrive();
    // P3: x1 = x + (sa @ Wso) * rw
    product_phase<T, TW, TKV, OP_SO>(wt(1, (size_t)D * D), D, D, bias(1, D), scale(1, D), rw,
                                     m.bufb, m.ldx, m.xs, m.ldx, c, m, kd, nullptr, cluster);
    // P4: qc = x1 @ Wcq
    product_phase<T, TW, TKV, OP_CQ>(wt(2, (size_t)D * D), D, D, bias(2, D), scale(2, D), 0.f,
                                     m.xs, m.ldx, m.bufa, m.lda, c, m, kd, nullptr, cluster);
    // P5: cross-attention items over the window
    cluster_wait();
    attention_items(c, n_items, [&](int i, const Group& gr, int slot) {
      const int g = i / H, h = i - g * H;
      const int b = c.b0 + g;
      const float* sk = KV8 ? a0.sk + l * D + h * dh : nullptr;
      const float* sv = KV8 ? a0.sv + l * D + h * dh : nullptr;
      float* q = m.q + slot * D;
      for (int d = gr.tid; d < dh; d += gr.n) {
        const float qc = m.bufa[(size_t)g * m.lda + h * dh + d];
        // K1 under kv8: the K scale folds into the query before its rounding
        q[d] = K1 && KV8 ? Elem<T>::round(qc * dm.scale * sk[d]) : query(qc);
      }
      gr.sync();
      const size_t base = (size_t)b * S * D + (size_t)h * dh;
      float* out = m.stage + slot * D;
      attend<TKV, TP, DEQUANT, true>(q, mk + base, mv + base, S, D, dh, p.bias + (size_t)b * S,
                                     sk, sv, m.apart + (size_t)(i / c.C) * S, attn_div, gr,
                                     m.att + slot * LS,
                                     m.part + slot * (CTA_THREADS / 2) * Elem<TKV>::VEC,
                                     m.red + slot * 2 * CTA_WARPS, out);
      if (K1 && KV8) {   // K1: the V scale multiplies the f32 PV sum
        for (int d = gr.tid; d < dh; d += gr.n) out[d] *= sv[d];
        gr.sync();
      }
      push(out, 1, dh, m.bufb + (size_t)g * m.ldx, m.ldx, h * dh, c.C, cluster, gr.tid, gr.n);
    });
    cluster_arrive();
    // P6: x2 = x1 + (ca @ Wco) * rw_src
    product_phase<T, TW, TKV, OP_CO>(wt(3, (size_t)D * D), D, D, bias(3, D), scale(3, D),
                                     rw_src, m.bufb, m.ldx, m.xs, m.ldx, c, m, kd, nullptr, cluster);
    // P7: h = relu(x2 @ Wf1)
    product_phase<T, TW, TKV, OP_F1>(wt(4, (size_t)D * F), D, F, bias(4, F), scale(4, F), 0.f,
                                     m.xs, m.ldx, m.bufa, m.lda, c, m, kd, nullptr, cluster);
    // P8: x3 = round_T(x2 + (h @ Wf2) * rw); the last layer writes x_out
    product_phase<T, TW, TKV, OP_F2>(wt(5, (size_t)F * D), F, D, bias(5, D), scale(5, D), rw,
                                     m.bufa, m.lda, m.xs, m.ldx, c, m, kd,
                                     l + 1 == dm.n_layers ? p.x_out : nullptr, cluster);
  }

  // attn of lane g: the H item rows added in head order, by CTA g % C
  cluster_wait();
  for (int g = c.rank; g < c.G; g += c.C) {
    for (int s = tid; s < S; s += CTA_THREADS) {
      float v = 0.f;
      for (int h = 0; h < H; ++h) {
        const int i = g * H + h;
        const float* row = cluster.map_shared_rank(m.apart, i % c.C) + (size_t)(i / c.C) * S;
        v += row[s];
      }
      p.attn_out[(size_t)(c.b0 + g) * S + s] = v;
    }
  }
  cluster.sync();       // no CTA exits while its rows are read
}

// ---- the host side ------------------------------------------------------------
template <typename T, typename TKV>
bool shapes_ok(const StepDims& d, int group, int cluster, int clusters) {
  if (d.B <= 0 || d.D <= 0 || d.H <= 0 || d.D % d.H != 0 || d.index < 0 ||
      d.index >= d.L || d.S <= 0 || d.F <= 0 || d.n_layers <= 0)
    return false;
  if (group < 1 || group > MAX_GROUP || cluster < 1 || cluster > MAX_CLUSTER ||
      clusters < 1 || clusters > d.B || (d.B + clusters - 1) / clusters > group)
    return false;
  // 16-column tiles; K in steps of 32 (a 16-byte load of int8 fragments)
  if (d.D % 32 != 0 || d.F % 32 != 0) return false;
  const int dh = d.D / d.H;
  auto rows_ok = [&](int vec) {
    const int lph = dh / vec;
    return dh % vec == 0 && lph >= 1 && lph <= 32 && (lph & (lph - 1)) == 0;
  };
  // 16 <= dh <= CTA_THREADS / 2: every thread group holds a thread per channel
  return dh >= 16 && 2 * dh <= CTA_THREADS && rows_ok(Elem<T>::VEC) && rows_ok(Elem<TKV>::VEC);
}

// The launch configuration of one instantiation: dynamic shared memory and
// the cluster attributes, set on the current device once per size.
template <Points P, typename T, typename TW, typename TKV>
int prepare(const StepDims& d, int group, int cluster, int clusters, size_t* smem_out) {
  if (!shapes_ok<T, TKV>(d, group, cluster, clusters)) return (int)cudaErrorInvalidValue;
  const ClusterDims kd = {group, cluster, d.D, d.F, d.H, d.L, d.S};
  size_t offs[9];
  const size_t smem = smem_floats<T, TW, TKV>(kd, offs) * sizeof(float);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  constexpr int MAX_DEVICES = 64;
  static size_t allowed[MAX_DEVICES] = {};
  static bool non_portable[MAX_DEVICES] = {};
  const void* kernel = (const void*)cluster_step_kernel<P, T, TW, TKV>;
  int err = allow_smem(kernel, smem, allowed, MAX_DEVICES);
  if (err != 0) return err;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return (int)cudaErrorInvalidDevice;
  if (cluster > 8 && (dev >= MAX_DEVICES || !non_portable[dev])) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
    if (dev < MAX_DEVICES) non_portable[dev] = true;
  }
  *smem_out = smem;
  return 0;
}

inline cudaLaunchConfig_t launch_config(int cluster, int clusters, size_t smem,
                                        cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(clusters * cluster));
  cfg.blockDim = dim3(CTA_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The C entry points' bodies (layer_step.cu, stacked_step.cu). dtype: 0 =
// float32, 1 = bfloat16 storage; w8 / kv8: int8 weights / cross K/V. `ptrs`
// holds N_PTRS device pointers in the order of params_from, each of an
// operand with a leading layer axis [n_layers, ...]: weights (in fragment
// order for bfloat16 storage, [in, out] for float32), biases, weight scales,
// rw [n_layers, 2], caches [n_layers, B, L, D], cross K/V [n_layers, B, S, D]
// and their scales [n_layers, D]; scales are read only for int8 operands.
// `dims` = B, D, F, H, L, S, index, n_layers. The plan of
// ops/cuda_decode.py: `clusters` clusters of `cluster` CTAs, cluster k owning
// lanes [k * B / clusters, (k + 1) * B / clusters), at most `group`. Returns
// cudaGetLastError() of the launch (0 = ok) or cudaErrorInvalidValue for
// shapes, types or a plan the kernel does not take. Does not synchronise and
// allocates nothing.
template <Points P>
int cluster_step(int dtype, int w8, int kv8, const void* const* ptrs, const int* dims,
                 float scale, int group, int cluster, int clusters, void* stream) {
  return dispatch_types(dtype, w8, kv8, [&](auto t, auto tw, auto tkv) {
    using T = typename decltype(t)::type;
    using TW = typename decltype(tw)::type;
    using TKV = typename decltype(tkv)::type;
    const StepParams<T, TW, TKV> p = params_from<T, TW, TKV>(ptrs, dims, scale);
    size_t smem = 0;
    const int err = prepare<P, T, TW, TKV>(p.dims, group, cluster, clusters, &smem);
    if (err != 0) return err;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg =
        launch_config(cluster, clusters, smem, (cudaStream_t)stream, &attr);
    const cudaError_t e = cudaLaunchKernelEx(&cfg, cluster_step_kernel<P, T, TW, TKV>, p,
                                             group);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
  });
}

// How many clusters of `cluster` CTAs of this instantiation the current
// device holds at once (cudaOccupancyMaxActiveClusters), in *slots; the
// shared memory is that of `group` lanes. Returns 0 or the CUDA error.
template <Points P>
int cluster_slots(int dtype, int w8, int kv8, const int* dims, int group, int cluster,
                  int* slots) {
  return dispatch_types(dtype, w8, kv8, [&](auto t, auto tw, auto tkv) {
    using T = typename decltype(t)::type;
    using TW = typename decltype(tw)::type;
    using TKV = typename decltype(tkv)::type;
    const StepDims d = dims_from(dims, 1.f);
    size_t smem = 0;
    const int err = prepare<P, T, TW, TKV>(d, group, cluster, (d.B + group - 1) / group, &smem);
    if (err != 0) return err;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = launch_config(cluster, 1, smem, 0, &attr);
    int n = 0;
    const cudaError_t e = cudaOccupancyMaxActiveClusters(
        &n, cluster_step_kernel<P, T, TW, TKV>, &cfg);
    if (e != cudaSuccess) return (int)e;
    *slots = n;
    return 0;
  });
}

}  // namespace
