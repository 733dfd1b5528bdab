// Fused decoder layer step: one ReZero decoder layer for one new token per
// lane, in one launch.
//
//   qkv = x @ Wqkv + b                      (fused projection)
//   cache_k[b, index] = k; cache_v[b, index] = v      (indexed store, in place)
//   sa  = softmax_h(q_h * scale . cache_k[<= index]) @ cache_v   per head
//   x1  = x + (sa @ Wso + b) * rw
//   qc  = x1 @ Wcq + b
//   p_h = softmax(qc_h * scale . mem_k + bias)        per head, over S
//   attn_out = mean_h p_h                              [B, S] f32
//   x2  = x1 + ((p @ mem_v) @ Wco + b) * rw_src
//   x3  = x2 + (relu(x2 @ Wf1 + b) @ Wf2 + b) * rw
//
// Storage type T is float or bf16 (activations, weights, caches, cross K/V);
// biases, the two ReZero scalars, the pad bias and attn_out are f32. Every
// product takes T-valued operands with f32 accumulation: the input of each
// weight product, the scaled queries and the probabilities are rounded to T
// first; the residual stream x1, x2, x3 stays f32 until the final store.
//
// Design: one thread block per lane (grid = B, 768 threads). The lane's
// residual stream, the product inputs/outputs, the two logit rows and the FF
// hidden stay in shared memory, so no intermediate touches device memory.
// Weights are [in, out] row-major and every block re-reads them through L2.
// A weight product is a GEMV whose threads run along the OUTPUT dimension
// with 16-byte loads (coalesced rows); when there are fewer 16-byte column
// groups than threads, the threads also split the input dimension and the
// partial sums are reduced through shared memory. Attention logits use one
// warp per group of cache rows with a segmented shuffle reduction per head;
// the probability-weighted sum again runs threads along the channel dim.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int NTHREADS = 768;        // the host wrapper checks D / VEC against it
constexpr int NWARPS = NTHREADS / 32;
constexpr int ROWS_PER_ITER = 8;     // cache rows a warp has in flight
constexpr int LOADS_IN_FLIGHT = 8;   // 16-byte loads a thread issues per batch

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static constexpr int VEC = 4;  // elements per 16-byte load
  __device__ static float to_f(float v) { return v; }
  __device__ static float from_f(float v) { return v; }
  __device__ static float round(float v) { return v; }
  __device__ static void unpack(const uint4& v, float* out) {
    out[0] = __uint_as_float(v.x); out[1] = __uint_as_float(v.y);
    out[2] = __uint_as_float(v.z); out[3] = __uint_as_float(v.w);
  }
};

template <>
struct Elem<__nv_bfloat16> {
  static constexpr int VEC = 8;
  __device__ static float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
  __device__ static __nv_bfloat16 from_f(float v) { return __float2bfloat16(v); }
  __device__ static float round(float v) {
    return __bfloat162float(__float2bfloat16(v));
  }
  __device__ static void unpack(const uint4& v, float* out) {
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // low half is the even element
      out[2 * i] = __uint_as_float(w[i] << 16);
      out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

// One 16-byte load of VEC elements, kept raw so that a batch of loads can be
// issued back to back before any of them is unpacked.
template <typename T>
__device__ inline uint4 load_raw(const T* p) {
  return *reinterpret_cast<const uint4*>(p);
}

// acc[0..VEC) += xv * (the VEC elements in raw)
template <typename T>
__device__ inline void fma_vec(float xv, const uint4& raw, float* acc) {
  float w[Elem<T>::VEC];
  Elem<T>::unpack(raw, w);
#pragma unroll
  for (int i = 0; i < Elem<T>::VEC; ++i) acc[i] = fmaf(xv, w[i], acc[i]);
}

template <typename T>
struct LayerStepParams {
  const T* x;
  const T* wqkv; const float* bqkv;
  const T* wso;  const float* bso;
  const T* wcq;  const float* bcq;
  const T* wco;  const float* bco;
  const T* wf1;  const float* bf1;
  const T* wf2;  const float* bf2;
  const float* rw;          // [2]: resweight, resweight_src
  T* ck; T* cv;             // [B, L, D] self cache, updated in place
  const T* mk; const T* mv; // [B, S, D] cross K/V
  const float* bias;        // [B, S] additive pad bias
  T* x_out;                 // [B, D]
  float* attn_out;          // [B, S]
  int B, D, F, H, L, S, index;
  float scale;              // 1 / sqrt(D / H)
};

// acc[0..VEC) += sum over k = k0, k0 + stride, ... < K of in_s[k] * W[k, col..col+VEC).
// LOADS_IN_FLIGHT rows are loaded before any is used: the loop is bound by
// load latency, so the loads a thread has in flight set its speed.
template <typename T>
__device__ inline void gemv_column(const float* in_s, int K, const T* wp, int N,
                                   int k0, int stride, float* acc) {
  int k = k0;
  for (; k + (LOADS_IN_FLIGHT - 1) * stride < K; k += LOADS_IN_FLIGHT * stride) {
    uint4 raw[LOADS_IN_FLIGHT];
#pragma unroll
    for (int u = 0; u < LOADS_IN_FLIGHT; ++u)
      raw[u] = load_raw(wp + (size_t)(k + u * stride) * N);
#pragma unroll
    for (int u = 0; u < LOADS_IN_FLIGHT; ++u)
      fma_vec<T>(in_s[k + u * stride], raw[u], acc);
  }
  for (; k < K; k += stride) fma_vec<T>(in_s[k], load_raw(wp + (size_t)k * N), acc);
}

// out_s[0..N) = in_s[0..K) @ W[K, N] + bias. Ends with a block barrier.
template <typename T>
__device__ void gemv(const float* in_s, int K, const T* W, int N,
                     const float* bias, float* out_s, float* part_s) {
  constexpr int VEC = Elem<T>::VEC;
  const int tid = threadIdx.x;
  const int ncol = N / VEC;
  if (ncol >= NTHREADS) {
    for (int cg = tid; cg < ncol; cg += NTHREADS) {
      float acc[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
      gemv_column<T>(in_s, K, W + (size_t)cg * VEC, N, 0, 1, acc);
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        out_s[cg * VEC + i] = acc[i] + bias[cg * VEC + i];
    }
    __syncthreads();
    return;
  }
  const int kslices = NTHREADS / ncol;
  const int cg = tid % ncol;
  const int ks = tid / ncol;
  if (ks < kslices) {
    float acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
    gemv_column<T>(in_s, K, W + (size_t)cg * VEC, N, ks, kslices, acc);
#pragma unroll
    for (int i = 0; i < VEC; ++i) part_s[ks * N + cg * VEC + i] = acc[i];
  }
  __syncthreads();
  for (int j = tid; j < N; j += NTHREADS) {
    float s = 0.f;
    for (int q = 0; q < kslices; ++q) s += part_s[q * N + j];
    out_s[j] = s + bias[j];
  }
  __syncthreads();
}

// att[h * ld + l] = q_s[head h] . rows[l][head h] (+ bias[l]) for l < n.
// A lane owns VEC channels of a 32*VEC-channel chunk; a head spans
// lph = dh / VEC lanes (a power of two <= 32). Ends with a block barrier.
template <typename T>
__device__ void attn_logits(const float* q_s, const T* rows, int n, int D,
                            int dh, float* att, int ld, const float* bias) {
  using E = Elem<T>;
  constexpr int VEC = E::VEC;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nvec = D / VEC;
  const int lph = dh / VEC;
  const int nchunk = (nvec + 31) / 32;
  for (int l0 = warp * ROWS_PER_ITER; l0 < n; l0 += NWARPS * ROWS_PER_ITER) {
    for (int c = 0; c < nchunk; ++c) {
      const int e = c * 32 + lane;
      const bool ok = e < nvec;
      float q[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) q[i] = ok ? q_s[e * VEC + i] : 0.f;
      uint4 raw[ROWS_PER_ITER];
#pragma unroll
      for (int u = 0; u < ROWS_PER_ITER; ++u) {
        // rows past n re-read row n-1 (always valid); their sums are dropped
        const int l = min(l0 + u, n - 1);
        raw[u] = load_raw(rows + (size_t)l * D + (size_t)(ok ? e : 0) * VEC);
      }
      float acc[ROWS_PER_ITER];
#pragma unroll
      for (int u = 0; u < ROWS_PER_ITER; ++u) {
        float kv[VEC];
        E::unpack(raw[u], kv);
        acc[u] = 0.f;
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[u] = fmaf(q[i], kv[i], acc[u]);
      }
#pragma unroll
      for (int u = 0; u < ROWS_PER_ITER; ++u)
        for (int off = lph >> 1; off > 0; off >>= 1)
          acc[u] += __shfl_xor_sync(0xffffffffu, acc[u], off);
      if (ok && (lane % lph) == 0) {
        const int h = (e * VEC) / dh;
#pragma unroll
        for (int u = 0; u < ROWS_PER_ITER; ++u) {
          const int l = l0 + u;
          if (l < n) att[h * ld + l] = acc[u] + (bias ? bias[l] : 0.f);
        }
      }
    }
  }
  __syncthreads();
}

// In-place f32 softmax of each of the H rows att[h * ld + 0..n).
__device__ void softmax_rows(float* att, int ld, int H, int n) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int h = warp; h < H; h += NWARPS) {
    float* a = att + h * ld;
    float m = -INFINITY;
    for (int l = lane; l < n; l += 32) m = fmaxf(m, a[l]);
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float s = 0.f;
    for (int l = lane; l < n; l += 32) {
      const float e = expf(a[l] - m);
      a[l] = e;
      s += e;
    }
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    for (int l = lane; l < n; l += 32) a[l] = a[l] / s;
  }
  __syncthreads();
}

// out_s[d] = sum_{l < n} round_T(att[head(d) * ld + l]) * rows[l][d].
// Threads run along the channel dim in 16-byte groups and split the rows
// when there are threads to spare. Ends with a block barrier.
template <typename T>
__device__ void attn_pv(const float* att, int ld, int n, const T* rows, int D,
                        int dh, float* out_s, float* part_s) {
  using E = Elem<T>;
  constexpr int VEC = E::VEC;
  const int tid = threadIdx.x;
  const int ncol = D / VEC;        // <= NTHREADS (checked on the host)
  const int slices = NTHREADS / ncol;
  const int cg = tid % ncol;
  const int sl = tid / ncol;
  if (sl < slices) {
    const float* p = att + ((cg * VEC) / dh) * ld;
    float acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
    const T* vp = rows + (size_t)cg * VEC;
    int l = sl;
    for (; l + (LOADS_IN_FLIGHT - 1) * slices < n; l += LOADS_IN_FLIGHT * slices) {
      uint4 raw[LOADS_IN_FLIGHT];
#pragma unroll
      for (int u = 0; u < LOADS_IN_FLIGHT; ++u)
        raw[u] = load_raw(vp + (size_t)(l + u * slices) * D);
#pragma unroll
      for (int u = 0; u < LOADS_IN_FLIGHT; ++u)
        fma_vec<T>(E::round(p[l + u * slices]), raw[u], acc);
    }
    for (; l < n; l += slices)
      fma_vec<T>(E::round(p[l]), load_raw(vp + (size_t)l * D), acc);
#pragma unroll
    for (int i = 0; i < VEC; ++i) part_s[sl * D + cg * VEC + i] = acc[i];
  }
  __syncthreads();
  for (int j = tid; j < D; j += NTHREADS) {
    float s = 0.f;
    for (int q = 0; q < slices; ++q) s += part_s[q * D + j];
    out_s[j] = s;
  }
  __syncthreads();
}

__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
layer_step_kernel(const LayerStepParams<T> p) {
  using E = Elem<T>;
  extern __shared__ __align__(16) float smem[];
  const int D = p.D, F = p.F, H = p.H, S = p.S;
  const int dh = D / H;
  const int W = imax(3 * D, F);
  const int LS = imax(p.L, S);
  float* xs = smem;            // [D]  f32 residual stream
  float* vin = xs + D;         // [W]  T-rounded input of the next product
  float* vout = vin + W;       // [W]  f32 output of the last product
  float* att = vout + W;       // [H, LS] logits -> probabilities
  float* part = att + H * LS;  // [NTHREADS * VEC] partial sums

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const float rw = p.rw[0];
  const float rw_src = p.rw[1];

  for (int d = tid; d < D; d += NTHREADS) {
    const float v = E::to_f(p.x[(size_t)b * D + d]);
    xs[d] = v;
    vin[d] = v;
  }
  __syncthreads();

  // ---- self-attention ---------------------------------------------------
  gemv<T>(vin, D, p.wqkv, 3 * D, p.bqkv, vout, part);
  T* ck = p.ck + (size_t)b * p.L * D;
  T* cv = p.cv + (size_t)b * p.L * D;
  for (int d = tid; d < D; d += NTHREADS) {
    ck[(size_t)p.index * D + d] = E::from_f(vout[D + d]);
    cv[(size_t)p.index * D + d] = E::from_f(vout[2 * D + d]);
    vin[d] = E::round(vout[d] * p.scale);
  }
  __syncthreads();  // the row just written is read below
  const int n_self = p.index + 1;  // positions > index are masked out
  attn_logits<T>(vin, ck, n_self, D, dh, att, LS, nullptr);
  softmax_rows(att, LS, H, n_self);
  attn_pv<T>(att, LS, n_self, cv, D, dh, vout, part);
  for (int d = tid; d < D; d += NTHREADS) vin[d] = E::round(vout[d]);
  __syncthreads();
  gemv<T>(vin, D, p.wso, D, p.bso, vout, part);
  for (int d = tid; d < D; d += NTHREADS) {
    const float x1 = xs[d] + vout[d] * rw;
    xs[d] = x1;
    vin[d] = E::round(x1);
  }
  __syncthreads();

  // ---- cross-attention over the precomputed window K/V --------------------
  gemv<T>(vin, D, p.wcq, D, p.bcq, vout, part);
  for (int d = tid; d < D; d += NTHREADS) vin[d] = E::round(vout[d] * p.scale);
  __syncthreads();
  const T* mk = p.mk + (size_t)b * S * D;
  const T* mv = p.mv + (size_t)b * S * D;
  attn_logits<T>(vin, mk, S, D, dh, att, LS, p.bias + (size_t)b * S);
  softmax_rows(att, LS, H, S);
  for (int s = tid; s < S; s += NTHREADS) {
    float acc = 0.f;
    for (int h = 0; h < H; ++h) acc += att[h * LS + s];
    p.attn_out[(size_t)b * S + s] = acc / (float)H;
  }
  attn_pv<T>(att, LS, S, mv, D, dh, vout, part);
  for (int d = tid; d < D; d += NTHREADS) vin[d] = E::round(vout[d]);
  __syncthreads();
  gemv<T>(vin, D, p.wco, D, p.bco, vout, part);
  for (int d = tid; d < D; d += NTHREADS) {
    const float x2 = xs[d] + vout[d] * rw_src;
    xs[d] = x2;
    vin[d] = E::round(x2);
  }
  __syncthreads();

  // ---- feed-forward -------------------------------------------------------
  gemv<T>(vin, D, p.wf1, F, p.bf1, vout, part);
  for (int j = tid; j < F; j += NTHREADS) vin[j] = E::round(fmaxf(vout[j], 0.f));
  __syncthreads();
  gemv<T>(vin, F, p.wf2, D, p.bf2, vout, part);
  for (int d = tid; d < D; d += NTHREADS)
    p.x_out[(size_t)b * D + d] = E::from_f(xs[d] + vout[d] * rw);
}

template <typename T>
int launch(const LayerStepParams<T>& p, cudaStream_t stream) {
  constexpr int VEC = Elem<T>::VEC;
  const int D = p.D, F = p.F, H = p.H;
  if (p.B <= 0 || D <= 0 || H <= 0 || D % H != 0 || p.index < 0 ||
      p.index >= p.L || p.S <= 0)
    return (int)cudaErrorInvalidValue;
  const int dh = D / H;
  const int lph = dh / VEC;
  // 16-byte rows and column groups; a head spans a power-of-two lane count.
  if (D % VEC != 0 || F % VEC != 0 || dh % VEC != 0 || lph > 32 ||
      (lph & (lph - 1)) != 0 || D / VEC > NTHREADS)
    return (int)cudaErrorInvalidValue;
  const size_t floats = (size_t)D + 2 * (size_t)imax(3 * D, F) +
                        (size_t)H * imax(p.L, p.S) + (size_t)NTHREADS * VEC;
  const size_t smem = floats * sizeof(float);
  if (smem > 48 * 1024) {
    // Above 48 KB a kernel must be allowed its dynamic shared memory first;
    // remembered per device so the call is not repeated on every launch.
    constexpr int MAX_DEVICES = 64;
    static size_t allowed[MAX_DEVICES] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= MAX_DEVICES || smem > allowed[dev]) {
      err = cudaFuncSetAttribute(
          layer_step_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (err != cudaSuccess) return (int)err;
      if (dev < MAX_DEVICES) allowed[dev] = smem;
    }
  }
  layer_step_kernel<T><<<p.B, NTHREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 storage. Returns cudaGetLastError() of
// the launch (0 = ok) or cudaErrorInvalidValue for shapes the kernel does not
// take. Does not synchronise and allocates nothing.
extern "C" int tal_layer_step(
    int dtype, const void* x,
    const void* wqkv, const void* bqkv, const void* wso, const void* bso,
    const void* wcq, const void* bcq, const void* wco, const void* bco,
    const void* wf1, const void* bf1, const void* wf2, const void* bf2,
    const void* rw, void* ck, void* cv, const void* mk, const void* mv,
    const void* bias, void* x_out, void* attn_out,
    int B, int D, int F, int H, int L, int S, int index, float scale,
    void* stream) {
#define TAL_FILL(T)                                                          \
  LayerStepParams<T> p;                                                      \
  p.x = (const T*)x;                                                         \
  p.wqkv = (const T*)wqkv; p.bqkv = (const float*)bqkv;                      \
  p.wso = (const T*)wso;   p.bso = (const float*)bso;                        \
  p.wcq = (const T*)wcq;   p.bcq = (const float*)bcq;                        \
  p.wco = (const T*)wco;   p.bco = (const float*)bco;                        \
  p.wf1 = (const T*)wf1;   p.bf1 = (const float*)bf1;                        \
  p.wf2 = (const T*)wf2;   p.bf2 = (const float*)bf2;                        \
  p.rw = (const float*)rw;                                                   \
  p.ck = (T*)ck; p.cv = (T*)cv; p.mk = (const T*)mk; p.mv = (const T*)mv;    \
  p.bias = (const float*)bias; p.x_out = (T*)x_out;                          \
  p.attn_out = (float*)attn_out;                                             \
  p.B = B; p.D = D; p.F = F; p.H = H; p.L = L; p.S = S; p.index = index;     \
  p.scale = scale;                                                           \
  return launch<T>(p, (cudaStream_t)stream);
  if (dtype == 0) {
    TAL_FILL(float)
  } else if (dtype == 1) {
    TAL_FILL(__nv_bfloat16)
  }
#undef TAL_FILL
  return (int)cudaErrorInvalidValue;
}
