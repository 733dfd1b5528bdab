// Device code of the fused decoder-step kernels:
//   K1 layer_step.cu   — one ReZero decoder layer per launch (everything here)
//   K3 stacked_step.cu — every layer of the decoder in one launch, on
//     thread-block clusters; it takes from here only the operand plumbing
//     (Elem, LayerOperands, StepParams, params_from, dispatch_types,
//     allow_smem), not layer_body, whose STACKED = true rounding points it
//     now computes itself. The K1 redesign (ROADMAP B) retires the per-lane
//     code below, the STACKED branch with it.
//
// One ReZero decoder layer for one new token per lane (`layer_body`):
//
//   qkv = (x @ Wqkv) * s + b                 (fused projection)
//   cache_k[b, index] = k; cache_v[b, index] = v      (indexed store, in place)
//   sa  = softmax_h(q_h * scale . cache_k[<= index]) @ cache_v   per head
//   x1  = x + ((sa @ Wso) * s + b) * rw
//   qc  = (x1 @ Wcq) * s + b
//   p_h = softmax(qc_h * scale . mem_k * sk + bias)   per head, over S
//   attn_acc += (sum_h p_h) / attn_div                [S] f32
//   x2  = x1 + ((p @ (mem_v * sv)) @ Wco * s + b) * rw_src
//   x3  = x2 + ((relu((x2 @ Wf1) * s + b) @ Wf2) * s + b) * rw
//
// Three element types: T (float or bf16) for the activations and the self
// cache, TW (T or int8) for the weights, TKV (T or int8) for the cross K/V.
// Weight scales `s` are per output channel and multiply the f32 sum, never
// the weights; scales are read only with int8 operands. Biases, the
// ReZero scalars, the pad bias and attn are f32; the residual stream is f32
// within a layer.
//
// Rounding points differ between the two kernels, as they do between the
// TPU kernels they replace; STACKED selects them:
//   K1 (STACKED = false): the scaled queries and the probabilities are
//     rounded to T before their products; under kv8 the K scale folds into
//     the query before that rounding and the V scale multiplies the f32 PV
//     sum.
//   K3 (STACKED = true): queries and probabilities stay f32; the cross K/V
//     are dequantized per element (k * sk, v * sv, f32) inside the products.
// Both round the input of every weight product to T, and the layer's output
// x3 to T (K3 then feeds it to the next layer).
//
// Design (K1): one thread block per lane, NTHREADS threads. The lane's residual
// stream, the product inputs/outputs, the logit rows and the FF hidden stay in
// shared memory. A weight product is a GEMV whose threads run along the
// OUTPUT dimension with 16-byte loads (coalesced rows of [in, out] weights);
// when there are fewer 16-byte column groups than threads, the threads also
// split the input dimension and the partial sums are reduced through shared
// memory. Attention logits use one warp per group of rows with a segmented
// shuffle reduction per head; the probability-weighted sum again runs threads
// along the channel dim. A 16-byte load carries 4 f32, 8 bf16 or 16 int8
// values, so every vector width follows the type of the operand it loads.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int NTHREADS = 768;        // the host wrappers check D / VEC against it
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

// int8 storage (weights or cross K/V): values -127..127, exact in bf16 and f32.
// Unpacked without int-to-float conversions (they run at 1/8 of the FMA rate
// and would bound a GEMV over int8 weights): the byte, offset by 128, becomes
// the low mantissa byte of 2^23, and one exact subtraction takes off 2^23 + 128.
template <>
struct Elem<int8_t> {
  static constexpr int VEC = 16;
  __device__ static void unpack(const uint4& v, float* out) {
    const unsigned w[4] = {v.x ^ 0x80808080u, v.y ^ 0x80808080u,
                           v.z ^ 0x80808080u, v.w ^ 0x80808080u};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j)  // byte j of a word is element 4i + j
        out[4 * i + j] =
            __uint_as_float(__byte_perm(w[i], 0x4B000000u, 0x7540u | j)) - 8388736.f;
    }
  }
};

template <typename A, typename B, typename C>
__host__ __device__ constexpr int max_vec() {
  constexpr int ab = Elem<A>::VEC > Elem<B>::VEC ? Elem<A>::VEC : Elem<B>::VEC;
  return ab > Elem<C>::VEC ? ab : Elem<C>::VEC;
}

__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

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

// acc[0..VEC) += sum over k = k0, k0 + stride, ... < K of in_s[k] * W[k, col..col+VEC).
// LOADS_IN_FLIGHT rows are loaded before any is used: the loop is bound by
// load latency, so the loads a thread has in flight set its speed.
template <typename TW>
__device__ inline void gemv_column(const float* in_s, int K, const TW* wp, int N,
                                   int k0, int stride, float* acc) {
  int k = k0;
  for (; k + (LOADS_IN_FLIGHT - 1) * stride < K; k += LOADS_IN_FLIGHT * stride) {
    uint4 raw[LOADS_IN_FLIGHT];
#pragma unroll
    for (int u = 0; u < LOADS_IN_FLIGHT; ++u)
      raw[u] = load_raw(wp + (size_t)(k + u * stride) * N);
#pragma unroll
    for (int u = 0; u < LOADS_IN_FLIGHT; ++u)
      fma_vec<TW>(in_s[k + u * stride], raw[u], acc);
  }
  for (; k < K; k += stride) fma_vec<TW>(in_s[k], load_raw(wp + (size_t)k * N), acc);
}

// out_s[j] = (in_s[0..K) @ W[K, N])[j] * scale[j] + bias[j] (without SCALED:
// scale unread, 1). Needs NTHREADS * VEC floats of part_s. Ends with a block
// barrier.
template <typename TW, bool SCALED>
__device__ void gemv(const float* in_s, int K, const TW* W, int N,
                     const float* bias, const float* scale, float* out_s,
                     float* part_s) {
  constexpr int VEC = Elem<TW>::VEC;
  const int tid = threadIdx.x;
  const int ncol = N / VEC;
  if (ncol >= NTHREADS) {
    for (int cg = tid; cg < ncol; cg += NTHREADS) {
      float acc[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
      gemv_column<TW>(in_s, K, W + (size_t)cg * VEC, N, 0, 1, acc);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const int j = cg * VEC + i;
        out_s[j] = (SCALED ? acc[i] * scale[j] : acc[i]) + bias[j];
      }
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
    gemv_column<TW>(in_s, K, W + (size_t)cg * VEC, N, ks, kslices, acc);
#pragma unroll
    for (int i = 0; i < VEC; ++i) part_s[ks * N + cg * VEC + i] = acc[i];
  }
  __syncthreads();
  for (int j = tid; j < N; j += NTHREADS) {
    float s = 0.f;
    for (int q = 0; q < kslices; ++q) s += part_s[q * N + j];
    out_s[j] = (SCALED ? s * scale[j] : s) + bias[j];
  }
  __syncthreads();
}

// att[h * ld + l] = sum_c q_s[c] * (rows[l][c] * kscale[c]) (+ bias[l]) over
// the channels c of head h, for l < n (without SCALED: kscale unread, 1). A lane owns VEC
// channels of a 32*VEC-channel chunk; a head spans lph = dh / VEC lanes (a
// power of two <= 32). Ends with a block barrier.
template <typename TR, bool SCALED>
__device__ void attn_logits(const float* q_s, const TR* rows, int n, int D,
                            int dh, float* att, int ld, const float* bias,
                            const float* kscale) {
  using E = Elem<TR>;
  constexpr int VEC = E::VEC;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nvec = D / VEC;
  const int lph = dh / VEC;
  const int nchunk = (nvec + 31) / 32;
  for (int l0 = warp * ROWS_PER_ITER; l0 < n; l0 += NWARPS * ROWS_PER_ITER) {
    for (int c = 0; c < nchunk; ++c) {
      const int e = c * 32 + lane;
      const bool ok = e < nvec;
      float q[VEC], ks[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        q[i] = ok ? q_s[e * VEC + i] : 0.f;
        if (SCALED) ks[i] = ok ? kscale[e * VEC + i] : 1.f;
      }
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
        for (int i = 0; i < VEC; ++i)
          acc[u] = fmaf(q[i], SCALED ? kv[i] * ks[i] : kv[i], acc[u]);
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
__device__ inline void softmax_rows(float* att, int ld, int H, int n) {
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

// out_s[d] = sum_{l < n} round_TP(att[head(d) * ld + l]) * (rows[l][d] * vscale[d])
// (without SCALED: vscale unread, 1; TP = float leaves the probabilities
// unrounded).
// Threads run along the channel dim in 16-byte groups and split the rows
// when there are threads to spare. Needs NTHREADS * VEC floats of part_s.
// Ends with a block barrier.
template <typename TP, typename TR, bool SCALED>
__device__ void attn_pv(const float* att, int ld, int n, const TR* rows, int D,
                        int dh, const float* vscale, float* out_s, float* part_s) {
  constexpr int VEC = Elem<TR>::VEC;
  const int tid = threadIdx.x;
  const int ncol = D / VEC;        // <= NTHREADS (checked on the host)
  const int slices = NTHREADS / ncol;
  const int cg = tid % ncol;
  const int sl = tid / ncol;
  if (sl < slices) {
    const float* p = att + ((cg * VEC) / dh) * ld;
    float acc[VEC], vs[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      acc[i] = 0.f;
      if (SCALED) vs[i] = vscale[cg * VEC + i];
    }
    const TR* vp = rows + (size_t)cg * VEC;
    int l = sl;
    for (; l + (LOADS_IN_FLIGHT - 1) * slices < n; l += LOADS_IN_FLIGHT * slices) {
      uint4 raw[LOADS_IN_FLIGHT];
#pragma unroll
      for (int u = 0; u < LOADS_IN_FLIGHT; ++u)
        raw[u] = load_raw(vp + (size_t)(l + u * slices) * D);
#pragma unroll
      for (int u = 0; u < LOADS_IN_FLIGHT; ++u) {
        float v[VEC];
        Elem<TR>::unpack(raw[u], v);
        const float pr = Elem<TP>::round(p[l + u * slices]);
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          acc[i] = fmaf(pr, SCALED ? v[i] * vs[i] : v[i], acc[i]);
      }
    }
    for (; l < n; l += slices) {
      float v[VEC];
      Elem<TR>::unpack(load_raw(vp + (size_t)l * D), v);
      const float pr = Elem<TP>::round(p[l]);
#pragma unroll
      for (int i = 0; i < VEC; ++i)
          acc[i] = fmaf(pr, SCALED ? v[i] * vs[i] : v[i], acc[i]);
    }
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

// The operands of one layer. For K3 these point at layer 0 of the stacked
// arrays and `at_layer` advances them.
template <typename T, typename TW, typename TKV>
struct LayerOperands {
  const TW* w[6];      // wqkv [D,3D], wso, wcq, wco [D,D], wf1 [D,F], wf2 [F,D]
  const float* b[6];   // biases [out]
  const float* s[6];   // per-output-channel weight scales [out] (int8 weights)
  const float* rw;     // [2]: resweight, resweight_src
  T* ck; T* cv;        // [B, L, D] self cache, updated in place at index
  const TKV* mk;       // [B, S, D] cross K/V
  const TKV* mv;
  const float* sk;     // [D] per-channel cross-K/V scales (int8 K/V)
  const float* sv;
};

struct StepDims {
  int B, D, F, H, L, S, index, n_layers;
  float scale;         // 1 / sqrt(D / H)
};

template <typename T, typename TW, typename TKV>
struct StepParams {
  const T* x;                      // [B, D]
  LayerOperands<T, TW, TKV> op;
  const float* bias;               // [B, S] additive pad bias
  T* x_out;                        // [B, D]
  float* attn_out;                 // [B, S]
  StepDims dims;
};

// Order of the pointer table the host passes (x, the operands, bias, outputs).
constexpr int N_PTRS = 29;

template <typename T, typename TW, typename TKV>
StepParams<T, TW, TKV> params_from(const void* const* ptr, const int* dims,
                                   float scale) {
  StepParams<T, TW, TKV> p;
  p.x = (const T*)ptr[0];
  for (int i = 0; i < 6; ++i) {
    p.op.w[i] = (const TW*)ptr[1 + i];
    p.op.b[i] = (const float*)ptr[7 + i];
    p.op.s[i] = (const float*)ptr[13 + i];
  }
  p.op.rw = (const float*)ptr[19];
  p.op.ck = (T*)ptr[20];
  p.op.cv = (T*)ptr[21];
  p.op.mk = (const TKV*)ptr[22];
  p.op.mv = (const TKV*)ptr[23];
  p.op.sk = (const float*)ptr[24];
  p.op.sv = (const float*)ptr[25];
  p.bias = (const float*)ptr[26];
  p.x_out = (T*)ptr[27];
  p.attn_out = (float*)ptr[28];
  p.dims.B = dims[0]; p.dims.D = dims[1]; p.dims.F = dims[2]; p.dims.H = dims[3];
  p.dims.L = dims[4]; p.dims.S = dims[5]; p.dims.index = dims[6];
  p.dims.n_layers = dims[7];
  p.dims.scale = scale;
  return p;
}

// Shared-memory plan of one block, in floats.
struct Smem {
  float* xs;        // [D]  f32 residual stream (T-valued between layers)
  float* vin;       // [W]  input of the next product
  float* vout;      // [W]  f32 output of the last product
  float* att;       // [H, LS] logits -> probabilities
  float* part;      // [NTHREADS * VEC] partial sums
  float* attn_acc;  // [S]  attn accumulated over heads (and layers)
  int LS;
};

template <typename T, typename TW, typename TKV>
__host__ __device__ inline size_t smem_floats(const StepDims& d) {
  return (size_t)d.D + 2 * (size_t)imax(3 * d.D, d.F) +
         (size_t)d.H * imax(d.L, d.S) +
         (size_t)NTHREADS * max_vec<T, TW, TKV>() + (size_t)d.S;
}

template <typename T, typename TW, typename TKV>
__device__ inline Smem smem_plan(float* base, const StepDims& d) {
  Smem m;
  const int W = imax(3 * d.D, d.F);
  m.LS = imax(d.L, d.S);
  m.xs = base;
  m.vin = m.xs + d.D;
  m.vout = m.vin + W;
  m.att = m.vout + W;
  m.part = m.att + d.H * m.LS;
  m.attn_acc = m.part + NTHREADS * max_vec<T, TW, TKV>();
  return m;
}

// One decoder layer for lane b. On entry xs and vin hold the layer's input
// (T-valued); on exit both hold round_T(x3), and (sum_h p_h) / attn_div has
// been added to attn_acc. Ends with a block barrier.
template <typename T, typename TW, typename TKV, bool STACKED>
__device__ void layer_body(const LayerOperands<T, TW, TKV>& a, int b,
                           const StepDims& dm, const float* bias_row,
                           const Smem& m, float attn_div) {
  using E = Elem<T>;
  using TP = typename std::conditional<STACKED, float, T>::type;
  constexpr bool W8 = std::is_same<TW, int8_t>::value;    // scales are read
  constexpr bool KV8 = std::is_same<TKV, int8_t>::value;  // only for int8
  const int D = dm.D, F = dm.F, H = dm.H, S = dm.S, L = dm.L;
  const int dh = D / H;
  const int tid = threadIdx.x;
  const float rw = a.rw[0];
  const float rw_src = a.rw[1];
  float* xs = m.xs;
  float* vin = m.vin;
  float* vout = m.vout;

  // ---- self-attention ---------------------------------------------------
  gemv<TW, W8>(vin, D, a.w[0], 3 * D, a.b[0], a.s[0], vout, m.part);
  T* ck = a.ck + (size_t)b * L * D;
  T* cv = a.cv + (size_t)b * L * D;
  for (int d = tid; d < D; d += NTHREADS) {
    ck[(size_t)dm.index * D + d] = E::from_f(vout[D + d]);
    cv[(size_t)dm.index * D + d] = E::from_f(vout[2 * D + d]);
    const float q = vout[d] * dm.scale;
    vin[d] = STACKED ? q : E::round(q);
  }
  __syncthreads();  // the row just written is read below
  const int n_self = dm.index + 1;  // positions > index are masked out
  attn_logits<T, false>(vin, ck, n_self, D, dh, m.att, m.LS, nullptr, nullptr);
  softmax_rows(m.att, m.LS, H, n_self);
  attn_pv<TP, T, false>(m.att, m.LS, n_self, cv, D, dh, nullptr, vout, m.part);
  for (int d = tid; d < D; d += NTHREADS) vin[d] = E::round(vout[d]);
  __syncthreads();
  gemv<TW, W8>(vin, D, a.w[1], D, a.b[1], a.s[1], vout, m.part);
  for (int d = tid; d < D; d += NTHREADS) {
    const float x1 = xs[d] + vout[d] * rw;
    xs[d] = x1;
    vin[d] = E::round(x1);
  }
  __syncthreads();

  // ---- cross-attention over the precomputed window K/V --------------------
  gemv<TW, W8>(vin, D, a.w[2], D, a.b[2], a.s[2], vout, m.part);
  for (int d = tid; d < D; d += NTHREADS) {
    float q = vout[d] * dm.scale;
    if (!STACKED && KV8) q = q * a.sk[d];   // K1: the K scale folds into q
    vin[d] = STACKED ? q : E::round(q);
  }
  __syncthreads();
  const TKV* mk = a.mk + (size_t)b * S * D;
  const TKV* mv = a.mv + (size_t)b * S * D;
  // K3 dequantizes the K/V entries inside the products
  attn_logits<TKV, STACKED && KV8>(vin, mk, S, D, dh, m.att, m.LS, bias_row, a.sk);
  softmax_rows(m.att, m.LS, H, S);
  for (int s = tid; s < S; s += NTHREADS) {
    float acc = 0.f;
    for (int h = 0; h < H; ++h) acc += m.att[h * m.LS + s];
    m.attn_acc[s] += acc / attn_div;
  }
  attn_pv<TP, TKV, STACKED && KV8>(m.att, m.LS, S, mv, D, dh, a.sv, vout, m.part);
  for (int d = tid; d < D; d += NTHREADS) {
    float c = vout[d];
    if (!STACKED && KV8) c = c * a.sv[d];   // K1: the V scale after the sum
    vin[d] = E::round(c);
  }
  __syncthreads();
  gemv<TW, W8>(vin, D, a.w[3], D, a.b[3], a.s[3], vout, m.part);
  for (int d = tid; d < D; d += NTHREADS) {
    const float x2 = xs[d] + vout[d] * rw_src;
    xs[d] = x2;
    vin[d] = E::round(x2);
  }
  __syncthreads();

  // ---- feed-forward -------------------------------------------------------
  gemv<TW, W8>(vin, D, a.w[4], F, a.b[4], a.s[4], vout, m.part);
  for (int j = tid; j < F; j += NTHREADS) vin[j] = E::round(fmaxf(vout[j], 0.f));
  __syncthreads();
  gemv<TW, W8>(vin, F, a.w[5], D, a.b[5], a.s[5], vout, m.part);
  for (int d = tid; d < D; d += NTHREADS) {
    const float x3 = E::round(xs[d] + vout[d] * rw);
    xs[d] = x3;
    vin[d] = x3;
  }
  __syncthreads();
}

// Loads lane b's input into xs / vin and zeroes attn_acc. Ends with a barrier.
template <typename T>
__device__ inline void load_lane(const T* x, int b, int D, int S, const Smem& m) {
  for (int d = threadIdx.x; d < D; d += NTHREADS) {
    const float v = Elem<T>::to_f(x[(size_t)b * D + d]);
    m.xs[d] = v;
    m.vin[d] = v;
  }
  for (int s = threadIdx.x; s < S; s += NTHREADS) m.attn_acc[s] = 0.f;
  __syncthreads();
}

// Writes lane b's hidden and attn rows.
template <typename T>
__device__ inline void store_lane(T* x_out, float* attn_out, int b, int D, int S,
                                  const Smem& m) {
  for (int d = threadIdx.x; d < D; d += NTHREADS)
    x_out[(size_t)b * D + d] = Elem<T>::from_f(m.xs[d]);
  for (int s = threadIdx.x; s < S; s += NTHREADS)
    attn_out[(size_t)b * S + s] = m.attn_acc[s];
}

// Shape checks shared by both launches: 16-byte rows and column groups for
// every operand's type, a head spanning a power-of-two lane count.
template <typename T, typename TW, typename TKV>
bool shapes_ok(const StepDims& d) {
  if (d.B <= 0 || d.D <= 0 || d.H <= 0 || d.D % d.H != 0 || d.index < 0 ||
      d.index >= d.L || d.S <= 0 || d.F <= 0 || d.n_layers <= 0)
    return false;
  const int dh = d.D / d.H;
  auto rows_ok = [&](int vec) {
    const int lph = dh / vec;
    return d.D % vec == 0 && dh % vec == 0 && lph >= 1 && lph <= 32 &&
           (lph & (lph - 1)) == 0 && d.D / vec <= NTHREADS;
  };
  constexpr int VT = Elem<T>::VEC, VW = Elem<TW>::VEC, VKV = Elem<TKV>::VEC;
  return rows_ok(VT) && rows_ok(VKV) && d.D % VW == 0 && d.F % VW == 0 &&
         d.F % VT == 0;
}

// Allows `kernel` `smem` bytes of dynamic shared memory on the current
// device; `allowed` remembers per device what was set, so the call is not
// repeated on every launch.
inline int allow_smem(const void* kernel, size_t smem, size_t* allowed,
                      int max_devices) {
  if (smem <= 48 * 1024) return 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < max_devices && smem <= allowed[dev]) return 0;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (dev < max_devices) allowed[dev] = smem;
  return 0;
}

template <typename X>
struct Tag {
  using type = X;
};

// Calls run(Tag<T>, Tag<TW>, Tag<TKV>) for dtype (0 = float32, 1 = bfloat16
// storage), w8 (int8 weights) and kv8 (int8 cross K/V).
template <typename Run>
int dispatch_types(int dtype, int w8, int kv8, Run run) {
  auto by_t = [&](auto t) {
    using T = typename decltype(t)::type;
    if (!w8 && !kv8) return run(t, Tag<T>(), Tag<T>());
    if (!w8 && kv8) return run(t, Tag<T>(), Tag<int8_t>());
    if (w8 && !kv8) return run(t, Tag<int8_t>(), Tag<T>());
    return run(t, Tag<int8_t>(), Tag<int8_t>());
  };
  if (dtype == 0) return by_t(Tag<float>());
  if (dtype == 1) return by_t(Tag<__nv_bfloat16>());
  return (int)cudaErrorInvalidValue;
}

}  // namespace
