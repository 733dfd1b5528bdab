// Operand plumbing of the two fused decoder-step kernels, which are one
// cluster kernel (cluster_step.cuh) at two sets of rounding points:
//   K1 layer_step.cu   — one ReZero decoder layer per launch
//   K3 stacked_step.cu — every layer of the decoder in one launch
//
// One ReZero decoder layer for one new token per lane:
//
//   qkv = (x @ Wqkv) * s + b                 (fused projection)
//   cache_k[b, index] = k; cache_v[b, index] = v      (indexed store, in place)
//   sa  = softmax_h(q_h * scale . cache_k[<= index]) @ cache_v   per head
//   x1  = x + ((sa @ Wso) * s + b) * rw
//   qc  = (x1 @ Wcq) * s + b
//   p_h = softmax(qc_h * scale . mem_k * sk + bias)   per head, over S
//   attn_acc += p_h / attn_div  (head by head)        [S] f32
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
// TPU kernels they replace (cluster_step.cuh's `Points`):
//   K1: the scaled queries and the probabilities are rounded to T before
//     their products; under kv8 the K scale folds into the query before that
//     rounding and the V scale multiplies the f32 PV sum.
//   K3: queries and probabilities stay f32; the cross K/V are dequantized per
//     element (k * sk, v * sv, f32) inside the products.
// Both round the input of every weight product to T, and the layer's output
// x3 to T (K3 then feeds it to the next layer).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

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
// Unpacked without int-to-float conversions (they run at 1/8 of the FMA
// rate): the byte, offset by 128, becomes the low mantissa byte of 2^23, and
// one exact subtraction takes off 2^23 + 128.
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

// The operands, each stacked along a leading layer axis (n_layers = 1 for
// K1); the kernel advances them layer by layer.
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
  const float* sv;     // (each shape above with the leading layer axis)
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

inline StepDims dims_from(const int* dims, float scale) {
  StepDims d;
  d.B = dims[0]; d.D = dims[1]; d.F = dims[2]; d.H = dims[3];
  d.L = dims[4]; d.S = dims[5]; d.index = dims[6]; d.n_layers = dims[7];
  d.scale = scale;
  return d;
}

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
  p.dims = dims_from(dims, scale);
  return p;
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
