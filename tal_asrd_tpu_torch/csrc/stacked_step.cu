// K3: stacked decoder step — every layer of the decoder for one new token per
// lane, in one launch. Replaces the TPU kernel `stacked_decoder_step` /
// `_stacked_step_kernel` of tal_asrd_tpu/ops/pallas_decode_stacked.py.
//
// The TPU kernel walks a grid (batch block, layer) in order and carries the
// hidden and the attn mean in VMEM from one layer's grid step to the next,
// while Mosaic double-buffers the next layer's weights. Blocks on Hopper run
// in no order and carry nothing over, so the layer loop moves inside the
// block: one thread block per lane (grid = B) loops over the layers, keeping
// the lane's hidden, the attn accumulator and every intermediate in shared
// memory throughout. Layer l's weights, scales, cache slab [l, b] and cross
// K/V [l, b] are addressed by stride. Lanes are independent, so no block
// waits for another.
//
// Rounding points are the TPU kernel's own, not K1's (decode_step.cuh,
// STACKED = true): f32 queries and probabilities, cross K/V dequantized per
// element, the hidden rounded to the activation type at the end of each
// layer and re-read by the next; attn accumulates (sum_h p) / (H * n_layers)
// layer by layer.
//
// What bounds it on an H100: bytes, as for K1 — n_layers times K1's traffic
// minus the hidden's round trips between layers. This first version reads
// every layer's weights once per lane through L2 and leaves the card's other
// SMs idle; sharing one weight read between lanes and prefetching the next
// layer (cp.async / TMA) is the work of a faster version.
#include "decode_step.cuh"

namespace {

template <typename T, typename TW, typename TKV>
__device__ inline LayerOperands<T, TW, TKV> at_layer(
    const LayerOperands<T, TW, TKV>& a, int l, const StepDims& d) {
  const size_t D = d.D, F = d.F;
  const size_t w_size[6] = {D * 3 * D, D * D, D * D, D * D, D * F, F * D};
  const size_t out_size[6] = {3 * D, D, D, D, F, D};
  LayerOperands<T, TW, TKV> o = a;
  for (int i = 0; i < 6; ++i) {
    o.w[i] = a.w[i] + l * w_size[i];
    o.b[i] = a.b[i] + l * out_size[i];
    o.s[i] = a.s[i] ? a.s[i] + l * out_size[i] : nullptr;
  }
  o.rw = a.rw + 2 * l;
  const size_t slab = (size_t)l * d.B;
  o.ck = a.ck + slab * d.L * D;
  o.cv = a.cv + slab * d.L * D;
  o.mk = a.mk + slab * d.S * D;
  o.mv = a.mv + slab * d.S * D;
  o.sk = a.sk ? a.sk + l * D : nullptr;
  o.sv = a.sv ? a.sv + l * D : nullptr;
  return o;
}

template <typename T, typename TW, typename TKV>
__global__ void __launch_bounds__(NTHREADS)
stacked_step_kernel(const StepParams<T, TW, TKV> p) {
  extern __shared__ __align__(16) float smem[];
  const Smem m = smem_plan<T, TW, TKV>(smem, p.dims);
  const int b = blockIdx.x;
  const float attn_div = (float)(p.dims.H * p.dims.n_layers);
  load_lane(p.x, b, p.dims.D, p.dims.S, m);
  for (int l = 0; l < p.dims.n_layers; ++l)
    layer_body<T, TW, TKV, true>(at_layer(p.op, l, p.dims), b, p.dims,
                                 p.bias + (size_t)b * p.dims.S, m, attn_div);
  store_lane(p.x_out, p.attn_out, b, p.dims.D, p.dims.S, m);
}

template <typename T, typename TW, typename TKV>
int launch(const StepParams<T, TW, TKV>& p, cudaStream_t stream) {
  if (!shapes_ok<T, TW, TKV>(p.dims)) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_floats<T, TW, TKV>(p.dims) * sizeof(float);
  constexpr int MAX_DEVICES = 64;
  static size_t allowed[MAX_DEVICES] = {};
  const int err = allow_smem((const void*)stacked_step_kernel<T, TW, TKV>, smem,
                             allowed, MAX_DEVICES);
  if (err != 0) return err;
  stacked_step_kernel<T, TW, TKV><<<p.dims.B, NTHREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 storage; w8 / kv8: int8 weights / cross
// K/V. `ptrs` holds N_PTRS device pointers in the order of params_from
// (decode_step.cuh), each of a stacked operand [n_layers, ...]: weights,
// biases, weight scales, rw [n_layers, 2], caches [n_layers, B, L, D], cross
// K/V [n_layers, B, S, D] and their scales [n_layers, D]; scales are read
// only for int8 operands. `dims` = B, D, F, H, L, S, index,
// n_layers. Returns cudaGetLastError() of the launch (0 = ok) or
// cudaErrorInvalidValue for shapes or types the kernel does not take. Does
// not synchronise and allocates nothing.
extern "C" int tal_stacked_step(int dtype, int w8, int kv8, const void* const* ptrs,
                                const int* dims, float scale, void* stream) {
  return dispatch_types(dtype, w8, kv8, [&](auto t, auto tw, auto tkv) {
    using T = typename decltype(t)::type;
    using TW = typename decltype(tw)::type;
    using TKV = typename decltype(tkv)::type;
    return launch(params_from<T, TW, TKV>(ptrs, dims, scale),
                  (cudaStream_t)stream);
  });
}
