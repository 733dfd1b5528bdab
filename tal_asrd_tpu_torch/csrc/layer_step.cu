// K1: fused decoder layer step — one ReZero decoder layer for one new token
// per lane, in one launch. Replaces the TPU kernel `fused_layer_step` /
// `_layer_step_kernel` of tal_asrd_tpu/ops/pallas_decode.py.
//
// The layer's arithmetic, its rounding points and the device functions it is
// built from are in decode_step.cuh (STACKED = false there). Storage types:
// activations and self cache float or bf16; weights the same or int8 with
// per-output-channel f32 scales (w8); cross K/V the same or int8 with
// per-channel f32 scales (kv8).
//
// What bounds it on an H100: bytes. One launch does about 2 operations per
// weight byte per lane (a GEMV per lane), far below the card's ~295
// operations per byte in bf16, so the floor is the traffic: the layer's
// weights (14*D^2 elements), the lanes' cross K/V (2*B*S*D) and the live
// part of the self cache. int8 weights or K/V halve their share of it. The
// design keeps every intermediate in shared memory, one thread block per lane
// (grid = B, NTHREADS threads), writes the cache with an indexed store of one
// row, reads only its live rows, and streams weights and K/V with coalesced
// 16-byte loads. Weights do not fit an SM's shared memory (a 2x layer has
// 6.3 MB in bf16), so every block re-reads them through L2, and only B of the
// card's SMs are busy: what a later, faster version changes.
#include "decode_step.cuh"

namespace {

template <typename T, typename TW, typename TKV>
__global__ void __launch_bounds__(NTHREADS)
layer_step_kernel(const StepParams<T, TW, TKV> p) {
  extern __shared__ __align__(16) float smem[];
  const Smem m = smem_plan<T, TW, TKV>(smem, p.dims);
  const int b = blockIdx.x;
  load_lane(p.x, b, p.dims.D, p.dims.S, m);
  layer_body<T, TW, TKV, false>(p.op, b, p.dims, p.bias + (size_t)b * p.dims.S,
                                m, (float)p.dims.H);
  store_lane(p.x_out, p.attn_out, b, p.dims.D, p.dims.S, m);
}

template <typename T, typename TW, typename TKV>
int launch(const StepParams<T, TW, TKV>& p, cudaStream_t stream) {
  if (p.dims.n_layers != 1 || !shapes_ok<T, TW, TKV>(p.dims))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_floats<T, TW, TKV>(p.dims) * sizeof(float);
  constexpr int MAX_DEVICES = 64;
  static size_t allowed[MAX_DEVICES] = {};
  const int err = allow_smem((const void*)layer_step_kernel<T, TW, TKV>, smem,
                             allowed, MAX_DEVICES);
  if (err != 0) return err;
  layer_step_kernel<T, TW, TKV><<<p.dims.B, NTHREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 storage; w8 / kv8: int8 weights / cross
// K/V. `ptrs` holds N_PTRS device pointers in the order of params_from
// (decode_step.cuh); `dims` = B, D, F, H, L, S, index, n_layers (= 1).
// Returns cudaGetLastError() of the launch (0 = ok) or cudaErrorInvalidValue
// for shapes or types the kernel does not take. Does not synchronise and
// allocates nothing.
extern "C" int tal_layer_step(int dtype, int w8, int kv8, const void* const* ptrs,
                              const int* dims, float scale, void* stream) {
  return dispatch_types(dtype, w8, kv8, [&](auto t, auto tw, auto tkv) {
    using T = typename decltype(t)::type;
    using TW = typename decltype(tw)::type;
    using TKV = typename decltype(tkv)::type;
    return launch(params_from<T, TW, TKV>(ptrs, dims, scale),
                  (cudaStream_t)stream);
  });
}
