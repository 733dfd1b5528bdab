// K3: stacked decoder step — every layer of the decoder for one new token per
// lane, in one launch. Replaces the TPU kernel `stacked_decoder_step` /
// `_stacked_step_kernel` of tal_asrd_tpu/ops/pallas_decode_stacked.py.
//
// The function is decode_step.cuh's layer (ReZero self-attention over the
// cache, cross-attention over the window K/V, feed-forward) for n_layers
// layers, at the TPU kernel's own rounding points: f32 queries and
// probabilities; under kv8 the cross K/V dequantized per element (k * sk,
// v * sv) inside the products; every weight product takes its input rounded
// to T, with exact products and f32 sums, and a w8 scale multiplies the f32
// sum; the hidden rounded to T at the end of each layer and re-read by the
// next; attn the mean of the probabilities over heads and layers.
//
// What bounds it on an H100: bytes. A 2x step (D = 512, 4 layers, B = 32,
// S = 340) reads 29.4 MB of bf16 weights, 89 MB of cross K/V and the live self
// cache, and does about 2 operations per weight byte per lane.
//
// Design: the cluster kernel of cluster_step.cuh at K3's points
// (Points::K3); the layers run one after another inside the launch, the hidden
// carried in the clusters' shared memory.
#include "cluster_step.cuh"

// See cluster_step (cluster_step.cuh) for the arguments; every operand
// carries a leading layer axis of n_layers = dims[7].
extern "C" int tal_stacked_step(int dtype, int w8, int kv8, const void* const* ptrs,
                                const int* dims, float scale, int group, int cluster,
                                int clusters, void* stream) {
  return cluster_step<Points::K3>(dtype, w8, kv8, ptrs, dims, scale, group, cluster,
                                  clusters, stream);
}

// How many clusters of `cluster` CTAs of K3's instantiation the current
// device holds at once, in *slots (cluster_slots, cluster_step.cuh).
extern "C" int tal_stacked_cluster_slots(int dtype, int w8, int kv8, const int* dims,
                                         int group, int cluster, int* slots) {
  return cluster_slots<Points::K3>(dtype, w8, kv8, dims, group, cluster, slots);
}
