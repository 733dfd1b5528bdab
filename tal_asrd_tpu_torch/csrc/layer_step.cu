// K1: fused decoder layer step — one ReZero decoder layer for one new token
// per lane, in one launch. Replaces the TPU kernel `fused_layer_step` /
// `_layer_step_kernel` of tal_asrd_tpu/ops/pallas_decode.py.
//
// The layer's arithmetic and its rounding points are in decode_step.cuh (K1:
// the scaled query and the probabilities rounded to T before their products;
// under kv8 the K scale folded into the query before that rounding and the V
// scale on the f32 PV sum). Storage types: activations and self cache float
// or bf16; weights the same or int8 with per-output-channel f32 scales (w8);
// cross K/V the same or int8 with per-channel f32 scales (kv8).
//
// What bounds it on an H100: bytes. One launch does about 2 operations per
// weight byte per lane, far below the card's ~295 operations per byte in
// bf16, so the floor is the traffic: the layer's weights (14*D^2 elements,
// 7.3 MB for a 2x layer in bf16), the lanes' cross K/V (2*B*S*D) and the live
// part of the self cache. int8 weights or K/V halve their share of it.
//
// Design: the cluster kernel of cluster_step.cuh with n_layers = 1, at K1's
// points (Points::K1). A cluster of up to 16 CTAs owns a group of lanes,
// reads every weight once per cluster on the tensor cores (bf16) and
// splits the attentions by (lane, head) across its CTAs; on an H100 7
// clusters of 16 CTAs cover B = 8 to 56 lanes in one wave.
#include "cluster_step.cuh"

// See cluster_step (cluster_step.cuh) for the arguments; dims[7] (n_layers)
// must be 1, and every operand carries a leading layer axis of 1 (that is,
// none: [B, L, D] caches, [B, S, D] cross K/V, [D] scales, rw [2]).
extern "C" int tal_layer_step(int dtype, int w8, int kv8, const void* const* ptrs,
                              const int* dims, float scale, int group, int cluster,
                              int clusters, void* stream) {
  if (dims[7] != 1) return (int)cudaErrorInvalidValue;
  return cluster_step<Points::K1>(dtype, w8, kv8, ptrs, dims, scale, group, cluster,
                                  clusters, stream);
}

// How many clusters of `cluster` CTAs of K1's instantiation the current
// device holds at once, in *slots (cluster_slots, cluster_step.cuh).
extern "C" int tal_layer_cluster_slots(int dtype, int w8, int kv8, const int* dims,
                                       int group, int cluster, int* slots) {
  return cluster_slots<Points::K1>(dtype, w8, kv8, dims, group, cluster, slots);
}
