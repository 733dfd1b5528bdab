// The exact-FMA design of the log-mel projection (K2), kept for
// `scripts/torch_kernel_probe.py k2-designs`, which times it beside the 3xTF32
// kernel that ships (tal_asrd_tpu_torch/csrc/logmel_project.cu). Same
// function, same argument list as tal_logmel_project; not part of the
// package's library.
//
// A persistent CUDA-core f32 GEMM: the filterbank staged once per block at
// [FP, M] (FP = F rounded to 4 with FP / 4 odd), 64-frame tiles of `power`
// double-buffered with 4-byte cp.async at row stride FP, each thread a 4 x 4
// register tile fed by 16-byte shared-memory loads, products summed in order
// of f with fmaf, the log in the epilogue.
#include <cuda_runtime.h>

namespace {

constexpr int TILE_N = 64, TM = 4, TN = 4;

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void load_tile(const float* __restrict__ power, long long row0,
                                          int rows, int f, int fp, float* dst) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  const float* src = power + row0 * f;
  for (int r = warp; r < rows; r += nwarps)
    for (int c = lane; c < f; c += 32) cp_async4(dst + r * fp + c, src + (size_t)r * f + c);
}

__global__ void __launch_bounds__(512)
exact_fma_kernel(const float* __restrict__ power, const float* __restrict__ fb,
                 float* __restrict__ out, long long n, int f, int fp, int m, float eps) {
  extern __shared__ __align__(16) float smem[];
  float* fb_s = smem;
  float* tiles[2] = {smem + (size_t)fp * m, smem + (size_t)fp * m + TILE_N * fp};
  const int tid = threadIdx.x, nthreads = blockDim.x;
  for (int i = tid; i < f * m / 4; i += nthreads) cp_async16(fb_s + 4 * i, fb + 4 * i);
  for (int i = f * m + tid; i < fp * m; i += nthreads) fb_s[i] = 0.f;
  const int pad = fp - f;
  for (int i = tid; i < 2 * TILE_N * pad; i += nthreads)
    tiles[0][(size_t)(i / pad) * fp + f + i % pad] = 0.f;
  const long long n_tiles = (n + TILE_N - 1) / TILE_N;
  long long tile = blockIdx.x;
  if (tile < n_tiles)
    load_tile(power, tile * TILE_N, (int)min((long long)TILE_N, n - tile * TILE_N), f, fp,
              tiles[0]);
  asm volatile("cp.async.commit_group;\n" ::);
  const int warp = tid >> 5, lane = tid & 31, mel_warps = m / 16;
  const int wf = warp / mel_warps, wm = warp % mel_warps, fg = lane & 7, mg = lane >> 3;
  const int frame0 = wf * 32 + fg, mel0 = wm * 16 + mg * TN;
  int buf = 0;
  for (; tile < n_tiles; tile += gridDim.x) {
    const long long next = tile + gridDim.x;
    if (next < n_tiles)
      load_tile(power, next * TILE_N, (int)min((long long)TILE_N, n - next * TILE_N), f, fp,
                tiles[buf ^ 1]);
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::);
    __syncthreads();
    const float* a_s = tiles[buf] + (size_t)frame0 * fp;
    const float* b_s = fb_s + mel0;
    float acc[TM][TN] = {};
#pragma unroll 2
    for (int k = 0; k < fp; k += 4) {
      float4 a[TM], b[4];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        a[i] = *reinterpret_cast<const float4*>(a_s + (size_t)8 * i * fp + k);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        b[kk] = *reinterpret_cast<const float4*>(b_s + (size_t)(k + kk) * m);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float bk[TN] = {b[kk].x, b[kk].y, b[kk].z, b[kk].w};
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float ak = kk == 0 ? a[i].x : kk == 1 ? a[i].y : kk == 2 ? a[i].z : a[i].w;
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(ak, bk[j], acc[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const long long row = tile * TILE_N + frame0 + 8 * i;
      if (row < n)
        __stcs(reinterpret_cast<float4*>(out + row * m + mel0),
               make_float4(logf(acc[i][0] + eps), logf(acc[i][1] + eps),
                           logf(acc[i][2] + eps), logf(acc[i][3] + eps)));
    }
    __syncthreads();
    buf ^= 1;
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
}

}  // namespace

extern "C" int tal_logmel_project_exact_fma(const void* power, const void* fb, void* out,
                                            long long n, int f, int m, float eps,
                                            int max_blocks, void* stream) {
  if (n <= 0) return 0;
  if (m % 16 != 0 || m > 128) return (int)cudaErrorInvalidConfiguration;
  int fp = (f + 3) / 4 * 4;
  if ((fp / 4) % 2 == 0) fp += 4;
  const size_t smem = ((size_t)fp * m + (size_t)2 * TILE_N * fp) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      exact_fma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long n_tiles = (n + TILE_N - 1) / TILE_N;
  const int blocks = (int)(n_tiles < max_blocks ? n_tiles : max_blocks);
  exact_fma_kernel<<<blocks, 2 * (m / 16) * 32, smem, (cudaStream_t)stream>>>(
      (const float*)power, (const float*)fb, (float*)out, n, f, fp, m, eps);
  return (int)cudaGetLastError();
}
