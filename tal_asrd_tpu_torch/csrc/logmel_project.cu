// Fused mel projection + log for the log-mel frontend.
//
//   out[n, m] = logf( sum_f power[n, f] * fb[f, m] + eps )
//
// power [N, F] f32 row-major, fb [F, M] f32 row-major, out [N, M] f32; f32
// accumulation. The mel energies live only in registers between the product
// and the log.
//
// Design: the filterbank (F*M floats, 64 KB at 201 x 80) is staged once per
// block in dynamic shared memory; a block then walks over tiles of TILE_N
// frames (grid-stride), copying each tile of `power` into shared memory with
// coalesced loads. Threads are laid out as M mel columns x ROW_GROUPS row
// groups; a thread keeps TILE_N / ROW_GROUPS accumulators for one mel column,
// so the filterbank value it loads per frequency is reused across its rows and
// the power values are shared-memory broadcasts. Stores are coalesced along m.
#include <cuda_runtime.h>

namespace {

constexpr int TILE_N = 32;       // frames per tile
constexpr int ROW_GROUPS = 4;    // thread rows; TILE_N / ROW_GROUPS frames each
constexpr int ROWS_PER_THREAD = TILE_N / ROW_GROUPS;

__global__ void logmel_project_kernel(const float* __restrict__ power,
                                      const float* __restrict__ fb,
                                      float* __restrict__ out,
                                      long long n, int f, int m, float eps) {
  extern __shared__ float smem[];
  float* fb_s = smem;                 // [f * m]
  float* pw_s = smem + (size_t)f * m; // [TILE_N * f]

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;    // == m * ROW_GROUPS
  for (int i = tid; i < f * m; i += nthreads) fb_s[i] = fb[i];

  const int col = tid % m;
  const int grp = tid / m;
  const long long n_tiles = (n + TILE_N - 1) / TILE_N;

  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long row0 = tile * TILE_N;
    const int rows = (int)((n - row0 < TILE_N) ? (n - row0) : TILE_N);
    __syncthreads();  // fb_s ready; previous tile's pw_s no longer read
    const float* src = power + row0 * f;
    for (int i = tid; i < rows * f; i += nthreads) pw_s[i] = src[i];
    for (int i = rows * f + tid; i < TILE_N * f; i += nthreads) pw_s[i] = 0.f;
    __syncthreads();

    float acc[ROWS_PER_THREAD];
#pragma unroll
    for (int r = 0; r < ROWS_PER_THREAD; ++r) acc[r] = 0.f;
    const float* pw = pw_s + (size_t)grp * ROWS_PER_THREAD * f;
    for (int k = 0; k < f; ++k) {
      const float w = fb_s[k * m + col];
#pragma unroll
      for (int r = 0; r < ROWS_PER_THREAD; ++r)
        acc[r] = fmaf(pw[r * f + k], w, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < ROWS_PER_THREAD; ++r) {
      const int row = grp * ROWS_PER_THREAD + r;
      if (row < rows) out[(row0 + row) * m + col] = logf(acc[r] + eps);
    }
  }
}

}  // namespace

// Returns cudaGetLastError() of the launch (0 = ok). Requires
// m * ROW_GROUPS <= 1024 threads and (f*m + TILE_N*f) floats of shared memory.
extern "C" int tal_logmel_project(const void* power, const void* fb, void* out,
                                  long long n, int f, int m, float eps,
                                  int max_blocks, void* stream) {
  if (n <= 0) return 0;
  const int threads = m * ROW_GROUPS;
  if (threads > 1024 || threads <= 0) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = ((size_t)f * m + (size_t)TILE_N * f) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      logmel_project_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long n_tiles = (n + TILE_N - 1) / TILE_N;
  const int blocks = (int)(n_tiles < max_blocks ? n_tiles : max_blocks);
  logmel_project_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      (const float*)power, (const float*)fb, (float*)out, n, f, m, eps);
  return (int)cudaGetLastError();
}
