// K2: fused mel projection + log for the log-mel frontend. Replaces the TPU
// kernel `fused_logmel_project` / `_logmel_kernel` of
// tal_asrd_tpu/ops/pallas_kernels.py.
//
//   out[n, m] = logf( sum_f power[n, f] * fb[f, m] + eps )
//
// power [N, F] f32 row-major, fb [F, M] f32 row-major, out [N, M] f32. The
// mel energies live only in registers between the product and the log.
//
// The product runs on the tensor cores in 3xTF32: each f32 operand x is split
// into big (x to TF32 precision) and small = x - big, and a * b is taken as
// a_small * b_big + a_big * b_small + a_big * b_big (mma.sync m16n8k8 tf32,
// f32 accumulators); the dropped a_small * b_small and the TF32 reading of
// small are each below 2^-21 of the product. Every product and every sum is
// of non-negative terms (a power spectrum and a filterbank), so the sum
// carries the relative error of its terms, about 1e-6, and the log that
// error as an absolute one.
//
// What bounds it on an H100: device memory. 281 floats move per frame; the
// 3 x 2 * 201 * 80 operations per frame take less time at the TF32 rate
// (494.7 TFLOP/s) than the bytes at 3.35 TB/s. (The exact-FMA design of this
// kernel, a CUDA-core GEMM with 4 x 4 register tiles, scripts/
// k2_exact_fma.cu, reaches 28 % of the f32 FMA rate on an H100; by its
// instruction mix shared memory limits it: a 16-byte load takes a warp four
// cycles, twice its FMAs' time.)
//
// Design: a persistent grid, one block per SM of 4 x M / 16 warps (20 at
// M = 80: with few warps an SM cannot hide the latency of a k-step's loads,
// splits and dependent mma).
// - The filterbank is staged once per block, rows padded with zeros to FP
//   (F rounded up to a multiple of 8: 208 at F = 201) at a row stride
//   MS = M + 8 (MS % 32 is 8 or 24: 88 at M = 80), which makes each warp's
//   B-fragment loads hit 32 different banks.
// - The block walks over tiles of 64 frames. A tile is one contiguous run of
//   64 x F floats (51,456 bytes at F = 201, a multiple of 16), which one
//   thread moves into shared memory with a 1D bulk copy (cp.async.bulk,
//   completed on an mbarrier), double-buffered: tile t + 1 loads while tile
//   t computes. The tile keeps the row stride F; at F = 201 the A-fragment
//   loads meet at most 2-way bank conflicts. Rows of a ragged last tile past
//   a multiple of 4 (a bulk copy moves multiples of 16 bytes), and every row
//   when `power` is not 16-byte aligned, take 4-byte cp.async copies. The
//   block's first copy is issued before the filterbank is staged. In the
//   last k-step the A values past F (the next row's first values) are zeroed
//   in registers and the filterbank's pad rows are zero, so the padded
//   frequencies add exact zeros.
// - Warp w computes 16 frames (m-tile w % 4) x 16 mels (w / 4): per 8
//   frequencies it loads and splits one A fragment and two B fragments, and
//   issues 3 mma for each of its two n-tiles.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int TILE_N = 64;             // frames per tile
constexpr int NT = 2;                  // n-tiles (8 mels) per warp
constexpr int MAX_MELS = 128;          // 4 x 128 / 16 = 32 warps

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}

// One arrival that also expects `bytes` of bulk copies, then the copy.
__device__ __forceinline__ void bulk_load(float* dst, const float* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}

// x = big + small: big is x to 11 significant bits (Veltkamp's split, exact
// in TF32), small = x - big exactly, which the tensor core reads to TF32 by
// dropping its low bits. Full-rate f32 arithmetic, never contracted into
// FMAs (the _rn intrinsics). Exact for |x| below 2^114.
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  const float c = __fmul_rn(x, 8193.0f);              // 2^13 + 1
  const float hi = __fsub_rn(c, __fsub_rn(c, x));
  big = __float_as_uint(hi);
  small = __float_as_uint(__fsub_rn(x, hi));
}

// Not volatile: independent products may be reordered around each other.
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Issues the copy of frames [row0, row0 + rows) into dst (row stride f):
// thread 0 bulk-copies the first rows in a multiple of 4 (all of them when
// `bulk`) and arrives on bar; every thread copies the rest with 4-byte
// cp.async. The caller commits the cp.async group.
__device__ __forceinline__ void load_tile(const float* __restrict__ power, long long row0,
                                          int rows, int f, bool bulk, float* dst,
                                          uint64_t* bar) {
  const int bulk_rows = bulk ? rows & ~3 : 0;
  if (threadIdx.x == 0) {
    // the block's reads of dst (ordered by the caller's barrier) precede the copy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    if (bulk_rows > 0)
      bulk_load(dst, power + row0 * f, (unsigned)(bulk_rows * f * sizeof(float)), bar);
    else
      mbar_arrive(bar);
  }
  const float* src = power + row0 * f;
  for (int i = bulk_rows * f + threadIdx.x; i < rows * f; i += blockDim.x)
    cp_async4(dst + i, src + i);
}

__global__ void __launch_bounds__(1024, 1)
logmel_project_kernel(const float* __restrict__ power, const float* __restrict__ fb,
                      float* __restrict__ out, long long n, int f, int fp, int m, int ms,
                      float eps) {
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) uint64_t bars[2];
  const int tsize = TILE_N * f + 8;                     // + what the last k-step of row 63 reads
  const int tstride = (tsize + 3) / 4 * 4;
  float* fb_s = smem;                                   // [fp, ms]
  float* tiles[2] = {smem + (size_t)fp * ms, smem + (size_t)fp * ms + tstride};
  const int tid = threadIdx.x;
  const bool bulk = ((uintptr_t)power & 15) == 0;

  if (tid == 0) {
    mbar_init(&bars[0]);
    mbar_init(&bars[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();      // the barriers are initialised before a copy arrives on them

  // the first tile's copy flies while the filterbank is staged
  const long long n_tiles = (n + TILE_N - 1) / TILE_N;
  long long tile = blockIdx.x;
  if (tile < n_tiles)
    load_tile(power, tile * TILE_N, (int)min((long long)TILE_N, n - tile * TILE_N), f, bulk,
              tiles[0], &bars[0]);
  // the filterbank, rows re-strided to ms with 16-byte copies (m % 16 == 0);
  // pad rows zero
  const int m4 = m / 4;
  for (int i = tid; i < f * m4; i += blockDim.x) {
    const int k = i / m4, c = i - k * m4;
    cp_async16(fb_s + k * ms + 4 * c, fb + (size_t)k * m + 4 * c);
  }
  for (int i = f * ms + tid; i < fp * ms; i += blockDim.x) fb_s[i] = 0.f;
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int mrow = (warp & 3) * 16;                     // the warp's m-tile
  const int ncol = (warp >> 2) * 8 * NT;                // the warp's first mel

  int buf = 0;
  unsigned parity[2] = {0u, 0u};
  for (; tile < n_tiles; tile += gridDim.x) {
    const long long next = tile + gridDim.x;
    if (next < n_tiles)
      load_tile(power, next * TILE_N, (int)min((long long)TILE_N, n - next * TILE_N), f,
                bulk, tiles[buf ^ 1], &bars[buf ^ 1]);
    cp_async_commit();
    mbar_wait(&bars[buf], parity[buf]);   // this tile's bulk copy has landed
    parity[buf] ^= 1u;
    cp_async_wait<1>();      // ... and its 4-byte copies
    __syncthreads();

    const float* a_s = tiles[buf] + (size_t)(mrow + g) * f + t;
    const float* b_s = fb_s + (size_t)t * ms + ncol + g;
    float acc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[j][r] = 0.f;
    // one k-step of 8 frequencies; in the last, partial one the A values past
    // F (the next row's, or stale ones) are zeroed before their product
    auto k_step = [&](int k0, bool tail) {
      uint32_t a_big[4], a_small[4];
      const float a0 = a_s[k0], a1 = a_s[8 * f + k0], a2 = a_s[k0 + 4], a3 = a_s[8 * f + k0 + 4];
      const bool lo = !tail || k0 + t < f, hi = !tail || k0 + t + 4 < f;
      split(lo ? a0 : 0.f, a_big[0], a_small[0]);
      split(lo ? a1 : 0.f, a_big[1], a_small[1]);
      split(hi ? a2 : 0.f, a_big[2], a_small[2]);
      split(hi ? a3 : 0.f, a_big[3], a_small[3]);
      const float* bk = b_s + (size_t)k0 * ms;
      uint32_t b_big[NT][2], b_small[NT][2];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        {
          split(bk[8 * j], b_big[j][0], b_small[j][0]);
          split(bk[4 * ms + 8 * j], b_big[j][1], b_small[j][1]);
        }
      }
      // the small terms first, each pass over independent accumulators
#pragma unroll
      for (int j = 0; j < NT; ++j)
        mma_tf32(acc[j], a_small, b_big[j][0], b_big[j][1]);
#pragma unroll
      for (int j = 0; j < NT; ++j)
        mma_tf32(acc[j], a_big, b_small[j][0], b_small[j][1]);
#pragma unroll
      for (int j = 0; j < NT; ++j)
        mma_tf32(acc[j], a_big, b_big[j][0], b_big[j][1]);
    };
    const int f_full = f / 8 * 8;
#pragma unroll 2
    for (int k0 = 0; k0 < f_full; k0 += 8) k_step(k0, false);
    if (f_full < fp) k_step(f_full, true);

    const long long row0 = tile * TILE_N + mrow + g;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = ncol + 8 * j + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long row = row0 + 8 * h;
        if (row < n)
          __stcs(reinterpret_cast<float2*>(out + row * m + col),
                 make_float2(logf(acc[j][2 * h] + eps), logf(acc[j][2 * h + 1] + eps)));
      }
    }
    __syncthreads();         // tiles[buf] is free for the copy issued next
    buf ^= 1;
  }
  cp_async_wait<0>();
}

// The padded sizes of a launch: fp frequencies (F in 8s) and the filterbank
// row stride ms, and the shared memory in bytes.
size_t plan_smem(int f, int m, int* fp, int* ms) {
  *fp = (f + 7) / 8 * 8;
  *ms = m + 8;                          // ms % 32 in {8, 24}: conflict-free B loads
  const size_t tstride = ((size_t)TILE_N * f + 8 + 3) / 4 * 4;
  return ((size_t)*fp * *ms + 2 * tstride) * sizeof(float);
}

}  // namespace

// Returns cudaGetLastError() of the launch (0 = ok), or
// cudaErrorInvalidConfiguration for m not a multiple of 16 or above 128, or a
// filterbank that does not fit in shared memory. `max_blocks` is the SM
// count: one block per SM walks over the tiles.
extern "C" int tal_logmel_project(const void* power, const void* fb, void* out,
                                  long long n, int f, int m, float eps,
                                  int max_blocks, void* stream) {
  if (n <= 0) return 0;
  if (f <= 0 || m <= 0 || m % 16 != 0 || m > MAX_MELS || max_blocks <= 0)
    return (int)cudaErrorInvalidConfiguration;
  int fp = 0, ms = 0;
  const size_t smem = plan_smem(f, m, &fp, &ms);
  if (smem > 232448) return (int)cudaErrorInvalidConfiguration;
  // the shared-memory allowance, set once per device and size (a driver call
  // on every launch would cost the host more than a small launch runs)
  constexpr int MAX_DEVICES = 64;
  static size_t allowed[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES || smem > allowed[dev]) {
    err = cudaFuncSetAttribute(logmel_project_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < MAX_DEVICES) allowed[dev] = smem;
  }
  const long long n_tiles = (n + TILE_N - 1) / TILE_N;
  const int blocks = (int)(n_tiles < max_blocks ? n_tiles : max_blocks);
  logmel_project_kernel<<<blocks, 4 * (m / (8 * NT)) * 32, smem, (cudaStream_t)stream>>>(
      (const float*)power, (const float*)fb, (float*)out, n, f, fp, m, ms, eps);
  return (int)cudaGetLastError();
}
