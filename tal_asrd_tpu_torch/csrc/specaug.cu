// SpecAugment with the spans drawn on the device (kernel K4).
//
// Replaces the TPU kernel `specaug_pallas` / `_specaug_kernel` of
// tal_asrd_tpu/ops/pallas_kernels.py, and follows the distribution of the
// function the reference's training runs, tal_asrd_tpu/ops/specaug.py
// `spec_augment`: per example n_f frequency spans and n_t time spans,
//   width ~ U{0..param-1}, start ~ U{0..dim-width-1}, length ~ U{0..width-1},
// zeroed out of spec [B, T, M] f32 into a new array (out of place).
//
// Random numbers: a counter-based 32-bit hash keyed by (seed, mask, draw),
// integers only, every product reduced mod 2^32 with multipliers below 2^31,
// so the plain version (tal_asrd_tpu_torch/ops/specaug.py, torch int64)
// draws the same spans and the two agree bit for bit. When dim <= width the
// start is 0 and the span is clipped to dim, so it stays inside [0, dim).
//
// What bounds it on an H100: it writes every value once and must read only
// the values it keeps, with a select per value, so those bytes
// (4 * (B*T*M + kept values)) over the memory rate are the floor. The design
// streams rows with 16-byte loads and stores, evict-first (the data is not
// reused), writes a row inside a time span as zeros without reading it, and
// draws each block's example's spans in the block (a few hash evaluations,
// cheaper than a second launch); no mask crosses memory. Rows are read whole,
// frequency-masked values included: 20 float4 per row of 80 mels.
//
// Grid: (tiles of ROWS time rows, examples).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_MASKS = 16;   // per axis
constexpr int MAX_MELS = 1024;  // columns a block keeps a flag for
constexpr int ROWS = 64;        // time rows per block
constexpr int THREADS = 256;

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x21f0aaadu;
  x ^= x >> 15;
  x *= 0x735a2d97u;
  x ^= x >> 15;
  return x;
}

// Span g of an example (g < n_f: frequency, else time) over an axis of
// length dim; key = mix32(seed). Writes [start, end).
__device__ void draw_span(uint32_t key, int g, int param, int dim, int* start,
                          int* end) {
  const uint32_t h0 = mix32(key ^ (uint32_t)(3 * g));
  const uint32_t h1 = mix32(key ^ (uint32_t)(3 * g + 1));
  const uint32_t h2 = mix32(key ^ (uint32_t)(3 * g + 2));
  const int width = (int)(h0 % (uint32_t)param);
  const int room = dim - width;
  const int s = room > 0 ? (int)(h1 % (uint32_t)room) : 0;
  const int len = width > 0 ? (int)(h2 % (uint32_t)width) : 0;
  *start = s;
  *end = min(s + len, dim);
}

__global__ void __launch_bounds__(THREADS)
specaug_kernel(const float* __restrict__ spec, float* __restrict__ out,
               const int* __restrict__ seeds, int t, int m, int f_param,
               int n_f, int t_param, int n_t) {
  __shared__ int span_s[2 * MAX_MASKS];
  __shared__ int span_e[2 * MAX_MASKS];
  __shared__ unsigned char keep_col[MAX_MELS];
  __shared__ unsigned char keep_row[ROWS];

  const int b = blockIdx.y;
  const int row0 = blockIdx.x * ROWS;
  const int tid = threadIdx.x;
  if (tid < n_f + n_t) {
    const uint32_t key = mix32((uint32_t)seeds[b]);
    const bool freq = tid < n_f;
    draw_span(key, tid, freq ? f_param : t_param, freq ? m : t, &span_s[tid],
              &span_e[tid]);
  }
  __syncthreads();
  for (int c = tid; c < m; c += THREADS) {
    bool keep = true;
    for (int g = 0; g < n_f; ++g) keep &= !(c >= span_s[g] && c < span_e[g]);
    keep_col[c] = keep;
  }
  if (tid < ROWS) {
    const int r = row0 + tid;
    bool keep = true;
    for (int g = n_f; g < n_f + n_t; ++g) keep &= !(r >= span_s[g] && r < span_e[g]);
    keep_row[tid] = keep;
  }
  __syncthreads();

  const int rows = min(ROWS, t - row0);
  const size_t base = ((size_t)b * t + row0) * m;
  const int mv = m / 4;
  const float4* src = reinterpret_cast<const float4*>(spec + base);
  float4* dst = reinterpret_cast<float4*>(out + base);
  for (int i = tid; i < rows * mv; i += THREADS) {
    const int r = i / mv;
    const int c = 4 * (i - r * mv);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (keep_row[r]) {
      v = __ldcs(src + i);
      v.x = keep_col[c] ? v.x : 0.f;
      v.y = keep_col[c + 1] ? v.y : 0.f;
      v.z = keep_col[c + 2] ? v.z : 0.f;
      v.w = keep_col[c + 3] ? v.w : 0.f;
    }
    __stcs(dst + i, v);
  }
}

}  // namespace

// spec, out [B, T, M] f32 contiguous and 16-byte aligned, M % 4 == 0;
// seeds [B] int32. Returns cudaGetLastError() of the launch (0 = ok).
extern "C" int tal_specaug(const void* spec, void* out, const void* seeds,
                           int b, int t, int m, int f_param, int n_f,
                           int t_param, int n_t, void* stream) {
  if (n_f < 0 || n_t < 0 || n_f > MAX_MASKS || n_t > MAX_MASKS || m > MAX_MELS ||
      (n_f > 0 && f_param < 1) || (n_t > 0 && t_param < 1) || m % 4 != 0 ||
      (uintptr_t)spec % 16 != 0 || (uintptr_t)out % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (b <= 0 || t <= 0 || m <= 0) return 0;
  const dim3 grid((t + ROWS - 1) / ROWS, b);
  specaug_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)spec, (float*)out, (const int*)seeds, t, m, f_param, n_f,
      t_param, n_t);
  return (int)cudaGetLastError();
}
