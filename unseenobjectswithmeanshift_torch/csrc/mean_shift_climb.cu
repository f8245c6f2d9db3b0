// vMF mean-shift hill climbing of the UCN clustering seeds, for Hopper (sm_90a).
//
// Replaces the hill-climbing phase of
// unseenobjectswithmeanshift_tpu/ops/pallas_mean_shift.py
// mean_shift_seeds_pallas (_kernel :42, steps S..S+max_iters-1); its seeding
// phase is csrc/fps_seeds.cu. For X [B, N, 64] fp32 unit rows and seeds
// Z [B, S, 64], each of `iters` steps computes
//   Z <- normalize(exp(kappa Z X^T) X),  normalize(v) = v / max(|v|, 1e-12)
// as ops/mean_shift.seed_hill_climbing does, without a running maximum (the
// JAX kernel subtracts none: e^20 x 307,200 keys fits in fp32).
//
// Design. The TPU kernel walks N in chunks inside one program per image and
// never writes the [S, N] weights. Here N is split over blocks, grid
// (nsplit, B): a block holds its slice of Z in registers (thread (s, q) keeps
// z_s[16q .. 16q+15]: 100 seeds x 4 quarters = 400 threads), stages a tile of
// 64 keys in shared memory (each key's quarters padded to 20 floats, so the 4
// float4 reads of a warp fall in distinct banks), and for each key forms
// z_s . x with a fixed 2-level shuffle over the 4 quarter lanes (all four get
// the same bits), w = expf(kappa z.x), and accumulates w x into its [16]
// quarter of the [S, 64] partial in registers, two keys at a time. Each block writes its partial
// [S, 64] once; a second kernel sums the nsplit partials of every seed in
// split order and normalizes. No atomics: deterministic. Keys past N are
// masked (w = 0).
//
// Bound. Per step and image 4 S N d operations (the dot and the weighted
// sum) plus S N exponentials: 7.9 GFLOP at N = 307,200, so 10 steps take at
// least 1.2 ms at 67 TFLOP/s fp32 (no tensor cores); X is read once per step
// (78.6 MB, 23 us at 3.35 TB/s): bounded by operations. This first version
// uses plain FMAs from registers and shared memory; no wgmma, no TMA.

#include <cuda_runtime.h>

namespace {

constexpr int D = 64;          // embedding width the kernel takes
constexpr int QUARTERS = 4;    // threads per seed, 16 dims each
constexpr int QD = D / QUARTERS;
constexpr int QPAD = QD + 4;   // padded floats per quarter in shared memory
constexpr int KPAD = QUARTERS * QPAD;
constexpr int TK = 64;         // keys per shared-memory tile
constexpr int MAX_SEEDS = 128;   // 4 threads per seed, 512 threads at most

// grid (nsplit, B); blockDim = round_up(4 S, 32).
// partial [B, nsplit, S, 64].
__global__ void __launch_bounds__(QUARTERS * MAX_SEEDS) climb_partial_kernel(
    const float* __restrict__ X, const float* __restrict__ Z,
    float* __restrict__ partial, int N, int S, int keys_per_block, float kappa) {
  __shared__ __align__(16) float xs[TK * KPAD];
  const int b = blockIdx.y;
  const int split = blockIdx.x;
  const int nsplit = gridDim.x;
  const int tid = threadIdx.x;
  const int s = tid / QUARTERS;
  const int q = tid % QUARTERS;
  const bool active = s < S;

  float z[QD], acc[QD];
#pragma unroll
  for (int j = 0; j < QD; ++j) {
    z[j] = active ? Z[((size_t)b * S + s) * D + q * QD + j] : 0.f;
    acc[j] = 0.f;
  }

  const int k0 = split * keys_per_block;
  const int k1 = min(k0 + keys_per_block, N);
  const float* Xb = X + (size_t)b * N * D;
  for (int t0 = k0; t0 < k1; t0 += TK) {
    const int nk = min(TK, k1 - t0);
    __syncthreads();   // the previous tile is consumed
    for (int v = tid; v < TK * (D / 4); v += blockDim.x) {
      const int k = v / (D / 4);
      const int c = (v % (D / 4)) * 4;   // first dim of this float4
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k < nk) x = reinterpret_cast<const float4*>(Xb + (size_t)(t0 + k) * D)[c / 4];
      *reinterpret_cast<float4*>(&xs[k * KPAD + (c / QD) * QPAD + c % QD]) = x;
    }
    __syncthreads();
    // two keys per iteration: two independent dot chains. The tile's rows
    // past nk are zeros, so a key past the end adds w * 0 = 0.
    for (int k = 0; k < nk; k += 2) {
      float x[2][QD], p[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float4* xr = reinterpret_cast<const float4*>(&xs[(k + u) * KPAD + q * QPAD]);
#pragma unroll
        for (int m = 0; m < QD / 4; ++m) {
          const float4 v = xr[m];
          x[u][4 * m] = v.x; x[u][4 * m + 1] = v.y; x[u][4 * m + 2] = v.z; x[u][4 * m + 3] = v.w;
        }
        p[u] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < QD; ++j) {
        p[0] = fmaf(z[j], x[0][j], p[0]);
        p[1] = fmaf(z[j], x[1][j], p[1]);
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        // the 4 quarter lanes of a seed are consecutive: xor 1, 2 stays inside
        p[u] += __shfl_xor_sync(0xffffffffu, p[u], 1);
        p[u] += __shfl_xor_sync(0xffffffffu, p[u], 2);
        const float w = expf(kappa * p[u]);
#pragma unroll
        for (int j = 0; j < QD; ++j) acc[j] = fmaf(w, x[u][j], acc[j]);
      }
    }
  }
  if (active) {
    float* dst = partial + (((size_t)b * nsplit + split) * S + s) * D + q * QD;
#pragma unroll
    for (int j = 0; j < QD; ++j) dst[j] = acc[j];
  }
}

// grid (S, B), 64 threads: Z[b, s] = sum_split partial / max(|sum|, 1e-12),
// summed in split order; the norm's sum of squares by a fixed tree.
__global__ void __launch_bounds__(D) climb_normalize_kernel(
    const float* __restrict__ partial, float* __restrict__ Z, int S, int nsplit) {
  __shared__ float warp_sums[D / 32];
  const int s = blockIdx.x;
  const int b = blockIdx.y;
  const int d = threadIdx.x;
  float sum = 0.f;
  for (int sp = 0; sp < nsplit; ++sp)
    sum += partial[(((size_t)b * nsplit + sp) * S + s) * D + d];
  float sq = sum * sum;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, off);
  if (d % 32 == 0) warp_sums[d / 32] = sq;
  __syncthreads();
  float total = warp_sums[0];
#pragma unroll
  for (int w = 1; w < D / 32; ++w) total += warp_sums[w];
  Z[((size_t)b * S + s) * D + d] = sum / fmaxf(sqrtf(total), 1e-12f);
}

}  // namespace

extern "C" {

const char* uoms_climb_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// Queues `iters` steps (two launches each) on `stream`, updating Z [B, S, 64]
// f32 in place. X [B, N, 64] f32; scratch partial [B, nsplit, S, 64] f32
// (allocated by the caller), nsplit = ceil(N / keys_per_block).
// Returns cudaGetLastError() of the first launch that fails, else of the last.
int uoms_ms_climb(const float* X, float* Z, float* partial, int B, int N, int d,
                  int S, float kappa, int iters, int keys_per_block, void* stream) {
  if (d != D || B < 1 || N < 1 || S < 1 || S > MAX_SEEDS || iters < 0 ||
      keys_per_block < 1 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int nsplit = (N + keys_per_block - 1) / keys_per_block;
  const int threads = (QUARTERS * S + 31) / 32 * 32;
  for (int it = 0; it < iters; ++it) {
    climb_partial_kernel<<<dim3(nsplit, B), threads, 0, st>>>(X, Z, partial, N, S,
                                                             keys_per_block, kappa);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    climb_normalize_kernel<<<dim3(S, B), D, 0, st>>>(partial, Z, S, nsplit);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
