// Farthest-point seed selection of the UCN mean-shift clustering, for Hopper
// (sm_90a).
//
// Replaces unseenobjectswithmeanshift_tpu/ops/pallas_mean_shift.py
// fps_seeds_pallas (_fps_kernel :182). Same function as
// ops/mean_shift.select_smart_seeds batched over images: for X [B, N, 64]
// fp32 unit rows and a first index per image,
//   seed_0 = X[first];  dist = 0.5 (1 - X seed_0)
//   step i = 1..S-1:  idx_i = argmax(dist) (lowest index on ties),
//                     seed_i = X[idx_i], dist = min(dist, 0.5 (1 - X seed_i))
// -> seeds [B, S, 64] (rows copied from X, so bit-equal to X[idx]) and
//    indices [B, S] int32.
//
// Design. The TPU kernel keeps X^T resident in VMEM for all S steps. That does
// not carry over: at 480x640, X is 78.6 MB, more than the 50 MB of L2 and all
// the SMs' shared memory together. So every step streams X from device memory
// once, and the steps are S dependent launches on the caller's stream, queued
// by one C entry point. Each block takes a chunk of rows of one image. At the
// start of step i it reduces the previous step's per-block (max, index)
// partials of its image to the argmax, redundantly in every block and in a
// fixed order; then it copies row X[idx] (256 B) into shared memory, computes
// 0.5 (1 - x . seed) for its rows (16 lanes per row, one float4 each, a fixed
// shuffle tree; 4 rows per lane group in flight), folds it into the running
// distance and writes its own (max, lowest index) partial. The partials ping-pong between two buffers, so
// no block reads a partial that another block of the same step writes.
// (value, -index) is a total order, so the argmax does not depend on the
// order of the reduction, and no atomics are used: the result is
// deterministic. The rows past N in the last chunk are masked.
//
// Bound. Per step 2 N d operations and N d 4 bytes: at N = 307,200 that is
// 39 MFLOP against 78.6 MB, so a step that streams X from HBM takes at least
// 23.5 us at 3.35 TB/s, 2.35 ms for 100 seeds. The function's own bound (each
// input read once, chip_smoke.py) is far lower: 3.9 GFLOP at 67 TFLOP/s fp32,
// 0.06 ms. The chain of 100 dependent argmaxes over 78.6 MB is what this
// design pays for; keeping X on chip would take a grid-wide sync across a
// persistent grid that holds X in shared memory (30 MB over 132 SMs) or in
// fp16 (not the same function).

#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>

namespace {

constexpr int D = 64;          // embedding width the kernel takes
constexpr int THREADS = 256;   // 16 rows of 16 lanes per pass
constexpr int LANES_PER_ROW = D / 4;
constexpr int ROWS_PER_PASS = THREADS / LANES_PER_ROW;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 4;      // rows per lane group per pass

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// Block-wide argmax of (v, i) with ties to the lowest index; every thread
// gets the result. Uses `sv`/`si` ([WARPS + 1] each) as scratch.
__device__ __forceinline__ void block_argmax(float& v, int& i, float* sv, int* si) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, v, off);
    const int oi = __shfl_down_sync(0xffffffffu, i, off);
    if (better(ov, oi, v, i)) { v = ov; i = oi; }
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) { sv[warp] = v; si[warp] = i; }
  __syncthreads();
  if (threadIdx.x == 0) {
    float bv = sv[0];
    int bi = si[0];
    for (int w = 1; w < WARPS; ++w)
      if (better(sv[w], si[w], bv, bi)) { bv = sv[w]; bi = si[w]; }
    sv[WARPS] = bv;
    si[WARPS] = bi;
  }
  __syncthreads();
  v = sv[WARPS];
  i = si[WARPS];
  __syncthreads();   // sv/si may be reused right after
}

// One step of the chain. grid (nblk, B), THREADS threads.
// pv/pi: [2][B][nblk] partials; step s reads buffer (s-1)&1, writes s&1.
__global__ void __launch_bounds__(THREADS) fps_step_kernel(
    const float* __restrict__ X, const int* __restrict__ first,
    float* __restrict__ dist, float* __restrict__ pv, int* __restrict__ pi,
    float* __restrict__ seeds, int* __restrict__ indices, int B, int N, int S,
    int nblk, int rows_per_block, int step) {
  __shared__ __align__(16) float seed[D];
  __shared__ float sv[WARPS + 1];
  __shared__ int si[WARPS + 1];
  const int b = blockIdx.y;
  const int blk = blockIdx.x;
  const int tid = threadIdx.x;

  int idx;
  if (step == 0) {
    // jnp indexing of X[first]: -N <= f < 0 wraps, then clamp to [0, N)
    const int f = first[b];
    idx = f < 0 ? max(f + N, 0) : min(f, N - 1);
  } else {
    const size_t base = ((size_t)((step - 1) & 1) * B + b) * nblk;
    float v = -FLT_MAX;
    int i = INT_MAX;
    for (int k = tid; k < nblk; k += THREADS)
      if (better(pv[base + k], pi[base + k], v, i)) { v = pv[base + k]; i = pi[base + k]; }
    block_argmax(v, i, sv, si);
    idx = i;
  }

  const float* row = X + ((size_t)b * N + idx) * D;
  if (tid < D) {
    const float x = row[tid];
    seed[tid] = x;
    if (blk == 0) seeds[((size_t)b * S + step) * D + tid] = x;
  }
  if (blk == 0 && tid == 0) indices[(size_t)b * S + step] = step == 0 ? first[b] : idx;
  if (step == S - 1) return;   // the last seed needs no distance update
  __syncthreads();

  const int lane = tid % LANES_PER_ROW;
  const int group = tid / LANES_PER_ROW;
  const float4 s4 = reinterpret_cast<const float4*>(seed)[lane];
  const int r0 = blk * rows_per_block;
  const int r1 = min(r0 + rows_per_block, N);
  float best = -FLT_MAX;
  int bidx = INT_MAX;
  // UNROLL independent rows per lane group per pass keep more loads in flight
  for (int base = r0; base < r1; base += UNROLL * ROWS_PER_PASS) {
    float p[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int r = base + u * ROWS_PER_PASS + group;
      p[u] = 0.f;
      if (r < r1) {
        const float4 x = reinterpret_cast<const float4*>(X + ((size_t)b * N + r) * D)[lane];
        p[u] = x.x * s4.x + x.y * s4.y + x.z * s4.z + x.w * s4.w;
      }
    }
    // the 16 lanes of a row sit in one half warp: xor 8..1 stays inside it
#pragma unroll
    for (int off = LANES_PER_ROW / 2; off > 0; off >>= 1)
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) p[u] += __shfl_xor_sync(0xffffffffu, p[u], off);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int r = base + u * ROWS_PER_PASS + group;
      if (r < r1 && lane == 0) {
        const float dnew = 0.5f * (1.0f - p[u]);
        const size_t o = (size_t)b * N + r;
        const float dm = step == 0 ? dnew : fminf(dist[o], dnew);
        dist[o] = dm;
        if (better(dm, r, best, bidx)) { best = dm; bidx = r; }
      }
    }
  }
  block_argmax(best, bidx, sv, si);
  if (tid == 0) {
    const size_t o = ((size_t)(step & 1) * B + b) * nblk + blk;
    pv[o] = best;
    pi[o] = bidx;
  }
}

}  // namespace

extern "C" {

const char* uoms_fps_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// Queues the S steps on `stream`. X [B, N, 64] f32; first [B] i32 (clamped to
// [0, N)); seeds [B, S, 64] f32 and indices [B, S] i32 (outputs); scratch
// (allocated by the caller): dist [B, N] f32, pv [2, B, nblk] f32,
// pi [2, B, nblk] i32 with nblk = ceil(N / rows_per_block).
// Returns cudaGetLastError() of the first launch that fails, else of the last.
int uoms_fps_seeds(const float* X, const int* first, float* seeds, int* indices,
                   float* dist, float* pv, int* pi, int B, int N, int d, int S,
                   int rows_per_block, void* stream) {
  if (d != D || B < 1 || N < 1 || S < 1 || rows_per_block < 1 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int nblk = (N + rows_per_block - 1) / rows_per_block;
  for (int step = 0; step < S; ++step) {
    fps_step_kernel<<<dim3(nblk, B), THREADS, 0, s>>>(
        X, first, dist, pv, pi, seeds, indices, B, N, S, nblk, rows_per_block, step);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
