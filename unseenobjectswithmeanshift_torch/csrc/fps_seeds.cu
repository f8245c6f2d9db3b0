// Farthest-point seed selection of the UCN mean-shift clustering, for Hopper
// (sm_90a).
//
// Replaces unseenobjectswithmeanshift_tpu/ops/pallas_mean_shift.py
// fps_seeds_pallas (_fps_kernel :182). Same function as
// ops/mean_shift.select_smart_seeds batched over images: for X [B, N, D]
// fp32 unit rows (D = 64, or 128 for UCN's 'cat' fusion) and a first index
// per image,
//   seed_0 = X[first];  dist = 0.5 (1 - X seed_0)
//   step i = 1..S-1:  idx_i = argmax(dist) (lowest index on ties),
//                     seed_i = X[idx_i], dist = min(dist, 0.5 (1 - X seed_i))
// -> seeds [B, S, D] (rows copied from X, so bit-equal to X[idx]) and
//    indices [B, S] int32.
//
// Bound. Per step 2 N d operations over N d 4 bytes of X: at N = 307,200 that
// is 39 MFLOP against 78.6 MB. The function's own bound (each input read
// once) is 3.9 GFLOP at 67 TFLOP/s fp32, 0.06 ms; what costs is the chain of
// S - 1 dependent argmaxes, each over all of X. The TPU kernel keeps X^T
// resident in VMEM for all S steps. On the H100 X does not fit on chip (78.6
// MB at 480x640, 257 MB for 20 crops of 224^2; shared memory is 132 x 227 KB
// ~ 30 MB, the register files ~ 34 MB, the L2 50 MB), so a step that
// re-reads X from device memory takes at least 23.5 us at 3.35 TB/s.
//
// Design: one persistent cooperative launch for the whole chain.
// - The grid is one block per SM (cudaLaunchCooperativeKernel, which refuses
//   a grid that cannot be resident at once; the C entry checks the device's
//   cooperative-launch support and the occupancy first, and never falls back
//   to one launch per step). The B N rows form one range, cut into equal
//   slices, one per block; a slice may cross image boundaries.
// - Each block keeps its slice on chip as far as it fits: the running
//   distance of every row in shared memory for all S steps (never in device
//   memory); the first `res` rows of X in shared memory and the next
//   REG x 32 rows in registers (16 lanes a row, one float4 each), both
//   loaded once; the next `l2_rows` rows are read with an evict_last L2
//   policy, so that they stay in the 50 MB L2 from step to step (their
//   priority is reset to normal at the end); only the rest is read from
//   device memory at each step, with evict_first. At B = 1 that leaves 10
//   of 78.6 MB to read a step (28.7 MB in shared memory and registers, 25
//   in the L2); at B = 20, 187 of 257 MB. (0 to 32 MiB kept in the L2
//   measured within 5% of one another from 16 MiB up, 10-25% slower at 0 at
//   B = 1; reading rows ahead into the L2 during the barrier cost 6% at
//   B = 20: scripts/sweep_mean_shift_blocks.py, PERF.md.)
// - Steps are separated by a grid barrier (one arrival counter, zeroed by the
//   C entry; a block's thread 0 adds one and waits for the step's total).
// - The argmax is the total order on (value, -index), `better`: ties go to
//   the lowest index and no atomics touch the values, so the result does not
//   depend on the order of the reduction and is the same run to run. Each
//   block writes one (max, index) partial per image it touches, at segment
//   blk + b (segments of one image are consecutive); after the barrier each
//   block reduces only the partials of its own images (at most ~2 images, 132
//   partials at B = 1). Partials ping-pong between two buffers: step s writes
//   buffer s & 1, so one barrier a step separates every write from its reads.
// - The seed row is copied from X by every block that needs it; the first
//   block of each image writes it to `seeds`, so seeds are X[idx] bit for bit.
//   The first index is read as jnp indexing reads X[first] (-N <= f < 0 wraps,
//   beyond the ends clamps) and returned as given in indices[:, 0].
// - D = 128 (the 'cat' embedding) is the same kernel with a row spread over
//   a whole warp (32 lanes of one float4) instead of half a warp: a pass
//   covers 16 rows instead of 32, and a block holds half as many rows on
//   chip (shared memory and registers hold the same bytes).
// The launch plan (rows per block, resident rows, register rows, image slots,
// shared-memory bytes) is made by ops/mean_shift_kernels.fps_plan; the C entry
// recomputes the bytes and refuses a plan that does not match.

#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;     // D = 64: 32 rows of 16 lanes a pass; D = 128: 16 of 32
constexpr int WARPS = THREADS / 32;
constexpr int REG = 16;          // register rows per lane group (REG x ROWS_PER_PASS a block)
template <int D>
constexpr int LANES_PER_ROW = D / 4;
template <int D>
constexpr int ROWS_PER_PASS = THREADS / LANES_PER_ROW<D>;
constexpr int RED_FLOATS = 2 * (WARPS + 1) + 2;   // argmax scratch, padded to 16 B

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

__device__ __forceinline__ float dot4(float4 x, float4 s) {
  return x.x * s.x + x.y * s.y + x.z * s.z + x.w * s.w;
}

// the lanes of a row sit in one half warp (D = 64: xor 8..1 stays inside
// it) or fill the warp (D = 128: xor 16..1)
template <int D, int U>
__device__ __forceinline__ void row_sums(float (&p)[U]) {
#pragma unroll
  for (int off = LANES_PER_ROW<D> / 2; off > 0; off >>= 1)
#pragma unroll
    for (int u = 0; u < U; ++u) p[u] += __shfl_xor_sync(0xffffffffu, p[u], off);
}

// Folds 0.5 (1 - p) into the running distance of local row r (lane 0 of the
// row's lane group) and into the running (best, bidx); `base` is the local
// index of the image's row 0.
__device__ __forceinline__ void fold(float* dist, int r, float p, bool init, int base,
                                     float& best, int& bidx) {
  const float dnew = 0.5f * (1.0f - p);
  const float dm = init ? dnew : fminf(dist[r], dnew);
  dist[r] = dm;
  if (better(dm, r - base, best, bidx)) { best = dm; bidx = r - base; }
}

// 16 bytes from device memory under an L2 cache policy (createpolicy)
__device__ __forceinline__ float4 ld_policy(const float* p, uint64_t policy) {
  float4 v;
  asm volatile("ld.global.L2::cache_hint.v4.f32 {%0,%1,%2,%3}, [%4], %5;\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p), "l"(policy));
  return v;
}

// Local rows [lo, hi) whose X rows start at src + r * D: in shared memory, or
// (DEVICE) in device memory, read under the L2 policy `policy`; U rows per
// lane group in flight. lo and hi are block-uniform, so every lane reaches
// every shuffle.
template <int D, int U, bool DEVICE>
__device__ __forceinline__ void rows_pass(const float* __restrict__ src, float* dist, int lo,
                                          int hi, float4 s4, bool init, int base, int lane,
                                          int group, uint64_t policy, float& best, int& bidx) {
  for (int r0 = lo; r0 < hi; r0 += U * ROWS_PER_PASS<D>) {
    float p[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = r0 + u * ROWS_PER_PASS<D> + group;
      const float* x = src + (size_t)r * D + 4 * lane;
      p[u] = r >= hi ? 0.f
             : dot4(DEVICE ? ld_policy(x, policy) : *reinterpret_cast<const float4*>(x), s4);
    }
    row_sums<D>(p);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = r0 + u * ROWS_PER_PASS<D> + group;
      if (r < hi && lane == 0) fold(dist, r, p[u], init, base, best, bidx);
    }
  }
}

// Grid-wide barrier: the blocks are all resident (cooperative launch), so
// each block's thread 0 adds one to the counter and waits until it reaches
// `target` (the number of blocks times the barriers passed so far).
__device__ __forceinline__ void grid_barrier(unsigned int* count, unsigned int target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();   // this block's partials before its arrival
    atomicAdd(count, 1u);
    unsigned int seen;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(seen) : "l"(count) : "memory");
    } while (seen < target);
    __threadfence();
  }
  __syncthreads();
}

// One block per SM, THREADS threads; dynamic shared memory as fps_smem_bytes.
// pv/pi: [2][gridDim.x + B] partials (segment blk + b); count: zeroed.
template <int D, int NREG>
__global__ void __launch_bounds__(THREADS, 1) fps_persistent_kernel(
    const float* __restrict__ X, const int* __restrict__ first, float* __restrict__ seeds,
    int* __restrict__ indices, float* __restrict__ pv, int* __restrict__ pi,
    unsigned int* __restrict__ count, int B, int N, int S, int rows_per_block, int res,
    int l2_rows, int img_slots) {
  extern __shared__ __align__(16) float smem[];
  float* seed_s = smem;                              // [img_slots][D]
  float* red_v = seed_s + img_slots * D;             // [WARPS + 1]
  int* red_i = reinterpret_cast<int*>(red_v + WARPS + 1);
  float* dist_s = smem + img_slots * D + RED_FLOATS;  // [rows_per_block, padded to 4]
  float* xs = dist_s + (rows_per_block + 3) / 4 * 4;  // [res][D]

  constexpr int ROWS = ROWS_PER_PASS<D>;
  const int tid = threadIdx.x, lane = tid % LANES_PER_ROW<D>, group = tid / LANES_PER_ROW<D>;
  const int blk = blockIdx.x, nblk = gridDim.x;
  const int total = B * N;
  const int g0 = blk * rows_per_block;                 // first row of the slice
  const int nrows = max(0, min(rows_per_block, total - g0));
  const int b_lo = g0 / N;
  const int nimg = nrows > 0 ? (g0 + nrows - 1) / N - b_lo + 1 : 0;
  const float* Xs = X + (size_t)g0 * D;                // the slice's rows in X
  const int reg_lo = min(res, nrows), reg_hi = min(res + NREG * ROWS, nrows);
  const int l2_hi = min(reg_hi + l2_rows, nrows);      // rows kept in the L2 across steps
  uint64_t keep, stream;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(keep));
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(stream));
  // streamed rows in flight per lane group (fewer beside the register rows)
  constexpr int STREAM_U = NREG > 0 ? 4 : 8;

  // resident rows, once: shared memory, then registers
  for (int v = tid; v < reg_lo * (D / 4); v += THREADS)
    reinterpret_cast<float4*>(xs)[v] = reinterpret_cast<const float4*>(Xs)[v];
  float4 xr[NREG > 0 ? NREG : 1];
#pragma unroll
  for (int u = 0; u < NREG; ++u) {
    const int r = res + u * ROWS + group;
    xr[u] = r < reg_hi ? reinterpret_cast<const float4*>(Xs + (size_t)r * D)[lane]
                       : make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (int step = 0; step < S; ++step) {
    // 1. this step's seed of every image the slice touches
    for (int j = 0; j < nimg; ++j) {
      const int b = b_lo + j;
      const int k_lo = (int)((long long)b * N / rows_per_block);   // the image's first block
      int idx;
      if (step == 0) {
        const int f = first[b];
        idx = f < 0 ? max(f + N, 0) : min(f, N - 1);
      } else {
        const int k_hi = (int)(((long long)b * N + N - 1) / rows_per_block);
        const size_t o = (size_t)((step - 1) & 1) * (nblk + B) + b;
        float v = -FLT_MAX;
        int i = INT_MAX;
        for (int k = k_lo + tid; k <= k_hi; k += THREADS) {
          const float ov = __ldcg(pv + o + k);   // L2: written by other blocks
          const int oi = __ldcg(pi + o + k);
          if (better(ov, oi, v, i)) { v = ov; i = oi; }
        }
        block_argmax(v, i, red_v, red_i);
        idx = i;
      }
      if (tid < D) {
        const float x = X[((size_t)b * N + idx) * D + tid];
        seed_s[j * D + tid] = x;
        if (blk == k_lo) seeds[((size_t)b * S + step) * D + tid] = x;
      }
      if (blk == k_lo && tid == 0) indices[(size_t)b * S + step] = step == 0 ? first[b] : idx;
    }
    if (step == S - 1) break;   // the last seed needs no distance update
    __syncthreads();

    // 2. fold the new seed's distance into every row; one partial per image
    const bool init = step == 0;
    for (int j = 0; j < nimg; ++j) {
      const int b = b_lo + j;
      const int base = b * N - g0;                     // local index of the image's row 0
      const int lo = max(base, 0), hi = min(base + N, nrows);
      const float4 s4 = reinterpret_cast<const float4*>(seed_s + j * D)[lane];
      float best = -FLT_MAX;
      int bidx = INT_MAX;
      rows_pass<D, 4, false>(xs, dist_s, lo, min(hi, reg_lo), s4, init, base, lane, group, 0,
                          best, bidx);
      if constexpr (NREG > 0) {
        if (max(lo, reg_lo) < min(hi, reg_hi)) {   // block-uniform
#pragma unroll
          for (int u0 = 0; u0 < NREG; u0 += 4) {
            float p[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) p[u] = dot4(xr[u0 + u], s4);
            row_sums<D>(p);
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int r = res + (u0 + u) * ROWS + group;
              if (r >= lo && r < hi && r < reg_hi && lane == 0)
                fold(dist_s, r, p[u], init, base, best, bidx);
            }
          }
        }
      }
      rows_pass<D, STREAM_U, true>(Xs, dist_s, max(lo, reg_hi), min(hi, l2_hi), s4, init, base,
                                lane, group, keep, best, bidx);
      rows_pass<D, STREAM_U, true>(Xs, dist_s, max(lo, l2_hi), hi, s4, init, base, lane, group,
                                stream, best, bidx);
      block_argmax(best, bidx, red_v, red_i);
      if (tid == 0) {
        const size_t o = (size_t)(step & 1) * (nblk + B) + blk + b;
        pv[o] = best;
        pi[o] = bidx;
      }
    }
    grid_barrier(count, (unsigned int)(step + 1) * nblk);
  }
  // the rows kept in the L2 go back to the normal eviction priority
  const char* kept = reinterpret_cast<const char*>(Xs + (size_t)reg_hi * D);
  for (int l = tid; l < (l2_hi - reg_hi) * (D * 4 / 128); l += THREADS)
    asm volatile("applypriority.global.L2::evict_normal [%0], 128;\n"
                 ::"l"(kept + (size_t)l * 128));
}

// dynamic shared memory of the kernel, in bytes
long long fps_smem_bytes(int rows_per_block, int res, int img_slots, int D) {
  return 4LL * (img_slots * D + RED_FLOATS + (rows_per_block + 3) / 4 * 4 + (long long)res * D);
}

}  // namespace

extern "C" {

const char* uoms_fps_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// out[0] = SM count, out[1] = the most dynamic shared memory a block may opt
// in to, out[2] = cooperative launch support, out[3] = threads a block, out[4]
// = register rows a lane group (REG), of the current device.
int uoms_fps_device_limits(int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(out, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(out + 1, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(out + 2, cudaDevAttrCooperativeLaunch, dev);
  out[3] = THREADS;
  out[4] = REG;
  return (int)err;
}

// One cooperative launch on `stream` for the whole chain. X [B, N, d] f32,
// d = 64 or 128; first [B] i32; seeds [B, S, d] f32 and indices [B, S] i32 (outputs);
// scratch (allocated by the caller): pv [2, grid + B] f32, pi [2, grid + B]
// i32, count [1] u32 (zeroed here). The plan: grid blocks of rows_per_block
// rows, the first `res` of a slice in shared memory, register rows (0 or
// REG) a lane group in registers, the next l2_rows kept in the L2,
// img_slots >= the images a slice can touch, smem_bytes as fps_smem_bytes.
// Returns 0, or the CUDA error: invalid value for a plan that does not hold,
// not supported without cooperative launch, cooperative launch too large
// when the grid cannot be resident.
int uoms_fps_seeds(const float* X, const int* first, float* seeds, int* indices, float* pv,
                   int* pi, unsigned int* count, int B, int N, int d, int S, int grid,
                   int rows_per_block, int res, int reg_rows, int l2_rows, int img_slots,
                   int smem_bytes, void* stream) {
  if ((d != 64 && d != 128) || B < 1 || N < 1 || S < 1 || grid < 1 || rows_per_block < 1 || res < 0 ||
      res > rows_per_block || (reg_rows != 0 && reg_rows != REG) ||
      l2_rows < 0 || img_slots < 1 ||
      (long long)B * N > INT_MAX || (long long)grid * rows_per_block < (long long)B * N ||
      (long long)(grid - 1) * rows_per_block >= (long long)B * N ||
      img_slots < (rows_per_block - 1 + N - 1) / N + 1 ||
      fps_smem_bytes(rows_per_block, res, img_slots, d) != smem_bytes)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  int limits[5];
  cudaError_t err = (cudaError_t)uoms_fps_device_limits(limits);
  if (err != cudaSuccess) return (int)err;
  if (!limits[2]) return (int)cudaErrorNotSupported;
  if (smem_bytes > limits[1]) return (int)cudaErrorInvalidValue;
  const void* kernel =
      d == 64 ? (reg_rows ? (const void*)fps_persistent_kernel<64, REG>
                          : (const void*)fps_persistent_kernel<64, 0>)
              : (reg_rows ? (const void*)fps_persistent_kernel<128, REG>
                          : (const void*)fps_persistent_kernel<128, 0>);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  if ((long long)per_sm * limits[0] < grid) return (int)cudaErrorCooperativeLaunchTooLarge;
  err = cudaMemsetAsync(count, 0, sizeof(unsigned int), s);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {(void*)&X, (void*)&first, (void*)&seeds, (void*)&indices, (void*)&pv,
                  (void*)&pi, (void*)&count, (void*)&B, (void*)&N, (void*)&S,
                  (void*)&rows_per_block, (void*)&res, (void*)&l2_rows, (void*)&img_slots};
  err = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(THREADS), args, (size_t)smem_bytes, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
