// vMF mean-shift hill climbing of the UCN clustering seeds, for Hopper (sm_90a).
//
// Replaces the hill-climbing phase of
// unseenobjectswithmeanshift_tpu/ops/pallas_mean_shift.py
// mean_shift_seeds_pallas (_kernel :42, steps S..S+max_iters-1); its seeding
// phase is csrc/fps_seeds.cu. For X [B, N, D] fp32 unit rows and seeds
// Z [B, S, D], D = 64 (or 128, the 'cat' embedding, below), each of `iters`
// steps computes
//   Z <- normalize(exp(kappa Z X^T) X),  normalize(v) = v / max(|v|, 1e-12)
// as ops/mean_shift.seed_hill_climbing does, without a running maximum (the
// JAX kernel subtracts none: e^20 x 307,200 keys fits in fp32).
//
// It is an attention without a softmax: queries Z, keys and values X. The
// TPU kernel walks N in chunks inside one program per image and never writes
// the [S, N] weights. Here N is split over blocks, grid (nsplit, B), one
// block per SM; each block walks its keys in tiles of 64 and writes one
// [S, 64] partial of sum_k w_sk x_k; a second kernel sums the nsplit partials
// of every seed in split order and normalizes. No atomics: deterministic.
//
// Tensor cores, 3xTF32 (csrc/tf32_mma.cuh): both products run on `wgmma`
// .tf32 with fp32 accumulation, each operand split hi/lo and
// a b ~ a_lo b_hi + a_hi b_lo + a_hi b_hi. Two warpgroups, one per 64 seeds
// (S = 100 runs as 128 rows; a warpgroup whose rows are all past S only
// copies and splits). Per tile:
//   - the tile reaches shared memory by cp.async, two stages in a ring (rows
//     padded to 68 floats, so the split pass reads without bank conflicts);
//   - all 256 threads split it into two K-major operand layouts: X as
//     [64 keys][K = 64 d] for S = Z X^T (X's rows are already K-major), and
//     X^T as [64 d][K = 64 keys] for W X, its keys permuted within each
//     8-key step (fragment column j <-> key 2j, j + 4 <-> key 2j + 1);
//   - S = Z X^T in two halves of 32 keys (m64n32k8, A = Z split once a
//     launch and kept in registers), both queued before the first half's
//     weights w = 2^(kappa log2(e) s) are taken (keys past the block's range
//     get 0); then O_tile += W X (m64n64k8), A = W taken straight from the S
//     accumulators by the permutation, no shuffle;
//   - the tensor core adds into its accumulator by truncation, so O_tile
//     starts from zero each tile and is added to the running partial with
//     round-to-nearest fp32 adds (as the cross-attention does).
// D = 128 ('cat' fusion) keeps every register array of D = 64: the two
// warpgroups split D instead of the seeds. Each takes 64 dims of Z and X and
// the same 64 seeds (grid (nsplit, B, ceil(S / 64))): it computes its half of
// S = Z X^T, the halves are added through shared memory (16 KB each; both
// warpgroups add them in the same order, so both take the same weights), and
// each warpgroup accumulates O for its own 64 dims. The tile's X is split
// once for both. Shared memory: 226 KB of the 227 a block may have.
// Plain 1xTF32 or bf16 would put the climbed seeds ~1e-3 from fp64
// (tests/test_torch_climb_tf32.py), against the 2e-5 gate of chip_smoke.py.
//
// Bound. Per step and image 4 S N d operations (the dot and the weighted
// sum) plus S N exponentials: 7.9 GFLOP at S = 100, N = 307,200. In 3xTF32
// (495 / 3 = 165 TFLOP/s) 10 steps take at least 0.48 ms, 1.18 ms at the
// 67 TFLOP/s fp32 rate; X is read once a step (78.6 MB, 23 us at 3.35
// TB/s): bounded by operations.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

constexpr int TK = 64;           // keys per tile
constexpr int THREADS = 256;     // two warpgroups
constexpr int MAX_SEEDS = 128;   // D = 64: one warpgroup per 64 seeds
constexpr int WD = 64;           // dims a warpgroup takes (D = 128: half of them)

// dynamic shared memory of climb_partial_kernel<D>, in bytes: the raw ring,
// the split layouts (hi and lo of X and of X^T) and, at D = 128, the two
// warpgroups' halves of S
template <int D>
constexpr int SMEM_BYTES = (int)sizeof(float) *
                           (2 * TK * (D + 4) + 4 * TK * D + (D == 128 ? 2 * 64 * TK : 0));

// grid (nsplit, B, 1) at D = 64, (nsplit, B, ceil(S / 64)) at D = 128;
// partial [B, nsplit, S, D].
template <int D>
__global__ void __launch_bounds__(THREADS, 1) climb_partial_kernel(
    const float* __restrict__ X, const float* __restrict__ Z, float* __restrict__ partial,
    int N, int S, int keys_per_block, float c_log2) {
  constexpr int RS = D + 4;               // raw tile row stride (floats)
  constexpr bool SPLIT_D = D == 128;      // the warpgroups split D, not the seeds
  extern __shared__ __align__(128) float smem[];
  float* raw = smem;                 // [2][TK][RS]
  float* xk_hi = raw + 2 * TK * RS;  // [TK keys][K = D]
  float* xk_lo = xk_hi + TK * D;
  float* xt_hi = xk_lo + TK * D;     // [D][K = TK keys, permuted]
  float* xt_lo = xt_hi + TK * D;
  float* ex = xt_lo + TK * D;        // D = 128: [2 warpgroups][32 values][128 threads]
  const int split = blockIdx.x, b = blockIdx.y, nsplit = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, g = lane >> 2, tg = lane & 3;
  const int wg = tid >> 7;
  const int wr = ((tid >> 5) & 3) * 16;   // this warp's 16 rows of the warpgroup's 64
  // seeds s0 .. s0 + 63 and dims dw .. dw + WD - 1 of this warpgroup
  const int s0 = SPLIT_D ? blockIdx.z * 64 : wg * 64;
  const int dw = SPLIT_D ? wg * WD : 0;
  const bool active = SPLIT_D || s0 < S;  // warpgroup-uniform (block-uniform at D = 128)

  // this warp's seeds, split once: A fragments of S = Z X^T (its dims)
  uint32_t zh[WD / 8][4], zl[WD / 8][4];
  {
    const float* zs = Z + (size_t)b * S * D;
    const int r0 = s0 + wr + g, r1 = r0 + 8;
#pragma unroll
    for (int ks = 0; ks < WD / 8; ++ks) {
      const int d0 = dw + ks * 8 + tg;
      split_tf32(r0 < S ? zs[r0 * D + d0] : 0.f, zh[ks][0], zl[ks][0]);
      split_tf32(r1 < S ? zs[r1 * D + d0] : 0.f, zh[ks][1], zl[ks][1]);
      split_tf32(r0 < S ? zs[r0 * D + d0 + 4] : 0.f, zh[ks][2], zl[ks][2]);
      split_tf32(r1 < S ? zs[r1 * D + d0 + 4] : 0.f, zh[ks][3], zl[ks][3]);
    }
  }
  float o[32];   // rows s0 + wr + g (+8), d = 8 j + 2 tg (+1), j = 0..7
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;

  const int k0 = split * keys_per_block;
  const int k1 = min(k0 + keys_per_block, N);
  const int ntiles = k1 > k0 ? (k1 - k0 + TK - 1) / TK : 0;
  const float* Xb = X + (size_t)b * N * D;
  auto issue = [&](int t, int buf) {
    const int key0 = k0 + t * TK;
    float* dst = raw + buf * TK * RS;
    for (int l = tid; l < TK * (D / 4); l += THREADS) {
      const int n = l / (D / 4), c4 = (l % (D / 4)) * 4;
      const bool ok = key0 + n < k1;
      cp_async16(dst + n * RS + c4, ok ? Xb + (size_t)(key0 + n) * D + c4 : Xb, ok);
    }
  };

  if (ntiles > 0) issue(0, 0);
  cp_commit();
  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) issue(t + 1, (t + 1) & 1);
    cp_commit();
    cp_wait<1>();      // this tile's copies (this thread's) are complete
    __syncthreads();   // ... everyone's; and the previous tile's products are done
    const float* rt = raw + (t & 1) * TK * RS;
    // X as [key][d], K-major: thread takes float4 (key n, dims 4c..4c+3)
#pragma unroll
    for (int i = 0; i < TK * D / 4 / THREADS; ++i) {
      const int l = tid + THREADS * i, n = l % TK, c = l / TK;
      const float4 v = *reinterpret_cast<const float4*>(rt + n * RS + 4 * c);
      uint4 h, lo;
      split_tf32(v.x, h.x, lo.x);
      split_tf32(v.y, h.y, lo.y);
      split_tf32(v.z, h.z, lo.z);
      split_tf32(v.w, h.w, lo.w);
      const int off = core_off(n, 4 * c, D / 4);
      *reinterpret_cast<uint4*>(xk_hi + off) = h;
      *reinterpret_cast<uint4*>(xk_lo + off) = lo;
    }
    // X^T as [d][permuted key], K-major: thread takes dim d and the four keys
    // of permuted index 4q..4q+3, keys 8m + 2j + h (m = q / 2, h = q % 2)
#pragma unroll
    for (int i = 0; i < TK * D / 4 / THREADS; ++i) {
      const int l = tid + THREADS * i, d = l % D, q = l / D;
      const float* col = rt + (8 * (q >> 1) + (q & 1)) * RS + d;
      uint4 h, lo;
      split_tf32(col[0], h.x, lo.x);
      split_tf32(col[2 * RS], h.y, lo.y);
      split_tf32(col[4 * RS], h.z, lo.z);
      split_tf32(col[6 * RS], h.w, lo.w);
      const int off = core_off(d, 4 * q, TK / 4);
      *reinterpret_cast<uint4*>(xt_hi + off) = h;
      *reinterpret_cast<uint4*>(xt_lo + off) = lo;
    }
    fence_async_smem();
    __syncthreads();

    if (active) {
      const int valid = k1 - (k0 + t * TK);   // keys of this tile in the block's range
      float sc[2][16];   // S of keys 0..31 and 32..63 of the tile
      float acc[32];     // O_tile, from zero each tile
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.f;
      // S = Z X^T, both halves queued at once: the tensor cores work on the
      // second while the warps turn the first into weights
      wg_pin(sc[0]);
      wg_pin(sc[1]);
      wg_fence();
#pragma unroll
      for (int hk = 0; hk < 2; ++hk) {
#pragma unroll
        for (int ks = 0; ks < WD / 8; ++ks) {
          const int kc = hk * 4 * (D / 4) + 2 * (dw / 8 + ks);   // core matrix of (keys, dims)
          wgmma_3xtf32(sc[hk], zh[ks], zl[ks], smem_desc(xk_hi + kc * 32, 128, (D / 4) * 128),
                       smem_desc(xk_lo + kc * 32, 128, (D / 4) * 128), ks == 0);
        }
        wg_commit();
      }
      if constexpr (SPLIT_D) {
        // S = the two warpgroups' halves, added in the same order by both
        wg_wait<0>();
        wg_pin(sc[0]);
        wg_pin(sc[1]);
        float* mine = ex + wg * 32 * 128 + (tid & 127);
        const float* other = ex + (1 - wg) * 32 * 128 + (tid & 127);
#pragma unroll
        for (int i = 0; i < 32; ++i) mine[i * 128] = sc[i >> 4][i & 15];
        __syncthreads();
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const float o_ = other[i * 128];
          sc[i >> 4][i & 15] = wg == 0 ? sc[i >> 4][i & 15] + o_ : o_ + sc[i >> 4][i & 15];
        }
      }
      uint32_t ah[2][4], al[2][4];
      wg_pin(acc);
#pragma unroll
      for (int hk = 0; hk < 2; ++hk) {
        if (hk == 0) wg_wait<1>();   // the first half's S is done
        wg_pin(sc[hk]);              // (the second's: by the waits of steps kt = 2, 3)
        // sc[hk][4 j + e]: seed wr + g + 8 (e >> 1), key 32 hk + 8 j + 2 tg + (e & 1)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float w = ex2_approx(c_log2 * sc[hk][4 * j + e]);
            sc[hk][4 * j + e] = 32 * hk + 8 * j + 2 * tg + (e & 1) < valid ? w : 0.f;
          }
        // O_tile += W X over these 32 keys, 8 at a time
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          // A column tg <-> key 8 j + 2 tg, column tg + 4 <-> key 8 j + 2 tg + 1
          const int kt = 4 * hk + j, ab = kt & 1;
          if (kt >= 2) wg_wait<1>();   // the wgmma that read this A buffer is done
          split_tf32(sc[hk][4 * j + 0], ah[ab][0], al[ab][0]);
          split_tf32(sc[hk][4 * j + 2], ah[ab][1], al[ab][1]);
          split_tf32(sc[hk][4 * j + 1], ah[ab][2], al[ab][2]);
          split_tf32(sc[hk][4 * j + 3], ah[ab][3], al[ab][3]);
          wg_fence();
          const int kc = (dw / 8) * (TK / 4) + 2 * kt;   // core matrix of (dims, keys)
          wgmma_3xtf32(acc, ah[ab], al[ab], smem_desc(xt_hi + kc * 32, 128, (TK / 4) * 128),
                       smem_desc(xt_lo + kc * 32, 128, (TK / 4) * 128), kt == 0);
          wg_commit();
        }
      }
      wg_wait<0>();
      wg_pin(acc);
#pragma unroll
      for (int i = 0; i < 32; ++i) o[i] += acc[i];
    }
  }

  if (active) {
    float* pb = partial + ((size_t)b * nsplit + split) * S * D;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int s = s0 + wr + g + 8 * rr;
      if (s < S) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<float2*>(pb + (size_t)s * D + dw + 8 * j + 2 * tg) =
              make_float2(o[4 * j + 2 * rr], o[4 * j + 2 * rr + 1]);
      }
    }
  }
}

// grid (S, B), D threads: Z[b, s] = sum_split partial / max(|sum|, 1e-12),
// summed in split order; the norm's sum of squares by a fixed tree.
template <int D>
__global__ void __launch_bounds__(D) climb_normalize_kernel(
    const float* __restrict__ partial, float* __restrict__ Z, int S, int nsplit) {
  __shared__ float warp_sums[D / 32];
  const int s = blockIdx.x;
  const int b = blockIdx.y;
  const int d = threadIdx.x;
  const float* p = partial + ((size_t)b * nsplit * S + s) * D + d;   // split sp at sp * S * D
  float sum = 0.f;
  int sp = 0;
  for (; sp + 8 <= nsplit; sp += 8) {   // 8 loads in flight, added in split order
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) v[u] = p[(size_t)(sp + u) * S * D];
#pragma unroll
    for (int u = 0; u < 8; ++u) sum += v[u];
  }
  for (; sp < nsplit; ++sp) sum += p[(size_t)sp * S * D];
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

template <int D>
int climb(const float* X, float* Z, float* partial, int B, int N, int S, float kappa, int iters,
          int keys_per_block, cudaStream_t st) {
  const int nsplit = (N + keys_per_block - 1) / keys_per_block;
  cudaError_t err = cudaFuncSetAttribute(climb_partial_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         SMEM_BYTES<D>);
  if (err != cudaSuccess) return (int)err;
  const float c_log2 = kappa * 1.4426950408889634f;
  const dim3 grid(nsplit, B, D == 128 ? (S + 63) / 64 : 1);
  for (int it = 0; it < iters; ++it) {
    climb_partial_kernel<D><<<grid, THREADS, SMEM_BYTES<D>, st>>>(X, Z, partial, N, S,
                                                                 keys_per_block, c_log2);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    climb_normalize_kernel<D><<<dim3(S, B), D, 0, st>>>(partial, Z, S, nsplit);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* uoms_climb_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// Queues `iters` steps (two launches each) on `stream`, updating Z [B, S, d]
// f32 in place, d = 64 or 128. X [B, N, d] f32 with rows 16-byte aligned;
// scratch partial [B, nsplit, S, d] f32 (allocated by the caller), nsplit =
// ceil(N / keys_per_block), keys_per_block a multiple of 64.
// Returns cudaGetLastError() of the first launch that fails, else of the last.
int uoms_ms_climb(const float* X, float* Z, float* partial, int B, int N, int d, int S,
                  float kappa, int iters, int keys_per_block, void* stream) {
  if ((d != 64 && d != 128) || B < 1 || N < 1 || S < 1 || S > MAX_SEEDS || iters < 0 ||
      keys_per_block < 1 || keys_per_block % TK != 0 || B > 65535 ||
      (reinterpret_cast<uintptr_t>(X) & 15u) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  return d == 64 ? climb<64>(X, Z, partial, B, N, S, kappa, iters, keys_per_block, st)
                 : climb<128>(X, Z, partial, B, N, S, kappa, iters, keys_per_block, st);
}

}  // extern "C"
