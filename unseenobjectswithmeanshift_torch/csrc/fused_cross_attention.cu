// Fused masked vMF cross-attention of the MSMFormer decoder, for Hopper (sm_90a).
//
// Replaces unseenobjectswithmeanshift_tpu/ops/fused_cross_attention.py
// fused_uoms_cross_attention, dense branch (_kernel :244, _tile_body :171).
// Same inputs, same output: [B, H, Q, D] attention output before the final
// per-head normalization.
//
// What it computes, per image b, head h, query q:
//   k_t  = awk^T f_t + wk^T pos_t + ck      (input_proj folded into awk/ck)
//   v_t  = awv^T f_t + cv
//   k^_t = k_t / |k_t| per head
//   m_qt = (me_q . mf_t >= 0)                (the reference's sigmoid < 0.5 mask)
//   m_qt = 1 for every t when no key is unmasked for q   (all-masked-row guard)
//   p_qt = exp(kappa (q . k^_t - 1))          (fixed maximum: q.k^ <= 1)
//   out  = sum_t m p v_t / sum_t m p
// present[b] == 0 skips image b (output zero).
//
// Design. The TPU kernel walks K in order on one core and carries the
// accumulators in VMEM. Hopper runs blocks in no order, so the key axis is cut
// into splits, one block per (split, head group, image), and each block loops
// over its key tiles. Every weight lies in [e^-2kappa, 1] (e^-60 ~ 9e-27 is a
// normal float), so partial sums over disjoint key ranges simply add: no
// running maximum and no rescaling. A last kernel sums the partials in a fixed
// order, so the result is deterministic run to run.
//
// The guard needs to know, per query, whether ANY key of the image is
// unmasked, which a block that sees a slice of K cannot tell. The TPU kernel
// keeps a second (unmasked) accumulator for it. Here a first pass computes the
// mask bits once per call (shared by all head groups) and counts the unmasked
// keys per query; the attention pass then uses mask = all-ones for queries with
// count 0. That is the same function with one accumulator instead of two.
//
// Four kernels, launched in order on the caller's stream by one C entry:
//   pos_proj_kernel   P[k, e] = sum_j pos[j, k] wk[j, e] + ck[e]   (batch-shared)
//   mask_kernel       bit[b, q, k] = me.mf >= 0, cnt[b, q] = #unmasked keys
//   xattn_partial     per tile: k/v projection, per-head L2 norm, q.k^, exp,
//                     masked p.[v|1] accumulation in registers
//   xattn_reduce      sum the splits, divide by the denominator column
//
// Tile skipping (decoder.tile_skip; replaces the JAX package's
// fused_uoms_cross_attention(tile_plan=...), _kernel_skip :282 and
// pallas_call :483). A block holds every query of its image, so once the mask
// words of a tile are in shared memory (with the count-0 rule applied), "no
// query of this image has a bit in this tile" is one __syncthreads_or. Such a
// tile adds exact zeros to every accumulator of the dense kernel, so the
// skipping variant (MODE 1) loads its mask words first and goes on to the next
// tile without touching features, P or k/v. The splits and the order of the
// remaining tiles are the dense kernel's, so the output equals the dense
// kernel's bit for bit. No bound on me.mf is needed: the bits are exact.
// A query whose mask is empty (the guard) attends to every key, so one such
// query keeps every tile of its image. The trained masks measured so far have
// such queries in every layer, so they skip nothing; a per-query skip of the
// attention loop (guard queries' warps first) saved no time on the H100, since
// a block still waits at every tile for the warps that attend (PERF.md §6).
// MODE 2 runs the same code with every tile counted as present (the
// tile_skip_force_all control, which measures the cost of the test).
//
// Bound. Per layer and 480x640 image (K = 307,200, H = 8, Q = 100, D = 32,
// C = 64, Cm = E = 256), fp32 operations:
//   pos projection 2 K E^2 = 40.3 G, k/v projection 2*2 K C E = 20.1 G,
//   mask 2 Q K Cm = 15.7 G, q.k^ 2 H Q K D = 15.7 G, p.[v|1] 2 H Q K (D+1) = 16.2 G
//   -> about 108 GFLOP. Each input read once is about 0.71 GB (featT 79 MB,
//   mfT 315 MB, posT 315 MB; queries, mask embeds and weights under 1 MB).
// Without tensor cores (67 TFLOP/s fp32) that is 1.6 ms of arithmetic against
// 0.21 ms of memory at 3.35 TB/s: the kernel is bounded by operations. This first version
// uses plain FMA loops from shared memory; no wgmma, no TMA.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int HEAD_DIM = 32;    // D: per-head width (256 / 8)
constexpr int TK = 64;          // keys per tile in the attention pass
constexpr int HPB = 4;          // heads per block in the attention pass
constexpr int MAX_PAIRS = 512;  // HPB * Q threads at most
constexpr int MASK_KEYS = 128;  // keys per block in the mask pass
constexpr int MASK_QR = 52;     // queries per thread in the mask pass (2*52 >= 100)
constexpr int PP_TILE = 64;     // pos projection output tile (rows and keys)
constexpr int PP_BK = 16;       // pos projection reduction step

// P[k * E + e] = sum_j posT[j * K + k] * wk[j * E + e] + ck[e]
__global__ void __launch_bounds__(256) pos_proj_kernel(
    const float* __restrict__ wk, const float* __restrict__ posT,
    const float* __restrict__ ck, float* __restrict__ P, int E, int K) {
  __shared__ float As[PP_BK][PP_TILE];  // As[j][e]
  __shared__ float Bs[PP_BK][PP_TILE];  // Bs[j][k]
  const int k0 = blockIdx.x * PP_TILE;
  const int e0 = blockIdx.y * PP_TILE;
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // keys  k0 + tx*4 + j
  const int ty = tid / 16;  // rows  e0 + ty*4 + i
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int j0 = 0; j0 < E; j0 += PP_BK) {
    for (int l = tid; l < PP_BK * PP_TILE; l += 256) {
      const int r = l / PP_TILE, c = l % PP_TILE, j = j0 + r;
      As[r][c] = (j < E && e0 + c < E) ? wk[(size_t)j * E + e0 + c] : 0.f;
      Bs[r][c] = (j < E && k0 + c < K) ? posT[(size_t)j * K + k0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < PP_BK; ++r) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = As[r][ty * 4 + i];
        b[i] = Bs[r][tx * 4 + i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int k = k0 + tx * 4 + j;
    if (k >= K) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = e0 + ty * 4 + i;
      if (e < E) P[(size_t)k * E + e] = acc[i][j] + ck[e];
    }
  }
}

// bits[(b*Q + q) * words + w] bit i = (me[b,q] . mf[b,:,32w+i] >= 0) for keys < K;
// cnt[b*Q + q] += number of such keys (cnt zeroed by the caller).
__global__ void __launch_bounds__(256) mask_kernel(
    const float* __restrict__ me, const float* __restrict__ mfT,
    const int* __restrict__ present, uint32_t* __restrict__ bits,
    int* __restrict__ cnt, int Q, int Cm, int K, int words) {
  const int b = blockIdx.y;
  if (!present[b]) return;
  __shared__ float mf_s[32][MASK_KEYS];
  __shared__ float me_s[2 * MASK_QR][33];
  const int tid = threadIdx.x;
  const int t = tid % MASK_KEYS;
  const int half = tid / MASK_KEYS;
  const int lane = tid % 32;
  const int k0 = blockIdx.x * MASK_KEYS;
  const float* mfb = mfT + (size_t)b * Cm * K;
  const float* meb = me + (size_t)b * Q * Cm;

  for (int qc = 0; qc < Q; qc += 2 * MASK_QR) {
    float acc[MASK_QR];
#pragma unroll
    for (int i = 0; i < MASK_QR; ++i) acc[i] = 0.f;
    for (int c0 = 0; c0 < Cm; c0 += 32) {
      for (int l = tid; l < 32 * MASK_KEYS; l += 256) {
        const int r = l / MASK_KEYS, c = l % MASK_KEYS;
        mf_s[r][c] = (c0 + r < Cm && k0 + c < K) ? mfb[(size_t)(c0 + r) * K + k0 + c] : 0.f;
      }
      for (int l = tid; l < 2 * MASK_QR * 32; l += 256) {
        const int qq = l / 32, r = l % 32;
        me_s[qq][r] = (qc + qq < Q && c0 + r < Cm) ? meb[(size_t)(qc + qq) * Cm + c0 + r] : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int r = 0; r < 32; ++r) {
        const float x = mf_s[r][t];
#pragma unroll
        for (int i = 0; i < MASK_QR; ++i) acc[i] = fmaf(me_s[half + 2 * i][r], x, acc[i]);
      }
      __syncthreads();
    }
    const int word = (k0 + t) / 32;
#pragma unroll
    for (int i = 0; i < MASK_QR; ++i) {
      const int q = qc + half + 2 * i;
      const unsigned w = __ballot_sync(0xffffffffu, acc[i] >= 0.f && k0 + t < K);
      if (lane == 0 && q < Q && word < words) {
        bits[((size_t)b * Q + q) * words + word] = w;
        atomicAdd(&cnt[b * Q + q], __popc(w));
      }
    }
  }
}

// Mask word w of query q at keys k0 + 32w .. k0 + 32w + 31 of the tile:
// all ones for a query with no unmasked key (the guard), zero past K.
__device__ __forceinline__ uint32_t tile_mask_word(const uint32_t* __restrict__ bits,
                                                   const int* __restrict__ cnt, int b,
                                                   int Q, int qq, int K, int words,
                                                   int k0, int w) {
  const int key0 = k0 + w * 32;
  const int nvalid = min(max(K - key0, 0), 32);
  const uint32_t valid = nvalid == 32 ? 0xffffffffu : ((1u << nvalid) - 1u);
  const int widx = key0 / 32;
  const uint32_t word = (widx < words) ? bits[((size_t)b * Q + qq) * words + widx] : 0u;
  return (cnt[b * Q + qq] == 0 ? 0xffffffffu : word) & valid;
}

// One block per (key split, head group, image). Thread = (head hl, query q).
// partial layout [B][nsplit][H][Q][D+1]; column D is the denominator.
// MODE 0: dense; 1: skip tiles where no query of the image has a mask bit;
// 2: the skipping code with every tile present (control).
template <int MODE>
__global__ void __launch_bounds__(MAX_PAIRS) xattn_partial_kernel(
    const float* __restrict__ qn, const float* __restrict__ featT,
    const float* __restrict__ P, const float* __restrict__ awk,
    const float* __restrict__ awv, const float* __restrict__ cv,
    const uint32_t* __restrict__ bits, const int* __restrict__ cnt,
    const int* __restrict__ present, float* __restrict__ partial,
    int H, int Q, int C, int K, int words, int tiles_per_split, float c_log2) {
  constexpr int D = HEAD_DIM;
  constexpr int R = HPB * D;   // k (and v) rows of this head group
  constexpr int RP = R + 4;    // padded row stride of k_s / v_s (16-byte aligned)
  constexpr int MW = TK / 32;  // mask words per query per tile
  const int split = blockIdx.x, hg = blockIdx.y, b = blockIdx.z;
  const int nsplit = gridDim.x;
  const int E = H * D;
  const int e0 = hg * R;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int pair = tid;
  const bool active = pair < HPB * Q;
  const int hl = active ? pair / Q : 0;
  const int q = active ? pair % Q : 0;

  float acc[D + 1];
#pragma unroll
  for (int d = 0; d <= D; ++d) acc[d] = 0.f;

  if (present[b]) {
    extern __shared__ __align__(16) float smem[];
    float* f_s = smem;                 // [C][TK]
    float* k_s = f_s + C * TK;         // [TK][RP]
    float* v_s = k_s + TK * RP;        // [TK][RP]
    uint32_t* m_s = reinterpret_cast<uint32_t*>(v_s + TK * RP);  // [Q][MW]

    float qv[D];
    const float* qsrc = qn + (((size_t)b * H + hg * HPB + hl) * Q + q) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) qv[d] = active ? qsrc[d] : 0.f;

    const int ntiles = (K + TK - 1) / TK;
    const int t_begin = split * tiles_per_split;
    const int t_end = min(t_begin + tiles_per_split, ntiles);
    const float* fb = featT + (size_t)b * C * K;

    for (int tile = t_begin; tile < t_end; ++tile) {
      const int k0 = tile * TK;
      if constexpr (MODE != 0) {
        int any = MODE == 2;
        for (int l = tid; l < Q * MW; l += nt) {
          m_s[l] = tile_mask_word(bits, cnt, b, Q, l / MW, K, words, k0, l % MW);
          any |= m_s[l] != 0u;
        }
        if (!__syncthreads_or(any)) continue;   // uniform: every thread skips
      }
      for (int l = tid; l < C * TK; l += nt) {
        const int c = l / TK, t = l % TK;
        f_s[l] = (k0 + t < K) ? fb[(size_t)c * K + k0 + t] : 0.f;
      }
      for (int l = tid; l < TK * R; l += nt) {
        const int t = l / R, r = l % R;
        k_s[t * RP + r] = (k0 + t < K) ? P[(size_t)(k0 + t) * E + e0 + r] : 0.f;
      }
      if constexpr (MODE == 0) {
        for (int l = tid; l < Q * MW; l += nt)
          m_s[l] = tile_mask_word(bits, cnt, b, Q, l / MW, K, words, k0, l % MW);
      }
      __syncthreads();

      // k = awk^T f + P (P already holds wk^T pos + ck), v = awv^T f + cv.
      // Item = (row of [k | v], chunk of 16 keys); a warp shares the chunk.
      for (int item = tid; item < 2 * R * (TK / 16); item += nt) {
        const int rr = item % (2 * R), ch = item / (2 * R);
        const bool isk = rr < R;
        const int r = isk ? rr : rr - R;
        const int e = e0 + r;
        const float* w = isk ? awk : awv;
        float* dst = isk ? k_s : v_s;
        float a[16];
#pragma unroll
        for (int j = 0; j < 16; ++j) a[j] = isk ? k_s[(ch * 16 + j) * RP + r] : cv[e];
        for (int c = 0; c < C; ++c) {
          const float wc = w[(size_t)c * E + e];
          const float* fr = f_s + c * TK + ch * 16;
#pragma unroll
          for (int j = 0; j < 16; ++j) a[j] = fmaf(wc, fr[j], a[j]);
        }
#pragma unroll
        for (int j = 0; j < 16; ++j) dst[(ch * 16 + j) * RP + r] = a[j];
      }
      __syncthreads();

      // per-head L2 normalization of k over D
      for (int item = tid; item < HPB * TK; item += nt) {
        const int hh = item / TK, t = item % TK;
        float4* kr = reinterpret_cast<float4*>(k_s + t * RP + hh * D);
        float ss = 0.f;
#pragma unroll
        for (int d4 = 0; d4 < D / 4; ++d4) {
          const float4 x = kr[d4];
          ss = fmaf(x.x, x.x, fmaf(x.y, x.y, fmaf(x.z, x.z, fmaf(x.w, x.w, ss))));
        }
        const float inv = rsqrtf(ss + 1e-24f);
#pragma unroll
        for (int d4 = 0; d4 < D / 4; ++d4) {
          float4 x = kr[d4];
          x.x *= inv; x.y *= inv; x.z *= inv; x.w *= inv;
          kr[d4] = x;
        }
      }
      __syncthreads();

      if (active) {
        const uint32_t* mq = m_s + q * MW;
        for (int t = 0; t < TK; ++t) {
          const float4* kr = reinterpret_cast<const float4*>(k_s + t * RP + hl * D);
          float s = 0.f;
#pragma unroll
          for (int d4 = 0; d4 < D / 4; ++d4) {
            const float4 x = kr[d4];
            s = fmaf(qv[4 * d4], x.x, s);
            s = fmaf(qv[4 * d4 + 1], x.y, s);
            s = fmaf(qv[4 * d4 + 2], x.z, s);
            s = fmaf(qv[4 * d4 + 3], x.w, s);
          }
          const bool on = (mq[t / 32] >> (t % 32)) & 1u;
          const float p = on ? exp2f(c_log2 * s - c_log2) : 0.f;
          const float4* vr = reinterpret_cast<const float4*>(v_s + t * RP + hl * D);
#pragma unroll
          for (int d4 = 0; d4 < D / 4; ++d4) {
            const float4 x = vr[d4];
            acc[4 * d4] = fmaf(p, x.x, acc[4 * d4]);
            acc[4 * d4 + 1] = fmaf(p, x.y, acc[4 * d4 + 1]);
            acc[4 * d4 + 2] = fmaf(p, x.z, acc[4 * d4 + 2]);
            acc[4 * d4 + 3] = fmaf(p, x.w, acc[4 * d4 + 3]);
          }
          acc[D] += p;
        }
      }
      __syncthreads();
    }
  }
  if (active) {
    float* dst = partial + ((((size_t)b * nsplit + split) * H + hg * HPB + hl) * Q + q) * (D + 1);
#pragma unroll
    for (int d = 0; d <= D; ++d) dst[d] = acc[d];
  }
}

// out[b,h,q,d] = sum_s num / max(sum_s den, 1e-30), summed in split order.
__global__ void xattn_reduce_kernel(const float* __restrict__ partial,
                                    const int* __restrict__ present,
                                    float* __restrict__ out, int B, int H, int Q,
                                    int nsplit) {
  constexpr int D = HEAD_DIM;
  const int row = blockIdx.x;  // (b, h, q)
  const int b = row / (H * Q);
  const int hq = row % (H * Q);
  const int d = threadIdx.x;
  __shared__ float den_s;
  float sum = 0.f;
  if (d <= D) {
    for (int s = 0; s < nsplit; ++s)
      sum += partial[(((size_t)b * nsplit + s) * H * Q + hq) * (D + 1) + d];
  }
  if (d == D) den_s = sum;
  __syncthreads();
  if (d < D) out[(size_t)row * D + d] = present[b] ? sum / fmaxf(den_s, 1e-30f) : 0.f;
}

}  // namespace

extern "C" {

// Size of the attention pass's dynamic shared memory, in bytes.
int uoms_xattn_smem_bytes(int Q, int C) {
  constexpr int RP = HPB * HEAD_DIM + 4;
  return (int)(sizeof(float) * (C * TK + 2 * TK * RP) + sizeof(uint32_t) * Q * (TK / 32));
}

const char* uoms_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// Launches the four kernels on `stream`. Scratch (allocated by the caller):
// P [K, E] f32, bits [B, Q, ceil(K/32)] u32, cnt [B, Q] i32,
// partial [B, nsplit, H, Q, D+1] f32. skip_mode: 0 dense, 1 tile skipping,
// 2 tile skipping with every tile present. Returns cudaGetLastError().
int uoms_fused_xattn(const float* qn, const float* featT, const float* mfT,
                     const float* me, const float* posT, const float* awk,
                     const float* awv, const float* wk, const float* ck,
                     const float* cv, const int* present, float* out, float* P,
                     uint32_t* bits, int* cnt, float* partial, int B, int H,
                     int Q, int D, int C, int Cm, int K, int nsplit,
                     int tiles_per_split, float kappa, int skip_mode, void* stream) {
  if (D != HEAD_DIM || H % HPB != 0 || HPB * Q > MAX_PAIRS || B < 1 || K < 1 ||
      nsplit < 1 || (long long)nsplit * tiles_per_split * TK < K || skip_mode < 0 ||
      skip_mode > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int E = H * D;
  const int words = (K + 31) / 32;

  pos_proj_kernel<<<dim3((K + PP_TILE - 1) / PP_TILE, (E + PP_TILE - 1) / PP_TILE), 256, 0, s>>>(
      wk, posT, ck, P, E, K);

  cudaError_t err = cudaMemsetAsync(cnt, 0, sizeof(int) * B * Q, s);
  if (err != cudaSuccess) return (int)err;
  mask_kernel<<<dim3((K + MASK_KEYS - 1) / MASK_KEYS, B), 256, 0, s>>>(
      me, mfT, present, bits, cnt, Q, Cm, K, words);

  const int smem = uoms_xattn_smem_bytes(Q, C);
  auto partial_kernel = skip_mode == 0   ? xattn_partial_kernel<0>
                        : skip_mode == 1 ? xattn_partial_kernel<1>
                                         : xattn_partial_kernel<2>;
  err = cudaFuncSetAttribute(partial_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = ((HPB * Q + 31) / 32) * 32;
  const float c_log2 = kappa * 1.4426950408889634f;
  partial_kernel<<<dim3(nsplit, H / HPB, B), threads, smem, s>>>(
      qn, featT, P, awk, awv, cv, bits, cnt, present, partial, H, Q, C, K, words,
      tiles_per_split, c_log2);

  xattn_reduce_kernel<<<B * H * Q, 64, 0, s>>>(partial, present, out, B, H, Q, nsplit);
  return (int)cudaGetLastError();
}

}  // extern "C"
