// Masked vMF attention with a fixed maximum, for Hopper (sm_90a).
//
// Replaces unseenobjectswithmeanshift_tpu/ops/pallas_attention.py:
//   masked_hypersphere_attention        (_flash_kernel :35, pallas_call :137)
//   fused_masked_hypersphere_attention  (_fused_flash_kernel :195, pallas_call :270)
// Same inputs, same output: [B, H, Q, D] attention output before the final
// per-head normalization.
//
// What it computes, per image b, head h, query q:
//   k_t  = k[b, h, t]                         (masked_hypersphere_attention), or
//   k_t  = (base_t + pos_t) wk + bk, v_t = base_t wv + bv   (fused: per tile)
//   k^_t = k_t / |k_t| per head               (raw k is normalized on the tile)
//   m_qt = !(logit[b, q, t] < 0)              (attend where the logit is >= 0)
//   m_qt = 1 for every t when no key is unmasked for q   (all-masked-row guard)
//   p_qt = exp(kappa (q . k^_t - 1))          (fixed maximum: q.k^ <= 1)
//   out  = sum_t m p v_t / sum_t m p
//
// Design: the structure of csrc/fused_cross_attention.cu. The TPU kernel walks
// K in order and keeps the accumulators in VMEM; here the key axis is cut into
// splits, one block per (split, head group of 4, image), each looping over its
// 64-key tiles with one [v | 1] accumulator per (head, query) thread in
// registers. Every weight lies in [e^-2kappa, 1], so the partial sums of the
// splits simply add; a last kernel sums them in split order (deterministic).
// The guard needs to know whether any key of the row is unmasked, which no
// single block sees: a first kernel counts the unmasked keys of each row, and
// the attention pass takes a row with count 0 as all ones. The TPU kernel gets
// the same flag from an XLA reduction before the call.
//
// Three kernels, launched in order on the caller's stream by one C entry:
//   count_kernel      cnt[b, q] = number of keys with logit >= 0
//   attn_partial      per tile: mask words from the logits (warp ballots),
//                     k/v tile (loaded, or projected in shared memory), per-head
//                     L2 norm of k, q.k^, exp, masked p.[v|1] in registers
//   attn_reduce       sum the splits, divide by the denominator column
//
// Bound, per image at K = 307,200, H = 8, Q = 100, D = 32 (E = 256), fp32:
//   q.k^ 2 H Q K D = 15.7 G, p.[v|1] 2 H Q K (D+1) = 16.2 G -> ~32 GFLOP, 0.48 ms
//   at 67 TFLOP/s; k, v and the logits read once are ~0.75 GB, 0.22 ms at
//   3.35 TB/s: bounded by operations. The fused variant adds the projections,
//   2 * 2 K E (H D) = 80.5 GFLOP, ~1.7 ms in all. This first version uses plain
//   FMA loops from shared memory; no tensor cores, no TMA.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int HEAD_DIM = 32;    // D
constexpr int TK = 64;          // keys per tile
constexpr int HPB = 4;          // heads per block
constexpr int MAX_PAIRS = 512;  // HPB * Q threads at most
constexpr int EC = 32;          // input channels per projection step (fused)
constexpr int TKP = TK + 1;     // padded key stride of the projection inputs

// cnt[row] = #keys of logits[row, :] that are not < 0; one block per (b, q) row.
__global__ void __launch_bounds__(256) count_kernel(const float* __restrict__ logits,
                                                    int* __restrict__ cnt, int K) {
  const float* row = logits + (size_t)blockIdx.x * K;
  int c = 0;
  for (int k = threadIdx.x; k < K; k += blockDim.x) c += !(row[k] < 0.f);
  for (int off = 16; off > 0; off >>= 1) c += __shfl_down_sync(0xffffffffu, c, off);
  __shared__ int part[8];
  if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < (int)(blockDim.x / 32); ++w) total += part[w];
    cnt[blockIdx.x] = total;
  }
}

// One block per (key split, head group, image). Thread = (head hl, query q).
// partial layout [B][nsplit][H][Q][D+1]; column D is the denominator.
// FUSED = false: k, v given; element (b, h, key, d) at (b H + h) K D + key sk + d sd.
// FUSED = true: k = (base + pos) wk + bk and v = base wv + bv per tile;
//   base [B, K, E], pos [K, E], wk/wv [E, H D], bk/bv [H D].
template <bool FUSED>
__global__ void __launch_bounds__(MAX_PAIRS) attn_partial_kernel(
    const float* __restrict__ qn, const float* __restrict__ kin,
    const float* __restrict__ vin, int sk, int sd, const float* __restrict__ base,
    const float* __restrict__ pos, const float* __restrict__ wk,
    const float* __restrict__ bk, const float* __restrict__ wv,
    const float* __restrict__ bv, const float* __restrict__ logits,
    const int* __restrict__ cnt, float* __restrict__ partial, int H, int Q, int E,
    int K, int tiles_per_split, float c_log2) {
  constexpr int D = HEAD_DIM;
  constexpr int R = HPB * D;   // k (and v) rows of this head group
  constexpr int RP = R + 4;    // padded row stride of k_s / v_s (16-byte aligned)
  constexpr int MW = TK / 32;  // mask words per query per tile
  const int split = blockIdx.x, hg = blockIdx.y, b = blockIdx.z;
  const int nsplit = gridDim.x;
  const int HD = H * D;
  const int e0 = hg * R;
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid % 32;
  const bool active = tid < HPB * Q;
  const int hl = active ? tid / Q : 0;
  const int q = active ? tid % Q : 0;

  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;                 // [TK][RP]
  float* v_s = k_s + TK * RP;        // [TK][RP]
  uint32_t* m_s = reinterpret_cast<uint32_t*>(v_s + TK * RP);  // [Q][MW]
  float* kin_s = v_s + TK * RP + Q * MW;   // fused: [EC][TKP] base + pos
  float* vin_s = kin_s + EC * TKP;         // fused: [EC][TKP] base

  float acc[D + 1];
#pragma unroll
  for (int d = 0; d <= D; ++d) acc[d] = 0.f;
  float qv[D];
  const float* qsrc = qn + (((size_t)b * H + hg * HPB + hl) * Q + q) * D;
#pragma unroll
  for (int d = 0; d < D; ++d) qv[d] = active ? qsrc[d] : 0.f;

  const int ntiles = (K + TK - 1) / TK;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(t_begin + tiles_per_split, ntiles);
  const float* lb = logits + (size_t)b * Q * K;

  for (int tile = t_begin; tile < t_end; ++tile) {
    const int k0 = tile * TK;
    // mask words: a warp takes 32 keys of one query (TK and nt are multiples of 32)
    for (int l = tid; l < Q * TK; l += nt) {
      const int qq = l / TK, key = k0 + l % TK;
      const bool on = key < K && (cnt[b * Q + qq] == 0 || !(lb[(size_t)qq * K + key] < 0.f));
      const uint32_t w = __ballot_sync(0xffffffffu, on);
      if (lane == 0) m_s[qq * MW + (l % TK) / 32] = w;
    }
    if constexpr (!FUSED) {
      const size_t slab = (size_t)K * D;
      const size_t hb = ((size_t)b * H + hg * HPB) * slab;
      for (int l = tid; l < TK * R; l += nt) {
        // neighbouring threads on neighbouring addresses in either layout
        const int t = sd == 1 ? l / R : l % TK;
        const int r = sd == 1 ? l % R : l / TK;
        const int key = k0 + t;
        const size_t off = hb + (size_t)(r / D) * slab + (size_t)key * sk + (size_t)(r % D) * sd;
        k_s[t * RP + r] = key < K ? kin[off] : 0.f;
        v_s[t * RP + r] = key < K ? vin[off] : 0.f;
      }
    } else {
      for (int l = tid; l < TK * R; l += nt) {
        const int t = l / R, r = l % R;
        k_s[t * RP + r] = bk[e0 + r];
        v_s[t * RP + r] = bv[e0 + r];
      }
      const float* bb = base + (size_t)b * K * E;
      for (int c0 = 0; c0 < E; c0 += EC) {
        for (int l = tid; l < TK * EC; l += nt) {
          const int t = l / EC, c = l % EC, key = k0 + t;
          const bool in = key < K && c0 + c < E;
          const float x = in ? bb[(size_t)key * E + c0 + c] : 0.f;
          vin_s[c * TKP + t] = x;
          kin_s[c * TKP + t] = in ? x + pos[(size_t)key * E + c0 + c] : 0.f;
        }
        __syncthreads();
        // item = (row of [k | v], chunk of 16 keys); a warp shares the chunk
        for (int item = tid; item < 2 * R * (TK / 16); item += nt) {
          const int rr = item % (2 * R), ch = item / (2 * R);
          const bool isk = rr < R;
          const int r = isk ? rr : rr - R;
          const float* w = (isk ? wk : wv) + e0 + r;
          const float* src = isk ? kin_s : vin_s;
          float* dst = (isk ? k_s : v_s) + ch * 16 * RP + r;
          float a[16];
#pragma unroll
          for (int j = 0; j < 16; ++j) a[j] = dst[j * RP];
          const int cn = min(EC, E - c0);
          for (int c = 0; c < cn; ++c) {
            const float wc = w[(size_t)(c0 + c) * HD];
            const float* fr = src + c * TKP + ch * 16;
#pragma unroll
            for (int j = 0; j < 16; ++j) a[j] = fmaf(wc, fr[j], a[j]);
          }
#pragma unroll
          for (int j = 0; j < 16; ++j) dst[j * RP] = a[j];
        }
        __syncthreads();
      }
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
  if (active) {
    float* dst = partial + ((((size_t)b * nsplit + split) * H + hg * HPB + hl) * Q + q) * (D + 1);
#pragma unroll
    for (int d = 0; d <= D; ++d) dst[d] = acc[d];
  }
}

// out[b,h,q,d] = sum_s num / max(sum_s den, 1e-30), summed in split order.
__global__ void attn_reduce_kernel(const float* __restrict__ partial,
                                   float* __restrict__ out, int H, int Q, int nsplit) {
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
  if (d < D) out[(size_t)row * D + d] = sum / fmaxf(den_s, 1e-30f);
}

}  // namespace

extern "C" {

// Size of the attention pass's dynamic shared memory, in bytes.
int uoms_mattn_smem_bytes(int Q, int fused) {
  constexpr int RP = HPB * HEAD_DIM + 4;
  return (int)(sizeof(float) * (2 * TK * RP + (fused ? 2 * EC * TKP : 0)) +
               sizeof(uint32_t) * Q * (TK / 32));
}

const char* uoms_mattn_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// Launches the three kernels on `stream`. fused = 0: k, v with element strides
// sk (between keys) and sd (between dims) inside each [K, D] head slab; base,
// pos, wk, bk, wv, bv unused. fused = 1: k, v unused. Scratch (allocated by the
// caller): cnt [B, Q] i32, partial [B, nsplit, H, Q, D+1] f32.
// Returns cudaGetLastError().
int uoms_masked_attn(const float* qn, const float* k, const float* v, int sk, int sd,
                     const float* base, const float* pos, const float* wk,
                     const float* bk, const float* wv, const float* bv,
                     const float* logits, float* out, int* cnt, float* partial, int B,
                     int H, int Q, int D, int E, int K, int nsplit, int tiles_per_split,
                     float kappa, int fused, void* stream) {
  if (D != HEAD_DIM || H % HPB != 0 || HPB * Q > MAX_PAIRS || Q < 1 || B < 1 || K < 1 ||
      nsplit < 1 || (long long)nsplit * tiles_per_split * TK < K || (fused && E < 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);

  count_kernel<<<B * Q, 256, 0, s>>>(logits, cnt, K);

  const int smem = uoms_mattn_smem_bytes(Q, fused);
  auto partial_kernel = fused ? attn_partial_kernel<true> : attn_partial_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(partial_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = ((HPB * Q + 31) / 32) * 32;
  const float c_log2 = kappa * 1.4426950408889634f;
  partial_kernel<<<dim3(nsplit, H / HPB, B), threads, smem, s>>>(
      qn, k, v, sk, sd, base, pos, wk, bk, wv, bv, logits, cnt, partial, H, Q, E, K,
      tiles_per_split, c_log2);

  attn_reduce_kernel<<<B * H * Q, 64, 0, s>>>(partial, out, H, Q, nsplit);
  return (int)cudaGetLastError();
}

}  // extern "C"
