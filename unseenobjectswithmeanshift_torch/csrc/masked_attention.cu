// Masked vMF attention with a fixed maximum, for Hopper (sm_90a).
//
// Replaces unseenobjectswithmeanshift_tpu/ops/pallas_attention.py:
//   masked_hypersphere_attention        (_flash_kernel :35, pallas_call :137)
//   fused_masked_hypersphere_attention  (_fused_flash_kernel :195, pallas_call :270)
// Same inputs, same output: [B, H, Q, D] attention output before the final
// per-head normalization.
//
// What it computes, per image b, head h, query q:
//   k_t  = k[b, h, t], v_t = v[b, h, t]      (masked_hypersphere_attention), or
//   k_t  = (base_t + pos_t) wk + bk, v_t = base_t wv + bv   (fused: per tile)
//   k^_t = k_t / |k_t| per head               (raw k is normalized on the tile)
//   m_qt = !(logit[b, q, t] < 0)              (attend where the logit is >= 0)
//   m_qt = 1 for every t when no key is unmasked for q   (all-masked-row guard)
//   p_qt = exp(kappa (q . k^_t - 1))          (fixed maximum: q.k^ <= 1)
//   out  = sum_t m p v_t / sum_t m p
//
// Passes, launched in order on the caller's stream by one C entry per row:
//   wsplit_kernel      (fused only) wk | wv of every head, transposed and split
//                      into hi/lo K-major core matrices, once a call
//   count_bits_kernel  bits[b, q, w] = the mask words of the logits (one
//                      ballot per 32 keys), cnt[b, q] = the unmasked keys
//   mha_partial / fused_partial   per 64-key tile: k^ and v split in shared
//                      memory (loaded, or projected on the tensor cores),
//                      S = q k^T, P = mask exp2(c s - c), O += P V
//   attn_reduce        sum the splits in order, divide by the row sums
//
// Splits. One block per (head, key split, image), the heads of a split next
// to each other in the grid, each looping over its 64-key tiles. Every weight
// lies in [e^-2kappa, 1], so the partial sums of the splits simply add: no
// running maximum, and the last kernel sums them in a fixed order
// (deterministic run to run; cnt is an integer sum). The guard needs to know
// whether any key of the row is unmasked, which no single block sees: the
// count pass counts, and the attention reads a query with count 0 as
// unmasked everywhere (the TPU kernel gets the same flag from an XLA
// reduction before the call).
//
// The logits, read once. The count pass reads every logit once and writes
// its mask word (1 bit a key, 1/32 of the logits' bytes: 3.8 MB at B=1,
// K=307,200, Q=100); the attention blocks of all heads read the words from
// there (the L2 holds them), built once per (image, tile) for every head.
// So the logits cost Q K 4 bytes of device memory a call, read once. Row 5
// at B=1, K=307,200, Q=100, H=8 reads k and v once (629 MB), the logits
// once (123 MB) and 3.8 MB of words eight times from the L2.
//
// Tensor cores, 3xTF32 (csrc/tf32_mma.cuh). Every product runs on wgmma
// .tf32 with fp32 accumulation, each operand split a = a_hi + a_lo and
// a b ~ a_lo b_hi + a_hi b_lo + a_hi b_hi, as in the cross-attention
// (csrc/fused_cross_attention.cu). Two warpgroups a block attend, one per
// 64 queries (Q = 100 runs as 128 rows; a warpgroup whose rows are all past
// Q only copies, splits and projects). M x N x K of the products:
//   k/v (fused)  [64 keys] x [32 k | 32 v columns] x [E, 32 a stage]  k: warpgroup 0, v: 1
//   S            [64 queries] x [32 keys] x [D = 32], two halves a tile
//   O            [64 queries] x [D = 32] x [8 keys], 8 steps a tile
// The queries are split once a block in registers; P is taken straight from
// the S accumulators: the keys of each 8-key step are permuted (fragment
// column j <-> key 2j, j + 4 <-> key 2j + 1) in P's registers and in v's
// layout alike. The tensor core adds into its accumulator by truncation, so
// a long chain into one accumulator drifts: O and the row sums start from
// zero each tile, and the projection each 32-channel stage (PROJ_CHUNK in
// ops/pallas_attention.py), and they join the running sums with round-to-nearest
// fp32 adds (tests/test_torch_masked_attention_tf32.py models it: one
// truncating chain over E = 256 lands 2-3x further from fp64). The weights
// use ex2.approx.
//
// Operand layouts. wgmma .tf32 reads B from shared memory K-major only: k^
// as [key][d] for S, v as [d][key] for O. Row 5's split pass writes both
// from the raw tile in either input layout ([B, H, K, D], or [B, H, D, K]
// with kv_transposed): k^ normalized on the way (a key's 32 values lie on 4
// lanes of a warp, reduced by shuffles), v transposed where needed. The raw
// tiles use row strides (36, 72 and 68 floats) that keep the reads of k and
// of untransposed v free of bank conflicts; transposed v reads with 4-way
// conflicts.
//
// Row 5 (masked_hypersphere_attention): bounded by the bytes. A cp.async
// ring of two stages holds the raw k, v and mask words of the next tile
// while this one splits and attends (16-byte copies where the rows are
// aligned and, transposed, K % 4 == 0; 4-byte copies else). Two barriers a
// tile. 72 KB of shared memory, two blocks (16 warps) per SM.
//
// Row 6 (fused_masked_hypersphere_attention): a GEMM with the attention as
// its epilogue. Per tile the block projects its head's k and v columns from
// [64 keys] x [E] inputs: A = base + pos (k, warpgroup 0) and base (v,
// warpgroup 1), added and split in registers; B = the head's wk | wv
// columns, split once a call by wsplit_kernel. A third, producer warpgroup
// copies base and pos into a cp.async ring of three 32-channel stages
// (ragged E zero-filled) behind mbarriers: it fills a slot once all 256
// consumer threads have released it and marks it full through
// cp.async.mbarrier.arrive. No block-wide barrier runs inside a tile, so one
// consumer warpgroup loads and splits while the other's wgmma run; with a
// __syncthreads a stage the two ran in step and a stage cost ~0.97 us a tile
// and head on an SM against ~0.79 (scripts/sweep_masked_attention.py,
// PERF.md section 6). The projection's accumulators go straight into k^ (bk
// added, normalized) and v (bv added) in the B layouts of S and O: neither
// ever reaches device memory. A padded key (t >= K) has k = bk, not zero:
// its weight is zeroed by the mask word (key < K), and its v row is bv,
// finite.
//
// Row 6's L2 traffic, the trade-off that set the design (B=1, K=307,200,
// E=256, H=8; base and pos 315 MB each):
//   - stream the weights of a head group through the ring for every key
//     tile: the weights (1 MB of hi/lo for 8 heads) are read again each
//     tile, K / TK x 1 MB = 4.9 GB with 64-key tiles, plus base and pos once
//     per head group; a tile of 128 keys halves the weights' share but
//     needs 256 KB of base and pos on chip at once, more than an SM has;
//   - keep one head's columns resident (64 x 256 x 2 floats = 128 KB in
//     shared memory): the weights are read once a block (264 blocks x 128 KB
//     = 35 MB), base and pos once per head, 8 x 629 MB = 5.0 GB from the L2.
//     The heads of a split sit next to each other in the grid and stream the
//     same rows at the same pace, so device memory serves each row about once.
// Both cost ~5 GB of L2 reads; the resident one keeps every operand of the
// products on chip with one 32-channel stage (16 KB) in flight, where the
// streaming one would move 2 x 16 KB a stage. Resident it is, for E <= 256
// (RES_MAX_E); a wider E streams the weight stage through the ring (the
// same code, another descriptor). 217 KB of shared memory: one block of
// three warpgroups per SM.
//
// Bounds at H = 8, Q = 100, D = 32, E = 256 (chip_smoke.py's counts;
// 3xTF32 at 495 / 3 = 165 TFLOP/s, 3.35 TB/s):
//   row 5, B=1, K=307,200: q.k^ 2 H Q K D + p.[v|1] 2 H Q K (D+1) = 31.9
//     GFLOP (0.194 ms), 0.753 GB (0.225 ms): 0.225 ms, bounded by bytes;
//     B=20, K=50,176: 104.4 GFLOP (0.633 ms), 2.457 GB: 0.733 ms, bytes;
//   row 6 adds the projections 2 * 2 K E (H D): 112.5 GFLOP (0.682 ms),
//     0.753 GB: 0.682 ms, bounded by operations; B=20: 367.5 GFLOP,
//     1.480 GB: 2.227 ms, operations.
// Registers (-Xptxas=-v on the H100 build, PERF.md section 6):
// mha_partial_kernel 128 (bounded for two blocks of 256 threads per SM),
// 56-80 bytes spilled; fused_partial_kernel 164 (at most 168 for 384
// threads), no spill.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

constexpr int D = 32;            // head width the kernels take
constexpr int TK = 64;           // keys per tile
constexpr int MAX_Q = 128;       // queries: one warpgroup per 64
constexpr int THREADS = 256;     // two warpgroups
constexpr int MW = TK / 32;      // mask words per query per tile
constexpr int CB = 2048;         // keys per block of the count pass (8 warps x 8 words)
// row 5: raw tiles of a ring stage
constexpr int RS = D + 4;        // [key][d] row stride (k and v, default layout)
constexpr int KST = TK + 8;      // [d][key] row stride of k (kv_transposed)
constexpr int VST = TK + 4;      // [d][key] row stride of v (kv_transposed)
constexpr int RAW = TK * RS;     // floats of one raw array (= D * KST >= D * VST)
constexpr int SLOT5 = 2 * RAW + MAX_Q * MW;   // floats of a row-5 stage: k, v, words
// row 6: projection stages
constexpr int EC = 32;           // channels per stage (ops/pallas_attention.PROJ_CHUNK)
constexpr int AS = EC + 4;       // [key][channel] row stride of a stage's base and pos
constexpr int NST = 3;           // stages in the ring
constexpr int RES_MAX_E = 256;   // padded E up to which a head's weights stay in shared memory
constexpr int NW = 64;           // projected columns of a head: 32 of k, 32 of v
constexpr int WSTAGE = 2 * NW * EC;   // floats of a streamed weight stage (hi, lo)
constexpr int PRODUCERS = 128;   // threads of row 6's producer warpgroup

constexpr int SPLIT_FLOATS = 4 * TK * D;   // k^ hi, lo; v hi, lo

// ---- count pass ------------------------------------------------------------

// grid (B Q rows, key chunks of CB): bits[row, w] bit i = !(logits[row, 32 w + i] < 0)
// for keys < K; cnt[row] += the unmasked keys (cnt zeroed by the caller).
__global__ void __launch_bounds__(256) count_bits_kernel(const float* __restrict__ logits,
                                                         uint32_t* __restrict__ bits,
                                                         int* __restrict__ cnt, int K,
                                                         int words) {
  const int row = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int w0 = blockIdx.y * (CB / 32) + (threadIdx.x >> 5) * 8;
  const float* lr = logits + (size_t)row * K;
  float x[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int key = (w0 + i) * 32 + lane;
    x[i] = key < K ? lr[key] : -1.f;
  }
  int c = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint32_t w = __ballot_sync(0xffffffffu, !(x[i] < 0.f));
    if (lane == 0 && w0 + i < words) bits[(size_t)row * words + w0 + i] = w;
    c += __popc(w);
  }
  if (lane == 0 && c != 0) atomicAdd(&cnt[row], c);
}

// ---- shared attention core -------------------------------------------------

__device__ __forceinline__ uint32_t valid_bits(int key0, int K) {
  const int n = min(max(K - key0, 0), 32);
  return n == 32 ? 0xffffffffu : ((1u << n) - 1u);
}

// mask word w of query q in a staged tile: all ones for a guarded query, zero past K
__device__ __forceinline__ uint32_t mask_word(const uint32_t* ms, const int* guard_s, int q,
                                              int w, int k0, int K) {
  return (guard_s[q] ? 0xffffffffu : ms[q * MW + w]) & valid_bits(k0 + 32 * w, K);
}

// this warp's queries (rows q0 + wr + g, + 8), split once: A fragments of S
__device__ __forceinline__ void load_queries(const float* qs, int Q, int r0, int tg,
                                             uint32_t (&qh)[4][4], uint32_t (&ql)[4][4]) {
  const int r1 = r0 + 8;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const int d0 = ks * 8 + tg;
    split_tf32(r0 < Q ? qs[r0 * D + d0] : 0.f, qh[ks][0], ql[ks][0]);
    split_tf32(r1 < Q ? qs[r1 * D + d0] : 0.f, qh[ks][1], ql[ks][1]);
    split_tf32(r0 < Q ? qs[r0 * D + d0 + 4] : 0.f, qh[ks][2], ql[ks][2]);
    split_tf32(r1 < Q ? qs[r1 * D + d0 + 4] : 0.f, qh[ks][3], ql[ks][3]);
  }
}

// One 64-key tile for this warpgroup's 64 queries: S = q k^T, P = mask
// exp2(c s - c), O += P V, 32 keys at a time. k_hi/k_lo [64 keys][K = 32 d]
// and v_hi/v_lo [32 d][K = 64 keys, permuted] are K-major core matrices;
// ms the tile's mask words [Q][MW]. O starts from zero each tile and is added
// to o with round-to-nearest adds; rs the row sums of rows g, g + 8.
__device__ __forceinline__ void attend_tile(const uint32_t (&qh)[4][4], const uint32_t (&ql)[4][4],
                                            const float* k_hi, const float* k_lo,
                                            const float* v_hi, const float* v_lo,
                                            const uint32_t* ms, const int* guard_s, int qr,
                                            int tg, int Q, int k0, int K, float c_log2,
                                            float (&o)[16], float (&rs)[2]) {
  float t[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) t[i] = 0.f;
#pragma unroll
  for (int hk = 0; hk < 2; ++hk) {
    const uint32_t mw0 = qr < Q ? mask_word(ms, guard_s, qr, hk, k0, K) : 0u;
    const uint32_t mw1 = qr + 8 < Q ? mask_word(ms, guard_s, qr + 8, hk, k0, K) : 0u;
    float sc[16];
    wg_pin(sc);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_3xtf32(sc, qh[ks], ql[ks],
                   smem_desc(k_hi + (hk * 4 * (D / 4) + 2 * ks) * 32, 128, (D / 4) * 128),
                   smem_desc(k_lo + (hk * 4 * (D / 4) + 2 * ks) * 32, 128, (D / 4) * 128),
                   ks == 0);
    wg_commit();
    wg_wait<0>();
    wg_pin(sc);
    // sc[4 j + e]: row g + 8 (e >> 1), key 32 hk + 8 j + 2 tg + (e & 1)
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool on = (((e < 2 ? mw0 : mw1) >> (8 * j + 2 * tg + (e & 1))) & 1u) != 0u;
        const float p = on ? ex2_approx(c_log2 * sc[4 * j + e] - c_log2) : 0.f;
        sc[4 * j + e] = p;
        if (e < 2) ps0 += p; else ps1 += p;
      }
    rs[0] += ps0;
    rs[1] += ps1;
    uint32_t ah[2][4], al[2][4];
    wg_pin(t);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // A column tg <-> key 8 j + 2 tg, column tg + 4 <-> key 8 j + 2 tg + 1
      const int ab = j & 1;
      if (j >= 2) wg_wait<1>();   // the wgmma that read this A buffer is done
      split_tf32(sc[4 * j + 0], ah[ab][0], al[ab][0]);
      split_tf32(sc[4 * j + 2], ah[ab][1], al[ab][1]);
      split_tf32(sc[4 * j + 1], ah[ab][2], al[ab][2]);
      split_tf32(sc[4 * j + 3], ah[ab][3], al[ab][3]);
      wg_fence();
      const int kt = 4 * hk + j;
      wgmma_3xtf32(t, ah[ab], al[ab], smem_desc(v_hi + 2 * kt * 32, 128, (TK / 4) * 128),
                   smem_desc(v_lo + 2 * kt * 32, 128, (TK / 4) * 128), hk == 0 && j == 0);
      wg_commit();
    }
    wg_wait<0>();
  }
  wg_pin(t);
#pragma unroll
  for (int i = 0; i < 16; ++i) o[i] += t[i];
}

// partial[b][split][head][q][0..D) = O, [D] = the row sum
__device__ __forceinline__ void write_partial(float* pb, const float (&o)[16], const float (&rs)[2],
                                              int qr, int tg, int Q) {
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float sum = rs[rr];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const int q = qr + 8 * rr;
    if (q < Q) {
      float* dst = pb + (size_t)q * (D + 1);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        dst[8 * j + 2 * tg] = o[4 * j + 2 * rr];
        dst[8 * j + 2 * tg + 1] = o[4 * j + 2 * rr + 1];
      }
      if (tg == 0) dst[D] = sum;
    }
  }
}

// the tile's mask words of every query into ms [Q][MW] (zero past the last word)
__device__ __forceinline__ void issue_words(uint32_t* ms, const uint32_t* bb, int tile, int Q,
                                            int words, int tid) {
  for (int l = tid; l < Q * MW; l += THREADS) {
    const int widx = tile * MW + l % MW;
    const bool ok = widx < words;
    cp_async4(ms + l, ok ? bb + (size_t)(l / MW) * words + widx : bb, ok);
  }
}

// ---- row 5: k and v given --------------------------------------------------

// grid (H, nsplit, B). k, v element (b, h, key, d) at (b H + h) K D + key D + d,
// or with TRANS (kv_transposed) at (b H + h) D K + d K + key. VEC: 16-byte
// copies (rows 16-byte aligned; TRANS also K % 4 == 0).
template <bool TRANS, bool VEC>
__global__ void __launch_bounds__(THREADS, 2) mha_partial_kernel(
    const float* __restrict__ qn, const float* __restrict__ kin, const float* __restrict__ vin,
    const uint32_t* __restrict__ bits, const int* __restrict__ cnt, float* __restrict__ partial,
    int H, int Q, int K, int words, int tiles_per_split, float c_log2) {
  const int head = blockIdx.x, split = blockIdx.y, b = blockIdx.z, nsplit = gridDim.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int wr = (warp & 3) * 16;
  const int q0 = (tid >> 7) * 64;
  const int qr = q0 + wr + g;
  const bool attends = q0 < Q;   // warpgroup-uniform

  extern __shared__ __align__(128) float smem[];
  float* k_hi = smem;                 // [64 keys][K = 32 d]: k^, split
  float* k_lo = k_hi + TK * D;
  float* v_hi = k_lo + TK * D;        // [32 d][K = 64 keys, permuted]: v, split
  float* v_lo = v_hi + TK * D;
  float* ring = v_lo + TK * D;        // [2][SLOT5]: raw k, raw v, mask words
  int* guard_s = reinterpret_cast<int*>(ring + 2 * SLOT5);   // [MAX_Q]

  if (tid < MAX_Q) guard_s[tid] = tid < Q && cnt[b * Q + tid] == 0;
  uint32_t qh[4][4], ql[4][4];
  load_queries(qn + ((size_t)b * H + head) * Q * D, Q, qr, tg, qh, ql);
  float o[16], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 16; ++i) o[i] = 0.f;

  const int ntiles = (K + TK - 1) / TK;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(t_begin + tiles_per_split, ntiles);
  const size_t slab = (size_t)K * D;
  const float* kh = kin + ((size_t)b * H + head) * slab;
  const float* vh = vin + ((size_t)b * H + head) * slab;
  const uint32_t* bb = bits + (size_t)b * Q * words;

  auto issue = [&](int tile, int buf) {
    float* rk = ring + buf * SLOT5;
    float* rv = rk + RAW;
    const int k0 = tile * TK;
    if (!TRANS && VEC) {          // a tile is 64 rows of 128 contiguous bytes
      for (int l = tid; l < TK * (D / 4); l += THREADS) {
        const int n = l / (D / 4), c4 = (l % (D / 4)) * 4;
        const bool ok = k0 + n < K;
        const size_t off = (size_t)(k0 + n) * D + c4;
        cp_async16(rk + n * RS + c4, ok ? kh + off : kh, ok);
        cp_async16(rv + n * RS + c4, ok ? vh + off : vh, ok);
      }
    } else if (!TRANS) {
      for (int l = tid; l < TK * D; l += THREADS) {
        const int n = l / D, d = l % D;
        const bool ok = k0 + n < K;
        const size_t off = (size_t)(k0 + n) * D + d;
        cp_async4(rk + n * RS + d, ok ? kh + off : kh, ok);
        cp_async4(rv + n * RS + d, ok ? vh + off : vh, ok);
      }
    } else if (VEC) {             // 32 rows (d) of 64 keys; K % 4 == 0
      for (int l = tid; l < D * (TK / 4); l += THREADS) {
        const int d = l / (TK / 4), c4 = (l % (TK / 4)) * 4;
        const bool ok = k0 + c4 < K;
        const size_t off = (size_t)d * K + k0 + c4;
        cp_async16(rk + d * KST + c4, ok ? kh + off : kh, ok);
        cp_async16(rv + d * VST + c4, ok ? vh + off : vh, ok);
      }
    } else {
      for (int l = tid; l < D * TK; l += THREADS) {
        const int d = l / TK, n = l % TK;
        const bool ok = k0 + n < K;
        const size_t off = (size_t)d * K + k0 + n;
        cp_async4(rk + d * KST + n, ok ? kh + off : kh, ok);
        cp_async4(rv + d * VST + n, ok ? vh + off : vh, ok);
      }
    }
    issue_words(reinterpret_cast<uint32_t*>(rv + RAW), bb, tile, Q, words, tid);
  };

  if (t_begin < t_end) issue(t_begin, 0);
  cp_commit();
  int buf = 0;
  for (int tile = t_begin; tile < t_end; ++tile, buf ^= 1) {
    cp_wait<0>();
    __syncthreads();   // tile's copies landed (all threads'); the last tile's products are done
    if (tile + 1 < t_end) issue(tile + 1, buf ^ 1);
    cp_commit();
    const float* rk = ring + buf * SLOT5;
    const float* rv = rk + RAW;

    // k^: thread (key n, part) holds d = part + 4 i; the key's 4 parts are
    // lanes 8 apart of one warp
    {
      const int n = 8 * warp + (lane & 7), part = lane >> 3;
      float x[8];
      float ss = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int d = part + 4 * i;
        x[i] = TRANS ? rk[d * KST + n] : rk[n * RS + d];
        ss = fmaf(x[i], x[i], ss);
      }
      ss += __shfl_xor_sync(0xffffffffu, ss, 8);
      ss += __shfl_xor_sync(0xffffffffu, ss, 16);
      const float inv = rsqrtf(ss + 1e-24f);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        uint32_t h, l;
        split_tf32(x[i] * inv, h, l);
        const int off = core_off(n, part + 4 * i, D / 4);
        k_hi[off] = __uint_as_float(h);
        k_lo[off] = __uint_as_float(l);
      }
    }
    // v^T: thread (d, permuted index 4 qq .. 4 qq + 3 = keys 8 (qq / 2) + qq % 2 + 2 j)
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      const int l = tid + THREADS * it, d = l % D, qq = l / D;
      const int key = 8 * (qq >> 1) + (qq & 1);
      float x[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        x[j] = TRANS ? rv[d * VST + key + 2 * j] : rv[(key + 2 * j) * RS + d];
      uint4 h, lo;
      split_tf32(x[0], h.x, lo.x);
      split_tf32(x[1], h.y, lo.y);
      split_tf32(x[2], h.z, lo.z);
      split_tf32(x[3], h.w, lo.w);
      const int off = core_off(d, 4 * qq, TK / 4);
      *reinterpret_cast<uint4*>(v_hi + off) = h;
      *reinterpret_cast<uint4*>(v_lo + off) = lo;
    }
    fence_async_smem();
    __syncthreads();

    if (attends)
      attend_tile(qh, ql, k_hi, k_lo, v_hi, v_lo, reinterpret_cast<const uint32_t*>(rv + RAW),
                  guard_s, qr, tg, Q, tile * TK, K, c_log2, o, rs);
  }
  if (attends)
    write_partial(partial + (((size_t)b * nsplit + split) * H + head) * Q * (D + 1), o, rs, qr,
                  tg, Q);
}

// ---- row 6: k and v projected per tile --------------------------------------

// grid (H * 64 * E_pad / 256): ws[head][hi, lo][core_off(n, e, E_pad / 4)] for
// n < 32 column head D + n of wk, n >= 32 column head D + n - 32 of wv; zero
// for e >= E.
__global__ void __launch_bounds__(256) wsplit_kernel(const float* __restrict__ wk,
                                                     const float* __restrict__ wv,
                                                     float* __restrict__ ws, int H, int E,
                                                     int E_pad) {
  const long long l = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= (long long)H * NW * E_pad) return;
  const int n = (int)(l % NW);
  const long long r = l / NW;
  const int e = (int)(r % E_pad), head = (int)(r / E_pad);
  const float* w = n < D ? wk : wv;
  const float x = e < E ? w[(size_t)e * H * D + head * D + (n % D)] : 0.f;
  uint32_t hi, lo;
  split_tf32(x, hi, lo);
  float* dst = ws + (size_t)head * 2 * NW * E_pad + core_off(n, e, E_pad / 4);
  dst[0] = __uint_as_float(hi);
  dst[(size_t)NW * E_pad] = __uint_as_float(lo);
}

// mbarriers (shared::cta): the ring of row 6 between its producer warpgroup
// and its two consumer warpgroups
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// arrives once this thread's earlier cp.async copies have landed (counted at init)
__device__ __forceinline__ void mbar_arrive_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
// barrier of the 256 consumer threads (id 1; __syncthreads is id 0)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(THREADS) : "memory");
}

// grid (H, nsplit, B), THREADS + PRODUCERS threads: two consumer warpgroups
// and a producer warpgroup. base [B, K, E], pos [K, E], ws from wsplit_kernel,
// bk/bv [H D]. VEC: 16-byte copies of base and pos (E % 4 == 0, aligned).
// RES: the head's weights stay in shared memory (E_pad <= RES_MAX_E);
// else each stage streams its weight slice through the ring.
//
// The producer warpgroup fills ring slot s % NST with stage s once every consumer
// has released the slot's previous stage (empty[slot], 256 arrivals) and
// marks it full when its copies land (full[slot], 128 arrivals through
// cp.async.mbarrier.arrive). The consumers wait for full[slot], load their A
// fragments and release the slot, so neither warpgroup waits for the other
// inside a tile: one can split and load while the other's wgmma run. They
// meet twice a tile, around the k^ / v split buffers.
template <bool VEC, bool RES>
__global__ void __launch_bounds__(THREADS + PRODUCERS, 1) fused_partial_kernel(
    const float* __restrict__ qn, const float* __restrict__ base, const float* __restrict__ pos,
    const float* __restrict__ ws, const float* __restrict__ bk, const float* __restrict__ bv,
    const uint32_t* __restrict__ bits, const int* __restrict__ cnt, float* __restrict__ partial,
    int H, int Q, int E, int E_pad, int K, int words, int tiles_per_split, float c_log2) {
  const int head = blockIdx.x, split = blockIdx.y, b = blockIdx.z, nsplit = gridDim.y;
  const int tid = threadIdx.x, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int wg = tid >> 7;                  // consumers: projects k (0) or v (1); queries 64 wg ..
  const int wr = ((tid >> 5) & 3) * 16;     // this warp's 16 rows of the warpgroup's 64
  const int q0 = wg * 64;
  const int qr = q0 + wr + g;
  const bool attends = q0 < Q;
  const int e0 = head * D;
  const int slot_floats = 2 * TK * AS + (RES ? 0 : WSTAGE);

  extern __shared__ __align__(128) float smem[];
  float* w_s = smem;                                   // RES: [hi, lo][64 cols][K = E_pad]
  float* ring = w_s + (RES ? 2 * NW * E_pad : 0);      // [NST][base, pos (, weights)]
  float* k_hi = ring + NST * slot_floats;              // [64 keys][K = 32 d]: k^, split
  float* k_lo = k_hi + TK * D;
  float* v_hi = k_lo + TK * D;                         // [32 d][K = 64 keys, permuted]
  float* v_lo = v_hi + TK * D;
  uint32_t* m_ring = reinterpret_cast<uint32_t*>(v_lo + TK * D);   // [2][MAX_Q * MW]
  int* guard_s = reinterpret_cast<int*>(m_ring + 2 * MAX_Q * MW);  // [MAX_Q]
  uint64_t* full = reinterpret_cast<uint64_t*>(guard_s + MAX_Q);  // [NST]
  uint64_t* empty = full + NST;                                    // [NST]

  const float* wsh = ws + (size_t)head * 2 * NW * E_pad;
  if (RES) {
    for (int l = tid; l < 2 * NW * E_pad / 4; l += blockDim.x)
      cp_async16(w_s + 4 * l, wsh + 4 * l, true);
  }
  cp_commit();
  if (tid < MAX_Q) guard_s[tid] = tid < Q && cnt[b * Q + tid] == 0;
  if (tid < NST) {
    mbar_init(&full[tid], PRODUCERS);
    mbar_init(&empty[tid], THREADS);
  }
  cp_wait<0>();
  fence_async_smem();   // the weights are read by wgmma (the async proxy)
  __syncthreads();

  const int ntiles = (K + TK - 1) / TK;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(t_begin + tiles_per_split, ntiles);
  const int nc = E_pad / EC;                       // stages per tile
  const int nstages = max(t_end - t_begin, 0) * nc;

  if (tid >= THREADS) {   // the producer warpgroup
    const int pt = tid - THREADS;
    const float* bb_in = base + (size_t)b * K * E;
    for (int s = 0; s < nstages; ++s) {
      const int tile = t_begin + s / nc, c0 = (s % nc) * EC, k0 = tile * TK, slot = s % NST;
      if (s >= NST) mbar_wait(&empty[slot], ((s / NST) + 1) & 1);
      float* a_b = ring + slot * slot_floats;   // [64 keys][AS]
      float* a_p = a_b + TK * AS;
      if (VEC) {
        for (int l = pt; l < TK * (EC / 4); l += PRODUCERS) {
          const int n = l / (EC / 4), c4 = (l % (EC / 4)) * 4;
          const bool ok = k0 + n < K && c0 + c4 < E;
          const size_t off = (size_t)(k0 + n) * E + c0 + c4;
          cp_async16(a_b + n * AS + c4, ok ? bb_in + off : bb_in, ok);
          cp_async16(a_p + n * AS + c4, ok ? pos + off : pos, ok);
        }
      } else {
        for (int l = pt; l < TK * EC; l += PRODUCERS) {
          const int n = l / EC, c = l % EC;
          const bool ok = k0 + n < K && c0 + c < E;
          const size_t off = (size_t)(k0 + n) * E + c0 + c;
          cp_async4(a_b + n * AS + c, ok ? bb_in + off : bb_in, ok);
          cp_async4(a_p + n * AS + c, ok ? pos + off : pos, ok);
        }
      }
      if (!RES) {   // hi, lo x 8 row groups x 8 core matrices (1 KB a row group)
        float* w_st = a_p + TK * AS;
        for (int l = pt; l < WSTAGE / 4; l += PRODUCERS) {
          const int hl = l / (NW * EC / 4), r = l % (NW * EC / 4);
          const int rg = r / (EC * 2), within = r % (EC * 2);   // 8 x 128 B = 64 pieces
          cp_async16(w_st + hl * NW * EC + rg * 8 * EC + within * 4,
                     wsh + (size_t)hl * NW * E_pad + ((size_t)rg * (E_pad / 4) + c0 / 4) * 32 +
                         within * 4, true);
        }
      }
      mbar_arrive_copies(&full[slot]);
    }
    cp_wait<0>();
    return;
  }

  uint32_t qh[4][4], ql[4][4];
  load_queries(qn + ((size_t)b * H + head) * Q * D, Q, qr, tg, qh, ql);
  float o[16], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 16; ++i) o[i] = 0.f;
  const uint32_t* bb = bits + (size_t)b * Q * words;

  float run[16];   // this warpgroup's k or v tile, summed over the stages
  for (int s = 0; s < nstages; ++s) {
    const int c = s % nc, tile = t_begin + s / nc, slot = s % NST;
    if (c == 0) {
#pragma unroll
      for (int i = 0; i < 16; ++i) run[i] = 0.f;
      // the tile's mask words, read by its attention (tile parity: the last
      // reader of this buffer, tile - 2, passed the consumers' barriers since)
      issue_words(m_ring + (tile & 1) * MAX_Q * MW, bb, tile, Q, words, tid);
      cp_commit();
    }
    mbar_wait(&full[slot], (s / NST) & 1);
    if (!RES) fence_async_smem();   // the streamed weights are read by wgmma
    // 1. run += A W over these 32 channels, from zero (the chunk), A = base (+ pos)
    {
      const float* a_b = ring + slot * slot_floats;
      const float* a_p = a_b + TK * AS;
      const float* wh;
      int wstride;   // bytes between 8-row groups of the B operand
      if (RES) {
        wh = w_s + (wg * 4 * (E_pad / 4) + c * (EC / 4)) * 32;
        wstride = (E_pad / 4) * 128;
      } else {
        wh = a_p + TK * AS + wg * 4 * (EC / 4) * 32;
        wstride = (EC / 4) * 128;
      }
      const float* wl = wh + NW * (RES ? E_pad : EC);
      float acc[16];
      uint32_t ah[2][4], al[2][4];
      wg_pin(acc);
#pragma unroll
      for (int kk = 0; kk < EC / 8; ++kk) {
        const int ab = kk & 1;
        if (kk >= 2) wg_wait<1>();   // the wgmma that read this A buffer is done
        const int off = (wr + g) * AS + kk * 8 + tg;
        float x0 = a_b[off], x1 = a_b[off + 8 * AS], x2 = a_b[off + 4], x3 = a_b[off + 8 * AS + 4];
        if (wg == 0) {
          x0 += a_p[off];
          x1 += a_p[off + 8 * AS];
          x2 += a_p[off + 4];
          x3 += a_p[off + 8 * AS + 4];
        }
        if (RES && kk == EC / 8 - 1) mbar_arrive(&empty[slot]);   // the slot is read
        split_tf32(x0, ah[ab][0], al[ab][0]);
        split_tf32(x1, ah[ab][1], al[ab][1]);
        split_tf32(x2, ah[ab][2], al[ab][2]);
        split_tf32(x3, ah[ab][3], al[ab][3]);
        wg_fence();
        wgmma_3xtf32(acc, ah[ab], al[ab], smem_desc(wh + 2 * kk * 32, 128, wstride),
                     smem_desc(wl + 2 * kk * 32, 128, wstride), kk == 0);
        wg_commit();
      }
      wg_wait<0>();
      wg_pin(acc);
      if (!RES) mbar_arrive(&empty[slot]);   // its weights are read too
#pragma unroll
      for (int i = 0; i < 16; ++i) run[i] += acc[i];
    }
    if (c != nc - 1) continue;

    // 2. the tile's k^ (warpgroup 0) or v (1) from the accumulators, split
    //    into the B layouts of S and O. run[4 j + e]: key wr + g + 8 (e >> 1),
    //    column 8 j + 2 tg + (e & 1)
    consumers_sync();   // the last tile's attention is done with the split buffers
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int t = wr + g + 8 * rr;
      if (wg == 0) {
        float kv[8];
        float ss = 0.f;   // per-head L2 norm: the quad's 4 lanes hold the key's 32 values
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            kv[2 * j + e] = run[4 * j + 2 * rr + e] + __ldg(bk + e0 + 8 * j + 2 * tg + e);
            ss = fmaf(kv[2 * j + e], kv[2 * j + e], ss);
          }
        ss += __shfl_xor_sync(0xffffffffu, ss, 1);
        ss += __shfl_xor_sync(0xffffffffu, ss, 2);
        const float inv = rsqrtf(ss + 1e-24f);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t h0, l0, h1, l1;
          split_tf32(kv[2 * j] * inv, h0, l0);
          split_tf32(kv[2 * j + 1] * inv, h1, l1);
          const int off = core_off(t, 8 * j + 2 * tg, D / 4);
          *reinterpret_cast<float2*>(k_hi + off) =
              make_float2(__uint_as_float(h0), __uint_as_float(h1));
          *reinterpret_cast<float2*>(k_lo + off) =
              make_float2(__uint_as_float(l0), __uint_as_float(l1));
        }
      } else {
        // K index of key t within its 8-key step: 2 t' -> t' (t' < 4), 2 t' + 1 -> 4 + t'
        const int kidx = (t & ~7) + ((t & 1) << 2) + ((t & 7) >> 1);
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int d = 8 * j + 2 * tg + e;
            uint32_t h, l;
            split_tf32(run[4 * j + 2 * rr + e] + __ldg(bv + e0 + d), h, l);
            const int off = core_off(d, kidx, TK / 4);
            v_hi[off] = __uint_as_float(h);
            v_lo[off] = __uint_as_float(l);
          }
      }
    }
    fence_async_smem();
    cp_wait<0>();        // this thread's copies of the tile's mask words
    consumers_sync();

    // 3. the attention over the tile
    if (attends)
      attend_tile(qh, ql, k_hi, k_lo, v_hi, v_lo, m_ring + (tile & 1) * MAX_Q * MW, guard_s, qr,
                  tg, Q, tile * TK, K, c_log2, o, rs);
  }
  if (attends)
    write_partial(partial + (((size_t)b * nsplit + split) * H + head) * Q * (D + 1), o, rs, qr,
                  tg, Q);
}

// ---- reduction -------------------------------------------------------------

// out[b,h,q,d] = sum_s num / max(sum_s den, 1e-30), summed in split order.
__global__ void attn_reduce_kernel(const float* __restrict__ partial,
                                   float* __restrict__ out, int H, int Q, int nsplit) {
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

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

int pad_channels(int E) { return (E + EC - 1) / EC * EC; }

int smem_bytes(int fused, int E) {
  if (!fused) return (int)(sizeof(float) * (SPLIT_FLOATS + 2 * SLOT5) + sizeof(int) * MAX_Q);
  const int E_pad = pad_channels(E);
  const bool res = E_pad <= RES_MAX_E;
  const int slot = 2 * TK * AS + (res ? 0 : WSTAGE);
  return (int)(sizeof(float) * ((res ? 2 * NW * E_pad : 0) + NST * slot + SPLIT_FLOATS) +
               sizeof(uint32_t) * 2 * MAX_Q * MW + sizeof(int) * MAX_Q +
               sizeof(uint64_t) * 2 * NST);
}

bool bad_shape(int B, int H, int Q, int Dh, int K, int nsplit, int tiles_per_split) {
  return Dh != D || B < 1 || B > 65535 || H < 1 || H > 65535 || Q < 1 || Q > MAX_Q || K < 1 ||
         nsplit < 1 || nsplit > 65535 || tiles_per_split < 1 ||
         (long long)nsplit * tiles_per_split * TK < K || (long long)B * Q > 0x7fffffffLL ||
         (K + CB - 1) / CB > 65535;
}

// zeroes cnt, launches the count pass
cudaError_t launch_count(const float* logits, uint32_t* bits, int* cnt, int B, int Q, int K,
                         cudaStream_t s) {
  cudaError_t err = cudaMemsetAsync(cnt, 0, sizeof(int) * B * Q, s);
  if (err != cudaSuccess) return err;
  count_bits_kernel<<<dim3(B * Q, (K + CB - 1) / CB), 256, 0, s>>>(logits, bits, cnt, K,
                                                                   (K + 31) / 32);
  return cudaGetLastError();
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

extern "C" {

// Dynamic shared memory of the attention pass, in bytes (fused: row 6 at E
// input channels).
int uoms_mattn_smem_bytes(int fused, int E) { return smem_bytes(fused, E); }

const char* uoms_mattn_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// Row 5. k, v [B, H, K, D] f32, or [B, H, D, K] with kv_transposed; logits
// [B, Q, K]. Scratch (allocated by the caller): bits [B, Q, ceil(K/32)] u32,
// cnt [B, Q] i32, partial [B, nsplit, H, Q, D+1] f32. Returns
// cudaGetLastError() (or the first error met).
int uoms_masked_attn(const float* qn, const float* k, const float* v, int kv_transposed,
                     const float* logits, float* out, uint32_t* bits, int* cnt, float* partial,
                     int B, int H, int Q, int Dh, int K, int nsplit, int tiles_per_split,
                     float kappa, void* stream) {
  if (bad_shape(B, H, Q, Dh, K, nsplit, tiles_per_split)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err = launch_count(logits, bits, cnt, B, Q, K, s);
  if (err != cudaSuccess) return (int)err;
  const bool vec = aligned16(k) && aligned16(v) && (!kv_transposed || K % 4 == 0);
  auto kernel = kv_transposed
                    ? (vec ? mha_partial_kernel<true, true> : mha_partial_kernel<true, false>)
                    : (vec ? mha_partial_kernel<false, true> : mha_partial_kernel<false, false>);
  const int smem = smem_bytes(0, 0);
  err = set_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(H, nsplit, B), THREADS, smem, s>>>(qn, k, v, bits, cnt, partial, H, Q, K,
                                                   (K + 31) / 32, tiles_per_split,
                                                   kappa * 1.4426950408889634f);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attn_reduce_kernel<<<B * H * Q, 64, 0, s>>>(partial, out, H, Q, nsplit);
  return (int)cudaGetLastError();
}

// Row 6. base [B, K, E], pos [K, E], wk/wv [E, H D], bk/bv [H D], logits
// [B, Q, K]. Scratch: ws [H, 2, 64, ceil(E/32)*32] f32, bits, cnt and
// partial as row 5. Returns cudaGetLastError() (or the first error met).
int uoms_fused_masked_attn(const float* qn, const float* base, const float* pos,
                           const float* wk, const float* bk, const float* wv, const float* bv,
                           const float* logits, float* out, float* ws, uint32_t* bits, int* cnt,
                           float* partial, int B, int H, int Q, int Dh, int E, int K, int nsplit,
                           int tiles_per_split, float kappa, void* stream) {
  if (bad_shape(B, H, Q, Dh, K, nsplit, tiles_per_split) || E < 1 || !aligned16(ws))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int E_pad = pad_channels(E);
  const long long wn = (long long)H * NW * E_pad;
  wsplit_kernel<<<(unsigned)((wn + 255) / 256), 256, 0, s>>>(wk, wv, ws, H, E, E_pad);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = launch_count(logits, bits, cnt, B, Q, K, s);
  if (err != cudaSuccess) return (int)err;
  const bool vec = E % 4 == 0 && aligned16(base) && aligned16(pos);
  const bool res = E_pad <= RES_MAX_E;
  auto kernel = fused_partial_kernel<false, false>;
  if (vec && res) kernel = fused_partial_kernel<true, true>;
  else if (vec) kernel = fused_partial_kernel<true, false>;
  else if (res) kernel = fused_partial_kernel<false, true>;
  const int smem = smem_bytes(1, E);
  err = set_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(H, nsplit, B), THREADS + PRODUCERS, smem, s>>>(
      qn, base, pos, ws, bk, bv, bits, cnt, partial, H, Q, E, E_pad, K, (K + 31) / 32,
      tiles_per_split, kappa * 1.4426950408889634f);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attn_reduce_kernel<<<B * H * Q, 64, 0, s>>>(partial, out, H, Q, nsplit);
  return (int)cudaGetLastError();
}

}  // extern "C"
