// Fused masked vMF cross-attention of the MSMFormer decoder, for Hopper (sm_90a).
//
// Replaces unseenobjectswithmeanshift_tpu/ops/fused_cross_attention.py
// fused_uoms_cross_attention, dense branch (_kernel :244, _tile_body :171),
// and its tile-skipping branch (tile_plan=, _kernel_skip :282, pallas_call
// :483). Same inputs, same output: [B, H, Q, D] attention output before the
// final per-head normalization.
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
// The positional term. The decoder's pos is the DETR sine encoding, laid out
// [y-feats | x-feats]: its first E/2 channels depend on the row y of key t
// only, the last E/2 on the column x only. So wk^T pos_t + ck = Py[y] + Px[x]
// with Py = pos_y^T wk[:E/2] + ck ([h, E]) and Px = pos_x^T wk[E/2:] ([w, E]):
// 2 (h + w) (E/2) E operations (73 MFLOP at 480x640) and 1.1 MB of tables,
// where the full projection is 2 K E^2 (40 GFLOP) and 315 MB. The separable
// form takes pos_y [E/2, h] and pos_x [E/2, w] (key t = y w + x) and builds
// the two tables with pos_table_kernel; the general form takes posT [E, K],
// builds the [K, E] table with the same kernel and a zero [1, E] one, and
// runs the same attention pass with w = 1. The general form is off the main
// path (the wrapper counts its launches apart).
//
// Passes, launched in order on the caller's stream by one C entry:
//   pos_table_kernel  Py, Px (or P and zeros)        plain FMA, 64x64 tiles
//   mask_kernel       bit[b, q, k] = me.mf >= 0, cnt[b, q] = #unmasked keys
//   xattn_partial     per 64-key tile: k/v projection, per-head L2 norm,
//                     S = q.k^, p = exp2(c s - c) under the mask, O += P V
//   xattn_reduce      sum the splits in order, divide by the row sums
// (uoms_mask_pass runs the mask pass alone, for checking its bits.)
//
// Splits. Hopper runs blocks in no order, so the key axis is cut into
// splits, one block per (split, head, image), each looping over its key
// tiles. Every weight lies in [e^-2kappa, 1] (e^-60 ~ 9e-27 is a normal
// float), so partial sums over disjoint key ranges simply add: no running
// maximum and no rescaling, and the last kernel sums them in a fixed order
// (deterministic run to run). The guard needs to know per query whether ANY
// key of the image is unmasked: the mask pass counts the unmasked keys per
// query, and the attention pass reads a query with count 0 as unmasked
// everywhere.
//
// Tensor cores, 3xTF32. Every product runs on the tensor cores in TF32
// with fp32 accumulation, each operand split as a = a_hi + a_lo, a_hi =
// rna(a), a_lo = rna(a - a_hi), and a b ~ a_lo b_hi + a_hi b_lo + a_hi b_hi
// (the small terms first). rna is cvt.rna.tf32.f32 (10 mantissa bits, ties
// away from zero), computed as two integer operations on the bits, which
// give the same bits and ran faster than the conversion instruction on the
// H100 (PERF.md section 6). The dropped a_lo b_lo is ~2^-22 of a b, near fp32
// rounding (tests/test_torch_tf32_split.py models the whole function in
// numpy against fp64). No product is left on fp32 FMA: with each one in
// 3xTF32 the kernel stays within 2e-6 to 5e-6 of fp64 on the check inputs,
// the error of the fp32 kernel it replaces. The products, M x N x K:
//   mask  [Q, 16-row tiles, <= 128] x [128 keys] x [Cm, 32 a stage]  mma.sync
//   k/v   [64 keys] x [32] x [C = 64], k and v a warpgroup each      wgmma
//   S     [Q, 64-row tiles] x [32 keys] x [D = 32], per head         wgmma
//   O     [Q, 64-row tiles] x [D = 32] x [32 keys], per head         wgmma
// The tensor core adds into its accumulator by truncation, so a long chain
// into one accumulator drifts; the attention's O and row sums start from
// zero each tile and are added to the running sums with round-to-nearest
// fp32 adds. The weights use ex2.approx (the exponent lies in
// [-2 kappa log2 e, 0], far from the flush-to-zero range).
//
// wgmma where the layout allows it, mma.sync elsewhere. wgmma reads B from
// shared memory, and for .tf32 only K-major (the transposed form is for
// 16-bit types); A may come from registers in the mma.sync fragment layout.
// The attention pass writes its own B operands: the head's awk | awv columns
// once a block, k^ and v once a tile, split (hi and lo arrays) into K-major
// 8 x 4 core matrices with no swizzle (leading offset: the next core matrix
// along K, 128 bytes; stride offset: the next 8 rows). Its A operands come
// from registers: the feature tile (key-contiguous in shared memory, so
// loaded by hand, conflict-free with a row stride of 72 floats, and split),
// the queries (split once a block), and P straight from the S accumulators:
// the key index of each 8-key step is permuted (fragment column j <-> key
// 2j, j + 4 <-> key 2j + 1), in P's registers and in v's layout alike, so no
// shuffle is needed. The mask pass's B operand, mfT, is key-contiguous
// (MN-major), which wgmma .tf32 does not take, and transposing 315 MB a call
// through shared memory is not paid: it stays on mma.sync.m16n8k8 with
// fragments loaded by hand (row strides 136 and 36 floats, conflict-free).
// On the H100, wgmma sustains more TF32 throughput than mma.sync (PERF.md).
//
// Copies. Features, mask features, mask embeds and mask words reach shared
// memory by cp.async (16 bytes where K % 4 == 0 and the rows are aligned,
// else 4), two stages: the mask pass streams mfT and me in 32-channel
// stages, the attention pass loads tile t + 1 (mask words, then features)
// while tile t computes.
//
// Occupancy. The attention pass runs 2 warpgroups a block at 128 registers
// (124-148 bytes spilled; 216 in the skipping modes) and 103 KB of shared
// memory (features 2 x 18 KB, awk | awv split 32 KB, k^ and v split 32 KB):
// two blocks, 16 warps, per SM. Warpgroup 0 projects k, warpgroup 1 v (64
// keys each); then each attends for 64 queries (rows past Q are padding:
// 28 of 128 at Q = 100).
// The mask pass runs 8 warps of 64 queries x 32 keys (one mask word) at
// 71 KB, two blocks (16 warps) per SM.
//
// Tile skipping (MODE 1; decoder.tile_skip). A block holds every query of
// its image, so once the mask words of a tile are in shared memory (with
// the count-0 rule applied), "no query of this image has a bit in this
// tile" is one __syncthreads_or, taken before any feature copy of that
// tile: the copy of tile t + 1's mask words comes first, and a skipped tile
// issues no feature copy. Such a tile adds exact zeros everywhere: its P is
// zero, so its O products (summed from zero for the tile) are +-0 and leave
// the running sums unchanged, bit for bit. The splits and the order of the
// remaining tiles are the dense kernel's. MODE 2 runs the same code with
// every tile counted as present (the tile_skip_force_all control). A query
// whose mask is empty (the guard) attends to every key and keeps every tile
// of its image.
//
// Bound. Per layer and 480x640 image (K = 307,200, H = 8, Q = 100, D = 32,
// C = 64, Cm = E = 256): mask 2 Q K Cm = 15.7 G, k/v 2*2 K C E = 20.1 G,
// q.k^ 2 H Q K D = 15.7 G, p.v 2 H Q K (D+1) = 16.2 G: 67.7 GFLOP of
// products, plus the separable pos tables (0.07 G). Each input read once is
// featT 79 MB + mfT 315 MB. In 3xTF32 (three TF32 products each: 495 / 3 =
// 165 TFLOP/s) the operations take 0.41 ms, memory 0.12 ms at 3.35 TB/s: the
// kernel is bounded by operations (1.01 ms at the 67 TFLOP/s fp32 rate).
// Measured on the H100 (PERF.md section 6): ~1.7-1.8 ms a call.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

constexpr int HEAD_DIM = 32;          // D: per-head width (256 / 8)
constexpr int TK = 64;                // keys per tile of the attention pass
constexpr int MAX_Q = 128;            // queries: 8 tiles of 16 rows
constexpr int MAX_C = 64;             // feature channels
constexpr int XT = 256;               // threads of the attention pass (2 warpgroups)
constexpr int FS = TK + 8;            // f_s row stride (floats)
constexpr int MW = TK / 32;           // mask words per query per tile
constexpr int MK = 128;               // keys per block of the mask pass
constexpr int MC = 32;                // channels per stage of the mask pass
constexpr int MFS = MK + 8;           // mf_s row stride
constexpr int MES = MC + 4;           // me_s row stride
constexpr int PP_TILE = 64;           // pos table output tile (rows and columns)
constexpr int PP_BK = 16;             // pos table reduction step

// ---- positional tables -----------------------------------------------------

// T[n * E + e] = sum_{j < J} pos[j * N + n] * W[j * E + e] (+ c[e] if c)
__global__ void __launch_bounds__(256) pos_table_kernel(
    const float* __restrict__ W, const float* __restrict__ pos, const float* __restrict__ c,
    float* __restrict__ T, int J, int E, int N) {
  __shared__ float As[PP_BK][PP_TILE];  // As[j][e]
  __shared__ float Bs[PP_BK][PP_TILE];  // Bs[j][n]
  const int n0 = blockIdx.x * PP_TILE;
  const int e0 = blockIdx.y * PP_TILE;
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // rows n0 + tx*4 + j
  const int ty = tid / 16;  // columns e0 + ty*4 + i
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int j0 = 0; j0 < J; j0 += PP_BK) {
    for (int l = tid; l < PP_BK * PP_TILE; l += 256) {
      const int r = l / PP_TILE, cc = l % PP_TILE, j = j0 + r;
      As[r][cc] = (j < J && e0 + cc < E) ? W[(size_t)j * E + e0 + cc] : 0.f;
      Bs[r][cc] = (j < J && n0 + cc < N) ? pos[(size_t)j * N + n0 + cc] : 0.f;
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
    const int n = n0 + tx * 4 + j;
    if (n >= N) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = e0 + ty * 4 + i;
      if (e < E) T[(size_t)n * E + e] = acc[i][j] + (c ? c[e] : 0.f);
    }
  }
}

// ---- mask pass -------------------------------------------------------------

// bits[(b*Q + q) * words + w] bit i = (me[b,q] . mf[b,:,32w+i] >= 0) for keys < K;
// cnt[b*Q + q] += number of such keys (cnt zeroed by the caller). One block per
// (128 keys, image); warp (wm, wn) holds queries 64 wm .. 64 wm + 63 and keys
// 32 wn .. 32 wn + 31 of the block: one mask word per query.
template <bool VEC>
__global__ void __launch_bounds__(256, 2) mask_kernel(
    const float* __restrict__ me, const float* __restrict__ mfT,
    const int* __restrict__ present, uint32_t* __restrict__ bits,
    int* __restrict__ cnt, int Q, int Cm, int K, int words) {
  const int b = blockIdx.y;
  if (!present[b]) return;
  extern __shared__ __align__(16) float msmem[];
  float* mf_s = msmem;                               // [2][MC][MFS]
  float* me_s = mf_s + 2 * MC * MFS;                 // [2][MAX_Q][MES]
  int* cnt_s = reinterpret_cast<int*>(me_s + 2 * MAX_Q * MES);  // [MAX_Q]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const int k0 = blockIdx.x * MK;
  const float* mfb = mfT + (size_t)b * Cm * K;
  const float* meb = me + (size_t)b * Q * Cm;
  if (tid < MAX_Q) cnt_s[tid] = 0;

  auto issue = [&](int c0, int s) {
    float* mfd = mf_s + s * MC * MFS;
    float* med = me_s + s * MAX_Q * MES;
    if (VEC) {
      for (int l = tid; l < MC * (MK / 4); l += 256) {
        const int r = l / (MK / 4), k4 = (l % (MK / 4)) * 4;
        const bool ok = c0 + r < Cm && k0 + k4 < K;
        cp_async16(mfd + r * MFS + k4, ok ? mfb + (size_t)(c0 + r) * K + k0 + k4 : mfb, ok);
      }
      for (int l = tid; l < MAX_Q * (MC / 4); l += 256) {
        const int q = l / (MC / 4), c4 = (l % (MC / 4)) * 4;
        const bool ok = q < Q && c0 + c4 < Cm;
        cp_async16(med + q * MES + c4, ok ? meb + (size_t)q * Cm + c0 + c4 : meb, ok);
      }
    } else {
      for (int l = tid; l < MC * MK; l += 256) {
        const int r = l / MK, kk = l % MK;
        const bool ok = c0 + r < Cm && k0 + kk < K;
        cp_async4(mfd + r * MFS + kk, ok ? mfb + (size_t)(c0 + r) * K + k0 + kk : mfb, ok);
      }
      for (int l = tid; l < MAX_Q * MC; l += 256) {
        const int q = l / MC, cc = l % MC;
        const bool ok = q < Q && c0 + cc < Cm;
        cp_async4(med + q * MES + cc, ok ? meb + (size_t)q * Cm + c0 + cc : meb, ok);
      }
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mt][nt][j] = 0.f;

  const int nst = (Cm + MC - 1) / MC;
  issue(0, 0);
  cp_commit();
  for (int st = 0; st < nst; ++st) {
    if (st + 1 < nst) issue((st + 1) * MC, (st + 1) & 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const float* mfs = mf_s + (st & 1) * MC * MFS + wn * 32;
    const float* mes = me_s + (st & 1) * MAX_Q * MES;
#pragma unroll
    for (int kk = 0; kk < MC; kk += 8) {
      uint32_t bh[4][2], bl[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        split_tf32(mfs[(kk + tg) * MFS + nt * 8 + g], bh[nt][0], bl[nt][0]);
        split_tf32(mfs[(kk + tg + 4) * MFS + nt * 8 + g], bh[nt][1], bl[nt][1]);
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int r0 = wm * 64 + mt * 16;
        if (r0 < Q) {   // warp-uniform
          uint32_t ah[4], al[4];
          split_tf32(mes[(r0 + g) * MES + kk + tg], ah[0], al[0]);
          split_tf32(mes[(r0 + g + 8) * MES + kk + tg], ah[1], al[1]);
          split_tf32(mes[(r0 + g) * MES + kk + tg + 4], ah[2], al[2]);
          split_tf32(mes[(r0 + g + 8) * MES + kk + tg + 4], ah[3], al[3]);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma_3xtf32(acc[mt][nt], ah, al, bh[nt], bl[nt]);
        }
      }
    }
    __syncthreads();
  }

  // Accumulator (mt, nt, j) of this lane holds query r0 + g (+8 for j >= 2) at
  // key 32 wn + 8 nt + 2 tg + (j & 1). A ballot gathers one (nt, j) over the
  // warp; the 4 bits of row g sit at 4 g .. 4 g + 3 (one per tg) and go to
  // word bits 8 nt + 2 tg + (j & 1).
  const int word = k0 / 32 + wn;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
    const int r0 = wm * 64 + mt * 16;
    if (r0 >= Q) break;   // warp-uniform
    uint32_t w0 = 0u, w1 = 0u;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + wn * 32 + nt * 8 + 2 * tg + (j & 1);
        const uint32_t bal = __ballot_sync(0xffffffffu, acc[mt][nt][j] >= 0.f && key < K);
        const uint32_t nib = (bal >> (4 * g)) & 0xfu;
        const uint32_t spread = ((nib & 1u) | ((nib & 2u) << 1) | ((nib & 4u) << 2) |
                                 ((nib & 8u) << 3)) << (nt * 8 + (j & 1));
        if (j < 2) w0 |= spread; else w1 |= spread;
      }
    const int q0 = r0 + g, q1 = q0 + 8;
    if (word < words) {
      if (tg == 0 && q0 < Q) {
        bits[((size_t)b * Q + q0) * words + word] = w0;
        atomicAdd(&cnt_s[q0], __popc(w0));
      }
      if (tg == 1 && q1 < Q) {
        bits[((size_t)b * Q + q1) * words + word] = w1;
        atomicAdd(&cnt_s[q1], __popc(w1));
      }
    }
  }
  __syncthreads();
  if (tid < Q && cnt_s[tid] != 0) atomicAdd(&cnt[b * Q + tid], cnt_s[tid]);
}

// ---- attention pass --------------------------------------------------------

__device__ __forceinline__ uint32_t valid_bits(int key0, int K) {
  const int n = min(max(K - key0, 0), 32);
  return n == 32 ? 0xffffffffu : ((1u << n) - 1u);
}

// One block per (key split, head, image), two warpgroups. partial layout
// [B][nsplit][H][Q][D+1]; column D is the row sum of the weights.
// pos_t = pos_row[(t / pos_w) E + e] + pos_col[(t % pos_w) E + e] (ck in pos_row).
// MODE 0: dense; 1: skip tiles where no query of the image has a mask bit;
// 2: the skipping code with every tile present (control).
template <int MODE, bool VEC>
__global__ void __launch_bounds__(XT, 2) xattn_partial_kernel(
    const float* __restrict__ qn, const float* __restrict__ featT,
    const float* __restrict__ pos_row, const float* __restrict__ pos_col, int pos_w,
    const float* __restrict__ awk, const float* __restrict__ awv,
    const float* __restrict__ cv, const uint32_t* __restrict__ bits,
    const int* __restrict__ cnt, const int* __restrict__ present,
    float* __restrict__ partial, int H, int Q, int C, int K, int words,
    int tiles_per_split, float c_log2) {
  constexpr int D = HEAD_DIM;
  const int split = blockIdx.x, head = blockIdx.y, b = blockIdx.z;
  const int nsplit = gridDim.x;
  const int E = H * D;
  const int e0 = head * D;
  const int tid = threadIdx.x, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int wg = tid >> 7;           // warpgroup: projects k (0) or v (1)
  const int wr = ((tid >> 5) & 3) * 16;   // this warp's 16 rows of the warpgroup's 64
  const int q0 = wg * 64;            // queries q0 .. q0 + 63 of this warpgroup
  const bool attends = q0 < Q;

  float o[16];   // O: rows q0 + wr + g (+8), d = 8 j + 2 tg (+1), j = 0..3
  float rs[2];   // row sums of rows g, g + 8
#pragma unroll
  for (int i = 0; i < 16; ++i) o[i] = 0.f;
  rs[0] = rs[1] = 0.f;

  if (present[b]) {
    extern __shared__ __align__(128) float smem[];
    float* f_s = smem;                        // [2][C][FS] raw features
    float* w_hi = f_s + 2 * C * FS;           // [64 cols][K = C]: awk | awv, split
    float* w_lo = w_hi + 64 * MAX_C;
    float* k_hi = w_lo + 64 * MAX_C;          // [64 keys][K = 32 d]: k^, split
    float* k_lo = k_hi + TK * D;
    float* v_hi = k_lo + TK * D;              // [32 d][K = 64 keys, permuted]: v, split
    float* v_lo = v_hi + TK * D;
    uint32_t* m_s = reinterpret_cast<uint32_t*>(v_lo + TK * D);   // [2][MAX_Q * MW]
    int* guard_s = reinterpret_cast<int*>(m_s + 2 * MAX_Q * MW);  // [MAX_Q]

    for (int l = tid; l < C * 2 * D; l += XT) {
      const int c = l / (2 * D), n = l % (2 * D);
      uint32_t hi, lo;
      split_tf32(n < D ? awk[(size_t)c * E + e0 + n] : awv[(size_t)c * E + e0 + n - D], hi, lo);
      const int off = core_off(n, c, MAX_C / 4);
      w_hi[off] = __uint_as_float(hi);
      w_lo[off] = __uint_as_float(lo);
    }
    if (tid < MAX_Q) guard_s[tid] = tid < Q && cnt[b * Q + tid] == 0;
    fence_async_smem();

    // this warp's queries, split once: A fragments of S
    uint32_t qh[4][4], ql[4][4];
    {
      const float* qs = qn + ((size_t)b * H + head) * Q * D;
      const int r0 = q0 + wr + g, r1 = r0 + 8;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const int d0 = ks * 8 + tg;
        split_tf32(r0 < Q ? qs[r0 * D + d0] : 0.f, qh[ks][0], ql[ks][0]);
        split_tf32(r1 < Q ? qs[r1 * D + d0] : 0.f, qh[ks][1], ql[ks][1]);
        split_tf32(r0 < Q ? qs[r0 * D + d0 + 4] : 0.f, qh[ks][2], ql[ks][2]);
        split_tf32(r1 < Q ? qs[r1 * D + d0 + 4] : 0.f, qh[ks][3], ql[ks][3]);
      }
    }

    const int ntiles = (K + TK - 1) / TK;
    const int t_begin = split * tiles_per_split;
    const int t_end = min(t_begin + tiles_per_split, ntiles);
    const float* fb = featT + (size_t)b * C * K;
    const uint32_t* bb = bits + (size_t)b * Q * words;

    auto issue_mask = [&](int tile, int buf) {
      uint32_t* dst = m_s + buf * MAX_Q * MW;
      for (int l = tid; l < Q * MW; l += XT) {
        const int widx = tile * MW + l % MW;
        const bool ok = widx < words;
        cp_async4(dst + l, ok ? bb + (size_t)(l / MW) * words + widx : bb, ok);
      }
    };
    auto issue_feat = [&](int tile, int buf) {
      float* dst = f_s + buf * C * FS;
      const int k0 = tile * TK;
      if (VEC) {
        for (int l = tid; l < C * (TK / 4); l += XT) {
          const int c = l / (TK / 4), t4 = (l % (TK / 4)) * 4;
          const bool ok = k0 + t4 < K;
          cp_async16(dst + c * FS + t4, ok ? fb + (size_t)c * K + k0 + t4 : fb, ok);
        }
      } else {
        for (int l = tid; l < C * TK; l += XT) {
          const int c = l / TK, t = l % TK;
          const bool ok = k0 + t < K;
          cp_async4(dst + c * FS + t, ok ? fb + (size_t)c * K + k0 + t : fb, ok);
        }
      }
    };
    // mask word w of query q in a staged tile: all ones for a guarded query, zero past K
    auto mask_word = [&](const uint32_t* ms, int q, int w, int k0) -> uint32_t {
      return (guard_s[q] ? 0xffffffffu : ms[q * MW + w]) & valid_bits(k0 + 32 * w, K);
    };
    // block-uniform: some query of the image has a bit in the staged tile
    auto tile_occupied = [&](int tile, int buf) -> bool {
      const uint32_t* ms = m_s + buf * MAX_Q * MW;
      int any = MODE == 2;
      for (int l = tid; l < Q * MW; l += XT) any |= mask_word(ms, l / MW, l % MW, tile * TK) != 0u;
      return __syncthreads_or(any) != 0;
    };

    int cur = t_begin;
    if constexpr (MODE != 0) {
      for (; cur < t_end; ++cur) {
        issue_mask(cur, 0);
        cp_commit();
        cp_wait<0>();
        __syncthreads();
        if (tile_occupied(cur, 0)) break;
      }
    } else {
      if (cur < t_end) issue_mask(cur, 0);
    }
    if (cur < t_end) issue_feat(cur, 0);
    cp_commit();

    int buf = 0;
    while (cur < t_end) {
      const int nb = buf ^ 1;
      int nxt = cur + 1;
      if constexpr (MODE == 0) {
        if (nxt < t_end) {
          issue_mask(nxt, nb);
          issue_feat(nxt, nb);
        }
        cp_commit();
        cp_wait<1>();            // this tile's group is complete
        __syncthreads();
      } else {
        for (;;) {               // probe the next tiles' mask words, in order
          if (nxt < t_end) issue_mask(nxt, nb);
          cp_commit();
          cp_wait<0>();
          __syncthreads();
          if (nxt >= t_end || tile_occupied(nxt, nb)) break;
          ++nxt;
        }
        if (nxt < t_end) issue_feat(nxt, nb);
        cp_commit();
      }

      const int k0 = cur * TK;
      const float* fs = f_s + buf * C * FS;
      const uint32_t* ms = m_s + buf * MAX_Q * MW;

      // 1. warpgroup 0: k = awk^T f + Py[y] + Px[x], normalized; warpgroup 1:
      //    v = awv^T f + cv; 64 keys x 32 columns, stored split for step 2
      {
        float acc[16];
        uint32_t ah[2][4], al[2][4];
        const float* wh = w_hi + wg * 4 * (MAX_C / 4) * 32;
        const float* wl = w_lo + wg * 4 * (MAX_C / 4) * 32;
        wg_pin(acc);
#pragma unroll
        for (int s = 0; s < MAX_C / 8; ++s) {
          if (8 * s >= C) break;      // block-uniform
          const int ab = s & 1;
          if (s >= 2) wg_wait<1>();   // the wgmma that read this A buffer is done
          const float* fr = fs + (8 * s + tg) * FS + wr + g;
          split_tf32(fr[0], ah[ab][0], al[ab][0]);
          split_tf32(fr[8], ah[ab][1], al[ab][1]);
          split_tf32(fr[4 * FS], ah[ab][2], al[ab][2]);
          split_tf32(fr[4 * FS + 8], ah[ab][3], al[ab][3]);
          wg_fence();
          wgmma_3xtf32(acc, ah[ab], al[ab], smem_desc(wh + 2 * s * 32, 128, (MAX_C / 4) * 128),
                       smem_desc(wl + 2 * s * 32, 128, (MAX_C / 4) * 128), s == 0);
          wg_commit();
        }
        wg_wait<0>();
        wg_pin(acc);
        // acc[4 j + e]: key wr + g + 8 (e >> 1), column 8 j + 2 tg + (e & 1)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int t = wr + g + 8 * rr, key = k0 + t;
          if (wg == 0) {
            if (key < K) {
              const int y = key / pos_w, x = key - y * pos_w;
              const float* pr = pos_row + (size_t)y * E + e0 + 2 * tg;
              const float* pc = pos_col + (size_t)x * E + e0 + 2 * tg;
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                const float2 a = __ldg(reinterpret_cast<const float2*>(pr + j * 8));
                const float2 c = __ldg(reinterpret_cast<const float2*>(pc + j * 8));
                acc[4 * j + 2 * rr] += a.x + c.x;
                acc[4 * j + 2 * rr + 1] += a.y + c.y;
              }
            }
            float ss = 0.f;   // per-head L2 norm: the quad's 4 lanes hold the key's 32 values
#pragma unroll
            for (int j = 0; j < 4; ++j)
              ss = fmaf(acc[4 * j + 2 * rr], acc[4 * j + 2 * rr],
                        fmaf(acc[4 * j + 2 * rr + 1], acc[4 * j + 2 * rr + 1], ss));
            ss += __shfl_xor_sync(0xffffffffu, ss, 1);
            ss += __shfl_xor_sync(0xffffffffu, ss, 2);
            const float inv = rsqrtf(ss + 1e-24f);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              uint32_t h0, l0, h1, l1;
              split_tf32(acc[4 * j + 2 * rr] * inv, h0, l0);
              split_tf32(acc[4 * j + 2 * rr + 1] * inv, h1, l1);
              const int off = core_off(t, 8 * j + 2 * tg, D / 4);
              *reinterpret_cast<float2*>(k_hi + off) =
                  make_float2(__uint_as_float(h0), __uint_as_float(h1));
              *reinterpret_cast<float2*>(k_lo + off) =
                  make_float2(__uint_as_float(l0), __uint_as_float(l1));
            }
          } else {
            // v: K index of key t within its 8-key step: 2 t' -> t' (t' < 4), 2 t' + 1 -> 4 + t'
            const int kidx = (t & ~7) + ((t & 1) << 2) + ((t & 7) >> 1);
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int d = 8 * j + 2 * tg + e;
                uint32_t h, l;
                split_tf32(acc[4 * j + 2 * rr + e] + __ldg(cv + e0 + d), h, l);
                const int off = core_off(d, kidx, TK / 4);
                v_hi[off] = __uint_as_float(h);
                v_lo[off] = __uint_as_float(l);
              }
          }
        }
      }
      fence_async_smem();
      __syncthreads();

      // 2. S = q k^T, P = mask exp2(c s - c), O += P V; 32 keys at a time
      if (attends) {   // warpgroup-uniform
        float t[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) t[i] = 0.f;
#pragma unroll
        for (int hk = 0; hk < 2; ++hk) {
          const int qr = q0 + wr + g;
          const uint32_t mw0 = qr < Q ? mask_word(ms, qr, hk, k0) : 0u;
          const uint32_t mw1 = qr + 8 < Q ? mask_word(ms, qr + 8, hk, k0) : 0u;
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
            if (j >= 2) wg_wait<1>();
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
      __syncthreads();
      cur = nxt;
      buf = nb;
    }
  }

  float* pb = partial + (((size_t)b * nsplit + split) * H + head) * Q * (D + 1);
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float sum = rs[rr];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const int q = q0 + wr + g + 8 * rr;
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

template <int MODE>
cudaError_t launch_partial(bool vec, dim3 grid, int smem, cudaStream_t s, const float* qn,
                           const float* featT, const float* pos_row, const float* pos_col,
                           int pos_w, const float* awk, const float* awv, const float* cv,
                           const uint32_t* bits, const int* cnt, const int* present,
                           float* partial, int H, int Q, int C, int K, int words,
                           int tiles_per_split, float c_log2) {
  auto kernel = vec ? xattn_partial_kernel<MODE, true> : xattn_partial_kernel<MODE, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, XT, smem, s>>>(qn, featT, pos_row, pos_col, pos_w, awk, awv, cv, bits, cnt,
                                present, partial, H, Q, C, K, words, tiles_per_split, c_log2);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// zeroes cnt and launches the mask pass
cudaError_t launch_mask(const float* me, const float* mfT, const int* present, uint32_t* bits,
                        int* cnt, int B, int Q, int Cm, int K, cudaStream_t s) {
  cudaError_t err = cudaMemsetAsync(cnt, 0, sizeof(int) * B * Q, s);
  if (err != cudaSuccess) return err;
  const bool mvec = K % 4 == 0 && Cm % 4 == 0 && aligned16(mfT) && aligned16(me);
  const int msmem = (int)(sizeof(float) * (2 * MC * MFS + 2 * MAX_Q * MES) + sizeof(int) * MAX_Q);
  auto mkernel = mvec ? mask_kernel<true> : mask_kernel<false>;
  err = cudaFuncSetAttribute(mkernel, cudaFuncAttributeMaxDynamicSharedMemorySize, msmem);
  if (err != cudaSuccess) return err;
  mkernel<<<dim3((K + MK - 1) / MK, B), 256, msmem, s>>>(me, mfT, present, bits, cnt, Q, Cm, K,
                                                         (K + 31) / 32);
  return cudaGetLastError();
}

// dynamic shared memory of the attention pass, in bytes
int xattn_smem_bytes(int C) {
  return (int)(sizeof(float) * (2 * C * FS + 2 * 64 * MAX_C + 4 * TK * HEAD_DIM) +
               sizeof(uint32_t) * 2 * MAX_Q * MW + sizeof(int) * MAX_Q);
}

}  // namespace

extern "C" {

const char* uoms_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// Launches the passes on `stream`. Positional input: pos_b == NULL takes the
// general form, pos_a = posT [E, K]; otherwise the separable form, pos_a =
// pos_y [E/2, pos_h] and pos_b = pos_x [E/2, pos_w] with pos_h * pos_w == K.
// Scratch (allocated by the caller): pos_row [K, E] (general) or [pos_h, E],
// pos_col [1, E] (general) or [pos_w, E], bits [B, Q, ceil(K/32)] u32,
// cnt [B, Q] i32, partial [B, nsplit, H, Q, D+1] f32. skip_mode: 0 dense,
// 1 tile skipping, 2 tile skipping with every tile present.
// Returns cudaGetLastError() (or the first error met).
int uoms_fused_xattn(const float* qn, const float* featT, const float* mfT,
                     const float* me, const float* pos_a, const float* pos_b,
                     const float* awk, const float* awv, const float* wk,
                     const float* ck, const float* cv, const int* present, float* out,
                     float* pos_row, float* pos_col, uint32_t* bits, int* cnt,
                     float* partial, int B, int H, int Q, int D, int C, int Cm, int K,
                     int pos_h, int pos_w, int nsplit, int tiles_per_split, float kappa,
                     int skip_mode, void* stream) {
  const int E = H * D;
  if (D != HEAD_DIM || H < 1 || Q < 1 || Q > MAX_Q || C < 8 || C > MAX_C ||
      C % 8 != 0 || Cm < 1 || B < 1 || K < 1 || nsplit < 1 ||
      (long long)nsplit * tiles_per_split * TK < K || skip_mode < 0 || skip_mode > 2)
    return (int)cudaErrorInvalidValue;
  if (pos_b != nullptr && ((long long)pos_h * pos_w != K || E % 2 != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int words = (K + 31) / 32;
  cudaError_t err;

  if (pos_b == nullptr) {
    pos_table_kernel<<<dim3((K + PP_TILE - 1) / PP_TILE, (E + PP_TILE - 1) / PP_TILE), 256, 0,
                       s>>>(wk, pos_a, ck, pos_row, E, E, K);
    err = cudaMemsetAsync(pos_col, 0, sizeof(float) * E, s);
    if (err != cudaSuccess) return (int)err;
    pos_w = 1;
  } else {
    const int half = E / 2;
    pos_table_kernel<<<dim3((pos_h + PP_TILE - 1) / PP_TILE, (E + PP_TILE - 1) / PP_TILE), 256,
                       0, s>>>(wk, pos_a, ck, pos_row, half, E, pos_h);
    pos_table_kernel<<<dim3((pos_w + PP_TILE - 1) / PP_TILE, (E + PP_TILE - 1) / PP_TILE), 256,
                       0, s>>>(wk + (size_t)half * E, pos_b, nullptr, pos_col, half, E, pos_w);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  err = launch_mask(me, mfT, present, bits, cnt, B, Q, Cm, K, s);
  if (err != cudaSuccess) return (int)err;

  const bool fvec = K % 4 == 0 && aligned16(featT);
  const int smem = xattn_smem_bytes(C);
  const dim3 grid(nsplit, H, B);
  const float c_log2 = kappa * 1.4426950408889634f;
  err = skip_mode == 0
            ? launch_partial<0>(fvec, grid, smem, s, qn, featT, pos_row, pos_col, pos_w, awk,
                                awv, cv, bits, cnt, present, partial, H, Q, C, K, words,
                                tiles_per_split, c_log2)
        : skip_mode == 1
            ? launch_partial<1>(fvec, grid, smem, s, qn, featT, pos_row, pos_col, pos_w, awk,
                                awv, cv, bits, cnt, present, partial, H, Q, C, K, words,
                                tiles_per_split, c_log2)
            : launch_partial<2>(fvec, grid, smem, s, qn, featT, pos_row, pos_col, pos_w, awk,
                                awv, cv, bits, cnt, present, partial, H, Q, C, K, words,
                                tiles_per_split, c_log2);
  if (err != cudaSuccess) return (int)err;

  xattn_reduce_kernel<<<B * H * Q, 64, 0, s>>>(partial, present, out, B, H, Q, nsplit);
  return (int)cudaGetLastError();
}

// The mask pass alone (bits and cnt as uoms_fused_xattn leaves them; the
// images with present[b] == 0 are not written), so that its bits can be
// checked on their own.
int uoms_mask_pass(const float* me, const float* mfT, const int* present, uint32_t* bits,
                   int* cnt, int B, int Q, int Cm, int K, void* stream) {
  if (B < 1 || Q < 1 || Q > MAX_Q || Cm < 1 || K < 1) return (int)cudaErrorInvalidValue;
  return (int)launch_mask(me, mfT, present, bits, cnt, B, Q, Cm, K,
                          reinterpret_cast<cudaStream_t>(stream));
}

}  // extern "C"
