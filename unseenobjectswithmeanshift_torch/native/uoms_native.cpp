// Host-side native library of the port: the evaluation inner loops that
// score whole datasets, and the two decoders of the dataset readers (PNG row
// unfiltering, the LZF codec of binary_compressed PCD files).
//
// A copy of the JAX package's native/uoms_native.cpp (seg2bmap,
// boundary_overlap_counts, pairwise_mask_stats, lzf_decompress; ref:
// lib/utils/evaluation.py), without its preprocess_rgbd (no caller), plus:
//   pairwise_boundary_counts: boundary_overlap_counts of every (gt, pred)
//       label pair of two label images, each label's boundary and its
//       dilation computed once
//   png_unfilter: the five PNG row filters undone, Paeth as the spec gives it
//
// C ABI for ctypes; built with g++ -O3 -shared -fPIC by native/__init__.py.

#include <algorithm>
#include <climits>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <new>
#include <vector>
#include <utility>

extern "C" {

// 1-pixel boundary map, boundaries offset 1/2 px toward the origin
// (David Martin's bmap; matches lib/utils/evaluation.py seg2bmap).
void seg2bmap(const uint8_t* seg, int h, int w, uint8_t* bmap) {
  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x) {
      const int i = y * w + x;
      const uint8_t s = seg[i] ? 1 : 0;
      const uint8_t e = (x + 1 < w) ? (seg[i + 1] ? 1 : 0) : 0;
      const uint8_t so = (y + 1 < h) ? (seg[i + w] ? 1 : 0) : 0;
      const uint8_t se = (x + 1 < w && y + 1 < h) ? (seg[i + w + 1] ? 1 : 0) : 0;
      uint8_t b;
      if (y == h - 1 && x == w - 1) {
        b = 0;
      } else if (y == h - 1) {
        b = s ^ e;
      } else if (x == w - 1) {
        b = s ^ so;
      } else {
        b = (s ^ e) | (s ^ so) | (s ^ se);
      }
      bmap[i] = b;
    }
  }
}

static std::vector<std::pair<int, int>> disk_offsets(int r) {
  std::vector<std::pair<int, int>> offs;
  for (int dy = -r; dy <= r; ++dy)
    for (int dx = -r; dx <= r; ++dx)
      if (dx * dx + dy * dy <= r * r) offs.emplace_back(dy, dx);
  return offs;
}

static void dilate_disk(const uint8_t* src, int h, int w, int r, uint8_t* dst) {
  // binary dilation with a disk structuring element (x^2 + y^2 <= r^2)
  const auto offs = disk_offsets(r);
  std::memset(dst, 0, (size_t)h * w);
  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x) {
      if (!src[y * w + x]) continue;
      for (auto& o : offs) {
        const int yy = y + o.first, xx = x + o.second;
        if (yy >= 0 && yy < h && xx >= 0 && xx < w) dst[yy * w + xx] = 1;
      }
    }
  }
}

// Dilated-boundary true positives (ref: boundary_overlap,
// lib/utils/evaluation.py:75-106). Returns via out2: [precision_tp, recall_tp].
void boundary_overlap_counts(const uint8_t* pred, const uint8_t* gt,
                             int h, int w, int bound_pix, int64_t* out2) {
  std::vector<uint8_t> fgb((size_t)h * w), gtb((size_t)h * w);
  std::vector<uint8_t> fgd((size_t)h * w), gtd((size_t)h * w);
  seg2bmap(pred, h, w, fgb.data());
  seg2bmap(gt, h, w, gtb.data());
  dilate_disk(gtb.data(), h, w, bound_pix, gtd.data());
  dilate_disk(fgb.data(), h, w, bound_pix, fgd.data());
  int64_t ptp = 0, rtp = 0;
  for (int i = 0; i < h * w; ++i) {
    if (fgb[i] && gtd[i]) ++ptp;
    if (gtb[i] && fgd[i]) ++rtp;
  }
  out2[0] = ptp;
  out2[1] = rtp;
}

// Label value -> slot of the tracked labels (the index of the value in
// ids, -1 for a value not tracked), for any int32 values: a table over
// [lo, hi], the span of the ids, when it spans at most kDenseSpan values;
// else a binary search of the sorted ids.
struct LabelMap {
  static constexpr int64_t kDenseSpan = 1 << 20;
  int64_t lo, hi;
  std::vector<int32_t> slot;                       // dense: value - lo -> slot
  std::vector<std::pair<int32_t, int32_t>> sorted; // sparse: (value, slot)
  LabelMap(const int32_t* ids, int n, int64_t lo_, int64_t hi_) : lo(lo_), hi(hi_) {
    if (n == 0) return;
    if (hi - lo < kDenseSpan) {
      slot.assign((size_t)(hi - lo + 1), -1);
      for (int i = 0; i < n; ++i) slot[(size_t)(ids[i] - lo)] = i;
    } else {
      for (int i = 0; i < n; ++i) sorted.emplace_back(ids[i], i);
      std::sort(sorted.begin(), sorted.end());
    }
  }
  int operator()(int32_t v) const {
    if (v < lo || v > hi) return -1;
    if (!slot.empty()) return slot[(size_t)(v - lo)];
    auto it = std::lower_bound(sorted.begin(), sorted.end(), std::make_pair(v, INT32_MIN));
    return (it != sorted.end() && it->first == v) ? it->second : -1;
  }
};

// Pairwise intersections + label sizes in ONE pass over the images.
// pred/gt: int32 [H*W] label images; ng/np_: number of gt/pred labels;
// gt_ids/pred_ids: distinct label values, each list within its [lo, hi].
// Outputs: inter [ng*np_] int64, gt_sizes [ng], pred_sizes [np_].
// Returns 0, or -1 if a label map cannot be allocated.
int pairwise_mask_stats(const int32_t* pred, const int32_t* gt, int n,
                        const int32_t* gt_ids, int ng, int64_t glo, int64_t ghi,
                        const int32_t* pred_ids, int np_, int64_t plo, int64_t phi,
                        int64_t* inter, int64_t* gt_sizes, int64_t* pred_sizes) {
  try {
    const LabelMap gmap(gt_ids, ng, glo, ghi), pmap(pred_ids, np_, plo, phi);
    std::memset(inter, 0, sizeof(int64_t) * (size_t)ng * np_);
    std::memset(gt_sizes, 0, sizeof(int64_t) * ng);
    std::memset(pred_sizes, 0, sizeof(int64_t) * np_);
    for (int i = 0; i < n; ++i) {
      const int gi = gmap(gt[i]), pi = pmap(pred[i]);
      if (gi >= 0) ++gt_sizes[gi];
      if (pi >= 0) ++pred_sizes[pi];
      if (gi >= 0 && pi >= 0) ++inter[(size_t)gi * np_ + pi];
    }
  } catch (const std::bad_alloc&) {
    return -1;
  }
  return 0;
}

// The boundary pixels of each tracked label of one label image: pixel i is
// on label k's boundary iff seg2bmap(img == ids[k]) is set there. Only the
// labels among the pixel's own, east, south and south-east values can be.
static void label_boundaries(const int32_t* img, int h, int w, const LabelMap& slot,
                             std::vector<std::vector<int32_t>>& out) {
  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x) {
      if (y == h - 1 && x == w - 1) continue;
      const int i = y * w + x;
      const bool has_e = x + 1 < w, has_s = y + 1 < h;
      int32_t cand[4];
      int nc = 0;
      cand[nc++] = img[i];
      if (has_e) cand[nc++] = img[i + 1];
      if (has_s) cand[nc++] = img[i + w];
      if (has_e && has_s) cand[nc++] = img[i + w + 1];
      bool uniform = true;                 // one value around: on no boundary
      for (int c = 1; c < nc; ++c) uniform &= cand[c] == cand[0];
      if (uniform) continue;
      for (int c = 0; c < nc; ++c) {
        const int32_t v = cand[c];
        bool seen = false;
        for (int d = 0; d < c; ++d) seen |= cand[d] == v;
        const int k = slot(v);
        if (seen || k < 0) continue;
        const int s = img[i] == v;
        const int e = has_e && img[i + 1] == v;
        const int so = has_s && img[i + w] == v;
        const int se = has_e && has_s && img[i + w + 1] == v;
        int b;
        if (y == h - 1) b = s ^ e;
        else if (x == w - 1) b = s ^ so;
        else b = (s ^ e) | (s ^ so) | (s ^ se);
        if (b) out[k].push_back(i);
      }
    }
  }
}

// boundary_overlap_counts(pred == pred_ids[j], gt == gt_ids[i]) for every
// pair, as counts[(i * np_ + j) * 2 + {0, 1}] = {precision_tp, recall_tp},
// and each label's boundary pixel count (gt_bsizes [ng], pred_bsizes [np_]).
// The ids as in pairwise_mask_stats. Returns 0, or -1 if an allocation fails.
int pairwise_boundary_counts(const int32_t* pred, const int32_t* gt, int h, int w,
                             const int32_t* gt_ids, int ng, int64_t glo, int64_t ghi,
                             const int32_t* pred_ids, int np_, int64_t plo, int64_t phi,
                             int bound_pix,
                             int64_t* counts, int64_t* gt_bsizes, int64_t* pred_bsizes) {
  try {
    const LabelMap gmap(gt_ids, ng, glo, ghi), pmap(pred_ids, np_, plo, phi);
    std::vector<std::vector<int32_t>> gb(ng), pb(np_);
    label_boundaries(gt, h, w, gmap, gb);
    label_boundaries(pred, h, w, pmap, pb);
    const auto offs = disk_offsets(bound_pix);
    std::vector<uint8_t> dil((size_t)h * w, 0);
    std::memset(counts, 0, sizeof(int64_t) * (size_t)ng * np_ * 2);
    // one label's dilated boundary at a time, read at the other image's
    // boundary pixels; then cleared through the same stamps
    auto stamp = [&](const std::vector<int32_t>& px, uint8_t v) {
      for (int32_t i : px) {
        const int y = i / w, x = i % w;
        for (auto& o : offs) {
          const int yy = y + o.first, xx = x + o.second;
          if (yy >= 0 && yy < h && xx >= 0 && xx < w) dil[(size_t)yy * w + xx] = v;
        }
      }
    };
    for (int i = 0; i < ng; ++i) {
      stamp(gb[i], 1);
      for (int j = 0; j < np_; ++j) {
        int64_t c = 0;
        for (int32_t p : pb[j]) c += dil[p];
        counts[((size_t)i * np_ + j) * 2 + 0] = c;
      }
      stamp(gb[i], 0);
    }
    for (int j = 0; j < np_; ++j) {
      stamp(pb[j], 1);
      for (int i = 0; i < ng; ++i) {
        int64_t c = 0;
        for (int32_t p : gb[i]) c += dil[p];
        counts[((size_t)i * np_ + j) * 2 + 1] = c;
      }
      stamp(pb[j], 0);
    }
    for (int i = 0; i < ng; ++i) gt_bsizes[i] = (int64_t)gb[i].size();
    for (int j = 0; j < np_; ++j) pred_bsizes[j] = (int64_t)pb[j].size();
  } catch (const std::bad_alloc&) {
    return -1;
  }
  return 0;
}

// LZF decompression (the PCL binary_compressed PCD codec; semantics identical
// to data/pcd.py _lzf_decompress, the pure-Python twin). Returns bytes
// written, or -1 on a malformed stream (out-of-range back reference /
// truncated input). Stops once out_len bytes are produced.
int64_t lzf_decompress(const uint8_t* in, int64_t in_len,
                       uint8_t* out, int64_t out_len) {
  int64_t i = 0, o = 0;
  while (i < in_len && o < out_len) {
    const uint32_t ctrl = in[i++];
    if (ctrl < 32) {               // literal run of ctrl+1 bytes
      int64_t cnt = (int64_t)ctrl + 1;
      if (i + cnt > in_len) cnt = in_len - i;          // truncated tail
      if (o + cnt > out_len) cnt = out_len - o;
      std::memcpy(out + o, in + i, (size_t)cnt);
      i += cnt; o += cnt;
    } else {                       // back reference
      int64_t len = ctrl >> 5;
      if (len == 7) {
        if (i >= in_len) return -1;
        len += in[i++];
      }
      if (i >= in_len) return -1;
      int64_t ref = o - (((int64_t)(ctrl & 0x1F)) << 8) - in[i++] - 1;
      if (ref < 0) return -1;
      for (int64_t k = 0; k < len + 2 && o < out_len; ++k)
        out[o++] = out[ref++];     // may overlap the output tail (RLE)
    }
  }
  return o;
}

// PNG row unfiltering (PNG spec section 9): data holds h rows of a filter
// type byte and stride filtered bytes; out gets the h * stride reconstructed
// bytes. bpp: bytes per complete pixel (>= 1). Returns 0, or the 1-based
// row of an unknown filter type, negated.
int64_t png_unfilter(const uint8_t* data, int64_t h, int64_t stride, int bpp, uint8_t* out) {
  for (int64_t y = 0; y < h; ++y) {
    const uint8_t* f = data + y * (stride + 1);
    const uint8_t type = f[0];
    ++f;
    uint8_t* r = out + y * stride;
    const uint8_t* up = y > 0 ? r - stride : nullptr;
    switch (type) {
      case 0:
        std::memcpy(r, f, (size_t)stride);
        break;
      case 1:
        for (int64_t x = 0; x < stride; ++x)
          r[x] = (uint8_t)(f[x] + (x >= bpp ? r[x - bpp] : 0));
        break;
      case 2:
        for (int64_t x = 0; x < stride; ++x) r[x] = (uint8_t)(f[x] + (up ? up[x] : 0));
        break;
      case 3:
        for (int64_t x = 0; x < stride; ++x) {
          const int a = x >= bpp ? r[x - bpp] : 0, b = up ? up[x] : 0;
          r[x] = (uint8_t)(f[x] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int64_t x = 0; x < stride; ++x) {
          const int a = x >= bpp ? r[x - bpp] : 0, b = up ? up[x] : 0;
          const int c = (x >= bpp && up) ? up[x - bpp] : 0;
          const int p = a + b - c;
          const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
          const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          r[x] = (uint8_t)(f[x] + pred);
        }
        break;
      default:
        return -(y + 1);
    }
  }
  return 0;
}

}  // extern "C"
