// Host-side native library of the port: the evaluation inner loops that
// score whole datasets, the decoders of the dataset readers (PNG row
// unfiltering, the LZF codec of binary_compressed PCD files, baseline JPEG),
// and the image operations of the training augmentations with cv2's
// semantics (resizes, BGR <-> HLS, line filters, filled ellipses).
//
// A copy of the JAX package's native/uoms_native.cpp (seg2bmap,
// boundary_overlap_counts, pairwise_mask_stats, lzf_decompress; ref:
// lib/utils/evaluation.py), without its preprocess_rgbd (no caller), plus:
//   pairwise_boundary_counts: boundary_overlap_counts of every (gt, pred)
//       label pair of two label images, each label's boundary and its
//       dilation computed once
//   png_unfilter: the five PNG row filters undone, Paeth as the spec gives it
//   jpeg_header / jpeg_decode: baseline and extended sequential Huffman JPEG
//       as libjpeg(-turbo) decodes it for cv2.imread: islow IDCT, fancy
//       upsampling, fixed-point YCbCr -> BGR
//   resize_linear_u8 / resize_cubic_f64, bgr_to_hls_u8 / hls_to_bgr_u8,
//       filter_line_u8, ellipse_fill: cv2.resize, cv2.cvtColor, cv2.filter2D
//       and cv2.ellipse as cv2 5.0 computes them for the augmentations
//
// C ABI for ctypes; built with g++ -O3 -shared -fPIC by native/__init__.py.

#include <algorithm>
#include <climits>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cfloat>
#include <cmath>
#include <new>
#include <stdexcept>
#include <string>
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

// ---------------------------------------------------------------------------
// Baseline JPEG: what libjpeg(-turbo) gives cv2.imread (IMREAD_COLOR) with its
// defaults: Huffman decoding with restart intervals, dequantization, the
// integer "islow" IDCT (jidctint.c), fancy (triangle) upsampling of
// subsampled chroma (jdsample.c: h2v1, h1v2, h2v2; box upsampling for other
// integral ratios and for planes at most 2 samples wide), the fixed-point
// YCbCr -> RGB of jdcolor.c. Progressive, lossless, hierarchical and
// arithmetic-coded files, 12-bit samples and 2 or 4 components raise.
namespace jpeg {

const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54,
    47, 55, 62, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Error : std::runtime_error {
  using std::runtime_error::runtime_error;
};

struct Huff {
  bool defined = false;
  uint8_t counts[17] = {};
  uint8_t vals[256] = {};
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint16_t look[512];  // (length << 8) | value for codes of at most 9 bits, 0 = longer
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int bw = 0, bh = 0;  // blocks allocated per row and per column
  int dw = 0, dh = 0;  // the downsampled plane's samples per row and rows
  std::vector<int16_t> coef;
  bool seen = false;
};

void build_huff(Huff& t) {
  int p = 0, code = 0;
  for (int l = 1; l <= 16; ++l) {
    if (t.counts[l]) {
      t.valoffset[l] = p - code;
      p += t.counts[l];
      code += t.counts[l];
      t.maxcode[l] = code - 1;
    } else {
      t.maxcode[l] = -1;
    }
    if (code > (1 << l)) throw Error("bad Huffman table");
    code <<= 1;
  }
  t.maxcode[17] = 0x7FFFFFFF;
  std::memset(t.look, 0, sizeof(t.look));
  p = 0;
  code = 0;
  for (int l = 1; l <= 9; ++l) {
    for (int i = 0; i < t.counts[l]; ++i, ++p, ++code) {
      const int base = code << (9 - l);
      for (int k = 0; k < (1 << (9 - l)); ++k) t.look[base + k] = (uint16_t)((l << 8) | t.vals[p]);
    }
    code <<= 1;
  }
  t.defined = true;
}

struct Decoder {
  const uint8_t* d;
  size_t n, pos = 0;
  int32_t qt[4][64];
  bool qt_defined[4] = {};
  Huff dc[4], ac[4];
  int width = 0, height = 0, hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  std::vector<Component> comps;
  int restart = 0;
  bool jfif = false, adobe = false, frame = false, progressive = false;
  int adobe_transform = -1;
  uint64_t acc = 0;
  int nbits = 0;
  bool marker_hit = false;

  Decoder(const uint8_t* data, size_t len) : d(data), n(len) {}

  int byte() {
    if (pos >= n) throw Error("truncated JPEG file");
    return d[pos++];
  }
  int word() {
    const int hi = byte();
    return (hi << 8) | byte();
  }
  int next_marker() {
    while (pos < n && d[pos] != 0xFF) ++pos;
    while (pos < n && d[pos] == 0xFF) ++pos;
    if (pos >= n) throw Error("JPEG file ends without an EOI marker");
    return d[pos++];
  }

  void read_frame() {
    if (frame) throw Error("JPEG file with more than one frame");
    const int len = word();
    const size_t end = pos + len - 2;
    if (byte() != 8) throw Error("JPEG sample precision other than 8 bits is not supported");
    height = word();
    width = word();
    const int nf = byte();
    if (height == 0 || width == 0)
      throw Error("JPEG frame with a zero size (DNL) is not supported");
    if (nf != 1 && nf != 3)
      throw Error("JPEG with " + std::to_string(nf) + " components is not supported (1 or 3)");
    for (int i = 0; i < nf; ++i) {
      Component c;
      c.id = byte();
      const int hv = byte();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = byte();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3) throw Error("bad JPEG component");
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
      comps.push_back(c);
    }
    if (pos != end) throw Error("bad JPEG frame header length");
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (auto& c : comps) {
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      c.dw = (int)(((int64_t)width * c.h + hmax - 1) / hmax);
      c.dh = (int)(((int64_t)height * c.v + vmax - 1) / vmax);
      c.coef.assign((size_t)c.bw * c.bh * 64, 0);
    }
    frame = true;
  }

  void read_dqt() {
    const int len = word();
    const size_t end = pos + len - 2;
    while (pos < end) {
      const int pq = byte();
      const int t = pq & 15, prec = pq >> 4;
      if (t > 3 || prec > 1) throw Error("bad JPEG quantization table");
      for (int k = 0; k < 64; ++k) qt[t][kNatural[k]] = prec ? word() : byte();
      qt_defined[t] = true;
    }
    if (pos != end) throw Error("bad JPEG quantization table length");
  }

  void read_dht() {
    const int len = word();
    const size_t end = pos + len - 2;
    while (pos < end) {
      const int tc = byte();
      const int cls = tc >> 4, id = tc & 15;
      if (cls > 1 || id > 3) throw Error("bad JPEG Huffman table class or id");
      Huff& t = cls ? ac[id] : dc[id];
      int total = 0;
      t.counts[0] = 0;
      for (int l = 1; l <= 16; ++l) total += (t.counts[l] = (uint8_t)byte());
      if (total > 256) throw Error("bad JPEG Huffman table");
      for (int i = 0; i < total; ++i) t.vals[i] = (uint8_t)byte();
      build_huff(t);
    }
    if (pos != end) throw Error("bad JPEG Huffman table length");
  }

  void read_app(int m) {
    const int len = word();
    const size_t end = pos + len - 2;
    if (end > n) throw Error("truncated JPEG marker segment");
    if (m == 0xE0 && len >= 7 && std::memcmp(d + pos, "JFIF\0", 5) == 0) jfif = true;
    if (m == 0xEE && len >= 14 && std::memcmp(d + pos, "Adobe", 5) == 0) {
      adobe = true;
      adobe_transform = d[pos + 11];
    }
    pos = end;
  }

  // ---- entropy decoding
  void fill() {
    while (nbits <= 56) {
      int b = 0;
      if (!marker_hit && pos < n) {
        if (d[pos] == 0xFF) {
          size_t p = pos + 1;
          while (p < n && d[p] == 0xFF) ++p;
          if (p < n && d[p] == 0x00) {
            b = 0xFF;
            pos = p + 1;
          } else {
            marker_hit = true;  // zeros from here, as libjpeg feeds them
          }
        } else {
          b = d[pos++];
        }
      }
      acc = (acc << 8) | (uint64_t)b;
      nbits += 8;
    }
  }
  int bits(int s) {
    if (s == 0) return 0;
    if (nbits < s) fill();
    nbits -= s;
    return (int)((acc >> nbits) & ((1u << s) - 1));
  }
  int decode(const Huff& t) {
    if (nbits < 16) fill();
    const int peek = (int)((acc >> (nbits - 9)) & 511);
    const int e = t.look[peek];
    if (e) {
      nbits -= e >> 8;
      return e & 255;
    }
    nbits -= 9;
    int code = peek, l = 9;
    while (code > t.maxcode[l]) {
      if (l == 16) throw Error("corrupt JPEG data: bad Huffman code");
      code = (code << 1) | bits(1);
      ++l;
    }
    return t.vals[t.valoffset[l] + code];
  }
  static int extend(int r, int s) { return r < (1 << (s - 1)) ? r - (1 << s) + 1 : r; }

  void decode_block(int16_t* blk, int& pred, const Huff& dct, const Huff& act) {
    int s = decode(dct);
    if (s > 15) throw Error("corrupt JPEG data: bad DC magnitude");
    const int diff = s ? extend(bits(s), s) : 0;
    pred += diff;
    blk[0] = (int16_t)pred;
    for (int k = 1; k < 64; ++k) {
      s = decode(act);
      const int r = s >> 4;
      s &= 15;
      if (s) {
        k += r;
        if (k > 63) throw Error("corrupt JPEG data: AC coefficient past the block");
        blk[kNatural[k]] = (int16_t)extend(bits(s), s);
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  void restart_marker(int expected) {
    nbits = 0;
    acc = 0;
    marker_hit = false;
    while (pos < n && d[pos] != 0xFF) ++pos;  // skip what the decoder left unread
    while (pos + 1 < n && d[pos] == 0xFF && d[pos + 1] == 0xFF) ++pos;
    if (pos + 1 >= n || d[pos] != 0xFF || d[pos + 1] != 0xD0 + expected)
      throw Error("corrupt JPEG data: missing restart marker RST" + std::to_string(expected));
    pos += 2;
  }

  void read_scan() {
    if (!frame) throw Error("JPEG scan before the frame header");
    const int len = word();
    const size_t end = pos + len - 2;
    const int ns = byte();
    if (ns < 1 || ns > 4) throw Error("bad JPEG scan header");
    std::vector<int> idx(ns), td(ns), ta(ns);
    for (int i = 0; i < ns; ++i) {
      const int id = byte(), t = byte();
      idx[i] = -1;
      for (size_t c = 0; c < comps.size(); ++c)
        if (comps[c].id == id) idx[i] = (int)c;
      if (idx[i] < 0) throw Error("JPEG scan names an unknown component");
      td[i] = t >> 4;
      ta[i] = t & 15;
      if (td[i] > 3 || ta[i] > 3 || !dc[td[i]].defined || !ac[ta[i]].defined)
        throw Error("JPEG scan uses an undefined Huffman table");
      if (!qt_defined[comps[idx[i]].tq])
        throw Error("JPEG component uses an undefined quantization table");
    }
    const int ss = byte(), se = byte(), a = byte();
    if (ss != 0 || se != 63 || a != 0)
      throw Error("JPEG scan with spectral selection: not sequential");
    if (pos != end) throw Error("bad JPEG scan header length");
    std::vector<int> pred(ns, 0);
    acc = 0;
    nbits = 0;
    marker_hit = false;
    int64_t units, per_row;
    if (ns == 1) {
      const Component& c = comps[idx[0]];
      per_row = (c.dw + 7) / 8;
      units = per_row * ((c.dh + 7) / 8);
    } else {
      per_row = mcux;
      units = (int64_t)mcux * mcuy;
    }
    int next_rst = 0;
    for (int64_t m = 0; m < units; ++m) {
      if (restart && m > 0 && m % restart == 0) {
        restart_marker(next_rst);
        next_rst = (next_rst + 1) & 7;
        std::fill(pred.begin(), pred.end(), 0);
      }
      const int64_t my = m / per_row, mx = m % per_row;
      for (int i = 0; i < ns; ++i) {
        Component& c = comps[idx[i]];
        const int hh = ns == 1 ? 1 : c.h, vv = ns == 1 ? 1 : c.v;
        for (int v = 0; v < vv; ++v)
          for (int h = 0; h < hh; ++h) {
            const int64_t by = my * vv + v, bx = mx * hh + h;
            decode_block(&c.coef[((size_t)by * c.bw + bx) * 64], pred[i], dc[td[i]], ac[ta[i]]);
          }
        c.seen = true;
      }
    }
    // past the scan's data to the next marker (stuffed FF 00 and RSTn are data)
    while (pos + 1 < n && !(d[pos] == 0xFF && d[pos + 1] != 0x00 && d[pos + 1] != 0xFF &&
                            !(d[pos + 1] >= 0xD0 && d[pos + 1] <= 0xD7)))
      ++pos;
  }

  // up to the first scan (header_only) or through every scan to EOI
  void parse(bool header_only) {
    if (n < 2 || d[0] != 0xFF || d[1] != 0xD8) throw Error("not a JPEG file (no SOI marker)");
    pos = 2;
    for (;;) {
      const int m = next_marker();
      if (m == 0xC0 || m == 0xC1) {
        read_frame();
      } else if (m == 0xC2 || m == 0xC6 || m == 0xCA || m == 0xCE) {
        throw Error("progressive JPEG is not supported (baseline and extended sequential "
                    "Huffman only)");
      } else if (m == 0xC3 || m == 0xC7 || m == 0xCB || m == 0xCF) {
        throw Error("lossless JPEG is not supported (baseline and extended sequential "
                    "Huffman only)");
      } else if (m == 0xC5) {
        throw Error("hierarchical JPEG is not supported (baseline and extended sequential "
                    "Huffman only)");
      } else if (m == 0xC9 || m == 0xCC) {
        throw Error("arithmetic-coded JPEG is not supported (baseline and extended "
                    "sequential Huffman only)");
      } else if (m == 0xC4) {
        read_dht();
      } else if (m == 0xDB) {
        read_dqt();
      } else if (m == 0xDD) {
        if (word() != 4) throw Error("bad JPEG DRI length");
        restart = word();
      } else if (m == 0xDA) {
        if (header_only) {
          if (!frame) throw Error("JPEG scan before the frame header");
          return;
        }
        read_scan();
      } else if (m == 0xD9) {
        if (header_only || !frame) throw Error("JPEG file without a frame or a scan");
        return;
      } else if (m >= 0xE0 && m <= 0xEF) {
        read_app(m);
      } else if (m == 0xDC) {
        throw Error("JPEG DNL marker is not supported");
      } else if (m == 0x01 || (m >= 0xD0 && m <= 0xD7)) {
        continue;  // no length
      } else {
        const int len = word();
        pos += len - 2;
      }
    }
  }

  bool rgb_transform() const {
    if (comps.size() != 3) return false;
    if (jfif) return false;
    if (adobe) return adobe_transform == 0;
    return comps[0].id == 'R' && comps[1].id == 'G' && comps[2].id == 'B';
  }
};

// jidctint.c jpeg_idct_islow: 8x8 dequantized coefficients -> samples
inline int range_limit(int64_t x) {
  const int v = (int)(x & 1023);
  return v < 128 ? v + 128 : v < 512 ? 255 : v < 896 ? 0 : v - 896;
}

void idct_islow(const int16_t* in, const int32_t* q, uint8_t* out, int stride) {
  const int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373,
                F1175 = 9633, F1501 = 12299, F1847 = 15137, F1961 = 16069, F2053 = 16819,
                F2562 = 20995, F3072 = 25172;
  int64_t ws[64];
  for (int c = 0; c < 8; ++c) {
    int64_t z1, z2, z3, z4, z5, tmp0, tmp1, tmp2, tmp3, tmp10, tmp11, tmp12, tmp13;
    z2 = (int64_t)in[16 + c] * q[16 + c];
    z3 = (int64_t)in[48 + c] * q[48 + c];
    z1 = (z2 + z3) * F0541;
    tmp2 = z1 + z3 * (-F1847);
    tmp3 = z1 + z2 * F0765;
    z2 = (int64_t)in[c] * q[c];
    z3 = (int64_t)in[32 + c] * q[32 + c];
    tmp0 = (z2 + z3) * 8192;
    tmp1 = (z2 - z3) * 8192;
    tmp10 = tmp0 + tmp3;
    tmp13 = tmp0 - tmp3;
    tmp11 = tmp1 + tmp2;
    tmp12 = tmp1 - tmp2;
    tmp0 = (int64_t)in[56 + c] * q[56 + c];
    tmp1 = (int64_t)in[40 + c] * q[40 + c];
    tmp2 = (int64_t)in[24 + c] * q[24 + c];
    tmp3 = (int64_t)in[8 + c] * q[8 + c];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    z4 = tmp1 + tmp3;
    z5 = (z3 + z4) * F1175;
    tmp0 *= F0298;
    tmp1 *= F2053;
    tmp2 *= F3072;
    tmp3 *= F1501;
    z1 *= -F0899;
    z2 *= -F2562;
    z3 *= -F1961;
    z4 *= -F0390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = 11;  // CONST_BITS - PASS1_BITS
    const int64_t rnd = (int64_t)1 << (sh - 1);
    ws[c] = (tmp10 + tmp3 + rnd) >> sh;
    ws[56 + c] = (tmp10 - tmp3 + rnd) >> sh;
    ws[8 + c] = (tmp11 + tmp2 + rnd) >> sh;
    ws[48 + c] = (tmp11 - tmp2 + rnd) >> sh;
    ws[16 + c] = (tmp12 + tmp1 + rnd) >> sh;
    ws[40 + c] = (tmp12 - tmp1 + rnd) >> sh;
    ws[24 + c] = (tmp13 + tmp0 + rnd) >> sh;
    ws[32 + c] = (tmp13 - tmp0 + rnd) >> sh;
  }
  for (int r = 0; r < 8; ++r) {
    const int64_t* w = ws + 8 * r;
    int64_t z1, z2, z3, z4, z5, tmp0, tmp1, tmp2, tmp3, tmp10, tmp11, tmp12, tmp13;
    z2 = w[2];
    z3 = w[6];
    z1 = (z2 + z3) * F0541;
    tmp2 = z1 + z3 * (-F1847);
    tmp3 = z1 + z2 * F0765;
    tmp0 = (w[0] + w[4]) * 8192;
    tmp1 = (w[0] - w[4]) * 8192;
    tmp10 = tmp0 + tmp3;
    tmp13 = tmp0 - tmp3;
    tmp11 = tmp1 + tmp2;
    tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    z4 = tmp1 + tmp3;
    z5 = (z3 + z4) * F1175;
    tmp0 *= F0298;
    tmp1 *= F2053;
    tmp2 *= F3072;
    tmp3 *= F1501;
    z1 *= -F0899;
    z2 *= -F2562;
    z3 *= -F1961;
    z4 *= -F0390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = 18;  // CONST_BITS + PASS1_BITS + 3
    const int64_t rnd = (int64_t)1 << (sh - 1);
    uint8_t* o = out + (size_t)r * stride;
    o[0] = (uint8_t)range_limit((tmp10 + tmp3 + rnd) >> sh);
    o[7] = (uint8_t)range_limit((tmp10 - tmp3 + rnd) >> sh);
    o[1] = (uint8_t)range_limit((tmp11 + tmp2 + rnd) >> sh);
    o[6] = (uint8_t)range_limit((tmp11 - tmp2 + rnd) >> sh);
    o[2] = (uint8_t)range_limit((tmp12 + tmp1 + rnd) >> sh);
    o[5] = (uint8_t)range_limit((tmp12 - tmp1 + rnd) >> sh);
    o[3] = (uint8_t)range_limit((tmp13 + tmp0 + rnd) >> sh);
    o[4] = (uint8_t)range_limit((tmp13 - tmp0 + rnd) >> sh);
  }
}

// One component upsampled to the full image (width x height), as jdsample.c
// with do_fancy_upsampling and libjpeg's context rows (the first and the last
// real row of the plane repeated above and below).
void upsample(const Component& c, const uint8_t* plane, int hmax, int vmax, int width,
              int height, uint8_t* out) {
  const int stride = c.bw * 8;
  const int rx = hmax / c.h, ry = vmax / c.v;
  if (hmax % c.h || vmax % c.v)
    throw Error("JPEG with fractional sampling ratios is not supported");
  auto at = [&](int y, int x) -> int {
    y = std::min(std::max(y, 0), c.dh - 1);
    x = std::min(std::max(x, 0), c.dw - 1);
    return plane[(size_t)y * stride + x];
  };
  const bool fancy_h = rx == 2 && c.dw > 2;
  for (int y = 0; y < height; ++y) {
    uint8_t* o = out + (size_t)y * width;
    if (rx == 1 && ry == 1) {
      std::memcpy(o, plane + (size_t)y * stride, width);
    } else if (rx == 2 && ry == 1 && fancy_h) {
      for (int x = 0; x < width; ++x) {
        const int cx = x >> 1, nx = (x & 1) ? cx + 1 : cx - 1;
        o[x] = (uint8_t)((at(y, cx) * 3 + at(y, nx) + ((x & 1) ? 2 : 1)) >> 2);
      }
    } else if (rx == 1 && ry == 2) {  // h1v2 (always fancy)
      const int cy = y >> 1, ny = (y & 1) ? cy + 1 : cy - 1;
      for (int x = 0; x < width; ++x)
        o[x] = (uint8_t)((at(cy, x) * 3 + at(ny, x) + ((y & 1) ? 2 : 1)) >> 2);
    } else if (rx == 2 && ry == 2 && fancy_h) {
      const int cy = y >> 1, ny = (y & 1) ? cy + 1 : cy - 1;
      for (int x = 0; x < width; ++x) {
        const int cx = x >> 1, nx = (x & 1) ? cx + 1 : cx - 1;
        const int here = at(cy, cx) * 3 + at(ny, cx), other = at(cy, nx) * 3 + at(ny, nx);
        o[x] = (uint8_t)((here * 3 + other + ((x & 1) ? 7 : 8)) >> 4);
      }
    } else {  // box upsampling (int_upsample, h2v1_upsample, h2v2_upsample)
      for (int x = 0; x < width; ++x) o[x] = (uint8_t)at(y / ry, x / rx);
    }
  }
}

void decode(Decoder& dec, int channels, uint8_t* out) {
  dec.parse(false);
  const int w = dec.width, h = dec.height;
  std::vector<std::vector<uint8_t>> full(dec.comps.size());
  for (size_t ci = 0; ci < dec.comps.size(); ++ci) {
    Component& c = dec.comps[ci];
    if (!c.seen) throw Error("JPEG component without a scan");
    const int stride = c.bw * 8;
    std::vector<uint8_t> plane((size_t)stride * c.bh * 8);
    const int32_t* q = dec.qt[c.tq];
    for (int by = 0; by < c.bh; ++by)
      for (int bx = 0; bx < c.bw; ++bx)
        idct_islow(&c.coef[((size_t)by * c.bw + bx) * 64], q,
                   &plane[(size_t)by * 8 * stride + bx * 8], stride);
    full[ci].resize((size_t)w * h);
    upsample(c, plane.data(), dec.hmax, dec.vmax, w, h, full[ci].data());
  }
  const size_t npx = (size_t)w * h;
  if (dec.comps.size() == 1) {
    const uint8_t* y = full[0].data();
    for (size_t i = 0; i < npx; ++i)
      for (int k = 0; k < channels; ++k) out[i * channels + k] = y[i];
    return;
  }
  if (channels == 1) {
    if (dec.rgb_transform()) throw Error("an RGB JPEG read as one channel is not supported");
    std::memcpy(out, full[0].data(), npx);
    return;
  }
  const uint8_t *c0 = full[0].data(), *c1 = full[1].data(), *c2 = full[2].data();
  if (dec.rgb_transform()) {
    for (size_t i = 0; i < npx; ++i) {
      out[3 * i] = c2[i];
      out[3 * i + 1] = c1[i];
      out[3 * i + 2] = c0[i];
    }
    return;
  }
  // jdcolor.c build_ycc_rgb_table / ycc_rgb_convert (SCALEBITS 16)
  const int64_t half = (int64_t)1 << 15;
  const int64_t fr = 91881, fb = 116130, fgcr = 46802, fgcb = 22554;
  auto clamp = [](int64_t v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); };
  for (size_t i = 0; i < npx; ++i) {
    const int64_t y = c0[i], cb = c1[i] - 128, cr = c2[i] - 128;
    const int64_t r = y + ((fr * cr + half) >> 16);
    const int64_t g = y + ((-fgcb * cb + half - fgcr * cr) >> 16);
    const int64_t b = y + ((fb * cb + half) >> 16);
    out[3 * i] = clamp(b);
    out[3 * i + 1] = clamp(g);
    out[3 * i + 2] = clamp(r);
  }
}

void copy_error(const std::exception& e, char* err, int errlen) {
  if (errlen <= 0) return;
  std::strncpy(err, e.what(), (size_t)errlen - 1);
  err[errlen - 1] = 0;
}

}  // namespace jpeg

// ---------------------------------------------------------------------------
// Image operations of the training augmentations, as cv2 5.0 computes them.
namespace imgops {

// cv2.resize: the source position of output index i (float, as cv2's
// (float)((i + 0.5) * scale - 0.5)) split into floor and fraction
inline void src_pos(int i, double scale, int& s, float& f) {
  const float fx = (float)((i + 0.5) * scale - 0.5);
  s = (int)std::floor(fx);
  f = fx - (float)s;
}

inline void cubic_coeffs(float x, float* c) {
  const float A = -0.75f;
  c[0] = ((A * (x + 1) - 5 * A) * (x + 1) + 8 * A) * (x + 1) - 4 * A;
  c[1] = ((A + 2) * x - (A + 3)) * x * x + 1;
  c[2] = ((A + 2) * (1 - x) - (A + 3)) * (1 - x) * (1 - x) + 1;
  c[3] = 1.f - c[0] - c[1] - c[2];
}

inline int cv_round(float v) { return (int)std::lrint(v); }

}  // namespace imgops

extern "C" {

// Header of a JPEG file: info = {height, width, components}. Returns 0, or
// -1 with the reason in err.
int jpeg_header(const uint8_t* data, int64_t len, int32_t* info, char* err, int errlen) {
  try {
    jpeg::Decoder dec(data, (size_t)len);
    dec.parse(true);
    info[0] = dec.height;
    info[1] = dec.width;
    info[2] = (int32_t)dec.comps.size();
  } catch (const std::exception& e) {
    jpeg::copy_error(e, err, errlen);
    return -1;
  }
  return 0;
}

// Decode a JPEG file into out: [height, width, channels] uint8, channels 3
// (BGR, as cv2.imread IMREAD_COLOR) or 1 (the luma, as IMREAD_GRAYSCALE
// gives for YCbCr and grey files). Returns 0, or -1 with the reason in err.
int jpeg_decode(const uint8_t* data, int64_t len, int channels, uint8_t* out, char* err,
                int errlen) {
  try {
    if (channels != 1 && channels != 3) throw jpeg::Error("channels must be 1 or 3");
    jpeg::Decoder dec(data, (size_t)len);
    jpeg::decode(dec, channels, out);
  } catch (const std::bad_alloc&) {
    jpeg::copy_error(std::runtime_error("out of memory"), err, errlen);
    return -1;
  } catch (const std::exception& e) {
    jpeg::copy_error(e, err, errlen);
    return -1;
  }
  return 0;
}

// cv2.resize(src, (dw, dh)) with INTER_LINEAR on uint8 [h, w, c]: 11-bit
// fixed-point coefficients, rows interpolated horizontally into int sums,
// then the vertical step as cv2's vector code rounds it:
// ((((S0 >> 4) * b0) >> 16) + (((S1 >> 4) * b1) >> 16) + 2) >> 2.
void resize_linear_u8(const uint8_t* src, int h, int w, int c, uint8_t* dst, int dh, int dw) {
  const double sx_scale = 1.0 / ((double)dw / w), sy_scale = 1.0 / ((double)dh / h);
  std::vector<int> xo(dw), xa0(dw), xa1(dw);
  for (int x = 0; x < dw; ++x) {
    int s;
    float f;
    imgops::src_pos(x, sx_scale, s, f);
    if (s < 0) f = 0, s = 0;
    if (s >= w - 1) f = 0, s = w - 1;
    xo[x] = s;
    xa0[x] = imgops::cv_round((1.f - f) * 2048.f);
    xa1[x] = imgops::cv_round(f * 2048.f);
  }
  std::vector<int> r0((size_t)dw * c), r1((size_t)dw * c);
  auto hrow = [&](int y, int* out) {
    const uint8_t* row = src + (size_t)y * w * c;
    for (int x = 0; x < dw; ++x) {
      const int s0 = xo[x], s1 = std::min(s0 + 1, w - 1);
      for (int k = 0; k < c; ++k)
        out[x * c + k] = row[s0 * c + k] * xa0[x] + row[s1 * c + k] * xa1[x];
    }
  };
  for (int y = 0; y < dh; ++y) {
    int s;
    float f;
    imgops::src_pos(y, sy_scale, s, f);
    const int b0 = imgops::cv_round((1.f - f) * 2048.f), b1 = imgops::cv_round(f * 2048.f);
    hrow(std::min(std::max(s, 0), h - 1), r0.data());
    hrow(std::min(std::max(s + 1, 0), h - 1), r1.data());
    uint8_t* o = dst + (size_t)y * dw * c;
    for (int i = 0; i < dw * c; ++i) {
      const int v = ((((r0[i] >> 4) * b0) >> 16) + (((r1[i] >> 4) * b1) >> 16) + 2) >> 2;
      o[i] = (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
    }
  }
}

// cv2.resize(src, (dw, dh)) with INTER_CUBIC on float64 [h, w, c]: float
// coefficients (A = -0.75), taps clamped to the edge, sums in double left to
// right, horizontal first.
void resize_cubic_f64(const double* src, int h, int w, int c, double* dst, int dh, int dw) {
  const double sx_scale = 1.0 / ((double)dw / w), sy_scale = 1.0 / ((double)dh / h);
  std::vector<int> xt((size_t)dw * 4);
  std::vector<float> xc((size_t)dw * 4);
  for (int x = 0; x < dw; ++x) {
    int s;
    float f;
    imgops::src_pos(x, sx_scale, s, f);
    imgops::cubic_coeffs(f, &xc[x * 4]);
    for (int k = 0; k < 4; ++k) xt[x * 4 + k] = std::min(std::max(s - 1 + k, 0), w - 1);
  }
  std::vector<double> hbuf((size_t)h * dw * c);
  for (int y = 0; y < h; ++y) {
    const double* row = src + (size_t)y * w * c;
    for (int x = 0; x < dw; ++x)
      for (int k = 0; k < c; ++k) {
        const int* t = &xt[x * 4];
        const float* a = &xc[x * 4];
        hbuf[((size_t)y * dw + x) * c + k] = row[t[0] * c + k] * (double)a[0] +
                                             row[t[1] * c + k] * (double)a[1] +
                                             row[t[2] * c + k] * (double)a[2] +
                                             row[t[3] * c + k] * (double)a[3];
      }
  }
  for (int y = 0; y < dh; ++y) {
    int s;
    float f, b[4];
    imgops::src_pos(y, sy_scale, s, f);
    imgops::cubic_coeffs(f, b);
    const double* rows[4];
    for (int k = 0; k < 4; ++k)
      rows[k] = &hbuf[(size_t)std::min(std::max(s - 1 + k, 0), h - 1) * dw * c];
    double* o = dst + (size_t)y * dw * c;
    for (int i = 0; i < dw * c; ++i)
      o[i] = rows[0][i] * (double)b[0] + rows[1][i] * (double)b[1] + rows[2][i] * (double)b[2] +
             rows[3][i] * (double)b[3];
  }
}

// cv2.cvtColor(COLOR_BGR2HLS) on n uint8 pixels (hue 0-180), as cv2's vector
// code computes it: the hue as one fused multiply-add, the saturation over
// (2 - (max + min)).
void bgr_to_hls_u8(const uint8_t* src, int64_t n, uint8_t* dst) {
  const float k = 1.f / 255.f;
  for (int64_t i = 0; i < n; ++i) {
    const float b = src[3 * i] * k, g = src[3 * i + 1] * k, r = src[3 * i + 2] * k;
    const float vmax = std::max(std::max(r, g), b), vmin = std::min(std::min(r, g), b);
    const float diff = vmax - vmin, msum = vmax + vmin, l = msum * 0.5f;
    float h = 0.f, s = 0.f;
    if (diff > FLT_EPSILON) {
      s = diff / (l < 0.5f ? msum : 2.f - msum);
      const float dd = 60.f / diff;
      float num, off;
      if (vmax == r) {
        num = g - b;
        off = num < 0 ? 360.f : 0.f;
      } else if (vmax == g) {
        num = b - r;
        off = 120.f;
      } else {
        num = r - g;
        off = 240.f;
      }
      // the fused multiply-add, without a libm call: num * dd is exact in
      // double and the sum needs at most 51 bits, so rounding it to float
      // rounds once, as the fma does
      h = (float)((double)num * dd + off);
    }
    h *= 0.5f;
    const int hv = imgops::cv_round(h), lv = imgops::cv_round(l * 255.f),
              sv = imgops::cv_round(s * 255.f);
    dst[3 * i] = (uint8_t)std::min(std::max(hv, 0), 255);
    dst[3 * i + 1] = (uint8_t)std::min(std::max(lv, 0), 255);
    dst[3 * i + 2] = (uint8_t)std::min(std::max(sv, 0), 255);
  }
}

// cv2.cvtColor(COLOR_HLS2BGR) on n uint8 pixels (hue 0-180).
void hls_to_bgr_u8(const uint8_t* src, int64_t n, uint8_t* dst) {
  static const int sector_data[6][3] = {{1, 3, 0}, {1, 0, 2}, {3, 0, 1},
                                        {0, 2, 1}, {0, 1, 3}, {2, 1, 0}};
  const float k = 1.f / 255.f, hscale = 6.f / 180.f;
  for (int64_t i = 0; i < n; ++i) {
    float h = src[3 * i];
    const float l = src[3 * i + 1] * k, s = src[3 * i + 2] * k;
    float bgr[3];
    if (s == 0) {
      bgr[0] = bgr[1] = bgr[2] = l;
    } else {
      const float p2 = l <= 0.5f ? l * (1 + s) : l + s - l * s;
      const float p1 = 2 * l - p2;
      h *= hscale;
      while (h >= 6) h -= 6;
      const int sector = (int)std::floor(h);
      h -= sector;
      const float tab[4] = {p2, p1, p1 + (p2 - p1) * (1 - h), p1 + (p2 - p1) * h};
      for (int j = 0; j < 3; ++j) bgr[j] = tab[sector_data[sector][j]];
    }
    for (int j = 0; j < 3; ++j) {
      const int v = imgops::cv_round(bgr[j] * 255.f);
      dst[3 * i + j] = (uint8_t)std::min(std::max(v, 0), 255);
    }
  }
}

// cv2.filter2D(src, -1, k / size) on uint8 [h, w, c] for the motion-blur
// kernels: k holds ones on its middle row (horizontal) or column. float32
// sums of one fused multiply-add a tap, in the kernel's order,
// BORDER_REFLECT_101, rounded half to even.
void filter_line_u8(const uint8_t* src, int h, int w, int c, int size, int horizontal,
                    uint8_t* dst) {
  const float f = (float)(1.0 / size);
  const int half = (size - 1) / 2, n = horizontal ? w : h;
  std::vector<int> tap((size_t)n * size);  // reflected source index of each tap
  for (int i = 0; i < n; ++i)
    for (int t = 0; t < size; ++t) {
      int j = i + t - half;
      while (n > 1 && (j < 0 || j >= n)) j = j < 0 ? -j : 2 * (n - 1) - j;
      tap[(size_t)i * size + t] = n > 1 ? j : 0;
    }
  const size_t row = (size_t)w * c;
  std::vector<float> acc(row);
  for (int y = 0; y < h; ++y) {
    std::fill(acc.begin(), acc.end(), 0.f);
    for (int t = 0; t < size; ++t) {
      // a fused multiply-add a tap: the product of a uint8 and a float is
      // exact in double and the sum needs at most 35 bits, so one rounding
      if (horizontal) {
        const uint8_t* s = src + (size_t)y * row;
        for (int x = 0; x < w; ++x) {
          const uint8_t* p = s + (size_t)tap[(size_t)x * size + t] * c;
          for (int ch = 0; ch < c; ++ch)
            acc[(size_t)x * c + ch] = (float)((double)p[ch] * f + acc[(size_t)x * c + ch]);
        }
      } else {
        const uint8_t* s = src + (size_t)tap[(size_t)y * size + t] * row;
        for (size_t i = 0; i < row; ++i) acc[i] = (float)((double)s[i] * f + acc[i]);
      }
    }
    uint8_t* o = dst + (size_t)y * row;
    for (size_t i = 0; i < row; ++i) {
      const int v = imgops::cv_round(acc[i]);
      o[i] = (uint8_t)std::min(std::max(v, 0), 255);
    }
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// cv2.ellipse(mask, center, axes, angle, 0, 360, 1, thickness=-1) (LINE_8):
// ellipse2Poly's polygon in 16-bit fixed point (cv2's SinTable: sin of whole
// degrees to 7 decimals, as float), its outline drawn by Line2 (with
// clipLine), then FillConvexPoly's scanline fill.
namespace ellipse {

const int kShift = 16;
const int64_t kOne = (int64_t)1 << kShift;

inline int64_t cdiv(int64_t a, int64_t b) { return a / b; }  // C truncation

struct Canvas {
  uint8_t* m;
  int h, w;
  void put(int64_t x, int64_t y) const {
    if (x >= 0 && x < w && y >= 0 && y < h) m[(size_t)y * w + x] = 1;
  }
};

bool clip_line(int64_t W, int64_t H, int64_t& x1, int64_t& y1, int64_t& x2, int64_t& y2) {
  const int64_t right = W - 1, bottom = H - 1;
  int c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8;
  int c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8;
  if ((c1 & c2) == 0 && (c1 | c2) != 0) {
    int64_t a;
    if (c1 & 12) {
      a = c1 < 8 ? 0 : bottom;
      x1 += (int64_t)((double)(a - y1) * (x2 - x1) / (y2 - y1));
      y1 = a;
      c1 = (x1 < 0) + (x1 > right) * 2;
    }
    if (c2 & 12) {
      a = c2 < 8 ? 0 : bottom;
      x2 += (int64_t)((double)(a - y2) * (x2 - x1) / (y2 - y1));
      y2 = a;
      c2 = (x2 < 0) + (x2 > right) * 2;
    }
    if ((c1 & c2) == 0 && (c1 | c2) != 0) {
      if (c1) {
        a = c1 == 1 ? 0 : right;
        y1 += (int64_t)((double)(a - x1) * (y2 - y1) / (x2 - x1));
        x1 = a;
        c1 = 0;
      }
      if (c2) {
        a = c2 == 1 ? 0 : right;
        y2 += (int64_t)((double)(a - x2) * (y2 - y1) / (x2 - x1));
        x2 = a;
        c2 = 0;
      }
    }
  }
  return (c1 | c2) == 0;
}

void line2(const Canvas& cv, int64_t x1, int64_t y1, int64_t x2, int64_t y2) {
  if (!clip_line((int64_t)cv.w << kShift, (int64_t)cv.h << kShift, x1, y1, x2, y2)) return;
  int64_t dx = x2 - x1, dy = y2 - y1;
  const int64_t j = dx < 0 ? -1 : 0, i = dy < 0 ? -1 : 0;
  const int64_t ax = (dx ^ j) - j, ay = (dy ^ i) - i;
  int64_t x_step, y_step, ecount;
  if (ax > ay) {
    dy = (dy ^ j) - j;
    if (j) std::swap(x1, x2), std::swap(y1, y2);
    x_step = kOne;
    y_step = cdiv(dy * kOne, ax | 1);
    ecount = (x2 - x1) >> kShift;
  } else {
    dx = (dx ^ i) - i;
    if (i) std::swap(x1, x2), std::swap(y1, y2);
    x_step = cdiv(dx * kOne, ay | 1);
    y_step = kOne;
    ecount = (y2 - y1) >> kShift;
  }
  x1 += kOne >> 1;
  y1 += kOne >> 1;
  cv.put((x2 + (kOne >> 1)) >> kShift, (y2 + (kOne >> 1)) >> kShift);
  if (ax > ay) {
    x1 >>= kShift;
    for (; ecount >= 0; --ecount, ++x1, y1 += y_step) cv.put(x1, y1 >> kShift);
  } else {
    y1 >>= kShift;
    for (; ecount >= 0; --ecount, x1 += x_step, ++y1) cv.put(x1 >> kShift, y1);
  }
}

void fill_convex(const Canvas& cv, const std::vector<std::pair<int64_t, int64_t>>& v) {
  const int npts = (int)v.size();
  const int64_t delta = kOne >> 1;
  int64_t xmin = v[0].first, xmax = xmin, ymin = v[0].second, ymax = ymin;
  int imin = 0;
  auto p0 = v[npts - 1];
  for (int i = 0; i < npts; ++i) {
    const auto& p = v[i];
    if (p.second < ymin) ymin = p.second, imin = i;
    ymax = std::max(ymax, p.second);
    xmax = std::max(xmax, p.first);
    xmin = std::min(xmin, p.first);
    line2(cv, p0.first, p0.second, p.first, p.second);
    p0 = p;
  }
  xmin = (xmin + delta) >> kShift;
  xmax = (xmax + delta) >> kShift;
  ymin = (ymin + delta) >> kShift;
  ymax = (ymax + delta) >> kShift;
  if (npts < 3 || (int)xmax < 0 || (int)ymax < 0 || (int)xmin >= cv.w || (int)ymin >= cv.h) return;
  ymax = std::min<int64_t>(ymax, cv.h - 1);
  struct Edge {
    int idx, di;
    int64_t x, dx;
    int64_t ye;
  } edge[2];
  edge[0].idx = edge[1].idx = imin;
  edge[0].ye = edge[1].ye = ymin;
  edge[0].di = 1;
  edge[1].di = npts - 1;
  edge[0].x = edge[1].x = -kOne;
  edge[0].dx = edge[1].dx = 0;
  int edges = npts;
  int64_t y = ymin;
  do {
    for (auto& e : edge) {
      if (y >= e.ye) {
        int idx0 = e.idx, di = e.di;
        int idx = idx0 + di;
        if (idx >= npts) idx -= npts;
        for (; edges-- > 0;) {
          const int64_t ty = (v[idx].second + delta) >> kShift;
          if (ty > y) {
            const int64_t xs = v[idx0].first, xe = v[idx].first;
            e.ye = ty;
            e.dx = cdiv((xe - xs) * 2 + (ty - y), 2 * (ty - y));
            e.x = xs;
            e.idx = idx;
            break;
          }
          idx0 = idx;
          idx += di;
          if (idx >= npts) idx -= npts;
        }
      }
    }
    if (edges < 0) break;
    if (y >= 0) {
      const int l = edge[0].x > edge[1].x ? 1 : 0, r = 1 - l;
      int64_t xx1 = (edge[l].x + delta) >> kShift, xx2 = (edge[r].x + delta) >> kShift;
      if (xx2 >= 0 && xx1 < cv.w) {
        xx1 = std::max<int64_t>(xx1, 0);
        xx2 = std::min<int64_t>(xx2, cv.w - 1);
        std::memset(cv.m + (size_t)y * cv.w + xx1, 1, (size_t)(xx2 - xx1 + 1));
      }
    }
    edge[0].x += edge[0].dx;
    edge[1].x += edge[1].dx;
  } while (++y <= ymax);
}

}  // namespace ellipse

extern "C" {

// Set mask [h, w] (uint8) to 1 inside the ellipse cv2.ellipse fills for
// integer center (cx, cy), axes (ax, ay) and angle in degrees. sin_table:
// cv2's 451 float sines of whole degrees.
void ellipse_fill(uint8_t* mask, int h, int w, int cx, int cy, int ax, int ay, int angle,
                  const float* sin_table) {
  using namespace ellipse;
  const ellipse::Canvas cv{mask, h, w};
  const double ccx = (double)((int64_t)cx << kShift), ccy = (double)((int64_t)cy << kShift);
  const int64_t aw = (int64_t)std::abs(ax) << kShift, ah = (int64_t)std::abs(ay) << kShift;
  int delta = (int)((std::max(aw, ah) + (kOne >> 1)) >> kShift);
  delta = delta < 3 ? 90 : delta < 10 ? 30 : delta < 15 ? 18 : 5;
  while (angle < 0) angle += 360;
  while (angle > 360) angle -= 360;
  const float alpha = sin_table[450 - angle], beta = sin_table[angle];
  std::vector<std::pair<double, double>> pts;
  for (int i = 0; i < 360 + delta; i += delta) {
    const int a = std::min(i, 360);
    const double x = (double)aw * sin_table[450 - a], y = (double)ah * sin_table[a];
    pts.emplace_back(ccx + x * alpha - y * beta, ccy + x * beta + y * alpha);
  }
  if (pts.size() == 1) pts.assign(2, {ccx, ccy});
  std::vector<std::pair<int64_t, int64_t>> v;
  for (const auto& p : pts) {
    int64_t x = (int64_t)std::lrint(p.first / (double)kOne) << kShift;
    int64_t y = (int64_t)std::lrint(p.second / (double)kOne) << kShift;
    x += std::lrint(p.first - (double)x);
    y += std::lrint(p.second - (double)y);
    if (v.empty() || v.back() != std::make_pair(x, y)) v.emplace_back(x, y);
  }
  if (v.size() == 1) v.assign(2, {(int64_t)cx << kShift, (int64_t)cy << kShift});
  fill_convex(cv, v);
}

}  // extern "C"
