"""Baseline JPEG decoding without cv2 or PIL, as ``cv2.imread`` decodes it.

The TOD colour images are JPEG (``rgb_*.jpeg``), and the card machine has
neither cv2 nor PIL. ``decode_jpeg(data)`` returns what ``cv2.imread``
returns with IMREAD_COLOR (BGR uint8; a grey file repeated into three
channels), or with ``channels=1`` the luma plane. It decodes what libjpeg
decodes with the defaults cv2 leaves in place:

- baseline and extended sequential Huffman frames (SOF0, SOF1), 8-bit
  samples, one or three components, one or several scans, restart
  intervals;
- dequantization and libjpeg's integer "islow" IDCT (jidctint.c), its
  range limiting included;
- subsampled components upsampled as jdsample.c does with
  do_fancy_upsampling: the triangle filters h2v1, h1v2 and h2v2 (box
  upsampling for other integral ratios, and for planes at most two samples
  wide), the first and last rows and columns of a plane repeated past its
  edges;
- jdcolor.c's fixed-point YCbCr -> RGB (16 fraction bits), or no conversion
  for an Adobe RGB file.

Progressive, lossless, hierarchical and arithmetic-coded files, 12-bit
samples and files of 2 or 4 components raise a ValueError naming the limit.

``backend="native"`` (the readers' path) decodes in the host library
(``native/uoms_native.cpp``, through ctypes, which releases the interpreter
lock). ``backend="numpy"`` is its twin for the tests and ``chip_smoke.py``:
the entropy decoding a symbol at a time in Python, the IDCT, upsampling and
colour conversion vectorized in numpy with the same integer operations
(slow: about a second for 480x640).
"""

from __future__ import annotations

import numpy as np

from .. import native

NATURAL = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34,
    27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44,
    51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
UNSUPPORTED = {
    **{m: "progressive" for m in (0xC2, 0xC6, 0xCA, 0xCE)},
    **{m: "lossless" for m in (0xC3, 0xC7, 0xCB, 0xCF)},
    0xC5: "hierarchical", 0xC9: "arithmetic-coded", 0xCC: "arithmetic-coded",
}
LIMIT = "(baseline and extended sequential Huffman only)"


def decode_jpeg(data: bytes, channels: int = 3, backend: str = "native") -> np.ndarray:
    """JPEG bytes -> [H, W, 3] BGR uint8 (channels 3) or [H, W] luma
    (channels 1), as cv2.imread decodes them."""
    native.check_backend(backend)
    if channels not in (1, 3):
        raise ValueError(f"channels must be 1 or 3, got {channels}")
    if backend == "native":
        return native.jpeg_decode(data, channels)
    return _Decoder(data).decode(channels)


class _Huffman:
    """A canonical Huffman table: {(length, code): value}."""

    def __init__(self, counts, values):
        self.codes, code, p = {}, 0, 0
        for length in range(1, 17):
            for _ in range(counts[length - 1]):
                self.codes[(length, code)] = values[p]
                code, p = code + 1, p + 1
            if code > (1 << length):
                raise ValueError("bad Huffman table")
            code <<= 1


class _Decoder:
    def __init__(self, data: bytes):
        self.d, self.pos = data, 0
        self.qt, self.dc, self.ac = {}, {}, {}
        self.comps, self.restart = [], 0
        self.jfif = self.adobe = False
        self.adobe_transform = -1

    # ---- marker segments
    def byte(self):
        if self.pos >= len(self.d):
            raise ValueError("truncated JPEG file")
        self.pos += 1
        return self.d[self.pos - 1]

    def word(self):
        return (self.byte() << 8) | self.byte()

    def segment(self):
        n = self.word() - 2
        body = self.d[self.pos:self.pos + n]
        if len(body) != n:
            raise ValueError("truncated JPEG marker segment")
        self.pos += n
        return body

    def next_marker(self):
        d, n = self.d, len(self.d)
        while self.pos < n and d[self.pos] != 0xFF:
            self.pos += 1
        while self.pos < n and d[self.pos] == 0xFF:
            self.pos += 1
        if self.pos >= n:
            raise ValueError("JPEG file ends without an EOI marker")
        self.pos += 1
        return d[self.pos - 1]

    def frame(self, body):
        if self.comps:
            raise ValueError("JPEG file with more than one frame")
        if body[0] != 8:
            raise ValueError("JPEG sample precision other than 8 bits is not supported")
        self.h, self.w, nf = (body[1] << 8) | body[2], (body[3] << 8) | body[4], body[5]
        if self.h == 0 or self.w == 0:
            raise ValueError("JPEG frame with a zero size (DNL) is not supported")
        if nf not in (1, 3):
            raise ValueError(f"JPEG with {nf} components is not supported (1 or 3)")
        for i in range(nf):
            cid, hv, tq = body[6 + 3 * i:9 + 3 * i]
            self.comps.append({"id": cid, "h": hv >> 4, "v": hv & 15, "tq": tq})
        self.hmax = max(c["h"] for c in self.comps)
        self.vmax = max(c["v"] for c in self.comps)
        self.mcux = -(-self.w // (8 * self.hmax))
        self.mcuy = -(-self.h // (8 * self.vmax))
        for c in self.comps:
            c["bw"], c["bh"] = self.mcux * c["h"], self.mcuy * c["v"]
            c["dw"] = -(-self.w * c["h"] // self.hmax)
            c["dh"] = -(-self.h * c["v"] // self.vmax)
            c["coef"] = np.zeros((c["bh"], c["bw"], 64), np.int64)
            c["seen"] = False

    def dqt(self, body):
        p = 0
        while p < len(body):
            prec, t = body[p] >> 4, body[p] & 15
            size = 2 if prec else 1
            raw = np.frombuffer(body[p + 1:p + 1 + 64 * size], ">u2" if prec else np.uint8)
            q = np.zeros(64, np.int64)
            q[NATURAL] = raw
            self.qt[t] = q
            p += 1 + 64 * size

    def dht(self, body):
        p = 0
        while p < len(body):
            cls, t = body[p] >> 4, body[p] & 15
            counts = list(body[p + 1:p + 17])
            total = sum(counts)
            table = _Huffman(counts, list(body[p + 17:p + 17 + total]))
            (self.ac if cls else self.dc)[t] = table
            p += 17 + total

    # ---- entropy-coded data, a bit at a time
    def fill(self):
        d, n = self.d, len(self.d)
        while self.nbits <= 24:
            b = 0
            if not self.marker and self.pos < n:
                if d[self.pos] == 0xFF:
                    p = self.pos + 1
                    while p < n and d[p] == 0xFF:
                        p += 1
                    if p < n and d[p] == 0:
                        b, self.pos = 0xFF, p + 1
                    else:
                        self.marker = True
                else:
                    b = d[self.pos]
                    self.pos += 1
            self.acc = ((self.acc << 8) | b) & 0xFFFFFFFFFF
            self.nbits += 8

    def bits(self, s):
        if s == 0:
            return 0
        if self.nbits < s:
            self.fill()
        self.nbits -= s
        return (self.acc >> self.nbits) & ((1 << s) - 1)

    def symbol(self, table):
        code = 0
        for length in range(1, 17):
            code = (code << 1) | self.bits(1)
            v = table.codes.get((length, code))
            if v is not None:
                return v
        raise ValueError("corrupt JPEG data: bad Huffman code")

    def extend(self, s):
        r = self.bits(s)
        return r - (1 << s) + 1 if r < (1 << (s - 1)) else r

    def block(self, out, pred, dc, ac):
        s = self.symbol(dc)
        pred += self.extend(s) if s else 0
        out[0] = pred
        k = 1
        while k < 64:
            rs = self.symbol(ac)
            r, s = rs >> 4, rs & 15
            if s:
                k += r
                if k > 63:
                    raise ValueError("corrupt JPEG data: AC coefficient past the block")
                out[NATURAL[k]] = self.extend(s)
            elif r != 15:
                break
            else:
                k += 15
            k += 1
        return pred

    def scan(self, body):
        ns = body[0]
        sel = []
        for i in range(ns):
            cid, t = body[1 + 2 * i], body[2 + 2 * i]
            comp = next((c for c in self.comps if c["id"] == cid), None)
            if comp is None:
                raise ValueError("JPEG scan names an unknown component")
            if (t >> 4) not in self.dc or (t & 15) not in self.ac:
                raise ValueError("JPEG scan uses an undefined Huffman table")
            sel.append((comp, self.dc[t >> 4], self.ac[t & 15]))
        ss, se, a = body[1 + 2 * ns:4 + 2 * ns]
        if (ss, se, a) != (0, 63, 0):
            raise ValueError("JPEG scan with spectral selection: not sequential")
        self.acc = self.nbits = 0
        self.marker = False
        if ns == 1:
            c = sel[0][0]
            per_row = -(-c["dw"] // 8)
            units = per_row * -(-c["dh"] // 8)
        else:
            per_row, units = self.mcux, self.mcux * self.mcuy
        pred = [0] * ns
        rst = 0
        for m in range(units):
            if self.restart and m and m % self.restart == 0:
                self.restart_marker(rst)
                rst, pred = (rst + 1) & 7, [0] * ns
            my, mx = divmod(m, per_row)
            for i, (c, dc, ac) in enumerate(sel):
                hh, vv = (1, 1) if ns == 1 else (c["h"], c["v"])
                for v in range(vv):
                    for h in range(hh):
                        pred[i] = self.block(c["coef"][my * vv + v, mx * hh + h], pred[i], dc, ac)
                c["seen"] = True
        d, n = self.d, len(self.d)
        while self.pos + 1 < n and not (d[self.pos] == 0xFF and d[self.pos + 1] not in (0, 0xFF)
                                        and not 0xD0 <= d[self.pos + 1] <= 0xD7):
            self.pos += 1

    def restart_marker(self, expected):
        d, n = self.d, len(self.d)
        self.acc = self.nbits = 0
        self.marker = False
        while self.pos < n and d[self.pos] != 0xFF:
            self.pos += 1
        while self.pos + 1 < n and d[self.pos] == 0xFF and d[self.pos + 1] == 0xFF:
            self.pos += 1
        if self.pos + 1 >= n or d[self.pos + 1] != 0xD0 + expected:
            raise ValueError(f"corrupt JPEG data: missing restart marker RST{expected}")
        self.pos += 2

    def parse(self):
        if self.d[:2] != b"\xff\xd8":
            raise ValueError("not a JPEG file (no SOI marker)")
        self.pos = 2
        while True:
            m = self.next_marker()
            if m in UNSUPPORTED:
                raise ValueError(f"{UNSUPPORTED[m]} JPEG is not supported {LIMIT}")
            if m in (0xC0, 0xC1):
                self.frame(self.segment())
            elif m == 0xC4:
                self.dht(self.segment())
            elif m == 0xDB:
                self.dqt(self.segment())
            elif m == 0xDD:
                self.restart = int.from_bytes(self.segment(), "big")
            elif m == 0xDA:
                if not self.comps:
                    raise ValueError("JPEG scan before the frame header")
                self.scan(self.segment())
            elif m == 0xD9:
                if not self.comps:
                    raise ValueError("JPEG file without a frame or a scan")
                return
            elif m == 0xDC:
                raise ValueError("JPEG DNL marker is not supported")
            elif m == 0x01 or 0xD0 <= m <= 0xD7:
                continue
            else:
                body = self.segment()
                if m == 0xE0 and body[:5] == b"JFIF\0":
                    self.jfif = True
                if m == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
                    self.adobe, self.adobe_transform = True, body[11]

    # ---- samples
    def plane(self, c):
        """IDCT of every block: [bh * 8, bw * 8] uint8."""
        x = c["coef"].reshape(-1, 8, 8) * self.qt[c["tq"]].reshape(8, 8)
        x = _idct_pass(x, 11, axis=1)              # columns, CONST_BITS - PASS1_BITS
        x = _idct_pass(x, 18, axis=2)              # rows, CONST_BITS + PASS1_BITS + 3
        v = x & 1023
        x = np.where(v < 128, v + 128, np.where(v < 512, 255, np.where(v < 896, 0, v - 896)))
        bh, bw = c["bh"], c["bw"]
        return x.reshape(bh, bw, 8, 8).transpose(0, 2, 1, 3).reshape(bh * 8, bw * 8)

    def upsample(self, c, p):
        rx, ry = self.hmax // c["h"], self.vmax // c["v"]
        if self.hmax % c["h"] or self.vmax % c["v"]:
            raise ValueError("JPEG with fractional sampling ratios is not supported")
        ys, xs = np.arange(self.h), np.arange(self.w)
        cy, cx = np.minimum(ys // ry, c["dh"] - 1), np.minimum(xs // rx, c["dw"] - 1)
        ny = np.clip(np.where(ys & 1, cy + 1, cy - 1), 0, c["dh"] - 1)
        nx = np.clip(np.where(xs & 1, cx + 1, cx - 1), 0, c["dw"] - 1)
        p = p.astype(np.int64)
        fancy_h = rx == 2 and c["dw"] > 2
        if rx == 1 and ry == 1:
            return p[:self.h, :self.w]
        if rx == 2 and ry == 1 and fancy_h:
            return (p[ys][:, cx] * 3 + p[ys][:, nx] + np.where(xs & 1, 2, 1)) >> 2
        if rx == 1 and ry == 2:
            return (p[cy][:, xs] * 3 + p[ny][:, xs] + np.where(ys & 1, 2, 1)[:, None]) >> 2
        if rx == 2 and ry == 2 and fancy_h:
            col = p[cy] * 3 + p[ny]                 # vertical sums, [H, dw]
            return (col[:, cx] * 3 + col[:, nx] + np.where(xs & 1, 7, 8)) >> 4
        return p[cy][:, cx]

    def decode(self, channels):
        self.parse()
        full = []
        for c in self.comps:
            if not c["seen"]:
                raise ValueError("JPEG component without a scan")
            full.append(self.upsample(c, self.plane(c)))
        rgb = len(self.comps) == 3 and not self.jfif and (
            self.adobe_transform == 0 if self.adobe
            else [c["id"] for c in self.comps] == [82, 71, 66])
        if len(self.comps) == 1:
            y = full[0].astype(np.uint8)
            return y if channels == 1 else np.repeat(y[..., None], 3, -1)
        if channels == 1:
            if rgb:
                raise ValueError("an RGB JPEG read as one channel is not supported")
            return full[0].astype(np.uint8)
        if rgb:
            return np.stack(full[::-1], -1).astype(np.uint8)
        y, cb, cr = full[0], full[1] - 128, full[2] - 128
        half = 1 << 15
        r = y + ((91881 * cr + half) >> 16)
        g = y + ((-22554 * cb + half - 46802 * cr) >> 16)
        b = y + ((116130 * cb + half) >> 16)
        return np.clip(np.stack([b, g, r], -1), 0, 255).astype(np.uint8)


def _idct_pass(x, shift, axis):
    """One 1-D pass of jidctint.c's islow IDCT along axis (1: columns of the
    8x8 blocks, 2: rows), int64, descaled by shift with rounding."""
    s = [np.take(x, k, axis=axis) for k in range(8)]
    z1 = (s[2] + s[6]) * 4433
    tmp2 = z1 + s[6] * -15137
    tmp3 = z1 + s[2] * 6270
    tmp0 = (s[0] + s[4]) * 8192
    tmp1 = (s[0] - s[4]) * 8192
    tmp10, tmp13, tmp11, tmp12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = s[7], s[5], s[3], s[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * 9633
    t0, t1, t2, t3 = t0 * 2446, t1 * 16819, t2 * 25172, t3 * 12299
    z1, z2, z3, z4 = z1 * -7373, z2 * -20995, z3 * -16069 + z5, z4 * -3196 + z5
    t0, t1, t2, t3 = t0 + z1 + z3, t1 + z2 + z4, t2 + z2 + z3, t3 + z1 + z4
    rnd = 1 << (shift - 1)
    out = [tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
           tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3]
    return np.stack([(o + rnd) >> shift for o in out], axis=axis)
