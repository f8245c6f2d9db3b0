"""Image files without cv2 or PIL: a PNG decoder and encoder on zlib and
numpy, baseline JPEG (``utils/jpeg.py``), and the readers' two calls.

The JAX readers read images with ``cv2.imread`` and label files with
``np.array(PIL.Image.open(path))`` (JAX ``data/datasets.py:38-42``). The
card machine has neither package, so the port decodes PNG itself:

- chunks IHDR, PLTE, IDAT and IEND, each CRC checked; ancillary chunks
  skipped; bit depth 8 and 16 (big-endian); colour types 0 (grey), 2 (RGB),
  3 (palette), 4 (grey + alpha) and 6 (RGBA); grey and palette also at 1, 2
  and 4 bits (PIL writes a palette of up to 16 colours in 4 bits);
  interlaced files raise;
- the five row filters undone by the native library, Paeth as the PNG spec
  gives it. ``decode_png(data, backend="numpy")`` undoes them by a byte loop
  in Python instead: the plain twin the tests hold the native one against
  (slow; no reader uses it).

``imread(path, flags)`` returns what ``cv2.imread`` returns for the two
modes the readers use, ``imread_indexed(path)`` what the JAX
``imread_indexed`` returns. The format is told by the file's content; JPEG
content (the TOD colour images) is decoded by ``utils/jpeg.decode_jpeg``
as cv2 decodes it. ``encode_png`` / ``write_png`` write any of the decoded
formats with a chosen filter per row.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

from .. import native
from .jpeg import decode_jpeg

IMREAD_COLOR = 1          # cv2.IMREAD_COLOR
IMREAD_ANYDEPTH = 2       # cv2.IMREAD_ANYDEPTH

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
JPEG_SIGNATURE = b"\xff\xd8\xff"
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}      # colour type -> samples a pixel
# libpng's rgb_to_gray weights (0.299, 0.587 and the rest, in 1/32768), as
# cv2 sets them for a colour PNG read as one channel
GREY_WEIGHTS = (9797, 19234, 32768 - 9797 - 19234)


class PNG:
    """A decoded PNG: samples [H, W, C] (uint8 or uint16, in the file's
    channel order), colour type, bit depth and palette ([N, 3] uint8 or None)."""

    def __init__(self, samples, color_type: int, bit_depth: int, palette):
        # samples of 1, 2 or 4 bits are held one a uint8
        self.samples, self.color_type, self.bit_depth = samples, color_type, bit_depth
        self.palette = palette


def _chunks(data: bytes):
    pos = len(PNG_SIGNATURE)
    while pos + 12 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length or pos + 12 + length > len(data):
            raise ValueError(f"truncated PNG chunk {kind!r}")
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r} fails its CRC")
        yield kind, body
        pos += 12 + length
        if kind == b"IEND":
            return
    raise ValueError("PNG without an IEND chunk")


def paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def unfilter_plain(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """The PNG spec's reconstruction, a byte at a time (native twin)."""
    out = bytearray(h * stride)
    for y in range(h):
        f = raw[y * (stride + 1):(y + 1) * (stride + 1)]
        kind, f = f[0], f[1:]
        r0 = y * stride
        for x in range(stride):
            a = out[r0 + x - bpp] if x >= bpp else 0
            b = out[r0 - stride + x] if y > 0 else 0
            c = out[r0 - stride + x - bpp] if (y > 0 and x >= bpp) else 0
            if kind == 0:
                pred = 0
            elif kind == 1:
                pred = a
            elif kind == 2:
                pred = b
            elif kind == 3:
                pred = (a + b) >> 1
            elif kind == 4:
                pred = paeth(a, b, c)
            else:
                raise ValueError(f"PNG row {y} has unknown filter type {kind}")
            out[r0 + x] = (f[x] + pred) & 0xFF
    return np.frombuffer(bytes(out), np.uint8).reshape(h, stride)


def decode_png(data: bytes, backend: str = "native") -> PNG:
    native.check_backend(backend)
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError("not a PNG file")
    header, palette, idat = None, None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind[0] & 0x20 == 0 and kind != b"IEND":
            raise ValueError(f"unknown critical PNG chunk {kind!r}")
    if header is None:
        raise ValueError("PNG without an IHDR chunk")
    w, h, depth, ctype, comp, filt, interlace = header
    if interlace:
        raise ValueError("interlaced (Adam7) PNG files are not supported")
    allowed = {0: (1, 2, 4, 8, 16), 3: (1, 2, 4, 8)}.get(ctype, (8, 16))
    if ctype not in CHANNELS or depth not in allowed:
        raise ValueError(f"unsupported PNG colour type {ctype} at bit depth {depth} "
                         "(supported: types 2, 4, 6 at 8 or 16 bits, type 0 at 1-16, "
                         "type 3 at 1-8)")
    if comp or filt:
        raise ValueError(f"unknown PNG compression {comp} or filter method {filt}")
    if ctype == 3 and palette is None:
        raise ValueError("palette PNG without a PLTE chunk")
    c = CHANNELS[ctype]
    bpp = max(1, c * depth // 8)
    stride = (w * c * depth + 7) // 8
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != h * (stride + 1):
        raise ValueError(f"PNG image data holds {len(raw)} bytes, expected {h * (stride + 1)}")
    if backend == "native":
        rows = native.png_unfilter(raw, h, stride, bpp)
    else:
        rows = unfilter_plain(raw, h, stride, bpp)
    if depth == 16:
        samples = rows.view(">u2").astype(np.uint16).reshape(h, w, c)
    elif depth == 8:
        samples = rows.reshape(h, w, c)
    else:                                   # 1, 2 or 4 bits, the leftmost pixel highest
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        packed = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
        samples = packed.reshape(h, -1)[:, :w, None]
    if ctype == 3 and samples.size and samples.max() >= len(palette):
        raise ValueError(f"palette index {samples.max()} past the {len(palette)} entries")
    return PNG(samples, ctype, depth, palette)


def _read(path):
    """The file's bytes, or None if there is no such file (as cv2.imread)."""
    if not os.path.isfile(path):
        return None
    with open(path, "rb") as f:
        return f.read()


def _grey(rgb, depth: int):
    """libpng's rgb_to_gray (cv2 reading a colour PNG as one channel):
    8-bit truncates, 16-bit rounds."""
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    wr, wg, wb = GREY_WEIGHTS
    off = 16384 if depth == 16 else 0
    return ((wr * r + wg * g + wb * b + off) >> 15).astype(rgb.dtype)


def png_as_cv2(png: PNG, flags: int):
    """What cv2.imread returns for this PNG with IMREAD_COLOR (BGR uint8;
    16-bit samples keep their high byte, palette expanded, grey replicated,
    alpha dropped) or IMREAD_ANYDEPTH (one channel at the file's depth;
    colour converted by libpng's weights)."""
    s, ctype = png.samples, png.color_type
    if ctype == 0 and png.bit_depth < 8:                 # libpng scales grey to 8 bits
        s = s * np.uint8(255 // ((1 << png.bit_depth) - 1))
    rgb = png.palette[s[..., 0]] if ctype == 3 else s[..., :3] if ctype in (2, 6) else None
    if flags == IMREAD_COLOR:
        if png.bit_depth == 16:
            s = (s >> 8).astype(np.uint8)
            rgb = None if rgb is None else (rgb >> 8).astype(np.uint8)
        if rgb is None:                                          # grey, grey + alpha
            return np.repeat(s[..., :1], 3, axis=-1)
        return np.ascontiguousarray(rgb[..., ::-1])
    if flags == IMREAD_ANYDEPTH:
        if rgb is None:
            return np.ascontiguousarray(s[..., 0])
        return _grey(rgb, png.bit_depth)
    raise ValueError(f"imread flags {flags}: IMREAD_COLOR (1) and IMREAD_ANYDEPTH (2) "
                     "are supported")


def imread(path, flags: int = IMREAD_COLOR):
    """cv2.imread(path, flags) for PNG and baseline JPEG files without cv2;
    None if the file does not exist (as cv2). A JPEG read with
    IMREAD_ANYDEPTH gives its luma, as cv2's one-channel read."""
    data = _read(path)
    if data is None:
        return None
    if data.startswith(PNG_SIGNATURE):
        return png_as_cv2(decode_png(data), flags)
    if data.startswith(JPEG_SIGNATURE):
        if flags not in (IMREAD_COLOR, IMREAD_ANYDEPTH):
            raise ValueError(f"imread flags {flags}: IMREAD_COLOR (1) and IMREAD_ANYDEPTH (2) "
                             "are supported")
        try:
            return decode_jpeg(data, 3 if flags == IMREAD_COLOR else 1)
        except ValueError as e:
            raise ValueError(f"{path}: {e}") from None
    raise ValueError(f"{path}: neither PNG nor JPEG content")


def imread_indexed(path) -> np.ndarray:
    """np.atleast_3d(np.array(PIL.Image.open(path)))[..., 0] as int32 (the
    JAX ``imread_indexed``, ref lib/utils/mask.py)."""
    data = _read(path)
    if data is None:
        raise FileNotFoundError(path)
    return png_indexed(decode_png(data))


def png_indexed(png: PNG) -> np.ndarray:
    """What PIL gives as the first channel of this PNG, as int32: palette
    indices for a palette PNG, the grey value (16-bit kept), else the first
    channel's high byte."""
    first = png.samples[..., 0]
    if png.bit_depth == 16 and png.color_type != 0:
        first = first >> 8
    if png.color_type == 0 and png.bit_depth in (2, 4):   # PIL scales these to 8 bits
        first = first * np.uint8(255 // ((1 << png.bit_depth) - 1))
    return first.astype(np.int32)


def _filter_rows(rows: np.ndarray, bpp: int, filters) -> np.ndarray:
    """[H, stride] raw bytes -> [H, 1 + stride] filtered rows, row y with
    filter type filters[y] (PNG spec section 9)."""
    h, stride = rows.shape
    x = rows.astype(np.int16)
    left = np.zeros_like(x)
    left[:, bpp:] = x[:, :-bpp]
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    upleft = np.zeros_like(x)
    upleft[1:, bpp:] = x[:-1, :-bpp]
    p = left + up - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
    pae = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    preds = np.stack([np.zeros_like(x), left, up, (left + up) >> 1, pae])
    kinds = np.asarray(filters, np.int64)
    filtered = ((x - preds[kinds, np.arange(h)]) & 0xFF).astype(np.uint8)
    return np.concatenate([kinds.astype(np.uint8)[:, None], filtered], axis=1)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def encode_png(samples, palette=None, filters=0) -> bytes:
    """PNG bytes of samples [H, W] or [H, W, C] (uint8 or uint16, C = 1-4
    in PNG channel order: grey, grey + alpha, RGB, RGBA); with palette ([N, 3]
    uint8) the uint8 samples are indices (colour type 3). filters: one
    filter type (0-4) for every row, or one a row."""
    s = np.asarray(samples)
    if s.ndim == 2:
        s = s[..., None]
    h, w, c = s.shape
    if s.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"PNG samples must be uint8 or uint16, got {s.dtype}")
    depth = 16 if s.dtype == np.uint16 else 8
    if palette is not None:
        palette = np.asarray(palette, np.uint8).reshape(-1, 3)
        if c != 1 or depth != 8 or not 1 <= len(palette) <= 256:
            raise ValueError("a palette PNG takes [H, W] uint8 indices and 1-256 colours")
        ctype = 3
    else:
        ctype = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    filters = np.broadcast_to(np.asarray(filters), (h,))
    if filters.min() < 0 or filters.max() > 4:
        raise ValueError("PNG filter types are 0-4")
    raw = s.astype(">u2").view(np.uint8) if depth == 16 else s
    bpp = c * depth // 8
    rows = _filter_rows(np.ascontiguousarray(raw).reshape(h, w * bpp), bpp, filters)
    out = [PNG_SIGNATURE, _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0))]
    if palette is not None:
        out.append(_chunk(b"PLTE", palette.tobytes()))
    out += [_chunk(b"IDAT", zlib.compress(rows.tobytes())), _chunk(b"IEND", b"")]
    return b"".join(out)


def write_png(path, samples, palette=None, filters=0) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(samples, palette=palette, filters=filters))
