"""The port's image and cloud decoding without cv2 or PIL, held against
cv2, PIL and the JAX package.

- PNG: ``imread`` (IMREAD_COLOR and IMREAD_ANYDEPTH) equal to
  ``cv2.imread`` and ``imread_indexed`` to PIL's indices, bit for bit, on
  files written by the port's encoder (every colour type and bit depth,
  each filter forced on every row), by cv2 and by PIL (paletted, 1-bit, LA,
  16-bit grey); both decoders (native, the Python twin); interlaced files
  and broken CRCs raise; JPEG content goes to cv2.
- PCD: ``read_pcd_xyz`` equal to the JAX reader's for ascii, binary and
  binary_compressed (NaN holes), both decoders; a header cut before its
  DATA line raises; native LZF, the Python
  twin and the JAX decoders equal on streams with back references (the JAX
  native tests' compressor) and on the port's literal-only writer.
"""

import struct
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

from test_native import _lzf_compress
from unseenobjectswithmeanshift_tpu.data import pcd as jpcd
from unseenobjectswithmeanshift_torch import native
from unseenobjectswithmeanshift_torch.data import pcd as ppcd
from unseenobjectswithmeanshift_torch.utils import image_io as io
from torch_threads import few_torch_threads, module_tmp_cleanup  # noqa: F401

BACKENDS = ["native", "numpy"]


def _pil_indices(path):
    return np.atleast_3d(np.array(Image.open(path)))[..., 0].astype(np.int32)


def _check_file(path, backend):
    """The file decoded by ``backend`` as cv2 and PIL give it; the readers'
    imread / imread_indexed (native) as well."""
    png = io.decode_png(path.read_bytes(), backend)
    for flag in (io.IMREAD_COLOR, io.IMREAD_ANYDEPTH):
        want = cv2.imread(str(path), flag)
        for got in (io.png_as_cv2(png, flag), io.imread(str(path), flag)):
            assert got.dtype == want.dtype and got.shape == want.shape, (path, flag)
            assert np.array_equal(got, want), (path, flag)
    want = _pil_indices(str(path))
    for got in (io.png_indexed(png), io.imread_indexed(str(path))):
        assert got.dtype == want.dtype and np.array_equal(got, want), path


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("depth", [8, 16])
def test_png_encoder_every_type_and_filter(tmp_path, backend, depth):
    rng = np.random.RandomState(depth)
    dt, top = (np.uint8, 255) if depth == 8 else (np.uint16, 65535)
    path = tmp_path / "x.png"
    for c in (1, 2, 3, 4):                       # colour types 0, 4, 2, 6
        s = (rng.rand(7, 11, c) * top).astype(dt)
        for f in range(5):
            io.write_png(path, s, filters=f)
            assert np.array_equal(io.decode_png(path.read_bytes(), backend).samples, s)
            _check_file(path, backend)
    if depth == 8:                               # colour type 3
        idx = rng.randint(0, 9, (7, 11)).astype(np.uint8)
        pal = (rng.rand(9, 3) * 255).astype(np.uint8)
        io.write_png(path, idx, palette=pal, filters=[r % 5 for r in range(7)])
        png = io.decode_png(path.read_bytes(), backend)
        assert png.color_type == 3 and np.array_equal(png.samples[..., 0], idx)
        _check_file(path, backend)


@pytest.mark.parametrize("backend", BACKENDS)
def test_png_files_of_cv2_and_pil(tmp_path, backend):
    rng = np.random.RandomState(1)
    path = tmp_path / "y.png"
    for dt, top in ((np.uint8, 255), (np.uint16, 65535)):
        for c in (1, 3, 4):
            s = (rng.rand(9, 13, c) * top).astype(dt)
            cv2.imwrite(str(path), s if c > 1 else s[..., 0])
            _check_file(path, backend)
    for mode, arr in (("L", (rng.rand(9, 13) * 255).astype(np.uint8)),
                      ("LA", (rng.rand(9, 13, 2) * 255).astype(np.uint8)),
                      ("RGBA", (rng.rand(9, 13, 4) * 255).astype(np.uint8)),
                      ("I;16", (rng.rand(9, 13) * 65535).astype(np.uint16)),
                      ("1", rng.rand(9, 13) > 0.5)):
        im = Image.fromarray(arr) if mode == "1" else Image.frombytes(
            mode, (13, 9), arr.tobytes())
        im.save(path)
        _check_file(path, backend)
    for n in (2, 5, 16, 200):                    # PIL packs small palettes in 1-4 bits
        im = Image.fromarray(rng.randint(0, n, (9, 13)).astype(np.uint8), mode="P")
        im.putpalette((rng.rand(n * 3) * 255).astype(np.uint8).tolist())
        im.save(path)
        _check_file(path, backend)


def test_png_refusals_and_jpeg(tmp_path):
    data = io.encode_png(np.zeros((4, 5), np.uint8))
    ihdr = bytearray(data[16:29])
    ihdr[-1] = 1                                 # interlace method 1 (Adam7)
    crc = struct.pack(">I", zlib.crc32(b"IHDR" + bytes(ihdr)))
    interlaced = data[:16] + bytes(ihdr) + crc + data[33:]
    with pytest.raises(ValueError, match="interlaced"):
        io.decode_png(interlaced)
    broken = bytearray(data)
    broken[20] ^= 1
    with pytest.raises(ValueError, match="CRC"):
        io.decode_png(bytes(broken))
    assert io.imread(str(tmp_path / "missing.png")) is None          # as cv2
    bgr = (np.random.RandomState(2).rand(8, 8, 3) * 255).astype(np.uint8)
    cv2.imwrite(str(tmp_path / "a.jpeg"), bgr)
    assert np.array_equal(io.imread(str(tmp_path / "a.jpeg")), cv2.imread(str(tmp_path / "a.jpeg")))


def test_lzf_decoders_equal(tmp_path):
    rng = np.random.RandomState(3)
    cases = [bytes(rng.randint(0, 256, 3000, dtype=np.uint8)), (b"abcdefgh" * 500)[:3000],
             bytes(np.zeros(2048, np.uint8)), b"x" * 3 + bytes(rng.randint(0, 4, 1500,
                                                                        dtype=np.uint8))]
    for raw in cases:
        for comp in (_lzf_compress(raw), ppcd.lzf_literal(raw)):
            assert native.lzf_decompress(comp, len(raw)) == raw
            assert ppcd._lzf_decompress(comp, len(raw)) == raw
            assert jpcd._lzf_decompress(comp, len(raw)) == raw
    stream = bytes([0, ord("A"), (7 << 5) | 0, 20, 0])    # overlapping back reference
    assert native.lzf_decompress(stream, 30) == jpcd._lzf_decompress(stream, 30) == b"A" * 30
    with pytest.raises(ValueError, match="malformed"):
        native.lzf_decompress(bytes([(1 << 5) | 0, 5]), 10)


@pytest.mark.parametrize("backend", BACKENDS)
def test_pcd_reader_equals_jax(tmp_path, backend):
    rng = np.random.RandomState(4)
    xyz = rng.randn(12, 16, 3).astype(np.float32)
    xyz[rng.rand(12, 16) < 0.1] = np.nan
    want = np.nan_to_num(xyz.reshape(-1, 3))
    for kind in ("ascii", "binary", "binary_compressed"):
        path = str(tmp_path / f"{kind}.pcd")
        ppcd.write_pcd_xyz(path, xyz, kind=kind)
        got = ppcd.read_pcd_xyz(path, backend)
        assert got.dtype == np.float32 and np.array_equal(got, want), kind
        assert np.array_equal(got, jpcd.read_pcd_xyz(path)), kind
    from torch_eval_cases import write_pcd_compressed

    path = str(tmp_path / "backref.pcd")
    write_pcd_compressed(path, xyz)
    assert np.array_equal(ppcd.read_pcd_xyz(path, backend), jpcd.read_pcd_xyz(path))


def test_pcd_header_without_data_raises(tmp_path):
    path = tmp_path / "cut.pcd"
    ppcd.write_pcd_xyz(str(path), np.zeros((2, 3, 3), np.float32), kind="binary")
    head = path.read_bytes().split(b"DATA")[0]
    for cut in (head, head[:40], b""):
        path.write_bytes(cut)
        with pytest.raises(ValueError, match="without a DATA line"):
            ppcd.read_pcd_xyz(str(path))
