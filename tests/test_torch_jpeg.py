"""The port's baseline JPEG decoder (``utils/jpeg.py``, native and numpy)
against ``cv2.imread``, on files cv2 writes and on files chip_smoke.py's
encoder writes.

Tolerance: none. Every decoded sample equals cv2's (np.array_equal, dtype
and shape included): qualities 50 / 75 / 95; 4:2:0, 4:2:2, 4:4:0 and 4:4:4
chroma; grey files (read as BGR and as one channel); the luma of colour
files; restart intervals; odd sizes down to 1x1 and planes 1-2 samples
wide (box upsampling). Progressive files raise a ValueError naming the
limit, and so does a truncated file.
"""

import sys
from pathlib import Path

import cv2
import numpy as np
import pytest

from unseenobjectswithmeanshift_torch.utils import image_io
from unseenobjectswithmeanshift_torch.utils.jpeg import decode_jpeg

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402
from torch_threads import few_torch_threads, module_tmp_cleanup  # noqa: F401

SAMPLING = {"420": 0x411111, "422": 0x211111, "440": 0x121111, "444": 0x111111}


def scene(rng, h, w):
    """A smooth gradient with noise and a few flat discs (edges for the
    chroma filters)."""
    yy, xx = np.mgrid[0:h, 0:w]
    im = np.stack([xx * 255 // max(w - 1, 1), yy * 255 // max(h - 1, 1), (xx + yy) % 256], -1)
    im = im.astype(np.float64) + rng.randn(h, w, 3) * 20
    for _ in range(4):
        cy, cx, r = rng.randint(0, h), rng.randint(0, w), rng.randint(2, 20)
        im[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = rng.randint(0, 256, 3)
    return np.clip(im, 0, 255).astype(np.uint8)


def encode(im, **params):
    flags = []
    for k, v in params.items():
        flags += [getattr(cv2, f"IMWRITE_JPEG_{k.upper()}"), v]
    ok, buf = cv2.imencode(".jpg", im, flags)
    assert ok
    return buf.tobytes()


def assert_decodes_as_cv2(data, backends=("native", "numpy")):
    buf = np.frombuffer(data, np.uint8)
    for channels, flag in ((3, cv2.IMREAD_COLOR), (1, cv2.IMREAD_GRAYSCALE)):
        want = cv2.imdecode(buf, flag)
        for backend in backends:
            got = decode_jpeg(data, channels, backend)
            assert got.dtype == want.dtype and got.shape == want.shape, (backend, channels)
            assert np.array_equal(got, want), (backend, channels, int((got != want).sum()))


@pytest.mark.parametrize("quality", [50, 75, 95])
@pytest.mark.parametrize("sampling", sorted(SAMPLING))
def test_colour_files_equal_cv2(quality, sampling):
    rng = np.random.RandomState(quality)
    for h, w in ((48, 64), (33, 47)):
        for rst in (0, 3):
            assert_decodes_as_cv2(encode(scene(rng, h, w), quality=quality,
                                         sampling_factor=SAMPLING[sampling], rst_interval=rst))


@pytest.mark.parametrize("hw", [(1, 1), (3, 3), (9, 2), (2, 17), (17, 5), (100, 1)])
def test_odd_and_tiny_sizes_equal_cv2(hw):
    rng = np.random.RandomState(sum(hw))
    for sampling in ("420", "422", "444"):
        assert_decodes_as_cv2(encode(scene(rng, *hw), quality=85,
                                     sampling_factor=SAMPLING[sampling]))


def test_grey_files_equal_cv2():
    rng = np.random.RandomState(5)
    for h, w in ((48, 64), (37, 29)):
        for rst in (0, 2):
            assert_decodes_as_cv2(encode(scene(rng, h, w)[..., 1], quality=80, rst_interval=rst))


def test_full_frame_native_equals_cv2_and_imread(tmp_path):
    """480x640 4:2:0 through the readers' path (imread, native); the numpy
    twin is held to it on the small files above (it decodes a frame in
    about a second)."""
    im = scene(np.random.RandomState(6), 480, 640)
    path = str(tmp_path / "frame.jpeg")
    cv2.imwrite(path, im, [cv2.IMWRITE_JPEG_QUALITY, 90])
    assert np.array_equal(image_io.imread(path), cv2.imread(path))
    assert np.array_equal(image_io.imread(path, image_io.IMREAD_ANYDEPTH),
                          cv2.imread(path, cv2.IMREAD_GRAYSCALE))


def test_chip_smoke_encoder_decodes_alike():
    """The files chip_smoke.py writes for jpeg_check and train_files_main:
    cv2 and the port decode them alike (4:2:0 and 4:4:4, with and without
    restart markers), close to the image encoded."""
    rng = np.random.RandomState(7)
    for h, w in ((48, 64), (35, 51)):
        im = scene(rng, h, w)
        for subsample in (True, False):
            for restart in (0, 4):
                data = chip_smoke.encode_jpeg(im, quality=90, subsample=subsample,
                                              restart=restart)
                assert_decodes_as_cv2(data)
                err = np.abs(decode_jpeg(data).astype(int) - im).mean()
                assert err < (15 if subsample else 8), err


def test_unsupported_and_corrupt_files_raise():
    im = scene(np.random.RandomState(8), 32, 40)
    progressive = encode(im, progressive=1)
    for backend in ("native", "numpy"):
        with pytest.raises(ValueError, match="progressive JPEG is not supported"):
            decode_jpeg(progressive, backend=backend)
    whole = encode(im, quality=90, rst_interval=2)
    for backend in ("native", "numpy"):
        with pytest.raises(ValueError):
            decode_jpeg(whole[:40], backend=backend)
        with pytest.raises(ValueError, match="not a JPEG"):
            decode_jpeg(b"\x89PNG" + whole[4:], backend=backend)
    # a restart marker renumbered out of sequence is refused, never decoded wrongly
    pos = whole.index(b"\xff\xd1")
    bad = whole[:pos] + b"\xff\xd5" + whole[pos + 2:]
    for backend in ("native", "numpy"):
        with pytest.raises(ValueError, match="restart marker"):
            decode_jpeg(bad, backend=backend)
