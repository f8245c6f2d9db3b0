"""The training augmentations and crop resizes without cv2
(``data/augmentation.py``, ``data/image_ops.py``) against the JAX package's
and cv2's, on the CPU.

Tolerance: none. Every output equals cv2's / the JAX function's bit for
bit, in both backends (native and numpy), and after each augmentation the
``RandomState`` equals the JAX one's (``get_state()``), which pins the
draw order. Measured so against cv2 5.0: BGR -> HLS on all 2^24 BGR
triples, HLS -> BGR on every hue 0-179 with all lightness and saturation
values (the numpy twin; the native path on a 1/16 sample), the motion-blur
filter at every kernel size (cv2 keeps its direct path at 11 and 15 here:
no +-1 allowance was needed), and several thousand ellipses, clipped ones
included.
"""

import cv2
import numpy as np
import pytest

from torch_train_cases import few_torch_threads  # noqa: F401
from unseenobjectswithmeanshift_torch.data import augmentation as paug
from unseenobjectswithmeanshift_torch.data import image_ops
from unseenobjectswithmeanshift_tpu.data import augmentation as jaug

BACKENDS = ("native", "numpy")


def _equal(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want), int((got != want).sum())


def same_state(a, b):
    """Two RandomStates in the same state (get_state() equal)."""
    sa, sb = a.get_state(), b.get_state()
    return sa[0] == sb[0] and np.array_equal(sa[1], sb[1]) and sa[2:] == sb[2:]


def _depth(rng, h=96, w=128):
    depth = (rng.rand(h, w) * 1.5 + 0.4).astype(np.float32)
    depth[rng.rand(h, w) < 0.1] = 0
    depth[:, : w // 5] = 0
    return depth


@pytest.mark.parametrize("backend", BACKENDS)
def test_depth_augmentations_equal_jax(backend):
    for seed in range(6):
        depth = _depth(np.random.RandomState(seed))
        xyz = np.random.RandomState(seed + 50).randn(*depth.shape, 3).astype(np.float32)
        pr, jr = np.random.RandomState(seed), np.random.RandomState(seed)
        _equal(paug.add_noise_to_depth(depth, rng=pr), jaug.add_noise_to_depth(depth, rng=jr))
        _equal(paug.dropout_random_ellipses(depth, rng=pr, backend=backend),
               jaug.dropout_random_ellipses(depth, rng=jr))
        _equal(paug.add_noise_to_xyz(xyz, depth, rng=pr, backend=backend),
               jaug.add_noise_to_xyz(xyz, depth, rng=jr))
        assert same_state(pr, jr)


@pytest.mark.parametrize("backend", BACKENDS)
def test_colour_augmentations_equal_jax(backend):
    """chromatic_transform and add_noise over enough seeds that both add_noise
    branches (gaussian, and motion blur in both directions) are taken."""
    im = (np.random.RandomState(9).rand(72, 96, 3) * 255).astype(np.uint8)
    blurs = set()
    for seed in range(60):
        pr, jr = np.random.RandomState(seed), np.random.RandomState(seed)
        _equal(paug.chromatic_transform(im, rng=pr, backend=backend),
               jaug.chromatic_transform(im, rng=jr))
        probe = np.random.RandomState(seed)
        probe.set_state(pr.get_state())
        if probe.rand(1) >= 0.9:
            blurs.add(seed)
        _equal(paug.add_noise(im, rng=pr, backend=backend), jaug.add_noise(im, rng=jr))
        assert same_state(pr, jr)
    assert len(blurs) >= 3


def test_hls_conversions_equal_cv2_on_every_value():
    v = np.arange(256, dtype=np.uint8)
    bgr = np.stack(np.meshgrid(v, v, v, indexing="ij"), -1).reshape(4096, 4096, 3)
    want = cv2.cvtColor(bgr, cv2.COLOR_BGR2HLS)
    _equal(image_ops.bgr_to_hls_u8(bgr, "numpy"), want)
    _equal(image_ops.bgr_to_hls_u8(bgr[::16], "native"), want[::16])
    hls = np.stack(np.meshgrid(np.arange(180, dtype=np.uint8), v, v, indexing="ij"), -1)
    hls = hls.reshape(-1, 256, 3)
    want = cv2.cvtColor(hls, cv2.COLOR_HLS2BGR)
    _equal(image_ops.hls_to_bgr_u8(hls, "numpy"), want)
    _equal(image_ops.hls_to_bgr_u8(hls[::16], "native"), want[::16])


@pytest.mark.parametrize("backend", BACKENDS)
def test_resizes_equal_cv2(backend):
    rng = np.random.RandomState(10)
    for h, w, size in ((300, 311, 224), (448, 448, 224), (37, 500, 224), (120, 90, 225),
                       (2, 3, 64), (480, 640, 100)):
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        _equal(image_ops.resize_linear_u8(img, size, size, backend), cv2.resize(img, (size, size)))
        lab = rng.randint(0, 9, (h, w)).astype(np.int32)
        xyz = rng.randn(h, w, 3).astype(np.float32)
        for a in (lab, xyz):
            _equal(image_ops.resize_nearest(a, size, size),
                   cv2.resize(a, (size, size), interpolation=cv2.INTER_NEAREST))
    for h, w in ((480, 640), (224, 224), (37, 53)):
        noise = rng.normal(0, 0.005, size=(h // 4, w // 4, 3))
        _equal(image_ops.resize_cubic_f64(noise, h, w, backend),
               cv2.resize(noise, (w, h), interpolation=cv2.INTER_CUBIC))
    if backend == "native":                 # sizes are checked before any pointer is passed
        with pytest.raises(ValueError):
            image_ops.resize_linear_u8(np.zeros((0, 4, 3), np.uint8), 8, 8)
        with pytest.raises(ValueError):
            image_ops.resize_cubic_f64(np.zeros((4, 4, 3)), 0, 8)


@pytest.mark.parametrize("backend", BACKENDS)
def test_motion_blur_equals_cv2(backend):
    im = np.random.RandomState(11).randint(0, 256, (120, 160, 3)).astype(np.uint8)
    for size in (3, 5, 7, 9, 11, 15):
        for horizontal in (True, False):
            k = np.zeros((size, size))
            if horizontal:
                k[(size - 1) // 2, :] = 1.0
            else:
                k[:, (size - 1) // 2] = 1.0
            _equal(image_ops.filter_line_u8(im, size, horizontal, backend),
                   cv2.filter2D(im, -1, k / size))
    if backend == "native":
        with pytest.raises(ValueError, match="odd"):
            image_ops.filter_line_u8(im, 4, True)


@pytest.mark.parametrize("backend", BACKENDS)
def test_ellipses_equal_cv2(backend):
    """Ellipses of the dropout's sizes and larger (every vertex step of
    ellipse2Poly: 90, 30, 18 and 5 degrees), centres inside and outside the
    image (clipLine), zero axes."""
    rng = np.random.RandomState(12)
    H, W = 60, 80
    for t in range(1500):
        scale = (1, 3, 0.2)[t % 3]
        c = (int(rng.randint(-8, W + 8)), int(rng.randint(-8, H + 8)))
        axes = (int(np.round(rng.gamma(5, scale))), int(np.round(rng.gamma(5, scale))))
        angle = int(rng.randint(0, 360))
        want = cv2.ellipse(np.zeros((H, W), np.float32), c, axes, angle=angle, startAngle=0,
                           endAngle=360, color=1, thickness=-1) == 1
        got = image_ops.ellipse_mask((H, W), c, axes, angle, backend)
        assert np.array_equal(got, want), (c, axes, angle)
