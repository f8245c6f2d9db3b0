"""The UOAIS readers without cv2, against the JAX package (which calls cv2).

The port's Telea inpainting (native and its numpy twin), its dilation, its
polygon fill and its nearest resize are held bit for bit to cv2 and to the
JAX package's ``inpaint_depth`` / ``ann_to_mask``; the three UOAIS readers
(OCID-UOAIS, OSD-UOAIS, UOAIS-Sim) to the JAX readers sample for sample, on
trees cv2 writes here. Tolerance: none; every comparison is exact.
"""

import json
from pathlib import Path

import cv2
import numpy as np
import pytest

from unseenobjectswithmeanshift_tpu.data import datasets as jds
from unseenobjectswithmeanshift_tpu.data import uoais as juoais
from unseenobjectswithmeanshift_torch.data import datasets as pds
from unseenobjectswithmeanshift_torch.data import image_ops
from unseenobjectswithmeanshift_torch.data import uoais as puoais
from torch_eval_cases import (assert_samples_equal, random_scene, write_ocid_tree,
                              write_osd_tree)
from torch_threads import few_torch_threads, module_tmp_cleanup  # noqa: F401

BACKENDS = ["native", "numpy"]


def depth_u8x3(rng, h, w, holes=12, speckle=0.01, border=0):
    """A normalized uint8 x3 depth as the readers make it: a tilted table,
    boxes in front of it, zero-depth holes (blobs, speckle, a border band)."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    d = 90 + 80 * y / h + 12 * np.sin(x / 17.0)
    for _ in range(5):
        cy, cx, r = rng.randint(0, h), rng.randint(0, w), rng.randint(3, max(4, h // 5))
        d[(y - cy) ** 2 + (x - cx) ** 2 < r * r] -= rng.randint(20, 60)
    hole = rng.rand(h, w) < speckle
    for _ in range(holes):
        cy, cx = rng.randint(0, h), rng.randint(0, w)
        dy, dx = rng.randint(1, max(2, h // 12)), rng.randint(1, max(2, w // 12))
        hole[cy:cy + dy, cx:cx + dx] = True
    hole[:, :border] = True
    d = np.where(hole, 0, np.clip(d, 1, 255)).astype(np.uint8)
    return np.repeat(d[..., None], 3, -1)


def telea_case(name, rng):
    h, w = 24, 32
    img = cv2.GaussianBlur((rng.rand(h, w, 3) * 255).astype(np.uint8), (0, 0), 2)
    mask = np.zeros((h, w), np.uint8)
    if name == "single":
        mask[11, 15] = 1
    elif name == "block":
        mask[8:14, 10:19] = 1
    elif name == "border":
        mask[0, :] = 1
        mask[:, -2:] = 1
        mask[-1, 3] = 1
    elif name == "touching":
        mask[5:10, 5:10] = 1
        mask[10:15, 10:15] = 1
        mask[5:10, 10:12] = 1
    elif name == "speckle":
        mask = (rng.rand(h, w) < 0.3).astype(np.uint8)
    elif name == "ones":
        mask[:] = 1
    elif name == "tiny":
        img, mask = img[:2, :3].copy(), (rng.rand(2, 3) < 0.5).astype(np.uint8)
    return img, mask


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", ["single", "block", "border", "touching", "speckle", "zeros",
                                  "ones", "tiny"])
def test_telea_equals_cv2(name, backend):
    img, mask = telea_case(name, np.random.RandomState(len(name)))
    want = cv2.inpaint(img, mask, 3, cv2.INPAINT_TELEA)
    got = image_ops.inpaint_telea(img, mask, 3, backend=backend)
    assert got.dtype == np.uint8 and np.array_equal(got, want)
    for radius in (1, 5):
        assert np.array_equal(image_ops.inpaint_telea(img, mask, radius, backend=backend),
                              cv2.inpaint(img, mask, radius, cv2.INPAINT_TELEA))


@pytest.mark.parametrize("backend", BACKENDS)
def test_telea_random_sweep_equals_cv2(backend):
    rng = np.random.RandomState(11)
    for c in range(40):
        h, w = rng.randint(2, 20), rng.randint(2, 20)
        img = (rng.rand(h, w, 3) * 255).astype(np.uint8)
        mask = (rng.rand(h, w) < rng.choice([0.05, 0.2, 0.5, 0.9])).astype(np.uint8)
        assert np.array_equal(image_ops.inpaint_telea(img, mask, 3, backend=backend),
                              cv2.inpaint(img, mask, 3, cv2.INPAINT_TELEA)), c


def test_telea_refuses_what_cv2_reads_outside():
    for backend in BACKENDS:
        with pytest.raises(ValueError, match="2x2"):
            image_ops.inpaint_telea(np.zeros((1, 5, 3), np.uint8), np.ones((1, 5)), 3, backend)
        with pytest.raises(ValueError):
            image_ops.inpaint_telea(np.zeros((4, 5), np.uint8), np.ones((4, 5)), 3, backend)


@pytest.mark.parametrize("backend,hw", [("native", (480, 640)), ("numpy", (96, 128))])
@pytest.mark.parametrize("factor,dilate", [(1, False), (1, True), (2, False), (2, True)])
def test_inpaint_depth_equals_jax(factor, dilate, backend, hw):
    d3 = depth_u8x3(np.random.RandomState(factor * 2 + dilate), *hw,
                    border=3 if dilate else 0)
    want = juoais.inpaint_depth(d3, factor=factor, dilate=dilate)
    got = puoais.inpaint_depth(d3, factor=factor, dilate=dilate, backend=backend)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert (got[d3 == 0] > 0).mean() > 0.5          # the holes were filled


def test_telea_twin_at_full_size():
    """The numpy twin against the native library on a 480x640 depth with
    real-looking holes (and cv2 on the same input)."""
    d3 = depth_u8x3(np.random.RandomState(7), 480, 640, holes=10, speckle=0.004, border=2)
    mask = np.all(d3 == 0, axis=2).astype(np.uint8)
    want = cv2.inpaint(d3, mask, 3, cv2.INPAINT_TELEA)
    assert np.array_equal(image_ops.inpaint_telea(d3, mask, 3), want)
    assert np.array_equal(image_ops.inpaint_telea(d3, mask, 3, backend="numpy"), want)


@pytest.mark.parametrize("backend", BACKENDS)
def test_dilate_equals_cv2(backend):
    rng = np.random.RandomState(2)
    for c in range(12):
        m = (rng.rand(rng.randint(1, 30), rng.randint(1, 30)) < 0.15).astype(np.uint8)
        m *= rng.randint(1, 255, m.shape).astype(np.uint8)
        for k in (1, 2, 3, 4, 5, (3, 5)):
            kernel = np.ones((k, k) if np.isscalar(k) else k, np.uint8)
            want = cv2.dilate(m, kernel, 1)               # as JAX inpaint_depth calls it
            assert np.array_equal(image_ops.dilate_u8(m, k, backend=backend), want), (c, k)


POLYGONS = {
    "convex": [[[4.2, 3.0, 30.6, 5.5, 27.0, 20.4, 6.0, 18.0]]],
    "concave": [[[3, 3, 30, 3, 30, 20, 17, 9, 3, 20]]],
    "self_intersecting": [[[2, 2, 30, 20, 30, 2, 2, 20]], [[5, 1, 25, 22, 5, 22, 25, 1, 15, 11]]],
    "clipped": [[[-6.4, -3, 20, 4, 12.5, 30]], [[20, -8, 44, 10, 38.5, 30, 25, 12]],
                [[-5, 5, 40, 6, 39, 7, -4, 8]], [[-10, -10, 50, -10, 50, 40, -10, 40]]],
    "repeated": [[[5, 5, 5, 5, 20, 6, 20, 6, 20, 6, 12, 18, 5, 5]]],
    "one_or_two_points": [[[7.5, 9.5]], [[3, 4, 25, 17]], [[10, 2, 10, 19]], [[2, 8, 28, 8]]],
    "several": [[[2, 2, 10, 2, 10, 10], [12, 12, 28, 13, 20, 21], [-3, 15, 6, 23, 0, 25]]],
    "half_vertices": [[[2.5, 3.5, 20.5, 4.5, 11.5, 19.5, 3.4999, 12.5001]]],
}


@pytest.mark.parametrize("name", sorted(POLYGONS))
def test_ann_to_mask_polygons_equal_jax(name):
    for seg in POLYGONS[name]:
        ann = {"segmentation": seg}
        want = juoais.ann_to_mask(ann, 24, 32)
        assert np.array_equal(puoais.ann_to_mask(ann, 24, 32), want)
        twin = np.zeros((24, 32), np.uint8)
        for poly in seg:
            pts = np.round(np.asarray(poly, np.float64).reshape(-1, 2)).astype(np.int32)
            image_ops.fill_poly(twin, pts, 1, backend="numpy")
        assert np.array_equal(twin, want)


@pytest.mark.parametrize("backend", BACKENDS)
def test_fill_poly_random_sweep_equals_cv2(backend):
    rng = np.random.RandomState(5)
    for c in range(400):
        h, w, n = rng.randint(1, 40), rng.randint(1, 40), rng.randint(1, 12)
        lo, hi = ((-w, -h), (2 * w, 2 * h)) if c % 2 else ((0, 0), (w, h))
        pts = np.stack([rng.randint(lo[0], hi[0], n), rng.randint(lo[1], hi[1], n)], 1)
        pts = np.repeat(pts, rng.randint(1, 3, n), 0).astype(np.int32)
        want = np.zeros((h, w), np.uint8)
        cv2.fillPoly(want, [pts], 3)
        got = image_ops.fill_poly(np.zeros((h, w), np.uint8), pts, 3, backend=backend)
        assert np.array_equal(got, want), (c, pts.tolist())


def test_resize_nearest_equals_cv2():
    rng = np.random.RandomState(8)
    for shape in ((48, 64, 3), (240, 320, 3), (480, 640, 3), (477, 641, 3), (720, 1280, 3)):
        d = (rng.rand(*shape) * 255).astype(np.uint8)
        want = cv2.resize(d, (640, 480), interpolation=cv2.INTER_NEAREST)
        assert np.array_equal(image_ops.resize_nearest(d, 480, 640), want), shape


def write_sim_tree(root, rng, h=48, w=64, frames=3):
    """UOAIS-Sim with polygons of every kind above, an RLE annotation and
    depth with zero holes, written by cv2."""
    root = Path(root)
    (root / "color").mkdir(parents=True)
    (root / "depth").mkdir()
    images, anns = [], []
    for i in range(frames):
        bgr, label, _ = random_scene(rng, h, w)
        cv2.imwrite(str(root / "color" / f"{i}.png"), bgr)
        depth = (rng.rand(h, w) * 12000 + 2000).astype(np.uint16)
        depth[rng.rand(h, w) < 0.03] = 0
        depth[:4, -5:] = 0
        cv2.imwrite(str(root / "depth" / f"{i}.png"), depth)
        images.append({"id": i, "height": h, "width": w, "file_name": f"color/{i}.png",
                       "depth_file_name": f"depth/{i}.png"})
        anns.append({"image_id": i, "segmentation": puoais.rle_encode(label == 2)})
        for name in sorted(POLYGONS)[i::frames]:
            for seg in POLYGONS[name]:
                anns.append({"image_id": i, "segmentation": seg})
    with open(root / "coco.json", "w") as fh:
        json.dump({"images": images, "annotations": anns}, fh)
    return str(root)


def test_uoais_readers_equal_jax(tmp_path):
    rng = np.random.RandomState(9)
    ocid = write_ocid_tree(tmp_path / "ocid", rng, frames=2, depth_png=True)
    osd = write_osd_tree(tmp_path / "osd", rng, frames=2, disparity=True)
    sim = write_sim_tree(tmp_path / "sim", rng)
    pairs = [(pds.get_dataset(name, root), jds.get_dataset(name, root))
             for name, root in (("ocid_object_uoais", ocid), ("osd_object_uoais", osd))]
    pairs.append((puoais.UOAISSimDataset(sim, "coco.json"),
                  juoais.UOAISSimDataset(sim, "coco.json")))
    for port, jax_ds in pairs:
        assert len(port) == len(jax_ds) >= 2
        for i in range(len(port)):
            assert_samples_equal(port[i], jax_ds[i])
    # the holes were there and were filled
    assert puoais.UOAISSimDataset(sim, "coco.json")[0]["label"].max() >= 3
