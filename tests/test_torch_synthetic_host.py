"""The host renderer, the synthetic_tabletop dataset, the device loader's
scene parameters and dataset_statistics, against the JAX package.

cv2's INTER_CUBIC on float32 runs Intel IPP's code where cv2 is built with
it (as here) and its own code otherwise. The port computes cv2's own code:
``image_ops.resize_cubic_f32`` (native and numpy) is bit-equal to cv2 with
IPP off, and within ``CUBIC_IPP_ULPS`` ulps of 1.0 of cv2 with IPP on. The
renderer's labels and depth do not read the mottle and are equal either
way; its rgb and the dataset's samples are equal bit for bit with IPP off,
and with IPP on the rgb is within 0.4 x the mottle's bound (the mottle's
weight in the albedo) and the uint8 image within one level.
"""

import contextlib
import io

import cv2
import numpy as np
import pytest

from unseenobjectswithmeanshift_tpu.cli import dataset_statistics as jstats
from unseenobjectswithmeanshift_tpu.data import datasets as jds
from unseenobjectswithmeanshift_tpu.data import synthetic as jsyn
from unseenobjectswithmeanshift_tpu.data.synthetic_jax import SyntheticDeviceLoader as JLoader
from unseenobjectswithmeanshift_torch.cli import dataset_statistics as pstats
from unseenobjectswithmeanshift_torch.data import datasets as pds
from unseenobjectswithmeanshift_torch.data import image_ops
from unseenobjectswithmeanshift_torch.data import synthetic as psyn
from unseenobjectswithmeanshift_torch.data.synthetic_device import SyntheticDeviceLoader
from torch_eval_cases import assert_samples_equal, write_ocid_tree
from torch_threads import few_torch_threads, module_tmp_cleanup  # noqa: F401

BACKENDS = ["native", "numpy"]
ULP1 = float(np.spacing(np.float32(1)))


@contextlib.contextmanager
def ipp(on: bool):
    was = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(on)
    try:
        yield
    finally:
        cv2.ipp.setUseIPP(was)


@pytest.mark.parametrize("backend", BACKENDS)
def test_resize_cubic_f32_equals_cv2_without_ipp(backend):
    rng = np.random.RandomState(0)
    with ipp(False):
        for c in range(60):
            h, w, dh, dw = (int(n) for n in rng.randint(1, [20, 20, 70, 70]))
            img = rng.rand(h, w, 3) if c % 3 == 0 else rng.rand(h, w)
            img = ((img - 0.3) * 40).astype(np.float32)
            want = cv2.resize(img, (dw, dh), interpolation=cv2.INTER_CUBIC)
            got = image_ops.resize_cubic_f32(img, dh, dw, backend=backend)
            assert got.dtype == np.float32 and np.array_equal(got, want), (c, img.shape, dh, dw)


def test_resize_cubic_f32_within_bound_of_cv2_with_ipp():
    rng = np.random.RandomState(1)
    with ipp(True):
        for hw in ((480, 640), (96, 128), (48, 64), (37, 53)):
            m = rng.rand(*psyn.MOTTLE_HW).astype(np.float32)
            want = cv2.resize(m, hw[::-1], interpolation=cv2.INTER_CUBIC)
            for backend in BACKENDS:
                got = image_ops.resize_cubic_f32(m, *hw, backend=backend)
                err = np.abs(got.astype(np.float64) - want).max() / ULP1
                assert err <= image_ops.CUBIC_IPP_ULPS, (hw, err)


def scene(seed, style, h, w):
    intr = psyn.fov_intrinsics(w, h)
    kw = dict(p_stack=0.3, p_composite=0.25, touching=True, max_slots=20) if style == "ocid" \
        else {}
    mk = dict(max_objects=14, min_objects=5) if style == "ocid" else {}
    p = psyn.sample_scene_params(np.random.RandomState(seed), intr, height=h, width=w, **kw, **mk)
    j = jsyn.sample_scene_params(np.random.RandomState(seed), intr, height=h, width=w, **kw, **mk)
    return p, j, intr


@pytest.mark.parametrize("style,hw", [("r4", (48, 64)), ("ocid", (60, 80)), ("r4", (120, 160))])
def test_render_scene_numpy_equals_jax(style, hw):
    for seed in range(2):
        p, j, intr = scene(seed, style, *hw)
        got = {b: psyn.render_scene_numpy(p, *hw, intr, backend=b) for b in BACKENDS}
        with ipp(False):
            want = jsyn.render_scene_numpy(j, *hw, intr)
        for b in BACKENDS:
            for g, w_ in zip(got[b], want):
                assert g.dtype == w_.dtype and np.array_equal(g, w_), b
        with ipp(True):
            rgb, depth, label = jsyn.render_scene_numpy(j, *hw, intr)
        assert np.array_equal(got["native"][1], depth) and np.array_equal(got["native"][2], label)
        bound = 0.4 * image_ops.CUBIC_IPP_ULPS * ULP1 + 4 * ULP1
        assert np.abs(got["native"][0] - rgb).max() <= bound
        assert label.max() >= 1


@pytest.mark.parametrize("kwargs", [
    dict(),
    dict(scene_style="ocid", image_set="test"),
    dict(syn_crop=True, crop_size=32, sampling=True, sampling_num=100),
    dict(input_type="COLOR", use_augmentation=False, chromatic=False, add_noise=False),
])
def test_synthetic_tabletop_equals_jax(kwargs):
    kw = dict(num_scenes=3, height=48, width=64, seed=4, **kwargs)
    port = pds.get_dataset("synthetic_tabletop", None, **kw)
    with ipp(False):
        jax_ds = jds.get_dataset("synthetic_tabletop", None, **kw)
        want = [jax_ds[i] for i in range(3)]
    assert len(port) == len(jax_ds) == 3
    for i in range(3):
        assert_samples_equal(port[i], want[i])
    # with IPP, the samples' labels and xyz are equal and the image within a level
    port = pds.get_dataset("synthetic_tabletop", "3", **{k: v for k, v in kw.items()
                                                         if k != "num_scenes"})
    jax_ds = jds.get_dataset("synthetic_tabletop", "3", **{k: v for k, v in kw.items()
                                                          if k != "num_scenes"})
    for i in range(3):
        g, w_ = port[i], jax_ds[i]
        assert np.array_equal(g["label"], w_["label"])
        assert (g["xyz"] is None and w_["xyz"] is None) or np.array_equal(g["xyz"], w_["xyz"])
        assert np.abs(g["image"] - w_["image"]).max() <= 1 / 255 + 1e-6


@pytest.mark.parametrize("style", ["r4", "ocid"])
@pytest.mark.parametrize("image_set", ["train", "test"])
def test_device_loader_scene_params_equal_jax(style, image_set):
    port = SyntheticDeviceLoader(3, 48, 64, seed=2, image_set=image_set, scene_style=style,
                                 device="cpu")
    jax_loader = JLoader(3, 48, 64, seed=2, image_set=image_set, scene_style=style)
    assert (port.max_objects, port.min_objects) == (jax_loader.max_objects,
                                                    jax_loader.min_objects)
    assert port.style == jax_loader.style
    got, want = port.params_for(range(4, 7)), jax_loader.params_for(range(4, 7))
    assert got.keys() == want.keys()
    for k in want:
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


@pytest.mark.parametrize("dataset", ["ocid_object", "ocid_object_uoais", "synthetic_tabletop"])
def test_dataset_statistics_equal_jax(dataset, tmp_path):
    if dataset == "synthetic_tabletop":
        root, extra = "1", []           # one 480x640 scene: the CLI takes no size
    else:
        root = write_ocid_tree(tmp_path / "ocid", np.random.RandomState(3), frames=3,
                               depth_png=True)
        # at this toy size the UOAIS reader's depth (480x640) and image
        # (48x64) cannot share a view, in either package
        extra = ["--view", "2"] if dataset == "ocid_object" else []
    argv = ["--dataset", dataset, "--root", root, *extra]
    with ipp(False):
        want = _run(jstats.main, argv + ["--view-out", str(tmp_path / "jax")])
    got = _run(pstats.main, argv + ["--view-out", str(tmp_path / "port")])
    norm = [line.replace(str(tmp_path / "port"), "").replace(str(tmp_path / "jax"), "")
            for line in (got, want)]
    assert norm[0] == norm[1] and "images:" in got
    for path in sorted((tmp_path / "jax").glob("*.png")):
        assert np.array_equal(cv2.imread(str(tmp_path / "port" / path.name)),
                              cv2.imread(str(path)))
