"""The port's demo CLI and ``read_sample`` on files written with cv2.

``read_sample`` gives the JAX package's image and XYZ for the same PNG pair
(a BGR color image and a 16-bit depth image in millimetres). The demo's
``main`` runs end to end on the CPU (``--device cpu``) on a folder of such
pairs, with and without camera_params.json, and writes a ``-label.png`` per
color image, as the JAX demo does.
"""

import json
import os

import cv2
import numpy as np
import pytest

import torch

from unseenobjectswithmeanshift_tpu.utils import preprocess as jax_preprocess
from unseenobjectswithmeanshift_tpu.utils.preprocess import read_sample as jax_read_sample
from unseenobjectswithmeanshift_torch.cli import demo
from unseenobjectswithmeanshift_torch.utils.preprocess import normalize_image_coco, read_sample
from torch_threads import few_torch_threads, module_tmp_cleanup  # noqa: F401

CAMERA = {"fx": 525.0, "fy": 525.0, "x_offset": 31.5, "y_offset": 23.5}


def _write_pair(folder, i, rng, h=48, w=64):
    color = rng.randint(0, 256, size=(h, w, 3)).astype(np.uint8)
    depth = rng.randint(400, 1500, size=(h, w)).astype(np.uint16)
    depth[rng.rand(h, w) < 0.1] = 0
    cp, dp = os.path.join(folder, f"{i:06d}-color.png"), os.path.join(folder, f"{i:06d}-depth.png")
    cv2.imwrite(cp, color)
    cv2.imwrite(dp, depth)
    return cp, dp


@pytest.mark.parametrize("input_type", ["RGBD", "COLOR"])
def test_read_sample_matches_jax(tmp_path, rng, input_type):
    cp, dp = _write_pair(str(tmp_path), 0, rng)
    want = jax_read_sample(cp, dp, CAMERA, input_type=input_type)
    got = read_sample(cp, dp, CAMERA, input_type=input_type, device="cpu")
    np.testing.assert_array_equal(got["image"].numpy(), np.asarray(want["image"]))
    if input_type == "COLOR":
        assert got["xyz"] is None and want["xyz"] is None
    else:
        # (u - px) z / fx in float32 on both sides
        np.testing.assert_allclose(got["xyz"].numpy(), np.asarray(want["xyz"]), rtol=1e-6,
                                   atol=1e-7)


def test_normalize_image_coco_matches_jax(rng):
    im = rng.randint(0, 256, size=(5, 7, 3)).astype(np.uint8)
    np.testing.assert_array_equal(normalize_image_coco(torch.from_numpy(im)).numpy(),
                                  np.asarray(jax_preprocess.normalize_image_coco(im)))


@pytest.mark.parametrize("with_params", [True, False])
def test_demo_main_writes_label_images(tmp_path, rng, with_params, capsys):
    imgdir, out = tmp_path / "imgs", tmp_path / "out"
    imgdir.mkdir()
    for i in range(2):
        _write_pair(str(imgdir), i, rng, 32, 32)
    if with_params:
        (imgdir / "camera_params.json").write_text(json.dumps(CAMERA))
    demo.main(["--imgdir", str(imgdir), "--out", str(out), "--device", "cpu",
               "--height", "32", "--width", "32"])
    printed = capsys.readouterr().out
    assert "done" in printed and ("FOV intrinsics" in printed) != with_params
    for i in range(2):
        label = cv2.imread(str(out / f"{i:06d}-color-label.png"), cv2.IMREAD_UNCHANGED)
        assert label.shape == (32, 32) and label.dtype == np.uint8
        assert set(np.unique(label)) <= {0, 255}
