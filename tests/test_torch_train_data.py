"""The port's on-device synthetic scenes against the JAX package's, on the CPU.

- ``sample_scene_params``: the port's copy draws the same scenes (equal
  arrays) in both scene styles.
- ``render_scene_batch`` against JAX's ``render_scene_batch`` on the same
  parameters: labels equal; depth and RGB within 1e-5 on 99.5% of the
  pixels and within 1e-3 on all. (XLA fuses the intersection arithmetic into
  fused multiply-adds, torch does not; where a ray grazes a primitive,
  disc = b^2 - a c cancels and the last bits of t differ. The JAX package
  holds its own renderer to its numpy one at 2e-3 of the labels,
  tests/test_synthetic.py.)
- ``instances`` equal to JAX's ``_instances_device``.
- SYN_CROP, where the port does what the JAX package intended and pins the
  difference: the bilinear taps clamp to the crop window (crop, then
  resize), where the JAX formula (synthetic_jax.py:361) reads the pixels
  outside it; a label image with no object crops the whole image, where the
  JAX crop (:328-330) is a degenerate window.
- The depth dropout's ellipse centres are independent draws (the JAX
  augment_depth draws rows and columns from one key: the image diagonal).
- The loader's batch contract and determinism in (seed, step).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch
import torch.nn.functional as F

from torch_threads import module_tmp_cleanup  # noqa: F401
from torch_train_cases import few_torch_threads  # noqa: F401 (autouse)
from unseenobjectswithmeanshift_tpu.data import synthetic as jax_synthetic
from unseenobjectswithmeanshift_tpu.data import synthetic_jax
from unseenobjectswithmeanshift_tpu.data.datasets import fov_intrinsics as jax_fov_intrinsics
from unseenobjectswithmeanshift_torch.data.synthetic import fov_intrinsics, sample_scene_params
from unseenobjectswithmeanshift_torch.data.synthetic_device import (
    SyntheticDeviceLoader, crop_resize, crop_windows, ellipse_params, instances,
    render_scene_batch, stack_scene_params,
)

H, W = 48, 64
OCID = dict(p_stack=0.3, p_composite=0.25, touching=True, max_slots=20, max_objects=14,
            min_objects=5)


def test_scene_sampler_equals_jax():
    assert fov_intrinsics(W, H) == jax_fov_intrinsics(W, H)
    intr = fov_intrinsics(W, H)
    for style in ({}, OCID):
        for i in range(6):
            a = sample_scene_params(np.random.RandomState(i), intr, height=H, width=W, **style)
            b = jax_synthetic.sample_scene_params(np.random.RandomState(i), intr, height=H,
                                                  width=W, **style)
            assert a.keys() == b.keys()
            assert all(np.array_equal(a[k], b[k]) for k in a)


def test_renderer_and_instances_match_jax():
    intr = fov_intrinsics(W, H)
    args = tuple(float(intr[k]) for k in ("fx", "fy", "x_offset", "y_offset"))
    ps = [sample_scene_params(np.random.RandomState(i), intr, height=H, width=W)
          for i in range(4)]
    rgb_j, dep_j, lab_j = map(np.asarray, synthetic_jax.render_scene_batch(
        synthetic_jax.stack_scene_params(ps), H, W, *args))
    rgb, dep, lab = render_scene_batch(stack_scene_params(ps, "cpu"), H, W, *args)
    np.testing.assert_array_equal(lab.numpy(), lab_j)
    for got, want in ((rgb.numpy(), rgb_j), (dep.numpy(), dep_j)):
        err = np.abs(got - want)
        assert np.mean(err <= 1e-5) >= 0.995 and err.max() <= 1e-3, (np.mean(err <= 1e-5),
                                                                     err.max())
    assert (lab_j > 0).any(axis=(1, 2)).all()
    for b in range(4):
        want = synthetic_jax._instances_device(jnp.asarray(lab_j[b]), 12)
        got = instances(torch.from_numpy(lab_j[b:b + 1].copy()), 12)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[0].numpy(), np.asarray(w))


def _jax_bilinear_taps(lo, hi, size, S):
    """The JAX crop's bilinear matrix (synthetic_jax.py:356-360), taps clamped
    to the image [0, size - 1]."""
    span = hi - lo + 1.0
    grid = np.arange(size, dtype=np.float32)[None, :]
    i = np.arange(S, dtype=np.float32)[:, None]
    c = np.clip(lo + (i + 0.5) * span / S - 0.5, 0.0, size - 1.0)
    return np.maximum(0.0, 1.0 - np.abs(grid - c))


def test_syn_crop_clamps_taps_to_the_window(rng):
    S = 40
    image = rng.rand(1, H, W, 3).astype(np.float32)
    label = np.zeros((1, H, W), np.int32)
    label[0, 20:26, 28:33] = 3                                  # one object, inside the image
    windows = crop_windows(torch.from_numpy(label), 5, torch.tensor([[0.3, 0.5]]))
    y_lo, y_hi, x_lo, x_hi = (int(w[0]) for w in windows)
    assert 0 < y_lo and y_hi < H - 1 and 0 < x_lo and x_hi < W - 1, (y_lo, y_hi, x_lo, x_hi)
    t = torch.from_numpy
    img_c, xyz_c, lab_c = crop_resize(t(image), t(image), t(label), windows, S)
    crop = t(image[0, y_lo:y_hi + 1, x_lo:x_hi + 1]).permute(2, 0, 1)[None]
    want = F.interpolate(crop, size=(S, S), mode="bilinear", align_corners=False)
    np.testing.assert_allclose(img_c[0].numpy(), want[0].permute(1, 2, 0).numpy(), atol=1e-6)
    assert set(np.unique(lab_c.numpy())) == {0, 3}
    assert np.isin(xyz_c.numpy(), image).all()                 # nearest: source pixels only
    Ry = _jax_bilinear_taps(y_lo, y_hi, H, S)
    Rx = _jax_bilinear_taps(x_lo, x_hi, W, S)
    jax_img = np.einsum("ih,hwc,jw->ijc", Ry, image[0], Rx)
    border = np.abs(jax_img - img_c[0].numpy())
    assert border[0].max() > 1e-3 and border[S // 2, S // 2].max() < 1e-5


def test_syn_crop_without_foreground_crops_the_whole_image(rng):
    S = 32
    image = rng.rand(1, H, W, 3).astype(np.float32)
    label = np.zeros((1, H, W), np.int32)
    t = torch.from_numpy
    windows = crop_windows(t(label), 5, torch.tensor([[0.7, 0.2]]))
    assert [int(w[0]) for w in windows] == [0, H - 1, 0, W - 1]
    img_c, _, lab_c = crop_resize(t(image), t(image), t(label), windows, S)
    want = F.interpolate(t(image).permute(0, 3, 1, 2), size=(S, S), mode="bilinear",
                         align_corners=False)
    np.testing.assert_allclose(img_c[0].numpy(), want[0].permute(1, 2, 0).numpy(), atol=1e-6)
    assert not instances(lab_c, 5)[2].any()
    jax_img, _, _ = synthetic_jax._syn_crop_device(jax.random.PRNGKey(0), jnp.asarray(image[0]),
                                                   jnp.asarray(image[0]), jnp.asarray(label[0]),
                                                   S, 5)
    assert np.abs(np.asarray(jax_img) - img_c[0].numpy()).max() > 1e-2   # the JAX garbage window


def test_ellipse_centres_are_independent():
    g = torch.Generator().manual_seed(0)
    _, cy, cx, _, _, _ = ellipse_params(4, H, W, g, device="cpu")
    assert not torch.allclose(cy / (H - 1), cx / (W - 1))


def test_loader_batch_contract():
    loader = SyntheticDeviceLoader(2, height=H, width=W, max_gt=12, seed=3, device="cpu")
    b = loader.batch_at(0)
    assert b["image"].shape == (2, H, W, 3) and b["xyz"].shape == (2, H, W, 3)
    assert b["gt_masks"].shape == (2, 12, H, W) and b["gt_valid"].shape == (2, 12)
    assert b["label_image"].dtype == torch.int32 and b["gt_labels"].dtype == torch.int32
    assert all(torch.isfinite(b[k]).all() for k in ("image", "xyz"))
    v = b["gt_valid"]
    assert (v.sum(1) >= 1).all() and not (v[:, 1:] & ~v[:, :-1]).any()   # valid slots first
    for i in range(2):
        for s in range(12):
            assert torch.equal(b["label_image"][i] == s + 1, b["gt_masks"][i, s] > 0.5)
    again = loader.batch_at(0)
    assert all(torch.equal(b[k], again[k]) for k in b)
    crops = SyntheticDeviceLoader(2, max_gt=12, seed=3, syn_crop=True, crop_size=32,
                                  render_hw=(H, W), device="cpu").batch_at(1)
    assert crops["image"].shape == (2, 32, 32, 3) and crops["gt_masks"].shape == (2, 12, 32, 32)
    assert (crops["gt_valid"].sum(1) >= 1).all()
