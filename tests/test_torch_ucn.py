"""The port's UCN pipeline against the JAX package on the CPU: the
size-ordered renumbering, the SEGNET weight bridge and the whole two-stage
``UCNPredictor`` at 64x64 with full ResNet34-8s towers.

Random SEGNET weights give embeddings with a large common component, and the
whole image falls into one cluster. The predictor cases therefore make the
random weights decisive: the RGB tower's fc bias is shifted by minus the mean
raw (pre-normalization) embedding of the scene, so the unit embeddings spread
over the sphere and stage 1 finds a dozen clusters (``_decisive``). The same
shifted weights go to both packages. Labels must be equal.
"""

import copy

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from unseenobjectswithmeanshift_tpu.config import get_config as jax_get_config
from unseenobjectswithmeanshift_tpu.models.segnet import SEGNET as JaxSEGNET
from unseenobjectswithmeanshift_tpu.pipeline.postprocess import (
    renumber_labels_by_size as jax_renumber,
)
from unseenobjectswithmeanshift_tpu.pipeline import refine as jax_refine
from unseenobjectswithmeanshift_tpu.pipeline.ucn import UCNPredictor as JaxUCNPredictor
from unseenobjectswithmeanshift_torch.config import get_config
from unseenobjectswithmeanshift_torch.ops import mean_shift_kernels as msk
from unseenobjectswithmeanshift_torch.pipeline.factory import build_ucn_predictor
from unseenobjectswithmeanshift_torch.pipeline.postprocess import renumber_labels_by_size
from unseenobjectswithmeanshift_torch.pipeline.refine import match_label_crop

from test_torch_backbone import _perturb_bn
from test_torch_cuda import tabletop_scene
from torch_threads import few_torch_threads, module_tmp_cleanup  # noqa: F401

SEEDS, T, CROP = 12, 4, 32


def test_renumber_labels_by_size_matches_jax(rng):
    label = rng.randint(0, 9, size=(40, 50)).astype(np.int32)
    label[label == 5] = 0                      # a label with no pixels
    label[:2, :] = 7                           # a clear largest cluster
    label[label == 3] = 4                      # two labels of equal size stay in order
    label[0, :9] = np.arange(9)                # ... after this, 3 has 1 pixel
    for max_label in (9, 100):
        want, want_k = jax_renumber(jnp.asarray(label), max_label)
        got, got_k = renumber_labels_by_size(torch.from_numpy(label), max_label)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert int(got_k) == int(want_k) == len(np.unique(label)) - 1


@pytest.mark.parametrize("with_depth", [True, False])
def test_match_label_crop_drops_crop_labels_beyond_the_slots(rng, with_depth):
    """UCN crop labels run up to num_seeds + 1, past the T + 2 values the
    paste-back ranks: those pixels belong to no segment, as in the JAX
    package (its one-hot drops them)."""
    H, W, T, S = 40, 48, 4, 16
    label = np.zeros((H, W), np.int32)
    for v, (y, x) in enumerate([(2, 3), (20, 5), (8, 25), (25, 30)], start=2):
        label[y:y + 12, x:x + 14] = v
    xyz = rng.rand(H, W, 3).astype(np.float32)
    crops = jax_refine.crop_rois(jnp.zeros((H, W, 3)), jnp.asarray(label), jnp.asarray(xyz), T, S)
    labels_crop = rng.randint(0, 3 * T, size=(T, S, S)).astype(np.int32)
    labels_crop[:, :5] = np.minimum(labels_crop[:, :5], 3)
    depth = np.asarray(crops.xyz[..., 2]) if with_depth else None
    args = (labels_crop, np.asarray(crops.mask), np.asarray(crops.rois), depth,
            np.asarray(crops.present))
    want = np.asarray(jax_refine.match_label_crop(
        *[None if a is None else jnp.asarray(a) for a in args], (H, W), overlap_threshold=0.05))
    got = match_label_crop(*[None if a is None else torch.from_numpy(np.array(a)) for a in args],
                           (H, W), overlap_threshold=0.05).numpy()
    assert labels_crop.max() >= T + 2 and want.max() >= 2
    np.testing.assert_array_equal(got, want)


def test_from_jax_segnet_variables_features_match(rng):
    img = rng.rand(1, 64, 64, 3).astype(np.float32) - 0.4
    xyz = (rng.rand(1, 64, 64, 3) * 1.5).astype(np.float32)
    jnet = JaxSEGNET()
    v = jax.tree.map(np.array, jnet.init(jax.random.PRNGKey(2), img, xyz))
    _perturb_bn(v["params"], rng)
    _perturb_bn(v["batch_stats"], rng)
    want = np.asarray(jnet.apply(v, img, xyz))
    pred = build_ucn_predictor(variables=v, variables_crop=v, device="cpu")
    with torch.no_grad():
        got = pred.network(torch.from_numpy(img), torch.from_numpy(xyz)).numpy()
    # as tests/test_torch_backbone.py: ~1e-6 after 2 x 37 fp32 convs, held at 2e-5
    np.testing.assert_allclose(got, want, atol=2e-5)


def _decisive(variables, img, xyz):
    """Shift the RGB tower's fc bias by minus the mean raw embedding."""
    raw = JaxSEGNET(normalize=False).apply(variables, img, xyz)
    fc = variables["params"]["fcn"]["fc"]
    fc["bias"] = fc["bias"] - np.asarray(raw).reshape(-1, raw.shape[-1]).mean(0)
    return variables


@pytest.fixture(scope="module")
def ucn_case():
    """Scene, decisive JAX variables and the JAX predictor's outputs."""
    cfg = jax_get_config("tabletop_pretrained")
    cfg.mean_shift.num_seeds, cfg.test.max_instances, cfg.test.crop_size = SEEDS, T, CROP
    pred = JaxUCNPredictor(cfg)
    img, xyz = tabletop_scene(1)
    v1, v2 = (_decisive(jax.tree.map(np.array, v), img, xyz)
              for v in pred.init(jax.random.PRNGKey(1), (64, 64), crop_size=CROP))
    labels, refined = pred(v1, v2, jnp.asarray(img), jnp.asarray(xyz))
    unrefined = pred(v1, v2, jnp.asarray(img), jnp.asarray(xyz), refine=False)[1]
    return img, xyz, v1, v2, np.asarray(labels), np.asarray(refined), np.asarray(unrefined)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("refine", [True, False])
def test_ucn_predictor_labels_equal_jax(ucn_case, refine, use_pallas):
    img, xyz, v1, v2, want_l, want_r, want_u = ucn_case
    cfg = get_config()
    cfg.mean_shift.num_seeds, cfg.test.max_instances, cfg.test.crop_size = SEEDS, T, CROP
    cfg.mean_shift.use_pallas = use_pallas
    pred = build_ucn_predictor(variables=v1, variables_crop=v2, device="cpu", cfg=cfg,
                               cfg_crop=copy.deepcopy(cfg))
    before = (msk.fps_seeds.launches, msk.mean_shift_seeds.launches)
    labels, refined = pred(torch.from_numpy(img), torch.from_numpy(xyz), refine=refine)
    assert (msk.fps_seeds.launches, msk.mean_shift_seeds.launches) == before   # plain on CPU

    # the comparison must exercise many clusters and a stage 2 that changes labels
    assert len(np.unique(want_l)) >= 8 and len(np.unique(want_r)) >= 3
    assert labels.shape == refined.shape == (1, 64, 64)
    assert labels.dtype == refined.dtype == torch.int32
    np.testing.assert_array_equal(labels.numpy(), want_l)
    np.testing.assert_array_equal(refined.numpy(), want_r if refine else want_u)
    np.testing.assert_array_equal(want_u, want_l)
