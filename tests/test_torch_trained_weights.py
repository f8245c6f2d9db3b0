"""Trained weights in the port: the committed release ``msmformer_synthetic_r5``
restored in process, carried into the port through the numpy export
(``scripts/export_release_npz.py`` -> ``weights.load_npz_variables``), and run
by both packages on held-out scenes rendered by the numpy oracle
``data/synthetic.py``, full width (E=256, 8 heads, Q=100, 6 layers), fp32, on
the CPU. Stage-1 labels of the port with ``decoder.tile_skip``, of the port
dense and of the JAX package must be equal.

Trained masks concentrate on objects, but they also leave some queries of
every layer with an empty mask, and the guard makes such a query attend to
every key: the test checks that such queries exist, which is why tile
skipping keeps every tile on these weights (PERF.md §6). It runs at
192x256; the 480x640 case is gated behind UOMS_FLAGSHIP_PARITY=1 as
tests/test_flagship_parity.py is.
"""

import os
import sys
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from unseenobjectswithmeanshift_tpu.config import get_config as jax_get_config
from unseenobjectswithmeanshift_tpu.data.synthetic import SyntheticTabletopDataset
from unseenobjectswithmeanshift_tpu.pipeline.two_stage import TwoStagePredictor
from unseenobjectswithmeanshift_torch.pipeline.factory import build_two_stage_predictor
from unseenobjectswithmeanshift_torch.weights import load_npz_variables

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "scripts"))
from chip_smoke import spy_cross_attention  # noqa: E402
from export_release_npz import flatten, release_variables  # noqa: E402
from torch_threads import few_torch_threads, module_tmp_cleanup  # noqa: F401

RELEASE = "msmformer_synthetic_r5"
SIZES = [(192, 256), pytest.param((480, 640), marks=pytest.mark.skipif(
    os.environ.get("UOMS_FLAGSHIP_PARITY") != "1",
    reason="480x640 on the CPU is heavy; set UOMS_FLAGSHIP_PARITY=1"))]


@pytest.fixture(scope="module")
def r5_variables():
    if not (REPO / "checkpoints" / RELEASE).is_dir():
        pytest.fail(f"the committed release checkpoints/{RELEASE} is missing")
    return release_variables(RELEASE)


def scenes(hw, n=2):
    ds = SyntheticTabletopDataset(image_set="test", height=hw[0], width=hw[1],
                                  use_augmentation=False, chromatic=False, add_noise=False,
                                  scene_style="ocid")
    samples = [ds[i] for i in range(n)]
    return (np.stack([s["image"] for s in samples]).astype(np.float32),
            np.stack([s["xyz"] for s in samples]).astype(np.float32))


@pytest.mark.parametrize("hw", SIZES)
def test_r5_stage1_labels_port_tile_skip_dense_and_jax(r5_variables, hw, tmp_path):
    npz = tmp_path / "r5.npz"
    np.savez(npz, **dict(flatten(r5_variables)))
    variables = load_npz_variables(npz)
    for got, want in zip(flatten(variables), flatten(r5_variables)):
        assert got[0] == want[0] and np.array_equal(got[1], want[1])

    img, xyz = scenes(hw)
    cfg = jax_get_config("tabletop_pretrained")
    jl, _ = TwoStagePredictor(cfg, jax_get_config("crop_tabletop_pretrained"))._forward(
        r5_variables, r5_variables, jnp.asarray(img), jnp.asarray(xyz), osd=False,
        refine=False)
    jl = np.asarray(jl)

    labels, log = {}, []
    for tile_skip in (False, True):
        pred = build_two_stage_predictor(variables=variables, variables_crop=variables,
                                         device="cpu", tile_skip=tile_skip)
        with torch.inference_mode(), spy_cross_attention(log):
            labels[tile_skip] = pred.stage1(torch.from_numpy(img), torch.from_numpy(xyz)).labels

    assert all(len(np.unique(jl[b])) >= 4 for b in range(len(jl))), "too few instances found"
    assert len(log) == 12 and all(guards > 0 for _, guards, *_ in log)
    assert torch.equal(labels[True], labels[False])
    np.testing.assert_array_equal(labels[True].numpy(), jl)
