"""The port's dataset readers against the JAX package's, bit for bit, on
fixture trees the tests write: OCID (a 'table' sequence with paletted labels
and LZF clouds with back references, a floor sequence with 16-bit labels),
OSD (ascii and binary clouds), the TOD test split (JPEG colour), pushing,
mixture, and the three UOAIS readers (cv2's Telea inpainting on both sides).
OCID and OSD with and without the clouds; so are the loader helpers.
"""

import numpy as np
import pytest

from torch_eval_cases import (
    assert_samples_equal, write_ocid_tree, write_osd_tree, write_pushing_tree,
    write_tod_tree, write_uoais_sim_tree,
)
from unseenobjectswithmeanshift_tpu.data import datasets as jds
from unseenobjectswithmeanshift_tpu.data import loader as jloader
from unseenobjectswithmeanshift_tpu.data import uoais as juoais
from unseenobjectswithmeanshift_torch.data import datasets as pds
from unseenobjectswithmeanshift_torch.data import loader as ploader
from unseenobjectswithmeanshift_torch.data import uoais as puoais


def _all_equal(port, jax_ds):
    assert len(port) == len(jax_ds) > 0
    for i in range(len(jax_ds)):
        assert_samples_equal(port[i], jax_ds[i])


@pytest.mark.parametrize("input_type", ["RGBD", "COLOR"])
def test_ocid_and_osd_equal_jax(tmp_path, input_type):
    rng = np.random.RandomState(0)
    ocid = write_ocid_tree(tmp_path / "ocid", rng, frames=2)
    osd = write_osd_tree(tmp_path / "osd", rng, frames=2)
    port = pds.get_dataset("ocid_object", ocid, input_type=input_type)
    _all_equal(port, jds.get_dataset("ocid_object", ocid, input_type=input_type))
    # the table sequence's floor (id 2) and table (id 1) went to background
    assert len(np.unique(port[0]["label"])) >= 2
    assert (port[0]["xyz"] is None) == (input_type == "COLOR")
    _all_equal(pds.get_dataset("osd_object", osd, input_type=input_type),
               jds.get_dataset("osd_object", osd, input_type=input_type))


def test_tod_pushing_mixture_equal_jax(tmp_path):
    rng = np.random.RandomState(1)
    tod = write_tod_tree(tmp_path / "tod", rng)
    push = write_pushing_tree(tmp_path / "push", rng)
    kw = dict(image_set="test", use_augmentation=False, chromatic=False, add_noise=False)
    tt = pds.get_dataset("tabletop_object", tod, **kw)
    jt = jds.get_dataset("tabletop_object", tod, **kw)
    _all_equal(tt, jt)
    pp, jp = pds.get_dataset("pushing", push), jds.get_dataset("pushing", push)
    _all_equal(pp, jp)
    _all_equal(pds.MixtureDataset(pp, tt), jds.MixtureDataset(jp, jt))


def test_uoais_readers_equal_jax(tmp_path):
    rng = np.random.RandomState(2)
    ocid = write_ocid_tree(tmp_path / "ocid", rng, frames=1, depth_png=True)
    osd = write_osd_tree(tmp_path / "osd", rng, frames=1, disparity=True)
    sim = write_uoais_sim_tree(tmp_path / "sim", rng)
    _all_equal(pds.get_dataset("ocid_object_uoais", ocid),
               jds.get_dataset("ocid_object_uoais", ocid))
    _all_equal(pds.get_dataset("osd_object_uoais", osd),
               jds.get_dataset("osd_object_uoais", osd))
    _all_equal(puoais.UOAISSimDataset(sim, "coco.json"),
               juoais.UOAISSimDataset(sim, "coco.json"))
    d = (rng.rand(16, 16) * 2000).astype(np.float32)
    n = puoais.normalize_depth(d)
    assert np.array_equal(n, juoais.normalize_depth(d))
    assert np.array_equal(puoais.unnormalize_depth(n), juoais.unnormalize_depth(n))
    rle = puoais.rle_encode(rng.rand(13, 17) > 0.6)
    assert rle == juoais.rle_encode(juoais.rle_decode(rle))


def test_training_branches_refused_naming_item_12(tmp_path):
    """Item 12's training branches are ported (their samples are held to the
    JAX reader's in tests/test_torch_train_files.py): each constructs and
    reads; what stays refused is the host-rendered synthetic_tabletop,
    which names its own ROADMAP item (14)."""
    tod = write_tod_tree(tmp_path / "tod", np.random.RandomState(3))
    assert pds.TableTopObject(tod, "test", seed=0)[0]["label"].shape == (48, 64)
    for flag in ("syn_crop", "sampling"):
        ds = pds.TableTopObject(tod, "test", use_augmentation=False, chromatic=False,
                                add_noise=False, seed=0, **{flag: True})
        assert ds[0]["image"].shape[-1] == 3
    with pytest.raises(ValueError, match="item 14"):
        pds.get_dataset("synthetic_tabletop", "4")


def test_loader_helpers_equal_jax():
    rng = np.random.RandomState(4)
    label = rng.randint(0, 6, (30, 33)).astype(np.int32)
    for got, want in zip(ploader.label_image_to_instances(label, 4),
                         jloader.label_image_to_instances(label, 4)):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    a = rng.rand(30, 33, 3).astype(np.float32)
    assert np.array_equal(ploader.pad_hw(a), jloader.pad_hw(a))
    assert np.array_equal(pds.remap_labels(label * 3), jds.remap_labels(label * 3))
    assert pds.fov_intrinsics() == jds.fov_intrinsics()
