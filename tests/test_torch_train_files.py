"""Training on files, the readers: ``TableTopObject`` with every training
branch and ``BatchLoader`` against the JAX package's, on TOD trees written
with cv2 (JPEG colour, 16-bit depth PNG, 8-bit labels with table id 1).

Tolerance: none. Each sample (normalized image, XYZ, label, file name) and
each collated batch equals the JAX reader's bit for bit, and after every
sample the reader's RandomState equals the JAX reader's, for RGBD, COLOR
and DEPTH input, with and without SYN_CROP and pixel sampling, with the
depth, chromatic and noise augmentations on (the JAX defaults).
"""

import numpy as np
import pytest
import torch

from test_torch_augmentation import same_state
from torch_eval_cases import write_tod_tree
from torch_threads import module_tmp_cleanup  # noqa: F401
from torch_train_cases import few_torch_threads  # noqa: F401
from unseenobjectswithmeanshift_torch.data import datasets as pds
from unseenobjectswithmeanshift_torch.data import loader as ploader
from unseenobjectswithmeanshift_tpu.data import datasets as jds
from unseenobjectswithmeanshift_tpu.data import loader as jloader


@pytest.fixture(scope="module")
def tod(tmp_path_factory):
    root = tmp_path_factory.mktemp("files") / "tod"
    return write_tod_tree(root, np.random.RandomState(20), h=96, w=128, scenes=1,
                          splits=("training_set", "test_set"))


def assert_sample_equal(got, want):
    assert got.keys() == want.keys() and got["file_name"] == want["file_name"]
    for k in ("image", "xyz", "label"):
        if want[k] is None:
            assert got[k] is None, k
            continue
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert np.array_equal(got[k], want[k]), (k, int((got[k] != want[k]).sum()))


@pytest.mark.parametrize("input_type", ["RGBD", "COLOR", "DEPTH"])
@pytest.mark.parametrize("syn_crop", [False, True])
@pytest.mark.parametrize("sampling", [False, True])
def test_tabletop_samples_equal_jax(tod, input_type, syn_crop, sampling):
    kw = dict(input_type=input_type, syn_crop=syn_crop, sampling=sampling,
              sampling_num=300, seed=3)
    p, j = pds.TableTopObject(tod, "train", **kw), jds.TableTopObject(tod, "train", **kw)
    assert len(p) == len(j) == (5 if syn_crop else 7)
    for i in (0, 3, len(p) - 1, 1):
        assert_sample_equal(p[i], j[i])
        assert same_state(p.rng, j.rng)
    if syn_crop:
        assert p[2]["image"].shape == (224, 224, 3)
    if sampling:
        assert (p[0]["label"] == -1).any()


def test_evaluation_split_clean_equal_jax(tod):
    """The split train_msmformer --eval-period reads: test, seed 1, no
    augmentation (with and without SYN_CROP)."""
    for syn_crop in (False, True):
        kw = dict(syn_crop=syn_crop, crop_size=224, seed=1, use_augmentation=False,
                  chromatic=False, add_noise=False)
        p, j = pds.TableTopObject(tod, "test", **kw), jds.TableTopObject(tod, "test", **kw)
        for i in range(len(p)):
            assert_sample_equal(p[i], j[i])


@pytest.mark.parametrize("prefetch", [0, 2])
def test_batch_loader_equals_jax(tod, prefetch):
    kw = dict(syn_crop=False, seed=4)
    p = ploader.BatchLoader(pds.TableTopObject(tod, "train", **kw), 2, max_gt=6, seed=7,
                            prefetch=prefetch)
    j = jloader.BatchLoader(jds.TableTopObject(tod, "train", **kw), 2, max_gt=6, seed=7,
                            prefetch=prefetch)
    assert len(p) == len(j) == 3
    for _ in range(2):                                # two passes: two shuffles
        got, want = list(p), list(j)
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert set(g) - {"file_name"} == set(w)
            for k in w:
                assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k
            assert len(g["file_name"]) == 2
        assert same_state(p.rng, j.rng) and same_state(p.dataset.rng, j.dataset.rng)


def test_batch_loader_to_device_and_without_masks(tod):
    """device= gives torch tensors with the trainer's keys (pinning only on a
    CUDA device); masks=False leaves out the instance masks, with the same
    label image; an error in the producer thread surfaces in the consumer."""
    ds = lambda: pds.TableTopObject(tod, "train", seed=4)
    full = list(ploader.BatchLoader(ds(), 2, max_gt=6, seed=7))
    lean = list(ploader.BatchLoader(ds(), 2, max_gt=6, seed=7, device="cpu", masks=False))
    for f, b in zip(full, lean):
        assert set(b) == {"image", "xyz", "label_image", "file_name"}
        assert all(torch.is_tensor(b[k]) for k in ("image", "xyz", "label_image"))
        for k in ("image", "xyz", "label_image"):
            assert np.array_equal(b[k].numpy(), f[k])
        assert ploader.batch_checksum(b) == ploader.batch_checksum(f)

    class Broken:
        rng = np.random.RandomState(0)

        def __len__(self):
            return 4

        def __getitem__(self, i):
            raise OSError(f"unreadable sample {i}")

    with pytest.raises(OSError, match="unreadable sample"):
        list(ploader.BatchLoader(Broken(), 2))
