"""The port and chip_smoke.py import neither JAX nor the JAX package, nor
cv2 or PyYAML (the card machine has neither: the port imports cv2 only
inside the UOAIS readers' Telea inpainting and polygon fill, and PyYAML
inside the function that reads YAML files).

Runs in a subprocess, because tests/conftest.py imports jax into the pytest
process. Also checks that chip_smoke.py refuses to run without CUDA, and
that the port reads OCID and OSD trees and scores them through
``cli.test_net.evaluate``, and reads TOD training samples (JPEG, every
augmentation, SYN_CROP) equal to the JAX reader's, in a process where cv2
and PIL cannot be imported.
"""

import functools
import json
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import torch

import unseenobjectswithmeanshift_torch

REPO = Path(__file__).resolve().parents[1]

PROBE = """
import importlib, json, pkgutil, sys
import unseenobjectswithmeanshift_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax",
                                    "unseenobjectswithmeanshift_tpu"))
lazy = sorted(k for k in sys.modules if k.split(".")[0] in ("cv2", "yaml"))
print(json.dumps({"modules": names, "bad": bad, "lazy": lazy}))
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    return env


@functools.lru_cache(maxsize=None)
def _probe():
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=REPO, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_port_and_chip_smoke_import_no_jax():
    result = _probe()
    expected = {m.name for m in pkgutil.walk_packages(
        unseenobjectswithmeanshift_torch.__path__, "unseenobjectswithmeanshift_torch.")}
    assert set(result["modules"]) == expected and len(expected) >= 15
    # the standard-backbone family's modules are among them
    assert {f"unseenobjectswithmeanshift_torch.{m}" for m in (
        "ops.ms_deform_attn", "models.backbone_resnet", "models.pixel_decoders",
        "models.swin")} <= expected
    # and the training path's, the CLI included
    assert {f"unseenobjectswithmeanshift_torch.{m}" for m in (
        "losses.point_sample", "losses.lsap", "losses.matcher", "losses.criterion",
        "losses.embedding", "train.trainer", "utils.checkpoint_io", "data.synthetic",
        "data.synthetic_device", "cli.train_msmformer")} <= expected
    # and the evaluation path's
    assert {f"unseenobjectswithmeanshift_torch.{m}" for m in (
        "utils.image_io", "data.pcd", "native", "utils.evaluation", "data.datasets",
        "data.loader", "data.uoais", "cli.test_net")} <= expected
    # and training on files: JPEG, the augmentations, UCN training
    assert {f"unseenobjectswithmeanshift_torch.{m}" for m in (
        "utils.jpeg", "data.image_ops", "data.augmentation", "train.ucn",
        "cli.train_net")} <= expected
    assert result["bad"] == []


def test_port_and_chip_smoke_import_no_cv2_or_yaml():
    result = _probe()
    assert {"unseenobjectswithmeanshift_torch.cli.demo",
            "unseenobjectswithmeanshift_torch.config",
            "unseenobjectswithmeanshift_torch.utils.preprocess",
            "unseenobjectswithmeanshift_torch.utils.image_io",
            "unseenobjectswithmeanshift_torch.data.uoais"} <= set(result["modules"])
    assert result["lazy"] == []


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        env = _env() | {"CUDA_VISIBLE_DEVICES": ""}
    else:
        env = _env()
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


NO_CV2 = """
import json, sys
import torch
sys.modules["cv2"] = None           # import cv2 / import PIL raise ImportError
sys.modules["PIL"] = None
torch.set_num_threads(2)            # beside the other test workers
from unseenobjectswithmeanshift_torch.cli.test_net import evaluate
from unseenobjectswithmeanshift_torch.config import get_config
from unseenobjectswithmeanshift_torch.data.datasets import get_dataset
from unseenobjectswithmeanshift_torch.pipeline.factory import build_two_stage_predictor
from unseenobjectswithmeanshift_torch.utils.evaluation import aggregate_metrics

def small(name):
    cfg = get_config(name)
    d, p = cfg.decoder, cfg.pixel_decoder
    d.num_queries, d.hidden_dim, d.dim_feedforward, d.dec_layers, d.nheads = 8, 32, 64, 2, 4
    d.mask_dim, d.conv_dim, p.conv_dim, p.mask_dim = 32, 16, 16, 32
    cfg.backbone.num_units, cfg.test.max_instances, cfg.test.crop_size = 16, 4, 32
    return cfg

pred = build_two_stage_predictor(cfg=small("tabletop_pretrained"),
                                 cfg_crop=small("crop_tabletop_pretrained"), device="cpu")
out = {}
for name, root in (("ocid_object", sys.argv[1]), ("osd_object", sys.argv[2])):
    ds = get_dataset(name, root)
    r = evaluate(pred, ds, batch=2, osd=name == "osd_object")
    out[name] = {"images": len(r["metrics"]), "labels": [int(g.max()) for g in r["gt"]],
                 "F": aggregate_metrics(r["metrics_refined"])["Objects F-measure"]}
print(json.dumps(out))
"""


def test_ocid_and_osd_score_without_cv2_or_pil(tmp_path):
    import numpy as np

    from torch_eval_cases import write_ocid_tree, write_osd_tree
    from unseenobjectswithmeanshift_tpu.data.datasets import get_dataset as jax_dataset

    ocid = write_ocid_tree(tmp_path / "ocid", np.random.RandomState(0), frames=1)
    osd = write_osd_tree(tmp_path / "osd", np.random.RandomState(1), frames=2)
    out = subprocess.run([sys.executable, "-c", NO_CV2, ocid, osd], cwd=REPO, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    result = json.loads(out.stdout.strip().splitlines()[-1])
    for name, root in (("ocid_object", ocid), ("osd_object", osd)):
        want = jax_dataset(name, root)
        assert result[name]["images"] == len(want) == 2
        assert result[name]["labels"] == [int(want[i]["label"].max()) for i in range(2)]
        assert 0.0 <= result[name]["F"] <= 1.0


NO_CV2_TOD = """
import pickle, sys
sys.modules["cv2"] = None
sys.modules["PIL"] = None
from unseenobjectswithmeanshift_torch.data.datasets import TableTopObject
out = []
for syn_crop in (False, True):
    ds = TableTopObject(sys.argv[1], "train", syn_crop=syn_crop, sampling=True,
                        sampling_num=200, seed=5)
    out += [ds[i] for i in range(len(ds))]
sys.stdout.buffer.write(pickle.dumps(out))
"""


def test_tod_training_reads_without_cv2_or_pil(tmp_path):
    import pickle

    import numpy as np

    from torch_eval_cases import write_tod_tree
    from unseenobjectswithmeanshift_tpu.data.datasets import TableTopObject

    tod = write_tod_tree(tmp_path / "tod", np.random.RandomState(6), splits=("training_set",))
    out = subprocess.run([sys.executable, "-c", NO_CV2_TOD, tod], cwd=REPO, env=_env(),
                         capture_output=True, timeout=300)
    assert out.returncode == 0, out.stderr.decode()
    got = pickle.loads(out.stdout)
    want = []
    for syn_crop in (False, True):
        ds = TableTopObject(tod, "train", syn_crop=syn_crop, sampling=True, sampling_num=200,
                            seed=5)
        want += [ds[i] for i in range(len(ds))]
    assert len(got) == len(want) == 12
    for g, w in zip(got, want):
        assert g["file_name"] == w["file_name"]
        for k in ("image", "xyz", "label"):
            assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k
