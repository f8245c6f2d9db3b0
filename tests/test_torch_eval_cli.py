"""The port's evaluation path on the CPU at toy width (tests/test_cli_eval.py's
_shrink configs): ``cli.test_net.evaluate`` on an OCID tree with MSMFormer
and UCN (decisive random weights, so that stage 2 runs), B=3 over 4 images
(a short last batch): every per-image metric equals the JAX package's
``multilabel_metrics`` on the port's labels, the ground truth equals the
reader's, and the labels equal the predictor's on the same batch. Then
``cli.test_net.main`` through its argv on OCID and TOD test trees, with and
without --ucn, --no-refine and --save-mat; and ``cli.train_msmformer
--eval-period`` on synthetic scenes at 32x32, and its scoring on a decisive
network at 64x64 (chip_smoke's train_eval gate).
"""

import copy
import glob
import json
import math
import os

import numpy as np
import pytest
import torch

from chip_smoke import decisive_predictor, decisive_ucn_predictor, train_eval_scoring
from torch_eval_cases import shrink, write_ocid_tree, write_tod_tree
from torch_threads import module_tmp_cleanup  # noqa: F401
from torch_train_cases import few_torch_threads  # noqa: F401
from unseenobjectswithmeanshift_tpu.utils.evaluation import multilabel_metrics as jax_metrics
from unseenobjectswithmeanshift_torch.cli import test_net, train_msmformer
from unseenobjectswithmeanshift_torch.config import get_config
from unseenobjectswithmeanshift_torch.data.datasets import get_dataset
from unseenobjectswithmeanshift_torch.data.loader import pad_hw
from unseenobjectswithmeanshift_torch.pipeline import factory


@pytest.fixture(scope="module")
def ocid_tree(tmp_path_factory):
    return write_ocid_tree(tmp_path_factory.mktemp("ocid"), np.random.RandomState(0),
                           h=64, w=64, frames=2)


def _batch(dataset, idx, B):
    samples = [dataset[i] for i in idx] + [dataset[idx[-1]]] * (B - len(idx))
    img = torch.from_numpy(np.stack([pad_hw(s["image"]) for s in samples]))
    return img, torch.from_numpy(np.stack([pad_hw(s["xyz"]) for s in samples]))


@pytest.mark.parametrize("kind", ["msmformer", "ucn"])
def test_evaluate_metrics_equal_jax_on_the_ports_labels(ocid_tree, kind):
    dataset = get_dataset("ocid_object", ocid_tree)
    assert len(dataset) == 4
    cfg = shrink(get_config("tabletop_pretrained"))
    if kind == "msmformer":
        pred = decisive_predictor(cfg=cfg, cfg_crop=shrink(get_config("crop_tabletop_pretrained")),
                                  device="cpu")
        thr = None
    else:
        img, xyz = _batch(dataset, [0], 1)
        pred = decisive_ucn_predictor(img, xyz, cfg=cfg, cfg_crop=copy.deepcopy(cfg),
                                      device="cpu")
        thr = cfg.test.depth_filter_threshold_ocid
    result = test_net.evaluate(pred, dataset, batch=3, ucn_threshold=thr)
    assert result["batches"] == [3, 1]
    refined_any = False
    for i in range(4):
        gt = dataset[i]["label"]
        assert np.array_equal(result["gt"][i], gt)
        assert result["metrics"][i] == jax_metrics(result["labels"][i], gt)
        assert result["metrics_refined"][i] == jax_metrics(result["refined"][i], gt)
        refined_any |= not np.array_equal(result["labels"][i], result["refined"][i])
    assert refined_any                                 # stage 2 changed some labels
    for idx in ([0, 1, 2], [3]):
        img, xyz = _batch(dataset, idx, 3)
        kw = {"depth_threshold": thr} if kind == "ucn" else {}
        labels, refined = pred(img, xyz, **kw)
        for j, i in enumerate(idx):
            assert np.array_equal(result["labels"][i], labels[j].numpy())
            assert np.array_equal(result["refined"][i], refined[j].numpy())


@pytest.mark.parametrize("tree,flags", [
    ("ocid", ["--save-mat", "MATS"]),
    ("ocid", ["--ucn", "--no-refine", "--batch", "2"]),
    ("tod", ["--dataset", "tabletop_object", "--limit", "3", "--save-mat", "MATS"]),
    ("tod", ["--dataset", "tabletop_object", "--ucn", "--limit", "2", "--no-refine"])])
def test_test_net_cli(ocid_tree, tmp_path, monkeypatch, capsys, tree, flags):
    monkeypatch.setattr(factory, "get_config", lambda name: shrink(get_config(name)))
    root = ocid_tree if tree == "ocid" else write_tod_tree(tmp_path / "tod",
                                                           np.random.RandomState(1), h=64, w=64)
    mats = str(tmp_path / "mats")
    argv = ["--root", root, "--device", "cpu"] + [mats if f == "MATS" else f for f in flags]
    result = test_net.main(argv)
    out = capsys.readouterr().out
    n = result["timing"]["images"]
    assert n == {"ocid": 4, "tod": 3 if "--save-mat" in flags else 2}[tree]
    assert f"{n} images in" in out and "random weights" in out
    assert out.count("Objects F-measure") == 2 and out.count("Boundary F-measure") == 2
    assert len(result["metrics"]) == len(result["metrics_refined"]) == n
    if "--no-refine" in flags:
        assert result["metrics"] == result["metrics_refined"]
    if "--save-mat" in flags:
        from scipy.io import loadmat

        files = sorted(glob.glob(os.path.join(mats, "*.mat")))
        assert len(files) == n
        m = loadmat(files[-1])
        assert m["labels"].shape == m["labels_refined"].shape == (64, 64)


def test_test_net_refuses_key_stride_with_ucn(ocid_tree):
    with pytest.raises(SystemExit):
        test_net.main(["--root", ocid_tree, "--device", "cpu", "--ucn", "--key-stride", "2"])


def test_train_eval_period(tmp_path, capsys):
    out = str(tmp_path / "run")
    train_msmformer.main(["--device", "cpu", "--batch", "1", "--image-size", "32", "32",
                          "--output", out, "--iters", "1", "--log-period", "1",
                          "--checkpoint-period", "10", "--eval-period", "1",
                          "--eval-samples", "2"])
    with open(os.path.join(out, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    evals = [r for r in records if r["kind"] == "eval"]
    assert [r["iter"] for r in evals] == [1]
    for r in evals:
        assert {"Objects F-measure", "Boundary F-measure", "obj_detected_075_percentage"} <= r.keys()
        assert all(math.isfinite(v) for k, v in r.items() if k != "kind")
    assert capsys.readouterr().out.count("eval at iter 1 on 2 held-out scenes") == 1


def test_train_eval_scoring_on_a_decisive_network():
    args = train_msmformer.parse_args(["--device", "cpu", "--image-size", "64", "64",
                                       "--eval-samples", "2", "--output", "unused"])
    pred = decisive_predictor(cfg=shrink(get_config("tabletop_pretrained")),
                              cfg_crop=shrink(get_config("crop_tabletop_pretrained")),
                              device="cpu")
    got = train_eval_scoring(args, pred)
    assert got["obj_detected"] > 0 and got["obj_gt"] > 0
