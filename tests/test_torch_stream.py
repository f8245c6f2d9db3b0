"""``TwoStagePredictor.stream`` and ``UCNPredictor.stream`` on the CPU.

Streaming queues stage 1 of the next ``depth`` batches before a batch's
crop-count sync; the outputs must be those of per-batch ``__call__``, bit for
bit (``torch.equal``), in order. Random weights are made decisive as in
``chip_smoke.py``, so that stage 2 runs on some batches (``__call__`` itself
is held against the JAX package in test_torch_two_stage.py and
test_torch_ucn.py).
"""

import copy

import numpy as np
import pytest
import torch

from unseenobjectswithmeanshift_torch.pipeline.factory import (
    build_two_stage_predictor, build_ucn_predictor,
)

from torch_port_cases import rgbd, small_configs


def _msmformer():
    _, _, pc, pcc = small_configs()
    pred = build_two_stage_predictor(cfg=pc, cfg_crop=pcc, device="cpu", seed=3)
    with torch.no_grad():
        for model in (pred.model, pred.model_crop):
            head = model.sem_seg_head.predictor
            head.mask_embed.layers[2].weight *= 30.0
            head.mask_embed.layers[2].bias *= 30.0
            head.class_embed.weight.zero_()
    return pred


def _ucn(batches, input_type="RGBD"):
    _, _, pc, _ = small_configs()
    pc.mean_shift.num_seeds, pc.test.max_instances = 12, 4
    pc.backbone.input_type, pc.use_depth = input_type, input_type != "COLOR"
    pred = build_ucn_predictor(cfg=pc, cfg_crop=copy.deepcopy(pc), device="cpu", seed=1)
    img, xyz = batches[0]
    with torch.no_grad():                 # spread the embeddings (chip_smoke.py)
        for net in (pred.network, pred.network_crop):
            t = lambda x: None if x is None else x.permute(0, 3, 1, 2)
            raw = net.raw_nchw(t(img), t(xyz))
            net.fcn.resnet34_8s.fc.bias -= raw.mean(dim=(0, 2, 3))
    return pred


def _batches(color=False, n=3):
    rng = np.random.RandomState(7)
    out = []
    for _ in range(n):
        img, xyz = rgbd(rng)
        out.append((torch.from_numpy(img), None if color else torch.from_numpy(xyz)))
    return out


@pytest.mark.parametrize("kind", ["msmformer", "ucn", "ucn_color"])
def test_stream_equals_per_batch_call(kind):
    batches = _batches(color=kind == "ucn_color")
    pred = _msmformer() if kind == "msmformer" else _ucn(
        batches, "COLOR" if kind == "ucn_color" else "RGBD")
    want = [pred(img, xyz) for img, xyz in batches]
    assert any(not torch.equal(r, l) for l, r in want), "stage 2 never ran"
    for depth in (1, 2):
        got = list(pred.stream(iter(batches), depth=depth))
        assert len(got) == len(want)
        for (gl, gr), (wl, wr) in zip(got, want):
            assert torch.equal(gl, wl) and torch.equal(gr, wr)
    with pytest.raises(ValueError):
        list(pred.stream(batches, depth=0))
