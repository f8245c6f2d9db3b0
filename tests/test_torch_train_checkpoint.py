"""Training checkpoints and the training CLI, on the CPU.

- save / restore / resume: a run restored from its step-2 checkpoint takes
  step 3 to the same parameters, running statistics and optimizer state as
  the uninterrupted run (torch.equal), and the checkpoint serves through
  ``build_two_stage_predictor(checkpoint=...)``.
- The CLI trains, writes checkpoint_<step>.pth and metrics.jsonl, and
  resumes from --output; what is not ported raises a ValueError naming its
  ROADMAP item; the embedding loss on the standard arch raises the JAX
  package's error; and --dataset tabletop_object (ported: its runs are in
  tests/test_torch_train_net.py) asks for its --root (evaluation during
  training runs since the readers and the metric are ported:
  tests/test_torch_eval_cli.py).
"""

import json
import os

import pytest
import torch

from torch_threads import module_tmp_cleanup  # noqa: F401
from torch_train_cases import few_torch_threads, tiny_batch, tiny_configs, to_torch  # noqa: F401
from unseenobjectswithmeanshift_torch.cli import train_msmformer
from unseenobjectswithmeanshift_torch.config import get_config
from unseenobjectswithmeanshift_torch.pipeline.factory import build_two_stage_predictor
from unseenobjectswithmeanshift_torch.train.trainer import Trainer
from unseenobjectswithmeanshift_torch.utils import checkpoint_io


def test_save_restore_resume_bit_for_bit(tmp_path):
    _, pc = tiny_configs()
    batch = to_torch(tiny_batch())
    a = Trainer(pc, device="cpu", seed=5)
    for _ in range(2):
        a.train_step(batch)
    path = checkpoint_io.save(checkpoint_io.checkpoint_path(str(tmp_path), a.step), a)
    (tmp_path / "checkpoint_0000009.pth.tmp").write_bytes(b"")     # an interrupted save
    assert checkpoint_io.latest_checkpoint(str(tmp_path)) == path
    a.train_step(batch)

    b = Trainer(pc, device="cpu", seed=5)
    assert checkpoint_io.restore(path, b) == 2
    b.train_step(batch)
    sa, sb = a.state_dict(), b.state_dict()
    assert sa["step"] == sb["step"] == 3
    assert all(torch.equal(v, sb["model"][k]) for k, v in sa["model"].items())
    opt_a, opt_b = sa["optimizer"]["state"], sb["optimizer"]["state"]
    assert opt_a.keys() == opt_b.keys()
    assert all(torch.equal(v, opt_b[i][n]) for i, s in opt_a.items() for n, v in s.items())

    pred = build_two_stage_predictor(cfg=pc, cfg_crop=pc, checkpoint=path, device="cpu")
    saved = torch.load(path, weights_only=True)["model"]
    assert all(torch.equal(v, saved[k]) for k, v in pred.model.state_dict().items())
    assert json.loads(torch.load(path, weights_only=True)["config"])["decoder"]["hidden_dim"] == 32


def test_cli_trains_and_resumes(tmp_path):
    out = str(tmp_path / "run")
    flags = ["--device", "cpu", "--batch", "1", "--image-size", "32", "32", "--output", out,
             "--log-period", "1", "--checkpoint-period", "1"]
    train_msmformer.main(flags + ["--iters", "1"])
    train_msmformer.main(flags + ["--iters", "2"])
    assert sorted(os.listdir(out)) == ["checkpoint_0000001.pth", "checkpoint_0000002.pth",
                                       "metrics.jsonl"]
    with open(os.path.join(out, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    assert [r["iter"] for r in records] == [1, 2]
    assert {"loss_ce", "loss_mask_5", "total_loss", "skipped_nonfinite"} <= records[1].keys()


@pytest.mark.parametrize("flags,item", [
    (["--dataset", "tabletop_object"], "--root is required"), (["--devices", "2"], "item 13"),
    (["--dataset", "tabletop_object", "--eval-period", "5"], "--root is required")])
def test_cli_refuses_what_is_not_ported(flags, item):
    with pytest.raises(ValueError, match=item):
        train_msmformer.check_args(train_msmformer.parse_args(flags))


@pytest.mark.parametrize("preset", ["tabletop_pretrained_resnet50", "tabletop_swin"])
def test_standard_backbone_embedding_loss_is_refused(preset):
    """The standard arch trains (tests/test_torch_train_standard.py) but has
    no embedding head: the embedding loss raises the JAX train step's error
    (JAX trainer.py:157-165), before a model is built."""
    cfg = get_config(preset)
    cfg.loss.use_embedding_loss = True
    with pytest.raises(ValueError, match="the standard R50/Swin arch has no embedding head"):
        Trainer(cfg, device="cpu")
