"""A reference-format ``.pth`` into the port and into the JAX package.

The port's MSMFormer state_dict is saved as detectron2 saves a checkpoint
(``{"model": ...}``), with one key that holds no network weight (a criterion
buffer) and the legacy ``static_query`` name of ``query_feat``. The JAX
package reads it with ``load_torch_state_dict`` and
``convert_msmformer_checkpoint``; the port with ``load_reference_checkpoint``
(through ``build_two_stage_predictor(checkpoint=...)``, which loads with
``strict=True``). Both forwards agree on pred_logits and pred_masks. The same
for a UCN SEGNET checkpoint (``module.`` prefixes, an embedding-loss buffer).
"""

import jax.numpy as jnp
import numpy as np
import torch

from unseenobjectswithmeanshift_tpu.models.meta_arch import MSMFormer as JaxMSMFormer
from unseenobjectswithmeanshift_tpu.models.segnet import SEGNET as JaxSEGNET
from unseenobjectswithmeanshift_tpu.utils.checkpoint import (
    convert_msmformer_checkpoint, convert_ucn_checkpoint, load_torch_state_dict,
)
from unseenobjectswithmeanshift_torch.models.meta_arch import MSMFormer
from unseenobjectswithmeanshift_torch.pipeline.factory import (
    build_two_stage_predictor, build_ucn_predictor,
)
from unseenobjectswithmeanshift_torch.weights import init_random, load_reference_checkpoint

from test_torch_decoder import assert_close
from torch_port_cases import rgbd, small_configs


def test_msmformer_pth_round_trip_matches_jax(tmp_path, rng):
    _, _, pc, pcc = small_configs()
    model = init_random(MSMFormer(pc), torch.Generator().manual_seed(5)).eval()
    with torch.no_grad():
        head = model.sem_seg_head.predictor
        head.mask_embed.layers[2].weight *= 30.0
        head.mask_embed.layers[2].bias *= 30.0
    sd = dict(model.state_dict())
    sd["sem_seg_head.predictor.static_query.weight"] = sd.pop(
        "sem_seg_head.predictor.query_feat.weight")
    sd["criterion.empty_weight"] = torch.ones(3)
    path = tmp_path / "model_final.pth"
    torch.save({"model": sd, "iteration": 7}, path)

    img, xyz = rgbd(rng, (32, 32))
    jax_vars = convert_msmformer_checkpoint(load_torch_state_dict(str(path)))
    want = JaxMSMFormer(small_configs()[0]).apply(jax_vars, jnp.asarray(img), jnp.asarray(xyz))
    loaded = load_reference_checkpoint(path)
    assert "criterion.empty_weight" not in loaded
    assert set(loaded) == set(model.state_dict())
    pred = build_two_stage_predictor(cfg=pc, cfg_crop=pcc, checkpoint=str(path), device="cpu")
    for net in (pred.model, pred.model_crop):
        with torch.no_grad():
            got = net(torch.from_numpy(img), torch.from_numpy(xyz), light=False)
        for key in ("pred_logits", "pred_masks"):
            assert_close(got[key].numpy(), want[key], key)


def test_ucn_pth_round_trip_matches_jax(tmp_path, rng):
    pred = build_ucn_predictor(device="cpu", seed=2)
    sd = {"module." + k: v for k, v in pred.network.state_dict().items()}
    sd["module.embedding_loss.alpha"] = torch.tensor(0.02)
    path = tmp_path / "seg.pth"
    torch.save(sd, path)
    img, xyz = rgbd(rng, (32, 32))
    want = JaxSEGNET().apply(convert_ucn_checkpoint(load_torch_state_dict(str(path))),
                             img, xyz)
    loaded = build_ucn_predictor(checkpoint=str(path), device="cpu")
    with torch.no_grad():
        got = loaded.network_crop(torch.from_numpy(img), torch.from_numpy(xyz))
    # as tests/test_torch_backbone.py: fp32 convs in two orders, held at 2e-5
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
