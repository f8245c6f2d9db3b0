"""bf16 serving of the port against the JAX package's bf16 path, on the CPU.

- The cross-attention's plain version (the kernel's twin) on bf16 inputs
  against the JAX kernel ``fused_uoms_cross_attention`` on the same bf16
  inputs in interpret mode, as tests/test_fused_cross_attention.py runs it:
  dense, tile skipping, a guard row, padded K and Q. The twin rounds where
  the JAX kernel rounds (k^, the weights, v) and computes the rest in fp32;
  measured: equal to the JAX kernel, bit for bit, at all four cases (on
  an x86 CPU with torch 2.13). Held at one bf16 ulp of the output's scale
  (2^-8 at outputs below 1), well inside the 2e-2 that the JAX package's
  bench.py gives its compiled bf16 kernel.
- The model surface: the port's MSMFormer in bf16 against the same weights
  in fp32, as JAX tests/test_factory.py:170-176 holds the JAX package's bf16
  (within 0.15 of scale, > 0.97 sign agreement on confident logits), and no
  further from fp32 than twice the JAX package's own bf16 MSMFormer on the
  same weights and input (measured: 7.8e-3 / 1.5e-2 of scale for
  pred_logits / pred_masks, the JAX package's 8.9e-3 / 1.7e-2). The fp32
  side of both is the port's fp32 MSMFormer, which equals the JAX
  package's within ~1e-6 (tests/test_torch_decoder.py), a JAX compile less.
- The UCN embedding: the port's bf16 SEGNET against the JAX bf16 SEGNET
  (measured 5.9e-3 apart; held at 1.6e-2, four bf16 ulps of a unit
  vector's components) and no further from fp32 than twice the JAX one
  (measured 5.3e-3 and 5.1e-3; the fp32 side is the port's fp32 SEGNET,
  2e-5 from the JAX package's, tests/test_torch_ucn.py).
- The entry points: the factories build bf16 from ``bf16=True`` and from a
  YAML with ``dtype: bfloat16`` (parameters stay fp32), and the demo runs
  with ``--bf16``.
"""

import copy

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from unseenobjectswithmeanshift_tpu.models.meta_arch import MSMFormer as JaxMSMFormer
from unseenobjectswithmeanshift_tpu.models.segnet import SEGNET as JaxSEGNET
from unseenobjectswithmeanshift_tpu.ops.fused_cross_attention import (
    fused_uoms_cross_attention as jax_fused, mf_tile_bounds, plan_tile_skip,
)
from unseenobjectswithmeanshift_torch import config
from unseenobjectswithmeanshift_torch.models.meta_arch import MSMFormer
from unseenobjectswithmeanshift_torch.ops.fused_cross_attention import fused_uoms_cross_attention
from unseenobjectswithmeanshift_torch.pipeline.factory import (
    build_two_stage_predictor, build_ucn_predictor,
)
from unseenobjectswithmeanshift_torch.weights import from_jax_variables

from test_fused_cross_attention import make_inputs
from test_torch_backbone import _perturb_bn
from torch_port_cases import jax_msmformer_variables, rgbd, small_configs
from torch_threads import few_torch_threads, module_tmp_cleanup  # noqa: F401

TWIN_TOL = 2.0 ** -8        # one bf16 ulp at outputs below 1
SURFACE_TOL, SIGN_AGREE = 0.15, 0.97
EMBED_TOL = 1.6e-2


def _torch_bf16(a):
    """A JAX bf16 array as a torch bf16 tensor (through fp32: exact)."""
    return torch.from_numpy(np.asarray(a.astype(jnp.float32))).to(torch.bfloat16)


@pytest.mark.parametrize("case", ["dense", "tile_skip", "guard", "padded"])
def test_twin_matches_jax_kernel_in_bf16(case):
    rng = np.random.RandomState(0)
    args = [np.array(a) for a in make_inputs(rng, **(dict(B=3, Q=5, K=90)
                                                     if case == "padded" else {}))]
    mf, me = args[2], args[3]
    if case == "guard":          # query 0 of image 0 masked everywhere
        mf[0, 0] = np.abs(mf[0, 0]) + 0.1
        me[0, 0] = 0.0
        me[0, 0, 0] = -5.0
    if case == "tile_skip":      # every query attends to keys 40-59 only
        keys = np.arange(mf.shape[-1])
        mf[:, 0] = np.where((keys >= 40) & (keys < 60), -4.0, 4.0)
        me *= 0.1
        me[:, :, 0] = -8.0
    jargs = [jnp.asarray(a, jnp.bfloat16) for a in args]
    plan = (plan_tile_skip(jargs[3], *mf_tile_bounds(jargs[2], 32), 2)
            if case == "tile_skip" else None)
    want = jax_fused(*jargs, kappa=30.0, block_k=32, block_b=2, interpret=True,
                     tile_plan=plan)
    got = fused_uoms_cross_attention(*[_torch_bf16(a) for a in jargs], kappa=30.0,
                                     tile_skip=case == "tile_skip")
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    if case == "tile_skip":
        assert not np.asarray(plan.occ).all()                  # some tile is skipped
    if case == "guard":
        assert (me[0, 0] @ mf[0] < 0).all()
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=TWIN_TOL, rtol=0)


@pytest.fixture(scope="module")
def surface():
    """(port fp32, port bf16, JAX bf16) outputs of one small MSMFormer on the
    same decisive weights and RGB-D input."""
    jc, _, pc, _ = small_configs()
    variables = jax_msmformer_variables(jc, seed=2)
    head = variables["params"]["predictor"]["mask_embed"]["layers_2"]
    head["kernel"] = head["kernel"] * 30.0
    head["bias"] = head["bias"] * 30.0
    img, xyz = rgbd(np.random.RandomState(0))
    jax16 = JaxMSMFormer(jc, dtype=jnp.bfloat16).apply(variables, jnp.asarray(img),
                                                       jnp.asarray(xyz))
    port_out = []
    for dt in ("float32", "bfloat16"):
        c = copy.deepcopy(pc)
        c.dtype = dt
        model = MSMFormer(c).eval()
        model.load_state_dict(from_jax_variables(variables))
        assert {v.dtype for v in model.state_dict().values()} <= {torch.float32, torch.int64}
        with torch.no_grad():
            port_out.append(model(torch.from_numpy(img), torch.from_numpy(xyz), light=False))
    return port_out + [jax16]


@pytest.mark.parametrize("key", ["pred_logits", "pred_masks"])
def test_model_surface_bf16_within_the_jax_packages_deviation(surface, key):
    p32, p16, j16 = surface
    assert p16[key].dtype == torch.bfloat16
    a, b = p32[key].numpy(), p16[key].float().numpy()
    jb = np.asarray(j16[key], np.float32)
    scale = np.abs(a).max()
    dev, jdev = np.abs(a - b).max() / scale, np.abs(a - jb).max() / scale
    conf = np.abs(a) > 0.1 * scale
    assert dev < SURFACE_TOL
    assert (np.sign(a[conf]) == np.sign(b[conf])).mean() > SIGN_AGREE
    assert dev <= 2 * jdev, f"port bf16 {dev:.3e} of scale from fp32, JAX bf16 {jdev:.3e}"


def test_ucn_embedding_bf16_matches_jax_bf16_segnet():
    rng = np.random.RandomState(0)
    img = rng.rand(1, 64, 64, 3).astype(np.float32) - 0.4
    xyz = (rng.rand(1, 64, 64, 3) * 1.5).astype(np.float32)
    v = jax.tree.map(np.array, JaxSEGNET().init(jax.random.PRNGKey(2), img, xyz))
    _perturb_bn(v["params"], rng)
    _perturb_bn(v["batch_stats"], rng)
    want16 = np.asarray(JaxSEGNET(dtype=jnp.bfloat16).apply(v, img, xyz).astype(jnp.float32))
    got = {}
    for bf16 in (False, True):
        pred = build_ucn_predictor(variables=v, variables_crop=v, device="cpu", bf16=bf16)
        assert pred.cfg.dtype == pred.cfg_crop.dtype == ("bfloat16" if bf16 else "float32")
        with torch.no_grad():
            got[bf16] = pred.network(torch.from_numpy(img), torch.from_numpy(xyz))
    assert got[True].dtype == torch.bfloat16
    got16 = got[True].float().numpy()
    np.testing.assert_allclose(got16, want16, atol=EMBED_TOL, rtol=0)
    got32 = got[False].numpy()
    assert np.abs(got16 - got32).max() <= 2 * np.abs(want16 - got32).max()


def test_factories_build_bf16_from_the_flag_and_from_yaml(tmp_path):
    _, _, pc, pcc = small_configs()
    pred = build_two_stage_predictor(cfg=pc, cfg_crop=pcc, bf16=True, device="cpu")
    for model, cfg in ((pred.model, pred.cfg), (pred.model_crop, pred.cfg_crop)):
        assert cfg.dtype == "bfloat16"
        assert model.sem_seg_head.predictor.dtype == torch.bfloat16
        assert {p.dtype for p in model.parameters()} == {torch.float32}
    assert pc.dtype == "float32"                     # the caller's config is not changed
    img, xyz = rgbd(np.random.RandomState(3))
    labels, refined = pred(torch.from_numpy(img), torch.from_numpy(xyz))
    assert labels.dtype == refined.dtype == torch.int32
    assert labels.shape == refined.shape == (1, 64, 64)
    yaml = tmp_path / "bf16.yaml"
    yaml.write_text("dtype: bfloat16\n")
    cfg = config.load_config(str(yaml), base=copy.deepcopy(pc))
    ucn = build_ucn_predictor(cfg=cfg, device="cpu")
    assert ucn.cfg.dtype == ucn.cfg_crop.dtype == "bfloat16"
    assert ucn.network.fcn.resnet34_8s.fc.compute_dtype == torch.bfloat16


def test_demo_main_runs_in_bf16(tmp_path, capsys, monkeypatch):
    """``cli.demo --bf16`` passes bf16 to the factory (here at the small
    widths) and writes a label image."""
    import cv2

    from unseenobjectswithmeanshift_torch.cli import demo

    _, _, pc, pcc = small_configs()
    built = []

    def small_factory(preset, **kw):
        built.append(build_two_stage_predictor(cfg=copy.deepcopy(pc),
                                               cfg_crop=copy.deepcopy(pcc), **kw))
        return built[-1]

    monkeypatch.setattr(demo, "build_two_stage_predictor", small_factory)

    rng = np.random.RandomState(4)
    cv2.imwrite(str(tmp_path / "000000-color.png"),
                rng.randint(0, 256, size=(32, 32, 3)).astype(np.uint8))
    cv2.imwrite(str(tmp_path / "000000-depth.png"),
                rng.randint(400, 1500, size=(32, 32)).astype(np.uint16))
    demo.main(["--imgdir", str(tmp_path), "--device", "cpu", "--bf16", "--height", "32",
               "--width", "32"])
    assert "done" in capsys.readouterr().out
    assert built[0].cfg.dtype == "bfloat16"
    label = cv2.imread(str(tmp_path / "000000-color-label.png"), cv2.IMREAD_UNCHANGED)
    assert label.shape == (32, 32) and label.dtype == np.uint8
