"""Export a committed release checkpoint as one numpy ``.npz``.

    python scripts/export_release_npz.py msmformer_synthetic_r5 _chip_tmp/r5.npz [--scene]

Restores ``checkpoints/<release>`` (orbax/OCDBT; ``msmformer_synthetic_r5``
or ``_r5_crop``, layout ``{params, batch_stats, step}``, or
``ucn_synthetic_r5``, the SEGNET's ``{params, batch_stats}``) into a template
made by the JAX package, as ``bench.py``'s ``_load`` and
``scripts/export_checkpoint.load_release`` do, and writes
``{params, batch_stats}`` to the path given, each leaf under its path joined
by ``weights.NPZ_SEP``. The PyTorch port reads it back with numpy alone
(``unseenobjectswithmeanshift_torch.weights.load_npz_variables``), where no
JAX, orbax or tensorstore is installed. The output must not be a tracked
path: write it under a directory that .gitignore lists.

--scene also stores one held-out scene (480x640, OCID statistics, rendered by
the numpy oracle ``data/synthetic.py``) as ``scene/image`` and ``scene/xyz``
([1, 480, 640, 3], the network's normalized BGR and camera XYZ), which
``chip_smoke.py --weights`` runs the trained weights on.
"""

import argparse
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402

from unseenobjectswithmeanshift_torch.weights import NPZ_SEP  # noqa: E402

RELEASES = ("msmformer_synthetic_r5", "msmformer_synthetic_r5_crop", "ucn_synthetic_r5")


def release_variables(release: str) -> dict:
    """{params, batch_stats} of checkpoints/<release> as a numpy tree."""
    import jax
    import jax.numpy as jnp

    from unseenobjectswithmeanshift_tpu.utils import checkpoint_io

    path = os.path.join(REPO, "checkpoints", release)
    if not os.path.isdir(path):
        raise FileNotFoundError(f"no release at {path}")
    zeros = jnp.zeros((1, 64, 64, 3), jnp.float32)
    if release.startswith("ucn"):
        from unseenobjectswithmeanshift_tpu.config import get_config
        from unseenobjectswithmeanshift_tpu.pipeline.ucn import UCNPredictor

        cfg = get_config("tabletop_pretrained")
        net = UCNPredictor(cfg, get_config("crop_tabletop_pretrained")).network
        template = jax.device_get(net.init(jax.random.PRNGKey(0), zeros, zeros))
    else:
        from unseenobjectswithmeanshift_tpu.config import get_config
        from unseenobjectswithmeanshift_tpu.train.trainer import Trainer

        state = Trainer(get_config("tabletop_pretrained")).init_state(
            jax.random.PRNGKey(0), (64, 64), batch_size=1)
        template = {"params": jax.device_get(state.params),
                    "batch_stats": jax.device_get(state.batch_stats),
                    "step": jax.device_get(state.step)}
    rel = checkpoint_io.restore(path, template)
    return jax.tree.map(np.asarray, {"params": rel["params"],
                                     "batch_stats": rel["batch_stats"]})


def held_out_scene(index: int = 0, height: int = 480, width: int = 640) -> dict:
    """One rendered test-stream scene, without augmentation or noise."""
    from unseenobjectswithmeanshift_tpu.data.synthetic import SyntheticTabletopDataset

    ds = SyntheticTabletopDataset(image_set="test", height=height, width=width,
                                  use_augmentation=False, chromatic=False, add_noise=False,
                                  scene_style="ocid")
    sample = ds[index]
    return {"image": sample["image"][None].astype(np.float32),
            "xyz": sample["xyz"][None].astype(np.float32),
            "label": sample["label"][None]}


def flatten(tree, prefix=""):
    for key, value in tree.items():
        name = f"{prefix}{NPZ_SEP}{key}" if prefix else str(key)
        if isinstance(value, dict):
            yield from flatten(value, name)
        else:
            yield name, np.asarray(value)


def tracked(path: str) -> bool:
    """git knows the path, or would add it (not ignored)."""
    rel = os.path.relpath(os.path.abspath(path), REPO)
    if rel.startswith(".."):
        return False
    out = subprocess.run(["git", "check-ignore", "-q", rel], cwd=REPO)
    return out.returncode != 0


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("release", choices=RELEASES)
    p.add_argument("out", help="the .npz to write (not a tracked path)")
    p.add_argument("--scene", action="store_true",
                   help="also store one held-out rendered scene (see above)")
    args = p.parse_args(argv)
    if tracked(args.out):
        sys.exit(f"{args.out} is a path git would track; write under a gitignored directory")
    tree = release_variables(args.release)
    if args.scene:
        tree["scene"] = held_out_scene()
    leaves = dict(flatten(tree))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez(args.out, **leaves)
    n = sum(v.size for v in leaves.values())
    print(f"wrote {args.out}: {len(leaves)} arrays, {n / 1e6:.1f}M values, "
          f"{os.path.getsize(args.out) / 2**20:.1f} MiB")


if __name__ == "__main__":
    main()
