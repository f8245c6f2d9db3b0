"""The port and chip_smoke.py import neither JAX nor the JAX package, nor
cv2 or PyYAML (the card machine has neither: the port imports them inside
the functions that read images and YAML files).

Runs in a subprocess, because tests/conftest.py imports jax into the pytest
process. Also checks that chip_smoke.py refuses to run without CUDA.
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
    assert result["bad"] == []


def test_port_and_chip_smoke_import_no_cv2_or_yaml():
    result = _probe()
    assert {"unseenobjectswithmeanshift_torch.cli.demo",
            "unseenobjectswithmeanshift_torch.config",
            "unseenobjectswithmeanshift_torch.utils.preprocess"} <= set(result["modules"])
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
