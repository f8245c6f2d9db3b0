"""Two module-scoped autouse fixtures for every port test file
(tests/test_torch_*.py): ``few_torch_threads`` caps torch at two intra-op
threads, and ``module_tmp_cleanup`` removes the file's temporary
directories when its tests end.

Tier-1 runs six pytest workers on the same cores. Torch's default of one
spinning intra-op thread per core made six concurrent runs of
tests/test_torch_decoder.py take ~106 s each on an 8-core CPU, against
~19 s with two threads. Each port test file imports both fixtures at module
level::

    from torch_threads import few_torch_threads, module_tmp_cleanup  # noqa: F401

and ``tests/test_torch_thread_cap.py`` fails for a file that does not. Subprocesses a test starts take ``capped_env()``.

The port's training tests write full-width checkpoints (the ResNet34-8s
towers with their optimizer state, 0.2-0.6 GB each) under ``tmp_path``: one
Tier-1 run left 6.2 GB there, and pytest keeps the last three runs. So
``module_tmp_cleanup`` removes, when its module ends, what the module's tests
and fixtures made under the worker's base temporary directory (modules run
one at a time in a worker): a temporary path does not outlive its module.
"""

import os
import shutil

import pytest
import torch

TORCH_TEST_THREADS = 2


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """Cap torch at TORCH_TEST_THREADS intra-op threads for the module and
    restore the count after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, TORCH_TEST_THREADS))
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", autouse=True)
def module_tmp_cleanup(tmp_path_factory):
    """Remove, when the module ends, the temporary directories its tests and
    fixtures made under the worker's base temporary directory."""
    base = tmp_path_factory.getbasetemp()
    before = set(base.iterdir())
    yield
    for path in set(base.iterdir()) - before:
        shutil.rmtree(path, ignore_errors=True)


def capped_env(env=None) -> dict:
    """A copy of ``env`` (default os.environ) whose OpenMP and MKL thread
    counts are TORCH_TEST_THREADS, for a subprocess that runs torch."""
    env = dict(os.environ if env is None else env)
    env["OMP_NUM_THREADS"] = env["MKL_NUM_THREADS"] = str(TORCH_TEST_THREADS)
    return env
