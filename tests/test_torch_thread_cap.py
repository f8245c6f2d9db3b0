"""Every port test file caps torch at two intra-op threads and removes its
temporary directories when it ends.

Tier-1 runs six pytest workers on one machine's cores; an uncapped file
spins one torch thread per core beside them (tests/torch_threads.py). Each
tests/test_torch_*.py must import ``few_torch_threads`` at module level, from
``torch_threads`` or from ``torch_train_cases`` (which re-exports it), and
``module_tmp_cleanup`` from ``torch_threads``, so that both autouse fixtures
apply to its tests.
"""

import ast
from pathlib import Path

import pytest
import torch

import torch_threads
import torch_train_cases
from torch_threads import (  # noqa: F401
    TORCH_TEST_THREADS, capped_env, few_torch_threads, module_tmp_cleanup,
)

TESTS = Path(__file__).resolve().parent
SOURCES = ("torch_threads", "torch_train_cases")


def imports_fixture(path: Path, name: str, sources=SOURCES) -> bool:
    """True when the module body imports ``name`` from one of ``sources``."""
    tree = ast.parse(path.read_text(), str(path))
    return any(isinstance(node, ast.ImportFrom) and node.module in sources
               and any(a.name == name and a.asname is None for a in node.names)
               for node in tree.body)


def imports_cap(path: Path) -> bool:
    return imports_fixture(path, "few_torch_threads")


def imports_cleanup(path: Path) -> bool:
    return imports_fixture(path, "module_tmp_cleanup", ("torch_threads",))


PORT_FILES = sorted(TESTS.glob("test_torch_*.py"))


def test_port_test_files_are_found():
    assert len(PORT_FILES) >= 47 and Path(__file__) in PORT_FILES


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_port_test_file_caps_torch_threads(path):
    assert imports_cap(path), (f"{path.name} does not import few_torch_threads from "
                               f"torch_threads at module level")
    assert imports_cleanup(path), (f"{path.name} does not import module_tmp_cleanup from "
                                   f"torch_threads at module level")


def test_cap_check_refuses_an_uncapped_file(tmp_path):
    bad = tmp_path / "test_torch_bad.py"
    bad.write_text("import torch\n\ndef test_x():\n    from torch_threads import "
                   "few_torch_threads\n")
    renamed = tmp_path / "test_torch_renamed.py"
    renamed.write_text("from torch_threads import few_torch_threads as f  # noqa\n")
    good = tmp_path / "test_torch_good.py"
    good.write_text("from torch_threads import few_torch_threads, module_tmp_cleanup  # noqa\n")
    assert not imports_cap(bad) and not imports_cap(renamed) and imports_cap(good)
    assert not imports_cleanup(bad) and imports_cleanup(good)


def test_fixture_caps_this_module_and_is_the_shared_one():
    assert torch.get_num_threads() <= TORCH_TEST_THREADS
    assert torch_train_cases.few_torch_threads is torch_threads.few_torch_threads


def test_capped_env_for_subprocesses():
    env = capped_env({"PATH": "/bin", "OMP_NUM_THREADS": "64"})
    assert env["OMP_NUM_THREADS"] == env["MKL_NUM_THREADS"] == str(TORCH_TEST_THREADS)
    assert env["PATH"] == "/bin"


def test_fixture_removes_the_modules_temporary_directories(tmp_path_factory):
    """module_tmp_cleanup's teardown removes what appeared under the base
    temporary directory during its module, and nothing that was there."""
    base = tmp_path_factory.getbasetemp()
    kept = tmp_path_factory.mktemp("kept")
    gen = module_tmp_cleanup.__wrapped__(tmp_path_factory)
    next(gen)
    made = tmp_path_factory.mktemp("made")
    (made / "checkpoint.pth").write_bytes(b"x" * 1024)
    with pytest.raises(StopIteration):
        next(gen)
    assert kept.exists() and not made.exists() and base.exists()
