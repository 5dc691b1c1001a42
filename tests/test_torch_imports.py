"""The port stands alone: ``centermask2_tpu_torch`` and ``chip_smoke.py``
import nothing of JAX, flax or the JAX package, and the smoke script's
Python config is the flagship yaml config.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "centermask2_tpu_torch").rglob("*.py")) + \
    [REPO / "chip_smoke.py"]
BANNED = ("jax", "jaxlib", "flax", "centermask2_tpu")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(REPO)) for p in PORT_FILES])
def test_no_jax_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(BANNED))
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


BLOCKER = """
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {banned!r}:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import pkgutil, importlib
import centermask2_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
import chip_smoke
print("imported", len(sys.modules))
"""


def test_imports_with_jax_blocked():
    res = subprocess.run(
        [sys.executable, "-c", BLOCKER.format(banned=set(BANNED))],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(REPO)})
    assert res.returncode == 0, res.stderr
    assert "imported" in res.stdout


def test_imports_with_jax_pil_and_cv2_blocked():
    """The card's machine may have no PIL or cv2: no port module and not
    chip_smoke imports either when it is imported."""
    banned = set(BANNED) | {"PIL", "cv2"}
    res = subprocess.run(
        [sys.executable, "-c", BLOCKER.format(banned=banned)],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(REPO)})
    assert res.returncode == 0, res.stderr
    assert "imported" in res.stdout


@pytest.mark.parametrize("yaml_name,build", [
    ("zy_model_config.yaml", "flagship_cfg"),
    ("zy_model_serving.yaml", "serving_cfg")])
def test_chip_smoke_config_is_the_flagship_yaml(yaml_name, build):
    import chip_smoke
    from centermask2_tpu_torch.config import get_cfg

    want = get_cfg()
    want.merge_from_file(str(REPO / "configs/centermask" / yaml_name))
    got = getattr(chip_smoke, build)()
    assert got == want
    assert got.MODEL.VOVNET.CONV_BODY == "V-39-eSE"
    assert got.TPU.COMPUTE_DTYPE == "bfloat16"
    assert got.TPU.S2D_STEM_INPUT == (build == "serving_cfg")


def test_chip_smoke_fails_without_a_gpu():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the smoke run would start")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
