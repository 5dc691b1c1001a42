"""Config parity: the port's ``get_cfg()`` merged with each shipped yaml
equals the JAX package's, key by key (values compared with ``==``, so a
yaml ``""`` must become ``None`` in both)."""

from pathlib import Path

import pytest

from centermask2_tpu.config import get_cfg as jax_get_cfg
from centermask2_tpu_torch.config import get_cfg

REPO = Path(__file__).resolve().parent.parent
YAMLS = sorted((REPO / "configs" / "centermask").glob("*.yaml"))


def _flat(node, prefix=""):
    out = {}
    for k, v in node.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("path", YAMLS, ids=[p.name for p in YAMLS])
def test_merge_equals_jax(path):
    want, got = jax_get_cfg(), get_cfg()
    want.merge_from_file(str(path))
    got.merge_from_file(str(path))
    fw, fg = _flat(want), _flat(got)
    assert sorted(fg) == sorted(fw)
    diff = {k: (fg[k], fw[k]) for k in fw
            if fg[k] != fw[k] or type(fg[k]) is not type(fw[k])}
    assert not diff, diff


@pytest.mark.parametrize("blank", ["", "  "])
def test_blank_string_decodes_like_jax(blank):
    want, got = jax_get_cfg(), get_cfg()
    want.merge_from_list(["MODEL.WEIGHTS", blank])
    got.merge_from_list(["MODEL.WEIGHTS", blank])
    assert got.MODEL.WEIGHTS is None and want.MODEL.WEIGHTS is None
