"""The reference against the program's plain path (float32, the CPU
versions of the kernels) at a small size: the same detections, and the
same scores, boxes and masks to float32 rounding."""

import numpy as np
import pytest
import torch

from benchmark.harness import compare, weights
from benchmark.harness.spec import program_cfg
from benchmark.reference.model import Reference, exact_f32
from benchmark.tests.helpers import TINY_LIMITS, tiny_cfg


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("kind", ["vovnet", "resnet"])
@pytest.mark.parametrize("hw", [(48, 64), (64, 64)])
def test_reference_matches_the_plain_path(kind, hw):
    from centermask2_tpu_torch.data.preprocess import (s2d_pack_u8,
                                                       single_preprocessing)
    from centermask2_tpu_torch.models.meta import build_centermask

    cfg_dict = tiny_cfg(kind)
    cfg = program_cfg({"cfg": cfg_dict})
    dev = torch.device("cpu")
    model = build_centermask(cfg, device=dev)
    w = weights.make(weights.recipe(model), 2 ** 31 + 17, dev)
    model.load_state_dict(w, strict=True)
    img = np.random.default_rng(4).integers(0, 256, (*hw, 3), np.uint8)
    edge = cfg.TPU.FIXED_EDGE_SIZE
    if cfg.TPU.S2D_STEM_INPUT:
        x = torch.from_numpy(s2d_pack_u8(img, edge))
        out = model.inference(x, None, torch.tensor([hw], dtype=torch.int32))
    else:
        out = model.inference(torch.from_numpy(
            single_preprocessing(img, edge)[None]))
    served = {k: v for k, v in out._asdict().items() if v is not None}
    with exact_f32(), torch.no_grad():
        ref = Reference(cfg_dict).load(w)
        own = ref.serve(torch.from_numpy(img), (edge, edge))
        g = compare.gaps(ref, served, torch.from_numpy(img), (edge, edge),
                         TINY_LIMITS)
    assert int(served["valid"].sum()) > 0
    assert torch.equal(served["valid"][0], own["valid"])
    v = own["valid"]
    assert torch.equal(served["pred_classes"][0][v].long(),
                       own["pred_classes"][v].long())
    assert torch.equal(served["locations"][0][v], own["locations"][v])
    assert max(g["score_gap"], g["box_gap"], g["mask_gap"],
               g["mask_score_gap"]) < 1e-4
    assert g["valid_gap"] == 0 and g["overlap"] <= 0.6
    # the same set, every candidate above the ties held to a decision
    assert g["set_gap"] == 0 and g["judged"] > 0


def test_float8_departs():
    """The control computes visibly apart from the float32 reference."""
    cfg_dict = tiny_cfg("vovnet")
    from centermask2_tpu_torch.models.meta import build_centermask

    model = build_centermask(program_cfg({"cfg": cfg_dict}), device="cpu")
    w = weights.make(weights.recipe(model), 9, torch.device("cpu"))
    img = torch.from_numpy(np.random.default_rng(5).integers(
        0, 256, (64, 48, 3), np.uint8))
    with exact_f32(), torch.no_grad():
        ref = Reference(cfg_dict).load(w)
        ref8 = Reference(cfg_dict, "fp8").load(w)
        g = compare.gaps(ref, compare.batch_of_one(ref8.serve(img, (128,
                                                                    128))),
                         img, (128, 128), TINY_LIMITS)
    assert g["score_gap"] > 1e-3 and g["mask_gap"] > 1e-4
