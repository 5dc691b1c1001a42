"""A run with the timed path broken underneath comes out not correct:
the program's answers altered where they are produced, one fault at a
time (the serving cells have no batch to halve, no state to leave
unchanged and no exchange between chips), and the program's decode
picking the wrong detections (``tools/faults.py``). And the control,
the reference in float8 put in the program's place, fails the tiny
cell's limits as it fails the full cells' on the card."""

import sys

import pytest
import torch

from benchmark.tests.helpers import BENCH, checkout, run

sys.path.insert(0, str(BENCH / "tools"))
from faults import CAUGHT, FAULTS as DECODE_FAULTS  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _first(t: torch.Tensor, f) -> torch.Tensor:
    """``t`` with the first slot of every image replaced by f(slot)."""
    t = t.clone()
    t[:, 0] = f(t[:, 0])
    return t


FAULTS = {
    "score": lambda o: o._replace(scores=_first(o.scores, lambda s: s * 0.9)),
    "box": lambda o: o._replace(pred_boxes=_first(o.pred_boxes,
                                                  lambda b: b + 4.0)),
    "class": lambda o: o._replace(pred_classes=_first(
        o.pred_classes, lambda c: (c + 1) % 80)),
    "mask": lambda o: o._replace(pred_masks=_first(o.pred_masks,
                                                   lambda m: 1.0 - m)),
    "mask_score": lambda o: o._replace(mask_scores=_first(
        o.mask_scores, lambda s: s + 0.05)),
    "dropped": lambda o: o._replace(scores=_first(o.scores, lambda s: 0 * s),
                                    valid=_first(o.valid, lambda v: v & 0)),
    "location": lambda o: o._replace(locations=_first(o.locations,
                                                      lambda x: x + 1.0)),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_altered_answer_is_not_correct(tmp_path, fault, capsys):
    def program(model):
        def call(*args):
            return FAULTS[fault](model.inference(*args))
        return call

    res = run(checkout(tmp_path), "tiny.open", capsys, program=program)
    assert res["correct"] is False
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


@pytest.mark.parametrize("fault", CAUGHT)
def test_wrong_detections_are_not_correct(tmp_path, fault, capsys):
    """Boxes of the reference's set that the program does not serve: only
    ``set_gap`` can see them, as every other number is read at the
    program's own picks."""
    def program(model):
        return DECODE_FAULTS[fault](model, lambda m: m.inference)

    res = run(checkout(tmp_path), "tiny.open", capsys, program=program)
    assert res["correct"] is False
    assert res["checks"]["set_gap"]["value"] > 0


@pytest.mark.parametrize("served,gap", [([0, 1, 2], 0.0), ([0, 2, 3], 1.0),
                                        ([1, 2, 3], 1.0)])
def test_set_gap_counts_what_the_ties_do_not_explain(served, gap):
    """Six candidates of one class, scores 0.9 to 0.4 far apart, the
    second overlapping the first at an IoU of 1/3, and a top-3: the
    reference keeps 0, 1, 2. NMS at 0.3 serves 0, 2, 3 and a top-k
    that drops the first serves 1, 2, 3; each leaves one candidate
    unexplained."""
    from types import SimpleNamespace

    from benchmark.harness import compare

    s = torch.tensor([0.9, 0.8, 0.7, 0.6, 0.5, 0.4])
    boxes = torch.tensor([[0, 0, 10, 10], [5, 0, 15, 10]] + [
        [100 * i, 100, 100 * i + 10, 110] for i in range(1, 5)]).float()
    d = SimpleNamespace(masked=(s * s)[:, None], boxes=boxes,
                        strides=torch.full((6,), 8.0))
    ref = SimpleNamespace(
        nms_thresh=0.6, classes=1, candidates_k=10, topk=3,
        candidates=lambda d: {"loc": torch.arange(6),
                              "cls": torch.zeros(6, dtype=torch.long),
                              "scores": s, "valid": s > 0})
    limits = {"score_gap": 0.01, "box_gap": 0.01, "overlap": 0.61}
    idx = torch.tensor(served)
    got, judged = compare.set_gap(ref, d, idx, torch.zeros(3).long(), s[idx],
                                  boxes[idx], limits)
    assert (got, judged) == (gap, 3.0 if served[-1] == 3 else 2.0)


def test_control_is_not_correct(tmp_path, capsys):
    """The reference computed in float8 e4m3, put in the program's place:
    it serves the image that the program's uint8 pack holds."""
    import json

    from benchmark.harness import compare
    from benchmark.reference.model import Reference

    root = checkout(tmp_path)
    cfg = json.loads((root / "benchmark/configs/tiny-vovnet.json")
                     .read_text())["cfg"]

    def program(model):
        ref8 = Reference(cfg, "fp8").load(model.state_dict())

        def call(x, sizes, vh, canvas):
            out = ref8.serve(unpack(x, vh), canvas or model.canvas_hw(x))
            return model.inference(x, sizes, vh, canvas)._replace(
                **compare.batch_of_one(out))
        return call

    assert run(root, "tiny.open", capsys, program=program)["correct"] is False


def unpack(x: torch.Tensor, vh: torch.Tensor) -> torch.Tensor:
    """The resized uint8 HWC image of a uint8 s2d pack: channel
    rho*12 + kap*3 + c of cell (i, j) holds pixel (4i + rho - 2,
    4j + kap - 2)."""
    _, Ho, Wo, _ = x.shape
    canvas = x.reshape(Ho, Wo, 4, 4, 3).permute(0, 2, 1, 3, 4).reshape(
        Ho * 4, Wo * 4, 3)[2:, 2:]
    h, w = (int(v) for v in vh[0])
    return canvas[:h, :w]
