"""The generator of serving traffic: a traffic file's parameters and a
seed in, the requests of a run out.

A traffic file (``benchmark/traffic/<name>.json``) of the serving runner
(``runner``: ``serve``, ``benchmark/runners/serve.py``) holds:

- ``arrivals``: ``{"kind": "poisson", "rate_per_s": r, "order": k}``
  (independent clients, an open loop) or ``{"kind": "closed",
  "in_flight": n}`` (a client that keeps n requests outstanding);
- ``canvas``: ``pad_to_deploy`` (the program runs at the configuration's
  TPU.FIXED_EDGE_SIZE square) or ``tight_compute`` (at the quantized
  tight canvas of each image, ``s2d_serving_canvas``);
- ``sizes``: ``short`` and ``max`` of the resize (INPUT.MIN_SIZE_TEST,
  INPUT.MAX_SIZE_TEST) and ``sources``: ``[[height, width, share], ...]``
  of the original images;
- ``variants``: distinct noise images made for each size;
- ``sample``: requests compared with the reference after the window;
- ``assumed``: the basis of what the file assumes (not read).

Every seed gets the same work: a fixed count of each size (largest
remainders of the shares), in the seed's order, and in an open loop one
schedule of arrivals: the quantiles of the exponential distribution at
the stated rate, scaled to fill the window exactly, in the order that
the traffic file's ``order`` key draws, the same for every seed. At
four fifths of the knee the 95th percentile is set by a few bursts; an
order drawn by the run's seed moved it by a fifth between seeds (99, 88
and 113 ms in three 51 s windows, V-39 at 64/s), so the bursts are part
of the mix and the seed draws the images, their order and the weights.
The image content is uint8 noise from the seed; it sets no work in a
program of fixed shapes.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np

ARRIVALS = ("poisson", "closed")
CANVASES = ("pad_to_deploy", "tight_compute")
CYCLE = 4096  # a closed loop's sizes repeat after this many requests


class Request(NamedTuple):
    index: int
    due_s: Optional[float]  # seconds after the window opens; None: closed
    hw: Tuple[int, int]  # resized (h, w)
    variant: int


def resize_shape(h: int, w: int, short: int, max_size: int
                 ) -> Tuple[int, int]:
    """detectron2 ResizeShortestEdge's output shape (the port's
    ``data/preprocess.py::compute_resize_shape``)."""
    scale = short * 1.0 / min(h, w)
    newh, neww = (short, scale * w) if h < w else (scale * h, short)
    if max(newh, neww) > max_size:
        scale = max_size * 1.0 / max(newh, neww)
        newh, neww = newh * scale, neww * scale
    return int(newh + 0.5), int(neww + 0.5)


def check(traffic: Dict) -> None:
    if traffic["arrivals"]["kind"] not in ARRIVALS:
        raise ValueError(f"arrivals {traffic['arrivals']['kind']!r}: one "
                         f"of {ARRIVALS}")
    if traffic["canvas"] not in CANVASES:
        raise ValueError(f"canvas {traffic['canvas']!r}: one of {CANVASES}")


def counts(shares: List[float], n: int) -> List[int]:
    """n split by ``shares`` with the largest remainders."""
    total = float(sum(shares))
    exact = [s / total * n for s in shares]
    out = [int(math.floor(e)) for e in exact]
    order = sorted(range(len(shares)), key=lambda i: out[i] - exact[i])
    for i in order[:n - sum(out)]:
        out[i] += 1
    return out


def resized_sizes(traffic: Dict) -> List[Tuple[int, int]]:
    sz = traffic["sizes"]
    return [resize_shape(int(h), int(w), sz["short"], sz["max"])
            for h, w, _ in sz["sources"]]


def gaps(n: int, seconds: float, rng: np.random.Generator) -> np.ndarray:
    """n gaps between arrivals: exponential quantiles, summing to
    ``seconds``, in the order ``rng`` draws."""
    q = -np.log1p(-(np.arange(n) + 0.5) / n)
    return rng.permutation(q * (seconds / q.sum()))


def schedule(traffic: Dict, seed: int, seconds: float) -> List[Request]:
    """The requests of one run, in the order they are sent."""
    check(traffic)
    rng = np.random.default_rng(seed)
    arr = traffic["arrivals"]
    sizes = resized_sizes(traffic)
    shares = [s for _, _, s in traffic["sizes"]["sources"]]
    if arr["kind"] == "closed":
        n = CYCLE
    else:
        n = max(1, int(round(arr["rate_per_s"] * seconds)))
    kinds = np.repeat(np.arange(len(sizes)), counts(shares, n))
    kinds = rng.permutation(kinds)
    variants = rng.integers(0, int(traffic["variants"]), n)
    if arr["kind"] == "closed":
        due = [None] * n
    else:
        due = np.cumsum(gaps(n, seconds, np.random.default_rng(
            int(arr["order"]))))
        due = list(due - due[0])
    return [Request(i, None if due[i] is None else float(due[i]),
                    sizes[int(kinds[i])], int(variants[i]))
            for i in range(n)]


def images(traffic: Dict, seed: int) -> Dict[Tuple[Tuple[int, int], int],
                                             np.ndarray]:
    """{(resized (h, w), variant): HWC uint8 BGR noise} for every size
    and variant the traffic can send, from the seed."""
    rng = np.random.default_rng([seed, 1])
    out = {}
    for hw in sorted(set(resized_sizes(traffic))):
        for v in range(int(traffic["variants"])):
            out[(hw, v)] = rng.integers(0, 256, (*hw, 3), dtype=np.uint8)
    return out
