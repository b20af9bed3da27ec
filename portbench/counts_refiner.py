"""Frozen counts of the refiner (``reference/refiner.py``): the operations
(2 per multiply-add) of one forward of an (A, B) pair, a tracking round:
every convolution, the heads' linear layers and the attention products.
Held equal to torch's own count of the reference by the tests."""
from __future__ import annotations

from .reference import refiner

# One forward at 160 x 160: 23.95 GFLOP (encodeA on two images 4.73,
# encodeAB 16.04, the two heads 3.18).
FORWARD_FLOPS_160 = 23_946_035_200


def _out(h: int, k: int, s: int) -> int:
    return (h + 2 * ((k - 1) // 2) - k) // s + 1


def forward_flops(res: int) -> int:
    """Operations of one refiner forward at res x res."""
    total, h = 0, res
    for stage, spec in refiner.STAGES:
        images = 2 if stage == "encodeA" else 1
        for kind, cin, cout, k, s in spec:
            convs = 1 if kind == "cbr" else 2
            h = _out(h, k, s)
            total += images * convs * 2 * cin * k * k * cout * h * h
    tokens, d = h * h, refiner.EMBED
    per_head = 2 * tokens * d * (3 * d + d + d + d + 3) \
        + 2 * 2 * tokens * tokens * d
    return total + 2 * per_head
