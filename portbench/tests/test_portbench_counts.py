"""The frozen counts and the trace's busy-time arithmetic."""
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import counts, trace
from portbench.reference import cnn


def _zero_weights():
    p = {k: torch.zeros(s) for k, s in cnn.param_shapes().items()}
    b = {}
    for n in cnn.bn_names():
        c = p[f"{n}.weight"].shape[0]
        b[f"{n}.running_mean"] = torch.zeros(c)
        b[f"{n}.running_var"] = torch.ones(c)
    return p, b


def test_forward_flops_frozen_at_176():
    """The frozen count, the count from the layer shapes, and torch's own
    count of the convolutions and linear layers agree: 5.53 GFLOP."""
    p, b = _zero_weights()
    x = torch.zeros(1, 176, 176, 4)
    with FlopCounterMode(display=False) as fc:
        cnn.forward(p, b, x, x)
    assert counts.forward_flops(176) == counts.FORWARD_FLOPS_176
    assert fc.get_total_flops() == counts.FORWARD_FLOPS_176
    assert round(counts.FORWARD_FLOPS_176 / 1e9, 2) == 5.53


def test_parameter_count():
    n = sum(torch.Size(s).numel() for s in cnn.param_shapes().values())
    assert n == 13_533_446


class _Event:
    def __init__(self, name, dev, s, e):
        self._n, self._d, self._s, self._e = name, dev, s, e

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e


class _Prof:
    def __init__(self, events):
        self.profiler = type("P", (), {})()
        self.profiler.kineto_results = type("K", (), {
            "events": lambda _self: events})()


def test_busy_union_counts_overlap_once():
    C, D = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    ev = [_Event(trace.WINDOW_SPAN, C, 0, 1_000_000),
          _Event("aten::item", C, 600_000, 900_000),
          _Event("k_a", D, 100_000, 400_000),
          _Event("k_b", D, 200_000, 500_000),      # overlaps k_a
          _Event("Memcpy DtoH", D, 450_000, 550_000),
          _Event("k_c", D, 950_000, 1_200_000)]    # runs past the window
    s = trace.summarize(_Prof(ev))
    assert s["window_s"] == 1e-3
    # [100, 550] and [950, 1000] us: 500 us, not the 800 us of the sum
    assert abs(s["busy_s"] - 500e-6) < 1e-12
    assert dict(s["idle_gaps"])["aten::item"] == 400e-6
    assert trace.merge([(5, 9), (1, 3), (2, 4)]) == [[1, 4], [5, 9]]
    sec, n = trace.seconds_of(s, None, exclude=(trace.CNN_KERNEL,))
    assert n == 4 and abs(sec - 0.00075) < 1e-12


def test_bounds_are_positive_and_bytes_bound():
    res = (176, 176)
    win = torch.full((176 * 176,), -1)
    win[:1000] = torch.arange(1000) % 50
    assert counts.pass2_bound_s(win, res) > 0
    assert counts.bound_s(3.35e9, 1.0) == 1e-3
