"""Holding two training runs of Se3TrackNet against each other: the port
against the JAX package, or the card against the port's CPU path, from the
same weights on the same batches.

Train steps cannot match bit for bit: the convolutions sum in different
orders, and Adam's first steps move each weight by about lr * sign(g), so
an element whose gradient is within rounding noise of 0 steps by +lr on one
side and -lr on the other (ROADMAP F12). The gradients of every step are
compared before Adam, and the trained states after it:

  - the first step's gradients, tensor by tensor, except the conv biases':
    the L2 norm of the difference within ``grad_rtol`` of the tensor's L2
    norm;
  - conv biases: each feeds a train-mode BatchNorm, which removes it, so
    its gradient is 0 in exact arithmetic and rounding noise on both sides:
    the first step's max |gradient| on each side within ``bias_floor`` of
    the max |gradient| of the conv's kernel. After Adam, within 2 lr per
    step;
  - every other parameter tensor: an element is noisy when at some step its
    two gradients lie more than ``NOISE_RTOL`` of the one apart (at the
    first step: its gradient is within rounding noise of 0; later, also
    where the two trajectories have parted). The share of the other
    elements off 2e-5 relative (atol 1e-6) after the steps stays under
    ``off_share``, and the share of noisy elements under ``noisy_share``
    where one is given (else it is reported as a reading, "noisy");
  - BatchNorm running variances within ``var_rtol`` relative; running means
    (near 0) within ``mean_rtol`` relative + ``mean_atol`` + ``mean_lr``
    * lr * steps^2: the noisy elements' +-lr steps enter the batch means of
    the later steps.

Each report maps a bar to (tensors under it, worst value / bar, the tensor
that gave it); a bar holds while the worst ratio is <= 1.

:func:`distances` measures one set of gradients against a float64
reference (``models/tracknet.as_float64``), tensor by tensor.
"""
from __future__ import annotations

import torch
from torch import nn

# The defaults are the bars of the port against the JAX package on the CPU
# (tests/test_torch_train_parity.py).
GRAD_RTOL = 1e-4
BIAS_FLOOR = 1e-5
VAR_RTOL = 1e-5
MEAN_RTOL = 1e-5
MEAN_ATOL = 2e-5
OFF_SHARE = 1e-3
NOISE_RTOL = 1e-2
ELEM_RTOL = 2e-5
ELEM_ATOL = 1e-6


def conv_biases(net: nn.Module) -> dict:
    """{conv bias name: its kernel's name} for every Conv2d of ``net``."""
    return {f"{n}.bias": f"{n}.weight" for n, m in net.named_modules()
            if isinstance(m, nn.Conv2d)}


def grads_of(net: nn.Module) -> dict:
    """Copies of the parameters' gradients on the CPU, by state_dict
    name."""
    return {n: p.grad.detach().to("cpu", copy=True)
            for n, p in net.named_parameters()}


def noisy(grads_a: list, grads_b: list) -> dict:
    """The elements whose gradients lie more than NOISE_RTOL of b's apart
    at some step, from two lists of :func:`grads_of` (one per step)."""
    out: dict = {}
    for ga, gb in zip(grads_a, grads_b):
        for k, a in ga.items():
            b = gb[k].double()
            f = (a.double() - b).abs() > NOISE_RTOL * b.abs()
            out[k] = out[k] | f if k in out else f
    return out


def _worst(report: dict, bar: str, name: str, ratio: float) -> None:
    n, worst, at = report.get(bar, (0, -1.0, ""))
    report[bar] = (n + 1, max(worst, ratio),
                   name if ratio > worst else at)


def compare_grads(net: nn.Module, g_a: dict, g_b: dict,
                  grad_rtol: float = GRAD_RTOL,
                  bias_floor: float = BIAS_FLOOR) -> dict:
    """Report of two sets of first-step gradients under the bars "grad"
    and "conv_bias_grad" (module docstring), over the names of ``g_a``."""
    biases = conv_biases(net)
    g_a = {k: v.detach().double().cpu() for k, v in g_a.items()}
    g_b = {k: v.detach().double().cpu() for k, v in g_b.items()}
    report: dict = {}
    for k, a in g_a.items():
        b = g_b[k]
        if k in biases:
            kernel = max(float(g_a[biases[k]].abs().max()),
                         float(g_b[biases[k]].abs().max()))
            ratio = max(float(a.abs().max()), float(b.abs().max())) \
                / (bias_floor * kernel)
            _worst(report, "conv_bias_grad", k, ratio)
        else:
            ratio = float((a - b).norm()) / (grad_rtol * float(b.norm()))
            _worst(report, "grad", k, ratio)
    return report


def distances(net: nn.Module, g: dict, g_ref: dict) -> dict:
    """{name: ||g - g_ref|| / ||g_ref||} over every parameter but the conv
    biases, whose exact gradient is 0 (module docstring), in float64."""
    biases = conv_biases(net)
    out = {}
    for k, ref in g_ref.items():
        if k in biases:
            continue
        ref = ref.detach().double().cpu()
        out[k] = float((g[k].detach().double().cpu() - ref).norm()
                       / ref.norm())
    return out


def compare_states(net: nn.Module, sd_a: dict, sd_b: dict, noise: dict,
                   lr: float, steps: int, var_rtol: float = VAR_RTOL,
                   mean_rtol: float = MEAN_RTOL, mean_atol: float = MEAN_ATOL,
                   mean_lr: float = 0.0, off_share: float = OFF_SHARE,
                   noisy_share: float | None = None) -> dict:
    """Report of two state_dicts after ``steps`` steps under the bars
    "bn_var", "bn_mean", "conv_bias", "param_off_share" and "noisy_share"
    (module docstring); ``noise`` from :func:`noisy` over those steps."""
    biases = conv_biases(net)
    report: dict = {}
    for k, b in sd_b.items():
        if k.endswith("num_batches_tracked"):
            continue
        a = sd_a[k].double().cpu()
        b = b.double().cpu()
        d = (a - b).abs()
        if k.endswith("running_var"):
            _worst(report, "bn_var", k, float((d / (var_rtol * b.abs())).max()))
        elif k.endswith("running_mean"):
            tol = mean_atol + mean_rtol * b.abs() + mean_lr * lr * steps ** 2
            _worst(report, "bn_mean", k, float((d / tol).max()))
        elif k in biases:
            _worst(report, "conv_bias", k,
                   float((d / (ELEM_ATOL + 2 * lr * steps)).max()))
        else:
            f = noise[k]
            off = (d > ELEM_ATOL + ELEM_RTOL * b.abs()) & ~f
            _worst(report, "param_off_share", k,
                   float(off.double().mean()) / off_share)
            share = float(f.double().mean())
            if noisy_share is None:
                _worst(report, "noisy", k, share)
            else:
                _worst(report, "noisy_share", k, share / noisy_share)
    return report


def failed(*reports: dict) -> list:
    """The bars of ``reports`` whose worst ratio exceeds 1."""
    return [(bar, v) for r in reports for bar, v in r.items()
            if bar != "noisy" and v[1] > 1.0]
