"""Se3TrackNet (Wen et al., IROS 2020, arXiv:2007.13866; the network of
wenbowen123/iros20-6d-pose-tracking ``se3_tracknet.py``) as plain functions
of a parameter dict, NHWC in and out.

  ConvBNSELU(cin, cout, k, s): conv (bias, pad (k-1)//2) + BatchNorm + SELU
  ResBlock(c): relu(bn(conv3x3)) -> bn(conv3x3) + x -> relu
  A: ConvBNSELU(4, 64, 7, 2), maxpool 3/2/1, ResBlock(64)
  B: ConvBNSELU(4, 64, 7, 2), maxpool 3/2/1, ResBlock(64) x 2
  trunk: concat -> ConvBNSELU(128, 256, 3, 2), ResBlock(256)
  heads (trans, rot): ConvBNSELU(256, 512, 3, 2), ResBlock(512), spatial
    mean, Linear(512, 3), tanh

Parameter names are the reference checkpoint's state_dict keys.
``precision`` is the arithmetic of every convolution and linear layer:
"float32" (TF32 off), "tf32" (TF32 on: the card's tensor-core format; on
the CPU its operand rounding is emulated) or "fp8" (operands quantised to
float8 e4m3 with one scale per tensor, accumulated in float32).
"""
from __future__ import annotations

import torch
from torch.nn import functional as F

BN_EPS = 1e-5

# (name, kind, cin, cout, kernel, stride)
LAYERS = (
    ("convA1", "cbs", 4, 64, 7, 2),
    ("convA2", "res", 64, 64, 3, 1),
    ("convB1", "cbs", 4, 64, 7, 2),
    ("convB2", "res", 64, 64, 3, 1),
    ("convB3", "res", 64, 64, 3, 1),
    ("convAB1", "cbs", 128, 256, 3, 2),
    ("convAB2", "res", 256, 256, 3, 1),
    ("trans_conv1", "cbs", 256, 512, 3, 2),
    ("trans_conv2", "res", 512, 512, 3, 1),
    ("rot_conv1", "cbs", 256, 512, 3, 2),
    ("rot_conv2", "res", 512, 512, 3, 1),
)
HEADS = (("trans_out.0", 512, 3), ("rot_out.0", 512, 3))


def _convs(name, kind):
    """(conv prefix, bn prefix) pairs of one layer."""
    if kind == "cbs":
        return [(f"{name}.0", f"{name}.1")]
    return [(f"{name}.conv1", f"{name}.bn1"), (f"{name}.conv2", f"{name}.bn2")]


def param_shapes() -> dict:
    """Trainable parameters, name -> shape, in the module's order."""
    out = {}
    for name, kind, cin, cout, k, _ in LAYERS:
        for i, (conv, bn) in enumerate(_convs(name, kind)):
            c_in = cin if i == 0 else cout
            out[f"{conv}.weight"] = (cout, c_in, k, k)
            out[f"{conv}.bias"] = (cout,)
            out[f"{bn}.weight"] = (cout,)
            out[f"{bn}.bias"] = (cout,)
    for name, cin, cout in HEADS:
        out[f"{name}.weight"] = (cout, cin)
        out[f"{name}.bias"] = (cout,)
    return _module_order(out)


def _module_order(shapes: dict) -> dict:
    """The module registration order of the network (layers, then each
    head's Linear after its head's convolutions)."""
    order = []
    for name, kind, *_ in LAYERS:
        order += [k for k in shapes if k.startswith(name + ".")]
        if name == "trans_conv2":
            order += [k for k in shapes if k.startswith("trans_out.")]
        if name == "rot_conv2":
            order += [k for k in shapes if k.startswith("rot_out.")]
    return {k: shapes[k] for k in order}


def bn_names() -> list:
    """BatchNorm prefixes, in order."""
    return [bn for name, kind, *_ in LAYERS for _, bn in _convs(name, kind)]


def fan_in(shape) -> int:
    n = 1
    for s in shape[1:]:
        n *= s
    return n


# --- arithmetic of the convolutions and linear layers ----------------------

def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits, to nearest."""
    b = x.contiguous().view(torch.int32)
    b = (b + 0x1000) & ~0x1FFF
    return b.view(torch.float32)


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """float32 through float8 e4m3 with one scale for the tensor."""
    amax = x.detach().abs().amax().clamp(min=1e-12)
    scale = 448.0 / amax
    return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


def _through(x, rounding):
    return x + (rounding(x.detach()) - x.detach())


class Arith:
    """Where the precision of the convolutions and linear layers is set."""

    def __init__(self, precision: str = "float32"):
        if precision not in ("float32", "tf32", "fp8"):
            raise ValueError(f"precision {precision!r}")
        self.precision = precision

    def operands(self, x, w):
        """The operands as the layer's arithmetic sees them; the rounding
        passes gradients straight through, as the hardware's does."""
        if self.precision == "fp8":
            return _through(x, _fp8), _through(w, _fp8)
        if self.precision == "tf32" and x.device.type != "cuda":
            return _through(x, _round_tf32), _through(w, _round_tf32)
        return x, w

    def __enter__(self):
        self._saved = (torch.backends.cuda.matmul.allow_tf32,
                       torch.backends.cudnn.allow_tf32)
        on = self.precision == "tf32"
        torch.backends.cuda.matmul.allow_tf32 = on
        torch.backends.cudnn.allow_tf32 = on
        return self

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self._saved


def matmul(a, b, precision: str = "float32"):
    """a @ b in the precision's arithmetic: under :class:`Arith` on the
    card the flags decide; on the CPU TF32's operand rounding is
    emulated."""
    if precision == "tf32" and a.device.type != "cuda":
        a, b = _round_tf32(a), _round_tf32(b)
    return a @ b


def _conv(ar, x, p, prefix, stride, k):
    xw, w = ar.operands(x, p[f"{prefix}.weight"])
    return F.conv2d(xw, w, p[f"{prefix}.bias"], stride, (k - 1) // 2)


def _bn(x, p, b, prefix, train):
    if train:
        return F.batch_norm(x, None, None, p[f"{prefix}.weight"],
                            p[f"{prefix}.bias"], True, 0.0, BN_EPS)
    return F.batch_norm(x, b[f"{prefix}.running_mean"],
                        b[f"{prefix}.running_var"], p[f"{prefix}.weight"],
                        p[f"{prefix}.bias"], False, 0.0, BN_EPS)


def _layer(ar, x, p, b, name, kind, k, stride, train):
    if kind == "cbs":
        conv, bn = _convs(name, kind)[0]
        return F.selu(_bn(_conv(ar, x, p, conv, stride, k), p, b, bn, train))
    (c1, b1), (c2, b2) = _convs(name, kind)
    y = torch.relu(_bn(_conv(ar, x, p, c1, 1, 3), p, b, b1, train))
    y = _bn(_conv(ar, y, p, c2, 1, 3), p, b, b2, train)
    return torch.relu(y + x)


def forward(params: dict, buffers: dict, A: torch.Tensor, B: torch.Tensor,
            train: bool = False, precision: str = "float32") -> dict:
    """A, B: (N, H, W, 4) float32. Returns {"trans", "rot"} (N, 3).
    ``train``: BatchNorm on the batch's statistics (the running buffers
    are not updated: the reference needs them only in eval mode)."""
    spec = {name: (kind, k, s) for name, kind, _, _, k, s in LAYERS}
    with Arith(precision) as ar:
        def run(x, name):
            kind, k, s = spec[name]
            return _layer(ar, x, params, buffers, name, kind, k, s, train)

        a = A.permute(0, 3, 1, 2)
        b_ = B.permute(0, 3, 1, 2)
        a = run(F.max_pool2d(run(a, "convA1"), 3, 2, 1), "convA2")
        b_ = F.max_pool2d(run(b_, "convB1"), 3, 2, 1)
        b_ = run(run(b_, "convB2"), "convB3")
        ab = run(run(torch.cat([a, b_], dim=1), "convAB1"), "convAB2")
        out = {}
        for head in ("trans", "rot"):
            f = run(run(ab, f"{head}_conv1"), f"{head}_conv2").mean(dim=(2, 3))
            fw, w = ar.operands(f, params[f"{head}_out.0.weight"])
            out[head] = torch.tanh(F.linear(fw, w,
                                            params[f"{head}_out.0.bias"]))
    return out


def loss(out: dict, t_label, r_label):
    """MSE(trans) + MSE(rot), each a mean over samples of the mean over the
    three components (reference se3_tracknet.py:114-121, weights 1)."""
    return ((out["trans"] - t_label) ** 2).mean() + \
        ((out["rot"] - r_label) ** 2).mean()
