"""FoundationPose's refiner (``models/refinenet.py``) as plain functions of a
parameter dict: the yardstick the module is held to in the tests, float32
with TF32 off, NHWC in. It imports torch alone: nothing of the module, of
the port's kernels or of JAX.

The network (NVlabs/FoundationPose ``learning/models/refine_network.py``
``RefineNet``, ``network_modules.py``; arXiv:2312.08344) at its published
pattern, any width a block list gives:

  ConvBNReLU(cin, cout, k, s): conv (bias, zero pad (k-1)//2) + BN + ReLU
  ResnetBasicBlock(c): relu(bn(conv3x3)) -> bn(conv3x3) + x -> relu
  encodeA (shared by A and B, one batch): ConvBNReLU(6, 64, 7, 2),
    ConvBNReLU(64, 128, 3, 2), ResnetBasicBlock(128) x 2
  encodeAB on cat(a, b): ResnetBasicBlock(256) x 2,
    ConvBNReLU(256, 512, 3, 2), ResnetBasicBlock(512) x 2
  tokens (N, h w, C) + pe[p, 2i] = sin(p 10000^(-2i/C)), cos at 2i + 1
  heads: post-norm encoder layer (x = LN(x + MHA(x)), x = LN(x + W2
    relu(W1 x)), 4 heads, LayerNorm eps 1e-5), Linear(C, 3) a token, mean
    over the tokens

Departures from the published description: zero padding (unconfirmed
offline); float32 (the published inference runs under fp16 autocast).
"""
from __future__ import annotations

import math

import torch
from torch.nn import functional as F

EPS = 1e-5
HEADS = 4
# (kind, cin, cout, kernel, stride) at the published widths
ENCODE_A = (("cbr", 6, 64, 7, 2), ("cbr", 64, 128, 3, 2),
            ("res", 128, 128, 3, 1), ("res", 128, 128, 3, 1))
ENCODE_AB = (("res", 256, 256, 3, 1), ("res", 256, 256, 3, 1),
             ("cbr", 256, 512, 3, 2), ("res", 512, 512, 3, 1),
             ("res", 512, 512, 3, 1))


def _bn(x, p, name):
    return F.batch_norm(x, p[f"{name}.running_mean"],
                        p[f"{name}.running_var"], p[f"{name}.weight"],
                        p[f"{name}.bias"], False, 0.0, EPS)


def _conv(x, p, name, stride, k):
    return F.conv2d(x, p[f"{name}.weight"], p[f"{name}.bias"], stride,
                    (k - 1) // 2)


def _block(x, p, name, kind, k, stride):
    if kind == "cbr":
        return torch.relu(_bn(_conv(x, p, f"{name}.net.0", stride, k), p,
                              f"{name}.net.1"))
    y = torch.relu(_bn(_conv(x, p, f"{name}.conv1", 1, 3), p, f"{name}.bn1"))
    y = _bn(_conv(y, p, f"{name}.conv2", 1, 3), p, f"{name}.bn2")
    return torch.relu(y + x)


def _encoder_layer(x, p, name):
    n, length, d = x.shape
    hd = d // HEADS
    qkv = x @ p[f"{name}.self_attn.in_proj_weight"].T \
        + p[f"{name}.self_attn.in_proj_bias"]
    q, k, v = qkv.reshape(n, length, 3, HEADS, hd).permute(2, 0, 3, 1, 4)
    a = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(hd), dim=-1) @ v
    a = a.transpose(1, 2).reshape(n, length, d)
    a = a @ p[f"{name}.self_attn.out_proj.weight"].T \
        + p[f"{name}.self_attn.out_proj.bias"]
    x = F.layer_norm(x + a, (d,), p[f"{name}.norm1.weight"],
                     p[f"{name}.norm1.bias"], EPS)
    y = torch.relu(x @ p[f"{name}.linear1.weight"].T
                   + p[f"{name}.linear1.bias"])
    y = y @ p[f"{name}.linear2.weight"].T + p[f"{name}.linear2.bias"]
    return F.layer_norm(x + y, (d,), p[f"{name}.norm2.weight"],
                        p[f"{name}.norm2.bias"], EPS)


def sinusoid(length: int, d: int) -> torch.Tensor:
    p = torch.arange(length, dtype=torch.float64)[:, None]
    w = torch.pow(10000.0, -torch.arange(0, d, 2, dtype=torch.float64) / d)
    pe = torch.zeros(length, d, dtype=torch.float64)
    pe[:, 0::2] = torch.sin(p * w)
    pe[:, 1::2] = torch.cos(p * w)
    return pe.to(torch.float32)


@torch.no_grad()
def forward(p: dict, A: torch.Tensor, B: torch.Tensor,
            encode_a=ENCODE_A, encode_ab=ENCODE_AB) -> dict:
    """A, B: (N, H, W, c_in) float32; ``p`` the state_dict's tensors by
    name (BatchNorm running statistics included). Returns {"trans",
    "rot"} (N, 3), ``rot`` before its tanh. ``encode_a`` and ``encode_ab``
    give the blocks' widths (the published ones by default)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    n = A.shape[0]
    x = torch.cat([A, B], 0).permute(0, 3, 1, 2)
    for i, (kind, _, _, k, s) in enumerate(encode_a):
        x = _block(x, p, f"encodeA.{i}", kind, k, s)
    x = torch.cat([x[:n], x[n:]], 1)
    for i, (kind, _, _, k, s) in enumerate(encode_ab):
        x = _block(x, p, f"encodeAB.{i}", kind, k, s)
    tokens = x.flatten(2).transpose(1, 2)
    tokens = tokens + sinusoid(tokens.shape[1], tokens.shape[2]).to(
        tokens.device)
    out = {}
    for head in ("trans", "rot"):
        y = _encoder_layer(tokens, p, f"{head}_head.0")
        out[head] = (y @ p[f"{head}_head.1.weight"].T
                     + p[f"{head}_head.1.bias"]).mean(1)
    return out
