"""FoundationPose's refiner (RefineNet) as a PyTorch ``nn.Module``, the
port's second tracking network.

FoundationPose (Wen, Yang, Kautz, Birchfield, CVPR, 2024, arXiv:2312.08344;
NVlabs/FoundationPose ``learning/models/refine_network.py`` and
``network_modules.py``) tracks frame to frame with this refiner, two
render-and-compare rounds a frame (``track_one``, ``track_refine_iter=2``).
At the published widths (``c_in=6``, 160x160 inputs, ``use_BN``,
``rot_rep: axis_angle``), in eval mode:

  - inputs, per image (A rendered, B real): ``cat(rgb / 255, xyz_n)``, 6
    channels, where ``xyz_n = (xyz - t_A) / (d / 2)`` is each pixel's
    camera-frame point less A's translation over the mesh radius, 0 where
    z < 1 mm or any |coordinate| >= 2 (:meth:`RefineNet.build_pair`);
  - ``encodeA``, one encoder shared by A and B (the batch ``cat([A, B])``
    goes through it once): ConvBNReLU(6, 64, 7, 2), ConvBNReLU(64, 128, 3,
    2), ResnetBasicBlock(128) x 2;
  - ``encodeAB`` on ``cat([a, b], 1)``: ResnetBasicBlock(256) x 2,
    ConvBNReLU(256, 512, 3, 2), ResnetBasicBlock(512) x 2: 512 x 20 x 20;
  - 400 tokens of width 512 plus the sinusoidal position embedding
    (``pos_embed.pe``, max_len 400);
  - ``trans_head`` and ``rot_head``: each one post-norm
    ``nn.TransformerEncoderLayer(512, nhead=4, dim_feedforward=512)``
    (ReLU, LayerNorm eps 1e-5, dropout inactive in eval), then
    Linear(512, 3) on every token and the mean over the tokens;
  - decode (:meth:`RefineNet.decode`): t_B = t_A + trans (d / 2), R_B =
    exp(tanh(rot) 20 deg) R_A, ``core/se3.decode_delta`` with tau = d / 2
    and rho = 20 deg.

ConvBNReLU is Conv (pad (k - 1) // 2, bias, zero padding) + BatchNorm +
ReLU; ResnetBasicBlock is Se3TrackNet's (``tracknet.ResnetBasicBlock``).
Parameter names are the published state_dict keys (``encodeA.0.net.0
.weight``, ``encodeAB.2.net.1.running_var``, ``trans_head.0.self_attn
.in_proj_weight``, ``trans_head.1.weight``, ``pos_embed.pe``, ...); the
encoder layer's are torch's ``nn.TransformerEncoderLayer`` names, which the
published module uses as it is. Padding zeros is an assumption that could
not be confirmed offline.

``forward(A, B)`` takes NHWC ``(N, H, W, 6)`` like Se3TrackNet and returns
``{"trans" (N, 3), "rot" (N, 3)}`` float32 (``rot`` before its tanh);
inside, the convolutions see NCHW views of channels-last activations and
read their weights in that layout, held with autograd off like the bf16
copies (``tracknet.conv_format``, ``weight_as``). ``dtype`` is the
activations' type. bf16 follows ``tracknet.py``'s rules: parameters and
BatchNorm statistics stay float32; convolutions, linear layers and the
attention's in-projection run on bf16 copies of the weights, held with
autograd off (made once for each version of a parameter and layout,
``tracknet.weight_as``) and cast on every call with it on; BatchNorm and LayerNorm compute in float32 and round once (the
LayerNorm's residual sum and the position embedding's sum are formed in
float32 too); attention runs ``F.scaled_dot_product_attention`` on bf16
q, k and v; the token means are float32. The published inference runs
under fp16 autocast: bf16 is the port's one lower precision, a departure.
In float32 attention runs torch's math backend, in full float32. Every
forward pins TF32 off (``se3.pin_full_fp32``).

Spans (``utils/profiling.py``, device spans: recorded in eager runs)
``refiner.encode`` (both encoders) and ``refiner.heads`` (embedding and the
two heads); the counter ``refine.attn_tokens`` adds the tokens through
attention a forward (2 heads x N x tokens). The tracking step adds the span
``refiner.round`` and the counter ``refine.rounds`` (``tracking/tracker.py``).
"""
from __future__ import annotations

import contextlib
import math

import torch
from torch import nn
from torch.nn import functional as F

from ..core import se3
from ..ops import pointcloud
from ..ops import roi as roi_ops
from ..utils import profiling
from .tracknet import (BatchNorm2d, Conv2d, Linear, ResnetBasicBlock,
                       weight_as)

EMBED_DIM = 512
NUM_HEADS = 4
MAX_TOKENS = 400
ROT_NORMALIZER = 0.3490658503988659   # 20 degrees, the published cfg's
CROP_RATIO = 1.2                      # the ROI's side over the diameter
XYZ_BOUND = 2.0                       # |xyz_n| at and above it is invalid
REFINE_ITERATIONS = 2                 # track_one's track_refine_iter
profiling.count("refine.attn_tokens", 0)  # listed before the first forward


class ConvBNReLU(nn.Module):
    """Conv(k, s, pad (k - 1) // 2, bias) + BatchNorm + ReLU, as ``net``
    (the published module's name)."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 3,
                 stride: int = 1):
        super().__init__()
        p = (kernel_size - 1) // 2
        self.net = nn.Sequential(
            Conv2d(cin, cout, kernel_size, stride, p, bias=True),
            BatchNorm2d(cout, eps=1e-5, momentum=0.1), nn.ReLU())

    def forward(self, x):
        return self.net(x)


class PositionalEmbedding(nn.Module):
    """x + pe[:, :L]: pe[p, 2i] = sin(p 10000^(-2i/d)), pe[p, 2i+1] =
    cos(p 10000^(-2i/d)), a buffer (1, max_len, d) as published. The sum is
    formed in float32 and rounded once to x's type."""

    def __init__(self, d_model: int = EMBED_DIM, max_len: int = MAX_TOKENS):
        super().__init__()
        self.register_buffer("pe", sinusoid(max_len, d_model))

    def forward(self, x):
        return (x.float() + self.pe[:, :x.shape[1]]).to(x.dtype)


def sinusoid(max_len: int, d_model: int) -> torch.Tensor:
    """The published table (1, max_len, d_model), float32."""
    pos = torch.arange(max_len, dtype=torch.float32)[:, None]
    div = torch.exp(torch.arange(0, d_model, 2, dtype=torch.float32)
                    * -(math.log(10000.0) / d_model))
    pe = torch.zeros(max_len, d_model)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe[None]


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` computed in float32 (float32 out)."""

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps)


class SelfAttention(nn.Module):
    """``nn.MultiheadAttention(d, heads, batch_first=True)`` as
    self-attention, with its parameter names (``in_proj_weight``,
    ``in_proj_bias``, ``out_proj``) and initialisation, through
    ``F.scaled_dot_product_attention`` in the input's type."""

    def __init__(self, dim: int = EMBED_DIM, heads: int = NUM_HEADS):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * dim))
        self.out_proj = Linear(dim, dim)
        nn.init.xavier_uniform_(self.in_proj_weight)
        nn.init.zeros_(self.in_proj_bias)
        nn.init.zeros_(self.out_proj.bias)

    def forward(self, x):
        n, length, dim = x.shape
        qkv = F.linear(x, weight_as(self.in_proj_weight, x.dtype),
                       weight_as(self.in_proj_bias, x.dtype))
        q, k, v = qkv.view(n, length, 3, self.heads,
                           dim // self.heads).permute(2, 0, 3, 1, 4)
        with _attention_backend(x.dtype):
            o = F.scaled_dot_product_attention(q, k, v)
        return self.out_proj(o.transpose(1, 2).reshape(n, length, dim))


def _attention_backend(dtype):
    """Float32 attention in torch's math backend (its matrix products
    follow the TF32 pin); any other type in the fused kernels."""
    if dtype != torch.float32:
        return contextlib.nullcontext()
    from torch.nn.attention import SDPBackend, sdpa_kernel

    return sdpa_kernel(SDPBackend.MATH)


class EncoderLayer(nn.Module):
    """Post-norm ``nn.TransformerEncoderLayer(d, nhead, dim_feedforward,
    batch_first=True)`` in eval mode, with its parameter names:
    x = LN1(x + MHA(x)), x = LN2(x + W2 relu(W1 x))."""

    def __init__(self, dim: int = EMBED_DIM, heads: int = NUM_HEADS,
                 ff: int = EMBED_DIM):
        super().__init__()
        self.self_attn = SelfAttention(dim, heads)
        self.linear1 = Linear(dim, ff)
        self.linear2 = Linear(ff, dim)
        self.norm1 = LayerNorm(dim, eps=1e-5)
        self.norm2 = LayerNorm(dim, eps=1e-5)

    def forward(self, x):
        dt = x.dtype
        x = self.norm1(x.float() + self.self_attn(x).float()).to(dt)
        y = self.linear2(torch.relu(self.linear1(x)))
        return self.norm2(x.float() + y.float()).to(dt)


class RefineNet(nn.Module):
    """The refiner (module docstring). ``dtype``: float32 or bfloat16.
    ``crop_ratio`` is the ROI's side over the mesh diameter: the tracker's
    ROI width (``TrackerConfig.object_width_mm``, the diameter plus a 20%
    bounding-box pad) over it gives the diameter d the inputs and the
    decode are scaled by. ``base``: the first convolution's width, 64 as
    published (the widths are base x (1, 2, 4, 8), the tokens' 8 base); a
    smaller one makes the same pattern small for the tests."""

    refine_iterations = REFINE_ITERATIONS
    round_span = "refiner.round"
    crop_ratio = CROP_RATIO

    def __init__(self, dtype: torch.dtype = torch.float32, base: int = 64):
        super().__init__()
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype {dtype}: float32 or bfloat16")
        self.dtype = dtype
        b, d = base, 8 * base
        self.encodeA = nn.Sequential(
            ConvBNReLU(6, b, 7, 2), ConvBNReLU(b, 2 * b, 3, 2),
            ResnetBasicBlock(2 * b), ResnetBasicBlock(2 * b))
        self.encodeAB = nn.Sequential(
            ResnetBasicBlock(4 * b), ResnetBasicBlock(4 * b),
            ConvBNReLU(4 * b, d, 3, 2), ResnetBasicBlock(d),
            ResnetBasicBlock(d))
        self.pos_embed = PositionalEmbedding(d, MAX_TOKENS)
        self.trans_head = nn.Sequential(EncoderLayer(d, NUM_HEADS, d),
                                        Linear(d, 3))
        self.rot_head = nn.Sequential(EncoderLayer(d, NUM_HEADS, d),
                                      Linear(d, 3))

    def forward(self, A: torch.Tensor, B: torch.Tensor) -> dict:
        se3.pin_full_fp32()
        n = A.shape[0]
        x = torch.cat([A, B], 0).to(self.dtype).permute(0, 3, 1, 2)
        with profiling.span("refiner.encode", device=True):
            x = self.encodeA(x)
            ab = self.encodeAB(torch.cat([x[:n], x[n:]], dim=1))
        with profiling.span("refiner.heads", device=True):
            tokens = self.pos_embed(ab.flatten(2).transpose(1, 2))
            profiling.count("refine.attn_tokens",
                            2 * tokens.shape[0] * tokens.shape[1])
            trans = self.trans_head(tokens).float().mean(dim=1)
            rot = self.rot_head(tokens).float().mean(dim=1)
        return {"trans": trans, "rot": rot}

    # -- the tracking step's parts (tracking/tracker.py::track_step) --
    def radius_m(self, width_mm):
        """The mesh radius d / 2 in metres from the ROI width in mm: a
        float, or a tensor of one width a view (N,) broadcast over (N,
        ...)."""
        return width_mm / (2000.0 * self.crop_ratio)

    def build_pair(self, views: dict, pose, K, mean, std, width_mm):
        """The network's (A, B) inputs (N, H, W, 6) float32 from one
        round's ROI views (``tracker.roi_geometry``) at ``pose`` ((4, 4),
        or (N, 4, 4)): rgb / 255 and the normalised camera-frame points. A's
        points come from the rendered depth at the render window's pixel
        centres, B's from the cropped depth at the crop's source pixels.
        ``mean`` and ``std`` are not used: the refiner normalises its
        inputs itself."""
        hw = views["rgbA"].shape[-3:-1]
        t = pose[..., :3, 3]
        radius = self.radius_m(width_mm)
        us, vs = pointcloud.window_pixel_centres(views["window"], hw)
        rows, cols = roi_ops.source_pixels(views["bbox"], hw)
        xyzA = pointcloud.roi_xyz(views["depthA"], us, vs, K)
        xyzB = pointcloud.roi_xyz(views["depthB"], cols.to(torch.float32),
                                  rows.to(torch.float32), K)
        A = torch.cat([views["rgbA"] / 255.0, pointcloud.normalize_xyz(
            xyzA, t, radius, XYZ_BOUND)], dim=-1)
        B = torch.cat([views["rgbB"] / 255.0, pointcloud.normalize_xyz(
            xyzB, t, radius, XYZ_BOUND)], dim=-1)
        if pose.dim() == 2:
            return A[None], B[None]
        return A, B

    def decode(self, pose, trans, rot, cfg, width_mm):
        """t_B = t_A + trans d / 2, R_B = exp(tanh(rot) 20 deg) R_A."""
        radius = self.radius_m(width_mm)
        if torch.is_tensor(radius) and radius.dim():
            radius = radius[..., None]
        return se3.decode_delta(pose, trans, torch.tanh(rot), radius,
                                ROT_NORMALIZER)
