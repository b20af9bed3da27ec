"""Se3TrackNet as a PyTorch ``nn.Module``.

Counterpart of ``iros20_6d_pose_tracking_tpu/models/tracknet.py``, with the
reference's architecture and quirks (reference se3_tracknet.py:52-121,
network_modules.py:49-120):

  - "ConvBNReLU" is Conv + BatchNorm + SELU;
  - the residual blocks use ReLU and biased 3x3 convolutions;
  - branch A has one post-stem residual block, branch B two;
  - the fusion trunk has a single 256-channel residual block;
  - two heads: ConvBNSELU(256 -> 512, s2) + ResBlock(512) + global average
    pool + Linear(512 -> 3) + tanh.

Parameter names are the reference's state_dict keys (``convA1.0.weight``,
``convA2.bn1.running_var``, ``trans_out.0.bias``, ...), so reference
``.pth.tar`` checkpoints load with ``strict=True``; Flax variables of the
JAX model come across through :func:`.convert.state_dict_from_jax`.
BatchNorm uses eps 1e-5 and momentum 0.1 (Flax's momentum 0.9), and in
train mode updates its running variance with the biased batch variance, as
Flax does (:class:`BatchNorm2d`). :func:`init_params` draws Flax's default
initialisers, so a freshly initialised network is the JAX trainer's.

The public ``forward(A, B)`` takes NHWC ``(N, H, W, 4)`` like the JAX model
and returns ``{"feature" (N, H/8, W/8, 256) NHWC, "trans" (N, 3),
"rot" (N, 3)}``; inside, the convolutions run NCHW.

Every forward pins float32 convolutions and matmuls (TF32 off, the JAX
reference's HIGHEST precision; ``core/se3.pin_full_fp32``), whichever entry
point calls it.

``dtype`` is the activations' type, the Flax model's ``dtype``: float32, or
bfloat16 with the parameters and BatchNorm's running statistics kept
float32 (the JAX package's TPU precision). In bfloat16 the convolutions and
the heads' Linear run on bfloat16 copies of the weights, the bias added in
the same call (one rounding; Flax adds it as a second bfloat16 op). With
autograd off (the tracking step, evaluation) each copy is made once for each
version of its parameter and held (:func:`weight_as`): a replayed tracking
step casts nothing. With autograd on (bf16 training) they are cast on every
call, so gradients reach the float32 parameters through the cast. BatchNorm
computes in float32 and rounds to bfloat16 once, as Flax's ``_normalize``
does; SELU, ReLU, max-pool and the spatial mean run in
bfloat16; ``trans`` and ``rot`` come out float32, ``feature`` bfloat16.
:func:`as_float64` makes a float64 copy, the reference float32 gradients
are held against (no entry point runs it).
"""
from __future__ import annotations

import copy
import math
import weakref

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.weak import WeakIdKeyDictionary

from ..core import se3
from ..ops import depthproc
from ..utils import profiling


def _at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32, or in float64 where it is float64."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` with Flax's running statistics.

    In train mode torch updates ``running_var`` with the unbiased batch
    variance (x n/(n-1)); Flax's ``nn.BatchNorm`` uses the biased one. Here
    the normalization is torch's own (``F.batch_norm`` on the batch
    statistics), and the running buffers are written from the biased
    variance: ``running = (1 - momentum) * running + momentum * batch``.
    Eval mode is unchanged. The buffers keep the reference's names, so
    reference checkpoints load with ``strict=True``.

    ``sync``: None, or (reduce, ranks) while a data-parallel step runs
    (``parallel/spmd.py``): ``reduce`` sums a tensor over the ``ranks``
    ranks that share the batch, carrying autograd, and train mode then
    normalizes with the statistics of the whole batch (sync BatchNorm)."""

    sync = None

    def forward(self, x):
        # A bfloat16 x is normalized in float32 against the float32
        # statistics and parameters, and rounded to bfloat16 once.
        if not self.training:
            return super().forward(x)
        if self.sync is not None:
            return self._synced(x, *self.sync)
        y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                         self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(_at_least_f32(x), dim=(0, 2, 3),
                                       correction=0)
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
            self.running_var.mul_(1.0 - m).add_(var, alpha=m)
            self.num_batches_tracked.add_(1)
        return y

    def _synced(self, x, reduce, ranks: int):
        """Train mode over a batch split across ``ranks`` ranks of equal
        shares: the mean, then the biased variance around it, each a sum
        over every rank's pixels (two passes, as one device computes)."""
        x32 = x.to(torch.float32)
        n = x32.numel() // x32.shape[1] * ranks
        mean = reduce(x32.sum(dim=(0, 2, 3))) / n
        d = x32 - mean[:, None, None]
        var = reduce((d * d).sum(dim=(0, 2, 3))) / n
        y = d * (torch.rsqrt(var + self.eps) * self.weight)[:, None, None] \
            + self.bias[:, None, None]
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean.detach(), alpha=m)
            self.running_var.mul_(1.0 - m).add_(var.detach(), alpha=m)
            self.num_batches_tracked.add_(1)
        return y.to(x.dtype)


# parameter -> (its storage, weakly; (data_ptr, version, dtype); the copy)
_held = WeakIdKeyDictionary()
profiling.count("weights.bf16_casts", 0)  # listed before the first forward
profiling.count("weights.bf16_held", 0)


def weight_as(p: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``p.to(dtype)``: ``p`` itself where it is of ``dtype``. A copy is
    held across calls where autograd is off and ``p`` is an
    ``nn.Parameter`` that is not an inference tensor; it is made again
    once ``p``'s storage, data pointer or version counter (an in-place
    update: ``load_state_dict``, ``copy_``, an optimizer step) or ``dtype``
    changes. The copies are held here, weakly keyed on the parameter, so
    they are in no ``state_dict``, and neither a ``copy.deepcopy`` nor a
    pickle of the model carries one. Elsewhere ``p`` is cast on every call:
    a forward with autograd on (the cast carries the gradient), a tensor
    swapped in by ``torch.func.functional_call`` or ``vmap``
    (``parallel/spmd.py``), an inference tensor, whose version cannot be
    read. A write that bypasses the version counter (through ``p.data``)
    is not seen. The counters ``weights.bf16_casts`` and
    ``weights.bf16_held`` count the casts made and the held copies used."""
    if p.dtype == dtype:
        return p
    if torch.is_grad_enabled() or not isinstance(p, nn.Parameter) \
            or p.is_inference():
        profiling.count("weights.bf16_casts")
        return p.to(dtype)
    storage = p.untyped_storage()
    key = (p.data_ptr(), p._version, dtype)
    held = _held.get(p)
    if held is None or held[0]() is not storage or held[1] != key:
        held = _held[p] = (weakref.ref(storage), key, p.to(dtype))
        profiling.count("weights.bf16_casts")
    else:
        profiling.count("weights.bf16_held")
    return held[2]


def held_weights(model: nn.Module) -> list:
    """The held copies (:func:`weight_as`) of ``model``'s parameters that
    are current, each with its parameter's storage: what a captured graph
    that reads them keeps alive (``tracking/compiled.py``), so that
    neither address is reused while it may replay."""
    out = []
    for p in model.parameters():
        held = _held.get(p)
        if held is None:
            continue
        storage = p.untyped_storage()
        if held[0]() is storage and held[1][:2] == (p.data_ptr(), p._version):
            out.append((storage, held[2]))
    return out


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` in the input's type: float32 parameters, used as
    bfloat16 copies on a bfloat16 input (:func:`weight_as`)."""

    def forward(self, x):
        return self._conv_forward(x, weight_as(self.weight, x.dtype),
                                  weight_as(self.bias, x.dtype))


class Linear(nn.Linear):
    """``nn.Linear`` in the input's type, as :class:`Conv2d`."""

    def forward(self, x):
        return F.linear(x, weight_as(self.weight, x.dtype),
                        weight_as(self.bias, x.dtype))


class ConvBNSELU(nn.Sequential):
    """Conv(k, s, symmetric (k-1)//2 pad, bias) + BatchNorm + SELU
    (reference network_modules.py:59-66)."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 3,
                 stride: int = 1):
        p = (kernel_size - 1) // 2
        super().__init__(
            Conv2d(cin, cout, kernel_size, stride, p, bias=True),
            BatchNorm2d(cout, eps=1e-5, momentum=0.1),
            nn.SELU(),
        )


class ResnetBasicBlock(nn.Module):
    """conv3x3-BN-ReLU-conv3x3-BN + identity, ReLU (stride 1, no
    downsample; reference network_modules.py:86-120)."""

    def __init__(self, ch: int):
        super().__init__()
        self.conv1 = Conv2d(ch, ch, 3, 1, 1, bias=True)
        self.bn1 = BatchNorm2d(ch, eps=1e-5, momentum=0.1)
        self.conv2 = Conv2d(ch, ch, 3, 1, 1, bias=True)
        self.bn2 = BatchNorm2d(ch, eps=1e-5, momentum=0.1)

    def forward(self, x):
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return torch.relu(y + x)


def pack_channels(rgb, depth):
    """RGB (H, W, 3) + depth (H, W) -> (H, W, 4) float32 (reference
    data_augmentation.py:175-196 ToTensor, NHWC)."""
    return torch.cat([rgb, depth[..., None]], dim=-1).to(torch.float32)


def normalize_pair(rgbA, depthA, rgbB, depthB, poseA, mean, std):
    """OffsetDepth + NormalizeChannels + pack, both branches. ``mean`` and
    ``std`` are the 8-channel training statistics (A rgbd, B rgbd) on the
    last axis: (8,), or one pair a view broadcast against the images."""
    bufA = pack_channels(rgbA, depthproc.offset_depth(depthA, poseA))
    bufB = pack_channels(rgbB, depthproc.offset_depth(depthB, poseA))
    bufA = (bufA - mean[..., :4]) / std[..., :4]
    bufB = (bufB - mean[..., 4:]) / std[..., 4:]
    return bufA, bufB


class Se3TrackNet(nn.Module):
    """Two-branch relative-pose regressor (reference se3_tracknet.py:52-112).

    ``image_size`` is kept for parity with the JAX model's signature; the
    network is fully convolutional up to the global pool. ``dtype``: the
    activations' type, float32 or bfloat16 (module docstring).

    The tracking step (``tracking/tracker.py::track_step``) asks the model
    for its rounds a frame (``refine_iterations``: one), its inputs
    (:meth:`build_pair`) and its decode (:meth:`decode`)."""

    refine_iterations = 1
    round_span = None

    def __init__(self, image_size: int = 176,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype {dtype}: float32 or bfloat16")
        self.image_size = image_size
        self.dtype = dtype
        self.convA1 = ConvBNSELU(4, 64, 7, 2)
        self.convA2 = ResnetBasicBlock(64)
        self.convB1 = ConvBNSELU(4, 64, 7, 2)
        self.convB2 = ResnetBasicBlock(64)
        self.convB3 = ResnetBasicBlock(64)
        self.convAB1 = ConvBNSELU(128, 256, 3, 2)
        self.convAB2 = ResnetBasicBlock(256)
        self.trans_conv1 = ConvBNSELU(256, 512, 3, 2)
        self.trans_conv2 = ResnetBasicBlock(512)
        self.trans_out = nn.Sequential(Linear(512, 3), nn.Tanh())
        self.rot_conv1 = ConvBNSELU(256, 512, 3, 2)
        self.rot_conv2 = ResnetBasicBlock(512)
        self.rot_out = nn.Sequential(Linear(512, 3), nn.Tanh())

    def forward(self, A: torch.Tensor, B: torch.Tensor) -> dict:
        # Every entry point that runs the network passes here, so TF32 is
        # pinned off here (the backward pass runs after it with the flags
        # still set): two host-side stores, nothing on the device.
        se3.pin_full_fp32()
        A = A.to(self.dtype).permute(0, 3, 1, 2)
        B = B.to(self.dtype).permute(0, 3, 1, 2)
        pool = nn.functional.max_pool2d
        a = self.convA2(pool(self.convA1(A), 3, 2, 1))
        b = self.convB3(self.convB2(pool(self.convB1(B), 3, 2, 1)))
        ab = self.convAB2(self.convAB1(torch.cat([a, b], dim=1)))
        t = self.trans_conv2(self.trans_conv1(ab)).mean(dim=(2, 3))
        r = self.rot_conv2(self.rot_conv1(ab)).mean(dim=(2, 3))
        return {
            "feature": ab.permute(0, 2, 3, 1),
            "trans": _at_least_f32(self.trans_out(t)),
            "rot": _at_least_f32(self.rot_out(r)),
        }

    def build_pair(self, views: dict, pose, K, mean, std, width_mm):
        """OffsetDepth and the 8-channel normalisation of one round's ROI
        views (``tracker.roi_geometry``) at ``pose`` ((4, 4) or (N, 4,
        4)): the batched (A, B) inputs."""
        batched = pose.dim() == 3
        bufA, bufB = normalize_pair(
            views["rgbA"], views["depthA"], views["rgbB"], views["depthB"],
            pose[:, None, None] if batched else pose, mean, std)
        return (bufA, bufB) if batched else (bufA[None], bufB[None])

    def decode(self, pose, trans, rot, cfg, width_mm):
        """The tanh outputs times the tracker's normalisers, composed onto
        ``pose`` (``se3.decode_delta``)."""
        return se3.decode_delta(pose, trans, rot, cfg.trans_normalizer,
                                cfg.rot_normalizer)


def loss_fn(pred_trans, pred_rot, target_trans, target_rot,
            trans_weight: float = 1.0, rot_weight: float = 1.0,
            sample_weight=None):
    """MSE(trans) + MSE(rot) (reference se3_tracknet.py:114-121), weighted
    per reference problems.py:91. ``sample_weight`` (N,) turns the means
    over samples into weighted means. Returns (total, {"trans", "rot"})."""
    se_t = torch.mean((_at_least_f32(pred_trans) - target_trans) ** 2, dim=-1)
    se_r = torch.mean((_at_least_f32(pred_rot) - target_rot) ** 2, dim=-1)
    if sample_weight is None:
        trans_loss = se_t.mean()
        rot_loss = se_r.mean()
    else:
        w = sample_weight.float()
        denom = torch.clamp(w.sum(), min=1.0)
        trans_loss = (se_t * w).sum() / denom
        rot_loss = (se_r * w).sum() / denom
    total = trans_weight * trans_loss + rot_weight * rot_loss
    return total, {"trans": trans_loss, "rot": rot_loss}


def as_float64(model: Se3TrackNet) -> Se3TrackNet:
    """A float64 copy of a float32 ``model``: parameters, BatchNorm
    statistics, activations, outputs and loss in float64, on the same
    inputs: the reference the float32 gradients of the card and of the
    CPU are held against (``chip_smoke.py``,
    tests/test_torch_train_parity.py)."""
    if model.dtype != torch.float32:
        raise ValueError(f"a {model.dtype} model has no float32 reference")
    m = copy.deepcopy(model).double()
    m.dtype = torch.float64
    return m


def create_model(image_size: int = 176,
                 dtype: torch.dtype = torch.float32) -> Se3TrackNet:
    return Se3TrackNet(image_size=image_size, dtype=dtype)


# Flax's lecun_normal: a normal truncated to [-2, 2] whose stddev is
# divided by the truncated distribution's own (0.8796...), so the kernel's
# variance is exactly 1 / fan_in.
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def init_params(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Flax's default initialisers, drawn from ``generator``: conv and
    dense kernels lecun-normal (truncated normal of variance 1 / fan_in),
    biases 0, BatchNorm scale 1 and bias 0, running mean 0 and variance 1.
    (Torch's own default, kaiming-uniform, is a different network at step
    0.) Modules are visited in registration order. Returns ``model``."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
            z = se3.truncated_normal(tuple(m.weight.shape), generator,
                                     m.weight.device, -2.0, 2.0)
            m.weight.copy_(z * std)
            m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
    return model
