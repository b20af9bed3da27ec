"""Training runtime: Adam with the multi-step schedule, the train step,
validation, the mean/std pass and the epoch loop with resume, in PyTorch.

Counterpart of ``iros20_6d_pose_tracking_tpu/train/trainer.py``, with the
reference trainer's hyperparameters (reference train.py:66-165,
problems.py:60-154, config.yml):

  - ``torch.optim.Adam(lr 1e-3, betas (0.9, 0.99), eps 1e-8, weight_decay
    1e-6)``: the L2 term is added to the gradient before the moments, as
    the JAX package's ``optax.add_decayed_weights`` does;
  - the learning rate ``lr * gamma^(#milestones m with step >= m * steps
    per epoch)``, set from the step counter before every update (optax's
    ``piecewise_constant_schedule`` applies a scale at its boundary count);
  - loss = w_t * MSE(trans) + w_r * MSE(rot) (reference problems.py:91);
  - the dataset mean/std pass with the reference's statistic: the std is
    taken over per-batch channel means (reference train.py:106-125).

One step: augment B -> OffsetDepth + normalize -> encode labels -> forward
and backward -> Adam. Random streams are ``torch.Generator``s keyed by the
absolute step (:func:`step_generator`), so a resumed run draws what the
uninterrupted run would have drawn. Batches are dicts of tensors on the
model's device, or of numpy arrays, which are moved there.
"""
from __future__ import annotations

import hashlib
import itertools
import os
import time
from dataclasses import dataclass
from typing import Callable, Iterable

import numpy as np
import torch

from ..core import se3
from ..data import augment as aug
from ..data.dataset import SyntheticPairs
from ..models import tracknet
from ..tracking.tracker import normalize_pair
from ..utils import profiling
from . import checkpoint as ckpt


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-3
    weight_decay: float = 1e-6
    betas: tuple = (0.9, 0.99)
    epochs: int = 300
    batch_size: int = 200
    milestones: tuple = (100, 200, 300)
    gamma: float = 0.1
    trans_loss_weight: float = 1.0
    rot_loss_weight: float = 1.0
    trans_normalizer: float = 0.02          # dataset_info.yml:12
    rot_normalizer: float = 15 * np.pi / 180  # dataset_info.yml:13
    resolution: int = 176
    aug: aug.AugmentConfig = aug.AugmentConfig()
    seed: int = 0


def step_generator(device, *key: int) -> torch.Generator:
    """A generator on ``device`` seeded from a tuple of ints (a run's seed
    and an absolute step, say): the same stream for the same key on every
    run and every resume."""
    digest = hashlib.blake2b(repr(tuple(int(k) for k in key)).encode(),
                             digest_size=8).digest()
    seed = int.from_bytes(digest, "little") & ((1 << 63) - 1)
    return torch.Generator(device=torch.device(device)).manual_seed(seed)


def make_optimizer(model: torch.nn.Module, cfg: TrainConfig,
                   steps_per_epoch: int):
    """torch.optim.Adam with the reference's settings, and the learning
    rate schedule as a function of the step count: ``(optimizer,
    lr_at)``. :func:`train_step` sets ``lr_at(step)`` before each update."""
    opt = torch.optim.Adam(model.parameters(), lr=cfg.learning_rate,
                           betas=tuple(cfg.betas), eps=1e-8,
                           weight_decay=cfg.weight_decay)
    bounds = [int(m) * steps_per_epoch for m in cfg.milestones]

    def lr_at(step: int) -> float:
        return cfg.learning_rate * cfg.gamma ** sum(step >= b for b in bounds)

    return opt, lr_at


def _on(device, raw: dict) -> dict:
    """The batch's arrays as tensors on ``device`` (float32; mask bool)."""
    def put(x, dtype=None):
        t = x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))
        return t.to(device=device, dtype=dtype)

    out = {k: put(raw[k], torch.float32) for k in (
        "rgbA", "depthA", "rgbB", "depthB", "A_in_cam", "B_in_cam")}
    out["maskB"] = put(raw["maskB"]) > 0
    return out


def preprocess_batch(gen, raw: dict, mean, std, cfg: TrainConfig,
                     train: bool, aug_draws: dict | None = None):
    """Raw pair batch -> (bufA, bufB, trans_label, rot_label) on ``mean``'s
    device: in train mode the B-branch augmentation (draws from ``gen``, or
    ``aug_draws`` when given), then OffsetDepth, the 8-channel normalization
    (reference train.py:130) and the label codec (reference
    datasets.py:141-150)."""
    r = _on(mean.device, raw)
    rgbB, depthB = r["rgbB"], r["depthB"]
    if train:
        if aug_draws is None:
            aug_draws = aug.draw_augment(gen, rgbB.shape[0], depthB.shape[1:],
                                         cfg.aug, rgbB.device)
        rgbB, depthB, _ = aug.apply_augment(aug_draws, rgbB, depthB,
                                            r["maskB"], cfg.aug)
    bufA, bufB = normalize_pair(r["rgbA"], r["depthA"], rgbB, depthB,
                                r["A_in_cam"][:, None, None], mean, std)
    t_label, r_label = se3.encode_delta(r["A_in_cam"], r["B_in_cam"],
                                        cfg.trans_normalizer,
                                        cfg.rot_normalizer)
    return bufA, bufB, t_label, r_label


def train_step(model: tracknet.Se3TrackNet, opt: torch.optim.Optimizer,
               lr: float, cfg: TrainConfig, gen, raw: dict, mean, std,
               aug_draws: dict | None = None) -> dict:
    """One update of ``model`` and ``opt`` in place at learning rate
    ``lr``, BatchNorm in train mode. Returns {"loss", "trans", "rot"} as
    0-d tensors on the device (not synchronised).

    Recorded as the span ``trainer.train_step`` (request: the call's
    number in the process) over ``trainer.augment``, ``trainer.forward``
    (with the loss), ``trainer.backward`` and ``trainer.adam``, each timed
    on the card's stream too."""
    dev = mean.device.type == "cuda"
    with profiling.span("trainer.train_step", device=dev,
                        request=next(_step_calls)):
        with profiling.span("trainer.augment", device=dev):
            bufA, bufB, t_label, r_label = preprocess_batch(
                gen, raw, mean, std, cfg, train=True, aug_draws=aug_draws)
        with profiling.span("trainer.forward", device=dev):
            model.train()
            out = model(bufA, bufB)
            loss, parts = tracknet.loss_fn(out["trans"], out["rot"], t_label,
                                           r_label, cfg.trans_loss_weight,
                                           cfg.rot_loss_weight)
        with profiling.span("trainer.backward", device=dev):
            opt.zero_grad(set_to_none=True)
            loss.backward()
        with profiling.span("trainer.adam", device=dev):
            for group in opt.param_groups:
                group["lr"] = lr
            opt.step()
    return {"loss": loss.detach(), "trans": parts["trans"].detach(),
            "rot": parts["rot"].detach()}


_step_calls = itertools.count()


def train_step_synth(model, opt, lr: float, cfg: TrainConfig,
                     synth: SyntheticPairs, gen_data, gen_aug, mean,
                     std) -> dict:
    """Sample a pair batch of ``cfg.batch_size`` from ``synth`` on
    ``gen_data`` and take one :func:`train_step` on it with ``gen_aug``:
    the same streams as ``synth.sample_batch`` followed by ``train_step``
    (the JAX package fuses the two into one program)."""
    raw = synth.sample_batch(gen_data, cfg.batch_size)
    return train_step(model, opt, lr, cfg, gen_aug, raw, mean, std)


@torch.no_grad()
def eval_step(model, cfg: TrainConfig, raw: dict, mean, std,
              n_valid: int | None = None) -> dict:
    """Validation loss with BatchNorm's running statistics. ``n_valid``
    masks the padded tail of a batch (``PairDataset.batches(...,
    pad_to_batch=True)``): the loss is the mean over the real samples."""
    bufA, bufB, t_label, r_label = preprocess_batch(
        None, raw, mean, std, cfg, train=False)
    model.eval()
    out = model(bufA, bufB)
    weight = None
    if n_valid is not None:
        weight = (torch.arange(out["trans"].shape[0], device=mean.device)
                  < n_valid).to(torch.float32)
    loss, parts = tracknet.loss_fn(out["trans"], out["rot"], t_label,
                                   r_label, cfg.trans_loss_weight,
                                   cfg.rot_loss_weight, sample_weight=weight)
    return {"loss": loss, "trans": parts["trans"], "rot": parts["rot"]}


@torch.no_grad()
def compute_mean_std(batches: Iterable[dict], cfg: TrainConfig, device,
                     max_samples: int = 10000, seed: int | None = None):
    """The reference's normalization pass (reference train.py:106-125):
    per-batch 8-channel means over about ``max_samples`` samples, with the
    augmentation and OffsetDepth applied (batch i augmented from
    ``step_generator(device, seed, i)``). Returns numpy (mean of the batch
    means, std of the batch means).

    The reference statistic is 0 when one batch fits in ``max_samples`` or
    a channel's batch means are constant; such channels fall back to the
    per-sample std, floored at 1e-3, so normalized inputs stay finite."""
    seed = cfg.seed if seed is None else seed
    zero = torch.zeros(8, device=device)
    one = torch.ones(8, device=device)
    means, stds = [], []
    seen = 0
    for i, raw in enumerate(batches):
        bufA, bufB, _, _ = preprocess_batch(step_generator(device, seed, i),
                                            raw, zero, one, cfg, train=True)
        stacked = torch.cat([bufA, bufB], dim=-1)  # (N, H, W, 8)
        means.append(stacked.mean(dim=(0, 1, 2)))
        stds.append(stacked.std(dim=(0, 1, 2), correction=0))
        seen += int(stacked.shape[0])
        if seen >= max_samples:
            break
    arr = torch.stack(means).cpu().numpy()
    std = arr.std(axis=0)
    fallback = np.maximum(torch.stack(stds).cpu().numpy().mean(axis=0), 1e-3)
    std = np.where(std < 1e-6, fallback, std)
    return arr.mean(axis=0), std


class Trainer:
    """Epoch loop with best-train / best-val checkpoints and resume.

    ``train_batches(epoch)`` and ``val_batches(epoch)`` return iterables of
    raw batch dicts: file-backed (``data.dataset.PairDataset.batches``) or
    synthetic (``data.dataset.SyntheticPairs``). The network is initialised
    with Flax's initialisers from ``cfg.seed`` (``tracknet.init_params``),
    and step s augments from ``step_generator(device, cfg.seed + 1, s)``.
    Checkpoints: ``model_best_train.pt``, ``model_best_val.pt``,
    ``checkpoint_last.pt`` under ``outdir``."""

    def __init__(self, model: tracknet.Se3TrackNet, cfg: TrainConfig,
                 outdir: str, steps_per_epoch: int, mean, std, device):
        self.device = torch.device(device)
        self.model = model.to(self.device)
        self.cfg = cfg
        self.outdir = outdir
        os.makedirs(outdir, exist_ok=True)
        tracknet.init_params(self.model,
                             torch.Generator().manual_seed(cfg.seed))
        self.opt, self.lr_at = make_optimizer(self.model, cfg,
                                              steps_per_epoch)
        self.step = 0
        self.epoch = 0
        self.mean = torch.as_tensor(np.asarray(mean), dtype=torch.float32).to(
            self.device)
        self.std = torch.as_tensor(np.asarray(std), dtype=torch.float32).to(
            self.device)
        self.best_train = float("inf")
        self.best_val = float("inf")
        np.save(os.path.join(outdir, "mean.npy"), np.asarray(mean))
        np.save(os.path.join(outdir, "std.npy"), np.asarray(std))

    # -- persistence -------------------------------------------------------

    def state_dict(self) -> dict:
        return {"model": self.model.state_dict(),
                "optimizer": self.opt.state_dict(),
                "step": self.step, "epoch": self.epoch,
                "mean": self.mean.cpu(), "std": self.std.cpu(),
                "best_train": self.best_train, "best_val": self.best_val}

    def save(self, name: str, metadata: dict | None = None) -> str:
        path = os.path.join(self.outdir, name)
        ckpt.save_checkpoint(path, self.state_dict(), metadata)
        return path

    def resume(self, path: str) -> None:
        """Restore the full training state of a checkpoint."""
        state = ckpt.load_checkpoint(path, map_location=self.device)
        self.model.load_state_dict(state["model"], strict=True)
        self.opt.load_state_dict(state["optimizer"])
        self.step = int(state["step"])
        self.epoch = int(state["epoch"])
        self.mean = state["mean"].to(self.device)
        self.std = state["std"].to(self.device)
        self.best_train = float(state["best_train"])
        self.best_val = float(state["best_val"])

    # -- loops -------------------------------------------------------------

    def train_epoch(self, batches, log_every: int = 100,
                    log_fn: Callable = print) -> float:
        metrics = None
        for raw in batches:
            gen = step_generator(self.device, self.cfg.seed + 1, self.step)
            metrics = train_step(self.model, self.opt, self.lr_at(self.step),
                                 self.cfg, gen, raw, self.mean, self.std)
            self.step += 1
            if self.step % log_every == 0:
                log_fn(f"epoch={self.epoch} step={self.step} "
                       f"loss={float(metrics['loss']):.6f} "
                       f"trans={float(metrics['trans']):.6f} "
                       f"rot={float(metrics['rot']):.6f}")
        return float(metrics["loss"]) if metrics is not None else float("nan")

    def validate(self, batches) -> float:
        """Unweighted mean of the per-batch losses (reference
        problems.py:106-132); a batch may carry ``n_valid``."""
        losses = []
        for raw in batches:
            raw = dict(raw)
            n_valid = raw.pop("n_valid", None)
            losses.append(float(eval_step(self.model, self.cfg, raw,
                                          self.mean, self.std,
                                          n_valid)["loss"]))
        return float(np.mean(losses)) if losses else float("inf")

    def loop(self, epochs: int, train_batches, val_batches,
             log_fn: Callable = print, save_all_checkpoints: bool = False):
        """Train from the current epoch to ``epochs``, saving the
        best-train, best-val and last checkpoints after every epoch
        (reference problems.py:135-153); ``save_all_checkpoints`` also keeps
        one per epoch (reference train.py:164)."""
        for epoch in range(self.epoch, epochs):
            t0 = time.time()
            train_loss = self.train_epoch(train_batches(epoch), log_fn=log_fn)
            val_loss = self.validate(val_batches(epoch))
            self.epoch = epoch + 1
            meta = {"epoch": epoch, "train_loss": train_loss,
                    "val_loss": val_loss, "secs": time.time() - t0}
            if train_loss < self.best_train:
                self.best_train = train_loss
                self.save("model_best_train.pt", meta)
            if val_loss < self.best_val:
                self.best_val = val_loss
                self.save("model_best_val.pt", meta)
            self.save("checkpoint_last.pt", meta)
            if save_all_checkpoints:
                self.save(f"checkpoint_epoch{epoch:04d}.pt", meta)
            log_fn(f">>> epoch {epoch}: train={train_loss:.6f} "
                   f"val={val_loss:.6f} ({meta['secs']:.1f}s)")
