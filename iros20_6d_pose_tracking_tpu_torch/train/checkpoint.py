"""Checkpoint save and load with full train-state resume, in PyTorch.

Counterpart of ``iros20_6d_pose_tracking_tpu/train/checkpoint.py``. A
checkpoint is one ``torch.save`` file holding the model's state_dict, the
optimizer's, the step and epoch counters, the 8-channel normalization
statistics and the best losses so far, plus a JSON sidecar
(``<path>.json``) of human-readable metadata. It loads with
``torch.load(weights_only=True)``: tensors, numbers and containers only.
The artifact names follow the reference (reference problems.py:143,150):
``model_best_train.pt``, ``model_best_val.pt``, ``checkpoint_last.pt``.

The JAX trainer's checkpoints are Flax msgpack files
(``flax.serialization.msgpack_serialize`` of nested dicts).
:func:`load_flax_checkpoint` reads them with ``msgpack`` and numpy alone,
and :func:`save_flax_checkpoint` writes the same format (tests, and a
Flax-format checkpoint made without JAX). Arrays travel as msgpack
extension types holding a msgpack triple (shape, dtype name, C-order bytes):
code 1 an ndarray, code 3 a numpy scalar; code 2 is a complex number
(real, imag). Arrays above 2**30 bytes are split into a
``__msgpack_chunked_array__`` dict of flat chunks.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"


def save_checkpoint(path: str, state: dict, metadata: dict | None = None):
    """``torch.save`` ``state`` to ``path`` (written to a temporary file and
    renamed, so a crash leaves the previous checkpoint whole), and
    ``metadata`` to ``path + ".json"``."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)
    if metadata is not None:
        with open(path + ".json", "w") as f:
            json.dump(metadata, f, indent=2, default=float)


def load_checkpoint(path: str, map_location="cpu") -> dict:
    """The state dict of a checkpoint, tensors on ``map_location``."""
    return torch.load(path, map_location=map_location, weights_only=True)


def load_metadata(path: str) -> dict:
    meta_path = path + ".json"
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            return json.load(f)
    return {}


def latest_checkpoint(outdir: str) -> str | None:
    """The resume checkpoint of a training output directory, if any."""
    path = os.path.join(outdir, "checkpoint_last.pt")
    return path if os.path.exists(path) else None


def _ndarray_from_bytes(data: bytes) -> np.ndarray:
    import msgpack

    shape, dtype_name, buffer = msgpack.unpackb(data, raw=True)
    if dtype_name == b"bfloat16":  # numpy has no bfloat16: widen, exactly
        bits = np.frombuffer(buffer, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name.decode()),
                         count=-1, offset=0).reshape(shape, order="C")


def _ext_unpack(code, data):
    import msgpack

    if code == _EXT_NDARRAY:
        return _ndarray_from_bytes(data)
    if code == _EXT_COMPLEX:
        real, imag = msgpack.unpackb(data)
        return complex(real, imag)
    if code == _EXT_NPSCALAR:
        return _ndarray_from_bytes(data)[()]
    return msgpack.ExtType(code, data)


def _unchunk(tree):
    """Chunked-array dicts back into arrays, through the nested dicts."""
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        shape = [tree["shape"][str(i)] for i in range(len(tree["shape"]))]
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def load_flax_checkpoint(path: str) -> dict:
    """A Flax msgpack checkpoint (the JAX ``train/checkpoint.py`` format) as
    nested dicts of numpy arrays and numbers; optimizer states come back as
    the dicts Flax flattened them into."""
    import msgpack

    with open(path, "rb") as f:
        tree = msgpack.unpackb(f.read(), ext_hook=_ext_unpack, raw=False)
    return _unchunk(tree)


def _ext_pack(x):
    import msgpack

    def triple(a):
        return msgpack.packb((a.shape, a.dtype.name, a.tobytes("C")),
                             use_bin_type=True)

    if isinstance(x, np.ndarray):
        return msgpack.ExtType(_EXT_NDARRAY, triple(x))
    if isinstance(x, np.generic):
        return msgpack.ExtType(_EXT_NPSCALAR, triple(np.asarray(x)))
    raise TypeError(f"cannot serialize {type(x).__name__}")


def save_flax_checkpoint(path: str, tree: dict):
    """Write nested dicts (string keys) of numpy arrays, numpy scalars and
    Python numbers as a
    Flax msgpack checkpoint: the bytes ``flax.serialization
    .msgpack_serialize`` gives for them, keys sorted as Flax sorts them
    (arrays of more than 2**30 bytes are refused, not chunked)."""
    import msgpack

    def canonical(t):
        if isinstance(t, dict):
            return {k: canonical(t[k]) for k in sorted(t)}
        if isinstance(t, np.ndarray) and t.nbytes > 2 ** 30:
            raise ValueError("arrays above 2**30 bytes are not supported")
        return t

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(msgpack.packb(canonical(tree), default=_ext_pack,
                              strict_types=True))
