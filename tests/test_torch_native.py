"""The port's native PNG decoder (``native/dataload.py`` over
``native/dataload.cc``) against Pillow, as tests/test_native.py holds the
JAX package's: 8-bit RGB and gray, 16-bit gray, the threaded batch, a
missing file; its build in the port's ``_build/``; ``PairDataset`` decoding
through it to Pillow's arrays. Skipped where there is no g++ or libpng."""
import os
import shutil

import numpy as np
import pytest
from PIL import Image

from iros20_6d_pose_tracking_tpu_torch.native import dataload


@pytest.fixture(scope="module")
def loader():
    if shutil.which("g++") is None:
        pytest.skip("no C++ toolchain")
    try:
        return dataload.NativeLoader()
    except (OSError, RuntimeError) as e:  # libpng missing, say
        pytest.skip(f"native loader unavailable: {e}")


def _write(tmp, name, arr):
    path = str(tmp / name)
    Image.fromarray(arr).save(path)
    return path


def test_built_into_the_port_build_dir(loader):
    path = dataload.library_path()
    assert os.path.exists(path)
    assert os.path.dirname(path) == os.path.join(
        os.path.dirname(os.path.dirname(dataload.__file__)), "_build")
    assert dataload.build() == path  # built once, then found


@pytest.mark.parametrize("kind", ["rgb8", "gray16", "gray8"])
def test_decode_equals_pillow(tmp_path, loader, kind):
    rng = np.random.RandomState(0)
    arr = {"rgb8": rng.randint(0, 256, (37, 53, 3)).astype(np.uint8),
           "gray16": rng.randint(0, 60000, (41, 29)).astype(np.uint16),
           "gray8": np.arange(100, dtype=np.uint8).reshape(10, 10)}[kind]
    path = _write(tmp_path, f"{kind}.png", arr)
    out = loader.read_png(path)
    assert out.dtype == arr.dtype
    np.testing.assert_array_equal(out, arr)
    np.testing.assert_array_equal(out, np.array(Image.open(path)))


def test_batch_threaded(tmp_path, loader):
    rng = np.random.RandomState(2)
    arrs = [rng.randint(0, 256, (24, 32, 3)).astype(np.uint8)
            for _ in range(16)]
    paths = [_write(tmp_path, f"b{i}.png", a) for i, a in enumerate(arrs)]
    out = loader.read_png_batch(paths, np.uint8, n_threads=8)
    assert out.shape == (16, 24, 32, 3)
    np.testing.assert_array_equal(out, np.stack(arrs))


def test_batch_u16_and_bad_batches(tmp_path, loader):
    rng = np.random.RandomState(3)
    arrs = [rng.randint(0, 2000, (24, 32)).astype(np.uint16)
            for _ in range(6)]
    paths = [_write(tmp_path, f"d{i}.png", a) for i, a in enumerate(arrs)]
    out = loader.read_png_batch(paths, np.uint16, n_threads=4)
    np.testing.assert_array_equal(out, np.stack(arrs))
    with pytest.raises(ValueError):
        loader.read_png_batch(paths, np.uint8)
    odd = _write(tmp_path, "odd.png", arrs[0][:20])
    with pytest.raises(OSError):
        loader.read_png_batch(paths + [odd], np.uint16)


def test_missing_file(tmp_path, loader):
    assert loader.read_png(str(tmp_path / "nowhere.png")) is None
    assert loader.info(str(tmp_path / "nowhere.png")) is None
    with pytest.raises(OSError):
        loader.read_png_batch([str(tmp_path / "nowhere.png")])


def _write_pairs(root, n, res, seed):
    rng = np.random.RandomState(seed)
    for i in range(n):
        for suffix in ("rgbA", "rgbB"):
            Image.fromarray(rng.randint(0, 256, (res, res, 3)).astype(
                np.uint8)).save(root / f"{i:07d}{suffix}.png")
        for suffix in ("depthA", "depthB"):
            Image.fromarray(rng.randint(300, 1500, (res, res)).astype(
                np.uint16)).save(root / f"{i:07d}{suffix}.png")
        Image.fromarray(np.ones((res, res), np.uint8)).save(
            root / f"{i:07d}segB.png")
        pose = np.eye(4)
        pose[2, 3] = 0.6
        np.savez(root / f"{i:07d}meta.npz", A_in_cam=pose, B_in_cam=pose)


@pytest.mark.parametrize("res,stored", [(48, 48), (32, 48)])
def test_pair_dataset_decodes_natively(tmp_path, loader, res, stored):
    """PairDataset decodes through the native loader (whole batches when
    the files need no resize, else record by record) to the arrays its
    Pillow path gives."""
    from iros20_6d_pose_tracking_tpu_torch.data.dataset import PairDataset

    _write_pairs(tmp_path, 4, stored, seed=res)
    ds = PairDataset(str(tmp_path), resolution=res)
    assert ds._native is not None
    fast = next(ds.batches(4, shuffle=False))
    rec = ds[1]
    ds._native = None  # the Pillow path
    slow = next(ds.batches(4, shuffle=False))
    assert fast.keys() == slow.keys()
    for k in fast:
        assert fast[k].dtype == slow[k].dtype, k
        np.testing.assert_array_equal(fast[k], slow[k], err_msg=k)
    for k, v in vars(ds[1]).items():
        np.testing.assert_array_equal(getattr(rec, k), v, err_msg=k)
