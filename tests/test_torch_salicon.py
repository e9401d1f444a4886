"""The port's SALICON loader (`data/salicon.py`) against the JAX package's
on the fixture of `tests/test_data.py::test_salicon_loader`, built in
`tmp_path`: images, saliency maps, fixations and the split indices equal,
the batches of four epochs (three reshuffles) equal; and
`cli.pretrain_shallownet --dataset salicon` on it."""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from recurrent_gaze_prediction_tpu.data import salicon as jsalicon
from recurrent_gaze_prediction_tpu_torch.cli import pretrain_shallownet
from recurrent_gaze_prediction_tpu_torch.data import salicon
from recurrent_gaze_prediction_tpu_torch.train import load_params


def salicon_tree(root, n=10, image_hw=(98, 98), val=0, seed=0):
    """`test_salicon_loader`'s layout: n JPEG images, their 49x49 saliency
    maps and `.npy` fixation maps under `train98x98` / `train49x49` /
    `train`, and `val` more of each under the val folders."""
    rng = np.random.RandomState(seed)
    for split, count in (("train", n), ("val", val)):
        if not count:
            continue
        img_dir = os.path.join(root, "images", f"{split}98x98")
        map_dir = os.path.join(root, "saliencymaps", f"{split}49x49")
        fix_dir = os.path.join(root, "fixations", split)
        for d in (img_dir, map_dir, fix_dir):
            os.makedirs(d)
        for i in range(count):
            name = f"img{i:03d}.jpg"
            Image.fromarray(rng.randint(0, 255, (*image_hw, 3)).astype(
                np.uint8)).save(os.path.join(img_dir, name))
            Image.fromarray(rng.randint(0, 255, (49, 49)).astype(
                np.uint8)).save(os.path.join(map_dir, name))
            fix = np.zeros((36, 48), np.uint8)
            fix[rng.randint(0, 36, 5), rng.randint(0, 48, 5)] = 1
            np.save(os.path.join(fix_dir, name + ".npy"), fix)
    return root


def _assert_same_dataset(got, want):
    np.testing.assert_array_equal(got.images, want.images)
    np.testing.assert_array_equal(got.saliencymaps, want.saliencymaps)
    assert len(got.fixationmaps) == len(want.fixationmaps)
    for a, b in zip(got.fixationmaps, want.fixationmaps):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("image_hw", [(98, 98), (120, 150)])
def test_salicon_splits_and_epochs_match_jax(tmp_path, image_hw):
    """The 80/20 split and eight batches of 3 from 8 images: two per
    epoch (the tail is dropped), so three reshuffles, drawn from the
    dataset-owned RandomState(3024202); images of another size go through
    the same LANCZOS resize."""
    root = salicon_tree(str(tmp_path / "salicon"), image_hw=image_hw)
    got = salicon.SaliconData(root=root, use_val_split=True).build()
    want = jsalicon.SaliconData(root=root, use_val_split=True).build()
    assert len(got.train) == 8 and len(got.valid) == 2
    assert got.train.images.shape == (8, 98, 98, 3)
    assert got.train.images.dtype == np.float32 and got.train.images.max() <= 1
    for split in ("train", "valid"):
        _assert_same_dataset(getattr(got, split), getattr(want, split))
    for _ in range(8):
        for a, b in zip(got.train.next_batch(3), want.train.next_batch(3)):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
    assert got.train.epochs_completed == want.train.epochs_completed == 3


def test_salicon_val_folders_are_the_test_split(tmp_path):
    root = salicon_tree(str(tmp_path / "salicon"), n=6, val=4, seed=1)
    got = salicon.SaliconData(root=root).build()
    want = jsalicon.SaliconData(root=root).build()
    assert len(got.train) == 6 and len(got.test) == 4
    assert got.valid is got.test
    _assert_same_dataset(got.train, want.train)
    _assert_same_dataset(got.test, want.test)
    with pytest.raises(ValueError, match="batch_size"):
        got.test.next_batch(5)


def test_pretrain_shallownet_on_salicon(tmp_path):
    root = salicon_tree(str(tmp_path / "salicon"))
    out = str(tmp_path / "sn.pt")
    assert pretrain_shallownet.main(
        ["--dataset", "salicon", "--salicon_root", root, "--out", out,
         "--max_steps", "3", "--batch_size", "4", "--steps_per_logprint",
         "1", "--train_dir", str(tmp_path / "run"), "--device", "cpu"]) == 0
    params = load_params(out)
    assert "conv1_w" in params
    assert all(torch.isfinite(t).all() for t in params.values())
    with open(tmp_path / "run" / "metrics.jsonl") as f:
        assert sum(1 for line in f if "loss/train" in line) == 3
