"""SALICON static-image saliency dataset loader (ShallowNet pretraining):
the port's counterpart of the JAX package's `data/salicon.py`, in numpy
and Pillow.

Rebuild of the reference's `salicon_input_data.py`: image / saliency-map /
fixation-map triples per split, with the reference's directory layout
(`images/train98x98/`, `saliencymaps/train49x49/`, `fixations/train/` with
per-image `.npy` fixation arrays, `salicon_input_data.py:166-179`), a
shuffled `next_batch`, and an 80/20 train/val split (replacing the sklearn
dependency with a seeded permutation).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np

from ..utils import log


class SaliconDataset:
    """Image-level dataset with shuffled epoch batching
    (`salicon_input_data.py:21-72`)."""

    def __init__(self, images, saliencymaps, fixationmaps=None):
        self.images = np.asarray(images)
        self.saliencymaps = np.asarray(saliencymaps)
        if fixationmaps is not None:
            # build a 1-D object array by assignment: np.asarray(...,
            # dtype=object) crashes on partially-ragged per-image maps
            # and silently boxes equal-shape ones element-wise
            fm = np.empty(len(fixationmaps), dtype=object)
            for i, m in enumerate(fixationmaps):
                fm[i] = m
            self.fixationmaps = fm
        else:
            self.fixationmaps = None
        self.epochs_completed = 0
        self._index = 0
        if len(self.images) == 0:
            raise ValueError("SaliconDataset needs at least one image")
        # dataset-owned RNG so epoch reshuffles are reproducible too (the
        # global np.random would make runs diverge from epoch 2 onward)
        self._rng = np.random.RandomState(3024202)
        self._perm = self._rng.permutation(len(self.images))

    def __len__(self) -> int:
        return len(self.images)

    def __repr__(self) -> str:
        return f"<SaliconDataset with {len(self)} images>"

    def next_batch(self, batch_size: int):
        start = self._index
        self._index += batch_size
        if self._index > len(self):
            self.epochs_completed += 1
            self._perm = self._rng.permutation(len(self))
            start = 0
            self._index = batch_size
            if batch_size > len(self):
                raise ValueError(f"batch_size {batch_size} > dataset size "
                                 f"{len(self)}")
        idx = self._perm[start:self._index]
        fix = (self.fixationmaps[idx] if self.fixationmaps is not None
               else None)
        return self.images[idx], self.saliencymaps[idx], fix


def read_salicon_data_set(image_dir: str, saliencymap_dir: str,
                          fixationmap_dir: Optional[str],
                          image_height: int = 98, image_width: int = 98,
                          saliencymap_height: int = 49,
                          saliencymap_width: int = 49) -> SaliconDataset:
    """Load one split folder triple (`salicon_input_data.py:75-131`)."""
    from PIL import Image

    filenames = sorted(
        f for f in os.listdir(image_dir)
        if os.path.isfile(os.path.join(image_dir, f)))
    images, maps, fixations = [], [], []
    for filename in filenames:
        img = Image.open(os.path.join(image_dir, filename)).convert("RGB")
        if img.size != (image_width, image_height):
            img = img.resize((image_width, image_height), Image.LANCZOS)
        images.append(np.asarray(img))

        smap = Image.open(os.path.join(saliencymap_dir, filename)).convert("L")
        if smap.size != (saliencymap_width, saliencymap_height):
            smap = smap.resize((saliencymap_width, saliencymap_height),
                               Image.LANCZOS)
        maps.append(np.asarray(smap))

        if fixationmap_dir is not None:
            fixations.append(
                np.load(os.path.join(fixationmap_dir, filename + ".npy")))

    images = np.stack(images).astype(np.float32) / 255.0
    maps = np.stack(maps).astype(np.float32) / 255.0
    return SaliconDataset(images, maps, fixations or None)


@dataclasses.dataclass
class SaliconData:
    """Split builder (`salicon_input_data.py:134-212`). Call `.build()`."""

    image_height: int = 98
    image_width: int = 98
    saliencymap_height: int = 49
    saliencymap_width: int = 49
    root: str = "salicon"
    use_example: bool = False
    use_val_split: bool = False
    split_seed: int = 0

    train: Optional[SaliconDataset] = None
    valid: Optional[SaliconDataset] = None
    test: Optional[SaliconDataset] = None

    def build(self) -> "SaliconData":
        log.info("loading SALICON data set ...")
        sub = "train2014examples" if self.use_example else None
        img_dir = os.path.join(
            self.root, "images", sub or f"train{self.image_height}x"
                                        f"{self.image_width}")
        map_dir = os.path.join(
            self.root, "saliencymaps",
            sub or f"train{self.saliencymap_height}x{self.saliencymap_width}")
        fix_dir = os.path.join(self.root, "fixations", sub or "train")
        if not os.path.isdir(fix_dir):
            fix_dir = None
        self.train = read_salicon_data_set(
            img_dir, map_dir, fix_dir, self.image_height, self.image_width,
            self.saliencymap_height, self.saliencymap_width)

        # SALICON has no public test labels; the val split doubles as test
        val_img = os.path.join(self.root, "images",
                               f"val{self.image_height}x{self.image_width}")
        if os.path.isdir(val_img):
            val_map = os.path.join(
                self.root, "saliencymaps",
                f"val{self.saliencymap_height}x{self.saliencymap_width}")
            val_fix = os.path.join(self.root, "fixations", "val")
            self.test = read_salicon_data_set(
                val_img, val_map,
                val_fix if os.path.isdir(val_fix) else None,
                self.image_height, self.image_width,
                self.saliencymap_height, self.saliencymap_width)

        if self.use_val_split:
            ds = self.train
            n = len(ds)
            perm = np.random.RandomState(self.split_seed).permutation(n)
            cut = int(n * 0.8)
            tr, va = perm[:cut], perm[cut:]

            def subset(idx):
                fix = (ds.fixationmaps[idx]
                       if ds.fixationmaps is not None else None)
                return SaliconDataset(ds.images[idx], ds.saliencymaps[idx],
                                      fix)

            self.train, self.valid = subset(tr), subset(va)
        else:
            self.valid = self.test
        log.info("Done.")
        return self
