"""CRC / Hollywood2 gaze-clip loader: the port's copy of the JAX package's
`data/crc.py` (numpy; h5py and PIL are imported inside `read_clip` only).

The reference's `crc_input_data_seq.py` with the same protocol, minus its
hardcoded data paths (a `DatasetLayout` carries the roots) and with an npz
cache in place of hickle:

  per clip folder (`read_crc_data_set`, `crc_input_data_seq.py:169-354`):
    * frame JPEGs subsampled [15::5], resized to 98x98, scaled to [0, 1]
    * per-user gazemaps at the resolution-matched key; users with NaN
      pupil traces skipped; gazelen = max(len(u0), len(u1)) - 10
    * fixation maps = SUM of user one-hot maps; gazemaps = MEAN, then
      per-frame Gaussian blur (sigma by resolution) + min-max normalize
    * optional original-scale fixation maps from sparse fixation_{t,r,c}
    * all streams truncated to the common min length

  split level (`read_crc_data_sets`, `crc_input_data_seq.py:504-679`):
    * crc: 60/40/rest split of seed-0-shuffled folders; hollywood2:
      official 823 train / 884 test when the full set is present, else
      0.5/0.4; crcxh2 = concatenation
    * every clip chunked into SEQ_LEN=42 windows (seq2batch)
    * pupil z-score + min-max normalization
    * thread-pool folder loading, npz cache keyed by the data roots
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

import numpy as np

from ..utils import log, mkdir_p
from . import codec
from .datasets import ClipDataset, DataSplits
from .gazemap import apply_gaussian_filter, gazemap_key_and_sigma
from .seq import FRAME_OFFSET, FRAME_STRIDE, SEQ_LEN, seq2batch


@dataclasses.dataclass
class DatasetLayout:
    """Filesystem layout of one dataset (the reference hardcodes these,
    `crc_input_data_seq.py:425-447`)."""

    root: str
    video_frame_dir: str = "vid_frm"
    gaze_map_dir: str = "gazemap"
    c3d_dir: str = "vid_c3d"

    def frame_folder(self, clip: str) -> str:
        return os.path.join(self.root, self.video_frame_dir, clip)

    def gaze_mat(self, clip: str) -> str:
        return os.path.join(self.root, self.gaze_map_dir, clip + ".mat")

    def c3d_file(self, clip: str) -> str:
        return os.path.join(self.root, self.c3d_dir, clip + ".c3d")

    def clip_folders(self) -> list[str]:
        base = os.path.join(self.root, self.video_frame_dir)
        return sorted(
            f for f in os.listdir(base)
            if os.path.isdir(os.path.join(base, f)))


def layouts_for(dataset: str, data_root: str) -> dict[str, DatasetLayout]:
    """Per-dataset layout table for a CLI --data_root.

    `crcxh2` concatenates BOTH constituent datasets
    (`crc_input_data_seq.py:518-529`), so it needs both layouts, rooted at
    `{data_root}/{name}`; plain datasets use `data_root` directly.
    """
    if dataset == "crcxh2":
        return {name: DatasetLayout(root=os.path.join(data_root, name))
                for name in ("crc", "hollywood2")}
    return {dataset: DatasetLayout(root=data_root)}


def read_clip(layout: DatasetLayout, clip: str, image_height: int,
              image_width: int, gazemap_height: Optional[int],
              gazemap_width: Optional[int],
              fixation_original_scale: bool = False) -> Optional[dict]:
    """Load one clip folder -> dict of aligned per-frame streams."""
    import h5py
    from PIL import Image

    frame_folder = layout.frame_folder(clip)
    frame_files = sorted(
        os.path.join(frame_folder, f) for f in os.listdir(frame_folder)
        if os.path.isfile(os.path.join(frame_folder, f)))

    images = []
    for path in frame_files[FRAME_OFFSET::FRAME_STRIDE]:
        img = Image.open(path).convert("RGB")
        if img.size != (image_width, image_height):
            img = img.resize((image_width, image_height), Image.LANCZOS)
        images.append(np.asarray(img))
    if not images:
        return None
    images = np.stack(images).astype(np.float32) / 255.0

    key, sigma = gazemap_key_and_sigma(gazemap_height, gazemap_width)

    with h5py.File(layout.gaze_mat(clip), "r") as mat:
        root = list(mat.values())[0]
        gazemaps_list, pupil_list = [], []
        for user_name in root.keys():
            user = root[user_name]
            if key not in user:
                log.warn("gazemap key %s missing for %s/%s", key, clip,
                         user_name)
                continue
            if np.isnan(np.min(np.asarray(user["pupilsize"]))):
                continue
            gazemaps_list.append(np.asarray(user[key]))
            pupil_list.append(np.squeeze(np.asarray(user["pupilsize"])))
        if not gazemaps_list:
            return None

        # gazelen heuristic from the reference (crc_input_data_seq.py:261)
        if len(gazemaps_list) >= 2:
            gazelen = max(len(gazemaps_list[0]), len(gazemaps_list[1])) - 10
        else:
            gazelen = len(gazemaps_list[0]) - 10

        pupil_list = [p[FRAME_OFFSET:gazelen:FRAME_STRIDE]
                      for p in pupil_list if p.shape[0] > gazelen - 1]
        if not pupil_list:
            log.warn("no pupil trace long enough for %s, skipping clip", clip)
            return None
        pupils = np.mean(np.asarray(pupil_list), axis=0)

        gazemaps_list = [g[FRAME_OFFSET:gazelen:FRAME_STRIDE]
                         for g in gazemaps_list if len(g) > gazelen - 1]
        fixationmaps = np.sum(np.asarray(gazemaps_list, dtype=np.float32),
                              axis=0)
        # (W, H) -> (H, W) swap, crc_input_data_seq.py:280
        fixationmaps = np.swapaxes(fixationmaps, 1, 2)

        gazemaps = fixationmaps.astype(np.float32) / len(gazemaps_list)
        # Defensive forward fill of all-zero frames (simultaneous tracking
        # loss across every user). Normally the offline preprocessing
        # already filled per-user frames (`add_gazemap.py:57-74`); the
        # reference loader defines fill_gazemap for this
        # (`crc_input_data_seq.py:159-166`) but never calls it — a zero
        # frame there flows into normalize_probability_map's 0/0 and
        # poisons the xentropy loss with NaN.
        if len(gazemaps) and gazemaps.reshape(len(gazemaps), -1).sum(
                axis=1).min() == 0:
            from .gazemap import fill_missing_frames

            try:
                fill_missing_frames(gazemaps)
            except ValueError:
                log.warn("clip %s has no gaze at all; skipping", clip)
                return None
        apply_gaussian_filter(gazemaps, sigma)

        if fixation_original_scale:
            fix_list = []
            for user_name in root.keys():
                user = root[user_name]
                if "fixation_t" not in user:
                    continue
                ts = np.asarray(user["fixation_t"]).astype(int).ravel()
                rs = np.asarray(user["fixation_r"]).astype(int).ravel()
                cs = np.asarray(user["fixation_c"]).astype(int).ravel()
                # h5py datasets expose .shape without reading the data —
                # np.asarray here would materialize the full original-
                # resolution tensor per user per clip just for its shape
                t_total, oh, ow = user["gazemap"].shape
                maps = np.zeros((t_total, oh, ow), np.uint8)
                maps[ts, rs, cs] = 1
                fix_list.append(maps)
            if fix_list:
                fix_list = [m[FRAME_OFFSET:gazelen:FRAME_STRIDE]
                            for m in fix_list if len(m) > gazelen - 1]
                fixationmaps = np.sum(np.asarray(fix_list), axis=0)
                fixationmaps = np.swapaxes(fixationmaps, 1, 2)

    # codec.load_c3d_for_model squeezes only INNER singleton dims — a bare
    # np.squeeze would drop the window axis of a single-window clip
    # ([1,1,512,2,7,7] -> [512,2,7,7]) and return channel dim 2, crashing
    # the whole split load at np.stack time
    c3d = codec.load_c3d_for_model(layout.c3d_file(clip)).astype(np.float32)

    n = min(len(images), len(gazemaps), len(fixationmaps), len(c3d),
            len(pupils))
    if n <= 0:
        return None
    return {
        "frames": images[:n],
        "gazemaps": gazemaps[:n].astype(np.float32),
        "fixationmaps": fixationmaps[:n].astype(np.float32),
        "c3d": c3d[:n],
        "pupils": pupils[:n].astype(np.float32),
        "clipnames": [clip] * n,
    }


# ---------------------------------------------------------------- splits

def split_foldernames(dataset: str, layout: DatasetLayout) -> dict:
    """Train/valid/test folder lists (`crc_input_data_seq.py:423-501`)."""
    foldernames = layout.clip_folders()
    total = len(foldernames)
    if dataset == "crc":
        np.random.RandomState(0).shuffle(foldernames)
        train_offset = int(0.6 * total)
        val_offset = train_offset + int(0.4 * total)
    elif dataset == "hollywood2":
        foldernames.sort(key=lambda x: ("test" in x, x))
        if total > 1600:  # official split
            train_offset = 823
            val_offset = 823 + (884 - 1)
        else:
            train_offset = int(0.5 * total)
            val_offset = train_offset + int(0.4 * total)
    else:
        raise NotImplementedError(dataset)
    return {
        "train": foldernames[:train_offset],
        "valid": foldernames[train_offset:val_offset],
        "test": foldernames[val_offset:],
    }


def _normalize_pupils(pupil_windows: np.ndarray) -> np.ndarray:
    """Z-score per TIME INDEX then global min-max shift
    (`crc_input_data_seq.py:612-619`): the reference calls
    `stats.zscore(asarray(pupil_list))` on an [N_windows, 42] array, and
    scipy's default axis=0 standardizes each time position independently —
    matched here. Its second step has a precedence bug
    `x - minx/(maxx-minx)`; the intended (x - minx)/(maxx - minx) is
    applied instead (documented divergence, PARITY.md)."""
    std = pupil_windows.std(axis=0)
    z = (pupil_windows - pupil_windows.mean(axis=0)) / np.maximum(std, 1e-12)
    lo, hi = z.min(), z.max()
    if hi > lo:
        z = (z - lo) / (hi - lo)
    return z.astype(np.float32)


def read_crc_data_sets(image_height: int = 98, image_width: int = 98,
                       gazemap_height: int = 49, gazemap_width: int = 49,
                       dataset: str = "crc",
                       layouts: Optional[dict[str, DatasetLayout]] = None,
                       seq_len: int = SEQ_LEN,
                       use_cache: bool = True,
                       cache_dir: Optional[str] = None,
                       max_folders: Optional[int] = None,
                       split_modes: Optional[Sequence[str]] = None,
                       fixation_original_scale: bool = False,
                       parallel_jobs: int = 8) -> DataSplits:
    """Load chunked clip windows for train/valid/test.

    `layouts` maps dataset name -> DatasetLayout; 'crcxh2' concatenates the
    'crc' and 'hollywood2' splits (`crc_input_data_seq.py:518-529`).
    """
    if layouts is None:
        raise ValueError("layouts required (no hardcoded data paths here)")
    if max_folders is not None:
        use_cache = False

    if dataset == "crcxh2":
        parts = [("crc", split_foldernames("crc", layouts["crc"])),
                 ("hollywood2",
                  split_foldernames("hollywood2", layouts["hollywood2"]))]
        split = {
            mode: [(name, layouts[name], clip) for name, sp in parts
                   for clip in sp[mode]]
            for mode in ("train", "valid", "test")
        }
    else:
        sp = split_foldernames(dataset, layouts[dataset])
        split = {
            mode: [(dataset, layouts[dataset], clip) for clip in sp[mode]]
            for mode in ("train", "valid", "test")
        }

    rs = np.random.RandomState(0)
    for mode in ("train", "valid", "test"):
        rs.shuffle(split[mode])
        if max_folders is not None:
            split[mode] = split[mode][:max_folders]

    if split_modes is None:
        split_modes = ("train", "valid", "test")
    elif isinstance(split_modes, str):
        split_modes = (split_modes,)

    def load_split(mode: str) -> Optional[ClipDataset]:
        instances = split[mode]
        if not instances:
            return None

        cache_file = None
        if use_cache and cache_dir is not None:
            mkdir_p(cache_dir)
            # key includes the data roots: one cache_dir reused across two
            # --data_root corpora must not serve the wrong arrays
            roots = "|".join(sorted(
                os.path.abspath(lay.root) for lay in layouts.values()))
            root_key = hashlib.sha1(roots.encode()).hexdigest()[:10]
            cache_file = os.path.join(
                cache_dir,
                f"datasets_{dataset}_{root_key}_{image_height}_{image_width}_"
                f"{gazemap_height}_{gazemap_width}_{seq_len}"
                + ("_origfix" if fixation_original_scale else "")
                + f".{mode}.npz")
            if os.path.exists(cache_file):
                log.infov("Loading from cache %s ...", cache_file)
                blob = np.load(cache_file, allow_pickle=True)
                return ClipDataset(
                    frames=blob["frames"], gazemaps=blob["gazemaps"],
                    fixationmaps=blob["fixationmaps"], c3d=blob["c3d"],
                    pupils=blob["pupils"],
                    clipnames=list(blob["clipnames"]))

        def task(item):
            _, layout, clip = item
            try:
                return read_clip(layout, clip, image_height, image_width,
                                 gazemap_height, gazemap_width,
                                 fixation_original_scale)
            except Exception as e:  # skip unreadable clips, like joblib did
                log.error("failed to load clip %s: %s", clip, e)
                return None

        with ThreadPoolExecutor(max_workers=parallel_jobs) as pool:
            results = list(pool.map(task, instances))

        streams = {k: [] for k in ("frames", "gazemaps", "fixationmaps",
                                   "c3d", "pupils")}
        clipname_windows: list[str] = []
        for clip_streams in results:
            if clip_streams is None:
                continue
            for k in streams:
                streams[k].extend(seq2batch(clip_streams[k], seq_len))
            clipname_windows.extend(
                names[0] for names in seq2batch(clip_streams["clipnames"],
                                                seq_len))
        if not streams["frames"]:
            return None

        def _stack(key, windows):
            # original-scale fixation maps take each clip's native tracker
            # resolution; crcxh2 (and mixed-resolution hollywood2 clips)
            # can therefore be ragged — fall back to an object array of
            # [T, H, W] windows instead of crashing in np.stack. The
            # NumPy evaluation protocol consumes these per frame.
            if key == "fixationmaps" and fixation_original_scale:
                shapes = {np.asarray(w).shape for w in windows}
                if len(shapes) > 1:
                    log.warn("mixed original-scale fixation resolutions "
                             "%s: storing as object array (per-frame "
                             "metrics fine; AUC_shuffled needs uniform "
                             "resolution)", sorted(shapes))
                    out = np.empty(len(windows), dtype=object)
                    for i, w in enumerate(windows):
                        out[i] = np.asarray(w)
                    return out
            return np.stack(windows)

        arrays = {k: _stack(k, v) for k, v in streams.items()}
        arrays["pupils"] = _normalize_pupils(arrays["pupils"])
        ds = ClipDataset(clipnames=clipname_windows, **arrays)
        log.warn("%s length: %d windows", mode, len(ds))

        if cache_file is not None:
            log.infov("Persisting into cache %s ...", cache_file)
            np.savez_compressed(
                cache_file, clipnames=np.asarray(clipname_windows),
                **arrays)
        return ds

    data = DataSplits()
    for mode in split_modes:
        setattr(data, mode, load_split(mode))
    return data
