"""Clip datasets, the synthetic corpus and the real-data loaders (numpy
copies of the JAX package's `data/`), the `.c3d` codec, video frames, and
the host-to-device batch copy."""

from . import codec, crc, gazemap, seq, synthetic
from .crc import DatasetLayout, read_crc_data_sets, split_foldernames
from .datasets import BATCH_KEYS, ClipDataset, DataSplits, empty_dataset
from .seq import SEQ_LEN, seq2batch

__all__ = [
    "codec",
    "crc",
    "gazemap",
    "seq",
    "synthetic",
    "BATCH_KEYS",
    "ClipDataset",
    "DataSplits",
    "empty_dataset",
    "DatasetLayout",
    "read_crc_data_sets",
    "split_foldernames",
    "SEQ_LEN",
    "seq2batch",
]
