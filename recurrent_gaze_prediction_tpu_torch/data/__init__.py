"""Clip datasets and the synthetic corpus (numpy only)."""

from .datasets import ClipDataset, DataSplits, empty_dataset

__all__ = ["ClipDataset", "DataSplits", "empty_dataset"]
