"""The Hollywood2 action classifier over gaze-attended C3D features, and
its frame records (the port's counterpart of the JAX package's
`action/`)."""

from . import classification, records
from .classification import (
    ActionClassifier,
    ActionHParams,
    evaluate,
    hamming_loss,
    zero_one_loss,
)
from .records import (
    iter_record_batches,
    load_clipset_labels,
    multi_hot,
    read_record_shard,
    write_record_shard,
)

__all__ = [
    "classification",
    "records",
    "ActionClassifier",
    "ActionHParams",
    "evaluate",
    "hamming_loss",
    "zero_one_loss",
    "write_record_shard",
    "read_record_shard",
    "iter_record_batches",
    "load_clipset_labels",
    "multi_hot",
]
