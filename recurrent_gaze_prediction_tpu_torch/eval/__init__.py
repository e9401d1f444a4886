"""Evaluation: the saliency metrics batched on the device (`metrics_torch`)
and the NumPy reference protocol (`metrics_np`, a copy of the JAX
package's), the generate-and-evaluate harness, the checkpoint sweep and
the visualization helpers (the port's counterpart of the JAX package's
`eval/`)."""

from . import metrics_np, metrics_torch
from .metrics_torch import (
    ALL_METRICS,
    AVAILABLE_METRICS,
    auc_borji_batch,
    auc_judd_batch,
    auc_shuffled_batch,
    build_other_map_union,
    cc_batch,
    evaluate_batch,
    kld_batch,
    nss_batch,
    sim_batch,
)

__all__ = [
    "metrics_np",
    "metrics_torch",
    "ALL_METRICS",
    "AVAILABLE_METRICS",
    "cc_batch",
    "sim_batch",
    "nss_batch",
    "kld_batch",
    "auc_judd_batch",
    "auc_borji_batch",
    "auc_shuffled_batch",
    "build_other_map_union",
    "evaluate_batch",
]
