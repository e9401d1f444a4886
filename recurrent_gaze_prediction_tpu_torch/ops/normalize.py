"""Map normalizers + 2-D softmax / cross-entropy over [..., H, W] maps.

The port's counterpart of the JAX package's `ops/normalize.py`:
  * `normalize_map`: per-map min-max to [0, 1]
  * `normalize_probability_map`: per-map divide-by-sum
  * `softmax_2d` / `softmax_cross_entropy_2d`: softmax / xent over the
    flattened HxW grid
  * `kl_divergence_2d`: KL(labels || pred) over flattened maps
"""

from __future__ import annotations

import torch


def normalize_map(t: torch.Tensor) -> torch.Tensor:
    """Min-max normalize each H x W map to [0, 1]; maps that are constant
    stay at 0 (the divide is guarded where max == 0)."""
    t = t - t.amin(dim=(-2, -1), keepdim=True)
    mx = t.amax(dim=(-2, -1), keepdim=True)
    return torch.where(mx > 0, t / torch.where(mx > 0, mx, 1.0), t)


def normalize_probability_map(t: torch.Tensor) -> torch.Tensor:
    """Normalize each H x W map to sum to 1."""
    return t / t.sum(dim=(-2, -1), keepdim=True)


def softmax_2d(logits: torch.Tensor) -> torch.Tensor:
    """Softmax over the flattened last-two (H, W) axes."""
    return torch.softmax(logits.flatten(-2), dim=-1).reshape(logits.shape)


def softmax_cross_entropy_2d(logits: torch.Tensor,
                             labels: torch.Tensor) -> torch.Tensor:
    """Per-map softmax cross entropy over flattened H x W; one scalar per
    leading index, like `tf.nn.softmax_cross_entropy_with_logits`."""
    log_probs = torch.log_softmax(logits.flatten(-2), dim=-1)
    return -(labels.flatten(-2) * log_probs).sum(dim=-1)


def kl_divergence_2d(pred_probs: torch.Tensor, label_probs: torch.Tensor,
                     eps: float = 1e-12) -> torch.Tensor:
    """KL(labels || pred) over flattened H x W maps."""
    p = label_probs.flatten(-2)
    q = pred_probs.flatten(-2)
    return (p * (torch.log(p + eps) - torch.log(q + eps))).sum(dim=-1)
