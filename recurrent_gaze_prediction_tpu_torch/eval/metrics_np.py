"""Saliency metrics — NumPy reference implementations: the port's copy
of the JAX package's `eval/metrics_np.py` (numpy + scipy only).

Golden-value implementations of the metric formulas used by the reference's
`evaluation_metrics.py` (itself derived from the public salicon-evaluation /
herrlich10 formulas):

  * AUC_Judd   — threshold sweep at fixated saliency values
                 (the reference's `evaluation_metrics.py:42-98`)
  * AUC_Borji  — n_rep=100 uniform random negative sets, 0.1 threshold grid
                 (`evaluation_metrics.py:101-164`)
  * AUC_shuffled — negatives drawn from the union of other images' fixations
                 (`evaluation_metrics.py:167-204`)
  * similarity — histogram intersection of sum-normalized maps
                 (`evaluation_metrics.py:207-218`)
  * cc         — Pearson correlation of z-scored maps
                 (`evaluation_metrics.py:221-236`)
  * nss        — mean z-scored saliency at fixation points (salicon protocol;
                 named in the rebuild target, BASELINE.md)
  * kld        — KL divergence of sum-normalized maps

These run on host for offline evaluation parity; the port's batched
versions live in `metrics_torch.py` and are tested against these.

Resize note: the reference upsamples predictions to the fixation-map scale
with `skimage.transform.resize(order=3)`; scikit-image is not available here,
so `_resize` uses `scipy.ndimage.zoom` spline interpolation of the same order
(documented deviation; both are cubic-spline families).
"""

from __future__ import annotations

import numpy as np
import scipy.ndimage
import scipy.sparse


def normalize_range(x: np.ndarray) -> np.ndarray:
    """Min-max normalize to [0, 1] (`evaluation_metrics.py:15-17`).

    A constant map normalizes to zeros instead of the reference's 0/0 ->
    all-NaN (which made `np.arange(0, nan)` CRASH AUC_Borji/shuffled on
    one degenerate frame — e.g. a uniform softmax from an untrained
    checkpoint — aborting the whole eval). Matches the on-device
    `metrics_jax._normalize_range` guard: such frames score chance (0.5)
    rather than killing the pass."""
    x = np.asarray(x, dtype=np.float64)
    lo, hi = x.min(), x.max()
    if hi > lo:
        return (x - lo) / (hi - lo)
    return np.zeros_like(x)


# Which cubic resize family the protocol uses. "skimage" reproduces
# reference-era skimage.transform.resize(order=3) semantics (the default;
# see _resize_skimage_like); "zoom" keeps scipy.ndimage.zoom (round-1/2
# behavior). The measured score delta between the families on the
# protocol fixture is <2e-3 per metric (tests/test_metrics.py::
# test_resize_family_score_delta, recorded in PARITY.md).
RESIZE_IMPL = "skimage"


def _resize_skimage_like(x: np.ndarray, shape: tuple[int, int],
                         order: int = 3) -> np.ndarray:
    """Reference-era `skimage.transform.resize(image, shape, order=3)`.

    skimage (<=0.14, as pinned by the reference's 2017 requirements)
    implements resize as `warp` with an AffineTransform whose inverse map
    is corner-anchored pure scaling — output pixel (r, c) samples source
    coordinate (r * H_in/H_out, c * W_in/W_out) — evaluated with an
    interpolating cubic spline and constant (cval=0) padding
    (the reference's `evaluation_metrics.py:248,255`). scikit-image is not
    in this container, so the same map is evaluated directly with
    `scipy.ndimage.map_coordinates` (the routine modern skimage warp
    itself delegates to for order>1).
    """
    x = np.asarray(x, dtype=np.float64)
    if x.shape == tuple(shape):
        return x
    r = np.arange(shape[0], dtype=np.float64) * (x.shape[0] / shape[0])
    c = np.arange(shape[1], dtype=np.float64) * (x.shape[1] / shape[1])
    grid = np.meshgrid(r, c, indexing="ij")
    return scipy.ndimage.map_coordinates(x, grid, order=order,
                                         mode="constant", cval=0.0)


def _resize(x: np.ndarray, shape: tuple[int, int], order: int = 3) -> np.ndarray:
    x = np.asarray(x, dtype=np.float64)
    if x.shape == tuple(shape):
        return x
    if RESIZE_IMPL == "skimage":
        return _resize_skimage_like(x, shape, order)
    zoom = (shape[0] / x.shape[0], shape[1] / x.shape[1])
    return scipy.ndimage.zoom(x, zoom, order=order, mode="nearest")


def AUC_Judd(fixation_map: np.ndarray, saliency_map: np.ndarray,
             jitter: bool = True, rng: np.random.RandomState | None = None
             ) -> float:
    """Area under ROC with thresholds at each fixated saliency value."""
    rng = rng or np.random
    saliency_map = np.asarray(saliency_map, dtype=np.float64)
    fixation_map = np.asarray(fixation_map) > 0.5
    if not fixation_map.any():
        return float("nan")
    if saliency_map.shape != fixation_map.shape:
        saliency_map = _resize(saliency_map, fixation_map.shape)
    if jitter:
        saliency_map = saliency_map + rng.rand(*saliency_map.shape) * 1e-7
    saliency_map = normalize_range(saliency_map)

    s = saliency_map.ravel()
    f = fixation_map.ravel()
    s_fix = s[f]
    n_fix = s_fix.size
    n_pixels = s.size

    thresholds = np.sort(s_fix)[::-1]
    # Vectorized sweep: for threshold k (0-based), tp=(k+1)/n_fix and
    # fp=(#{s >= thr} - (k+1)) / (n_pixels - n_fix).
    s_sorted = np.sort(s)
    above = n_pixels - np.searchsorted(s_sorted, thresholds, side="left")
    k = np.arange(1, n_fix + 1, dtype=np.float64)
    tp = np.concatenate([[0.0], k / n_fix, [1.0]])
    fp = np.concatenate([[0.0], (above - k) / (n_pixels - n_fix), [1.0]])
    return float(np.trapezoid(tp, fp))


def AUC_Borji(fixation_map: np.ndarray, saliency_map: np.ndarray,
              n_rep: int = 100, step_size: float = 0.1,
              rand_sampler=None, rng: np.random.RandomState | None = None
              ) -> float:
    """AUC with uniform random negative samples, threshold grid of step 0.1."""
    rng = rng or np.random
    saliency_map = np.asarray(saliency_map, dtype=np.float64)
    fixation_map = np.asarray(fixation_map) > 0.5
    if not fixation_map.any():
        return float("nan")
    if saliency_map.shape != fixation_map.shape:
        saliency_map = _resize(saliency_map, fixation_map.shape)
    saliency_map = normalize_range(saliency_map)

    s = saliency_map.ravel()
    f = fixation_map.ravel()
    s_fix = s[f]
    n_fix = s_fix.size
    n_pixels = s.size

    if rand_sampler is None:
        r = rng.randint(0, n_pixels, [n_fix, n_rep])
        s_rand = s[r]
    else:
        s_rand = rand_sampler(s, f, n_rep, n_fix)

    auc = np.empty(n_rep)
    for rep in range(n_rep):
        max_val = max(s_fix.max(initial=0.0), s_rand[:, rep].max(initial=0.0))
        thresholds = np.arange(0.0, max_val, step_size)[::-1]
        tp = np.zeros(thresholds.size + 2)
        fp = np.zeros(thresholds.size + 2)
        tp[-1] = 1.0
        fp[-1] = 1.0
        tp[1:-1] = (s_fix[None, :] >= thresholds[:, None]).sum(1) / float(n_fix)
        fp[1:-1] = (s_rand[None, :, rep] >= thresholds[:, None]).sum(1) / float(n_fix)
        auc[rep] = np.trapezoid(tp, fp)
    return float(auc.mean())


def AUC_shuffled(fixation_map: np.ndarray, saliency_map: np.ndarray,
                 other_map: np.ndarray, n_rep: int = 100,
                 step_size: float = 0.1,
                 rng: np.random.RandomState | None = None) -> float:
    """AUC_Borji with negatives sampled from fixated pixels of other images."""
    rng = rng or np.random
    other_map = np.asarray(other_map) > 0.5
    if other_map.shape != np.asarray(fixation_map).shape:
        raise ValueError("other_map.shape != fixation_map.shape")

    def sample_other(s, f, n_rep, n_fix):
        fixated = np.nonzero(other_map.ravel())[0]
        rows = [rng.permutation(fixated.size)[:n_fix] for _ in range(n_rep)]
        r = fixated[np.transpose(rows)]  # [n_fix' x n_rep]
        return s[r]

    return AUC_Borji(fixation_map, saliency_map, n_rep, step_size,
                     rand_sampler=sample_other, rng=rng)


def similarity(gt_map: np.ndarray, pred_map: np.ndarray) -> float:
    """SIM: sum of elementwise min of sum-normalized maps."""
    gt = np.asarray(gt_map, dtype=np.float64)
    pred = np.asarray(pred_map, dtype=np.float64)
    gt = gt / gt.sum()
    pred = pred / pred.sum()
    return float(np.minimum(gt, pred).sum())


def cc(gt_map: np.ndarray, pred_map: np.ndarray) -> float:
    """Pearson correlation of the z-scored maps."""
    gt = np.asarray(gt_map, dtype=np.float64)
    pred = np.asarray(pred_map, dtype=np.float64)
    gt = gt - gt.mean()
    if gt.max() > 0:
        gt = gt / gt.std()
    pred = pred - pred.mean()
    if pred.max() > 0:
        pred = pred / pred.std()
    return float(np.corrcoef(pred.ravel(), gt.ravel())[0, 1])


def nss(fixation_map: np.ndarray, saliency_map: np.ndarray) -> float:
    """Normalized Scanpath Saliency: mean z-scored saliency at fixations."""
    fix = np.asarray(fixation_map) > 0.5
    if not fix.any():
        return float("nan")
    sal = np.asarray(saliency_map, dtype=np.float64)
    if sal.shape != fix.shape:
        sal = _resize(sal, fix.shape)
    sal = (sal - sal.mean()) / max(sal.std(), 1e-12)
    return float(sal[fix].mean())


def kld(gt_map: np.ndarray, pred_map: np.ndarray, eps: float = 1e-12) -> float:
    """KL(gt || pred) of sum-normalized maps (salicon protocol)."""
    gt = np.asarray(gt_map, dtype=np.float64)
    pred = np.asarray(pred_map, dtype=np.float64)
    gt = gt / gt.sum()
    pred = pred / pred.sum()
    return float(np.sum(gt * (np.log(gt + eps) - np.log(pred + eps))))


# ---------------------------------------------------------------------------
# Aggregation API (mirrors `evaluation_metrics.py:239-297`)
# ---------------------------------------------------------------------------

AVAILABLE_METRICS = ("sim", "cc", "AUC_shuffled", "AUC_Borji")
ALL_METRICS = ("sim", "cc", "nss", "kld", "AUC_Judd", "AUC_Borji",
               "AUC_shuffled")


def saliency_score_single(metric: str, pred_map, gt_map, fixation_map,
                          other_map_union=None,
                          rng: np.random.RandomState | None = None) -> float:
    """Score one frame. Pred/gt are resized (cubic) to the fixation-map scale
    and the prediction is min-max normalized first, mirroring
    `evaluation_metrics.py:239-272`."""
    if scipy.sparse.issparse(fixation_map):
        fixation_map = fixation_map.toarray()
    fixation_map = np.asarray(fixation_map)

    pred_map = normalize_range(np.asarray(pred_map, dtype=np.float64))
    pred_orig = _resize(pred_map, fixation_map.shape)
    gt_orig = _resize(np.asarray(gt_map, dtype=np.float64), fixation_map.shape)

    if metric == "cc":
        return cc(gt_orig, pred_orig)
    if metric == "sim":
        return similarity(gt_orig, pred_orig)
    if metric == "nss":
        return nss(fixation_map, pred_orig)
    if metric == "kld":
        return kld(gt_orig, pred_orig)
    if metric == "AUC_Judd":
        return AUC_Judd(fixation_map, pred_orig, rng=rng)
    if metric == "AUC_Borji":
        return AUC_Borji(fixation_map, pred_orig, rng=rng)
    if metric == "AUC_shuffled":
        if other_map_union is None:
            raise ValueError("other_map_union required for AUC_shuffled")
        return AUC_shuffled(fixation_map, pred_orig, other_map_union, rng=rng)
    raise ValueError(f"unknown metric: {metric}")


def build_other_map_union(fixation_maps,
                          rng: np.random.RandomState | None = None,
                          m: int = 10) -> np.ndarray:
    """Union of min(m, N) randomly chosen fixation maps — the AUC_shuffled
    negative set (`evaluation_metrics.py:283-287`). Handles scipy.sparse
    fixation maps (the SALICON loader stores them sparse)."""
    rng = rng or np.random

    def _dense(fm):
        return fm.toarray() if scipy.sparse.issparse(fm) else np.asarray(fm)

    m = min(m, len(fixation_maps))
    other_union = np.zeros(_dense(fixation_maps[0]).shape)
    for i in rng.choice(range(len(fixation_maps)), m, replace=False):
        fm = _dense(fixation_maps[i])
        if fm.shape != other_union.shape:
            raise ValueError(
                f"AUC_shuffled needs all fixation maps at one resolution; "
                f"got {fm.shape} vs {other_union.shape} (mixed-resolution "
                f"original-scale eval: score each dataset separately)")
        other_union += (fm > 0).astype(np.int64)
    return other_union


def saliency_scores(metric: str, pred_maps, gt_maps, fixation_maps,
                    rng: np.random.RandomState | None = None) -> list:
    """Per-frame scores for one metric (the values a scores.txt row holds);
    AUC_shuffled negatives come from the union of M=10 randomly chosen
    other fixation maps built ONCE for the whole set
    (`evaluation_metrics.py:275-295`). Building the union lazily keeps the
    other metrics working on mixed-resolution (ragged) fixation maps."""
    assert len(gt_maps) == len(pred_maps) == len(fixation_maps)
    rng = rng or np.random

    other_union = (build_other_map_union(fixation_maps, rng=rng)
                   if metric == "AUC_shuffled" and len(fixation_maps)
                   else None)
    return [
        saliency_score_single(metric, p, g, f, other_union, rng=rng)
        for p, g, f in zip(pred_maps, gt_maps, fixation_maps)
    ]


def saliency_score(metric: str, pred_maps, gt_maps, fixation_maps,
                   rng: np.random.RandomState | None = None) -> float:
    """Mean per-frame score (`evaluation_metrics.py:275-295`)."""
    scores = saliency_scores(metric, pred_maps, gt_maps, fixation_maps,
                             rng=rng)
    # nanmean, NOT the reference's np.mean (`evaluation_metrics.py:295`):
    # the per-frame metrics deliberately return NaN for frames with no
    # fixations (AUC*/NSS), and sparse original-scale evals routinely
    # contain such frames — a plain mean lets ONE empty frame poison the
    # whole score, and the on-device protocol (`eval/metrics_jax.py`)
    # already excludes those frames via nanmean. Divergence recorded in
    # PARITY.md.
    return float(np.nanmean(scores))
