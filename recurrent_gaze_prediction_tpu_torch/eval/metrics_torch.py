"""Saliency metrics, batched on the maps' device: the port's counterpart of
the JAX package's `eval/metrics_jax.py`.

Every metric takes [N, H, W] stacks (tensors on the card, or on the CPU)
and returns [N] scores in f32, so a whole evaluation is a few batched
reductions instead of the reference's per-frame NumPy loop
(`evaluation_metrics.py`, kept as `metrics_np.py`).

Variable-length structures are handled with fixed capacities and masks,
as in the JAX package:

  * AUC_Judd: thresholds are the top-`max_fix` fixated saliency values per
    frame; rows past the true fixation count collapse onto the (1, 1) ROC
    endpoint and add zero area, so the trapezoid sum is exact.
  * AUC_Borji / AUC_shuffled: the reference sweeps `arange(0, max, 0.1)`
    over min-max-normalized maps, so a fixed descending grid
    {0.9, ..., 0.0} is used; thresholds above a frame's max land on the
    (0, 0) endpoint and add zero area.
  * random draws (AUC_Judd's tie-breaking jitter, the samplers, the
    AUC_shuffled other-map union) come from a `torch.Generator` on the
    maps' device in place of the JAX package's keys. The two packages'
    streams differ, so only the deterministic paths (exact AUCs, no
    jitter, an explicit other map) agree value for value.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

AVAILABLE_METRICS = ("sim", "cc", "AUC_shuffled", "AUC_Borji")
ALL_METRICS = ("sim", "cc", "nss", "kld", "AUC_Judd", "AUC_Borji",
               "AUC_shuffled")


def _flatten(maps: torch.Tensor) -> torch.Tensor:
    return maps.reshape(maps.shape[0], -1)


def _normalize_range(x: torch.Tensor) -> torch.Tensor:
    """Min-max normalize each row in x's own dtype; a constant row -> 0."""
    lo = x.amin(dim=-1, keepdim=True)
    hi = x.amax(dim=-1, keepdim=True)
    return (x - lo) / torch.where(hi > lo, hi - lo, torch.ones_like(hi))


def _sum_normalize(x: torch.Tensor) -> torch.Tensor:
    # plain division, like the golden: an all-zero map propagates NaN
    # through sim/kld instead of silently scoring garbage
    return x / x.sum(dim=-1, keepdim=True)


def _generator(generator: Optional[torch.Generator],
               device: torch.device) -> torch.Generator:
    return (generator if generator is not None
            else torch.Generator(device=device).manual_seed(0))


def cc_batch(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Pearson correlation per map (`evaluation_metrics.py:221-236`)."""
    p = _flatten(pred).float()
    g = _flatten(gt).float()
    p = p - p.mean(dim=-1, keepdim=True)
    g = g - g.mean(dim=-1, keepdim=True)
    num = (p * g).sum(dim=-1)
    den = torch.sqrt((p * p).sum(dim=-1) * (g * g).sum(dim=-1))
    # constant map -> NaN, matching np.corrcoef in the golden
    safe = torch.where(den > 0, den, torch.ones_like(den))
    return torch.where(den > 0, num / safe, torch.full_like(den, torch.nan))


def sim_batch(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """SIM: intersection of sum-normalized maps
    (`evaluation_metrics.py:207-218`)."""
    p = _sum_normalize(_flatten(pred).float())
    g = _sum_normalize(_flatten(gt).float())
    return torch.minimum(p, g).sum(dim=-1)


def nss_batch(pred: torch.Tensor, fixation: torch.Tensor) -> torch.Tensor:
    """NSS: mean z-scored saliency at fixated pixels (population std, as
    `jnp.std`); NaN for a frame without fixations."""
    p = _flatten(pred).float()
    f = _flatten(fixation) > 0.5
    mean = p.mean(dim=-1, keepdim=True)
    std = p.std(dim=-1, keepdim=True, correction=0)
    z = (p - mean) / torch.clamp(std, min=1e-12)
    n_fix = f.sum(dim=-1)
    score = torch.where(f, z, torch.zeros_like(z)).sum(dim=-1) / torch.clamp(
        n_fix, min=1)
    return torch.where(n_fix > 0, score, torch.full_like(score, torch.nan))


def kld_batch(pred: torch.Tensor, gt: torch.Tensor,
              eps: float = 1e-12) -> torch.Tensor:
    """KL(gt || pred) of sum-normalized maps."""
    p = _sum_normalize(_flatten(pred).float())
    g = _sum_normalize(_flatten(gt).float())
    return (g * (torch.log(g + eps) - torch.log(p + eps))).sum(dim=-1)


def _trapezoid(tp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """Area under the (fp, tp) curve over the last axis, with the (0, 0)
    and (1, 1) endpoints added."""
    zeros = tp.new_zeros(tp.shape[:-1] + (1,))
    ones = tp.new_ones(tp.shape[:-1] + (1,))
    tp = torch.cat([zeros, tp, ones], dim=-1)
    fp = torch.cat([zeros, fp, ones], dim=-1)
    return (0.5 * (tp[..., 1:] + tp[..., :-1])
            * (fp[..., 1:] - fp[..., :-1])).sum(dim=-1)


def _nan_without_fixations(area: torch.Tensor,
                           n_fix: torch.Tensor) -> torch.Tensor:
    return torch.where(n_fix > 0, area, torch.full_like(area, torch.nan))


def auc_judd_batch(pred: torch.Tensor, fixation: torch.Tensor,
                   generator: Optional[torch.Generator] = None,
                   max_fix: int = 64, jitter: bool = True) -> torch.Tensor:
    """Batched AUC-Judd (`evaluation_metrics.py:42-98`).

    Threshold sweep over the (top `max_fix`) fixated saliency values of
    each frame; exact when every frame has <= max_fix fixated pixels.
    """
    s = _flatten(pred).float()
    f = _flatten(fixation) > 0.5
    n, p_pixels = s.shape
    max_fix = min(max_fix, p_pixels)

    if jitter:
        gen = _generator(generator, s.device)
        s = s + torch.rand(s.shape, generator=gen, device=s.device) * 1e-7
    s = _normalize_range(s)

    n_fix = f.sum(dim=-1)
    # top-K fixated values, descending; padded with -inf
    fix_vals = torch.where(f, s, torch.full_like(s, -torch.inf))
    thresholds = torch.topk(fix_vals, max_fix, dim=-1).values

    # above[i, k] = #{ s[i] >= thresholds[i, k] }
    s_sorted = torch.sort(s, dim=-1).values
    idx = torch.searchsorted(s_sorted, thresholds.contiguous(), right=False)
    above = (p_pixels - idx).float()

    k = torch.arange(1, max_fix + 1, dtype=torch.float32,
                     device=s.device)[None, :]
    valid = k <= n_fix[:, None]
    nf = torch.clamp(n_fix, min=1).float()[:, None]
    one = torch.ones((), device=s.device)
    tp = torch.where(valid, k / nf, one)
    fp = torch.where(valid, (above - k) / torch.clamp(p_pixels - nf, min=1.0),
                     one)
    return _nan_without_fixations(_trapezoid(tp, fp), n_fix)


def _auc_from_samples(s_fix: torch.Tensor, fix_valid: torch.Tensor,
                      s_rand: torch.Tensor, rand_valid: torch.Tensor,
                      n_thresholds: int = 10,
                      step: float = 0.1) -> torch.Tensor:
    """Shared Borji-style AUC of the samplers: fixed descending threshold
    grid {(n-1)*step, ..., 0}; tp/fp normalized by the true fixation
    count. s_fix [N, K], s_rand [N, R, K]."""
    grid = torch.arange(n_thresholds - 1, -1, -1, dtype=torch.float32,
                        device=s_fix.device) * step
    n_fix = fix_valid.sum(dim=-1).float()
    nf = torch.clamp(n_fix, min=1.0)

    tp_counts = ((s_fix[:, None, :] >= grid[None, :, None])
                 & fix_valid[:, None, :]).sum(dim=-1).float()   # [N, T]
    tp = tp_counts / nf[:, None]
    fp_counts = ((s_rand[:, :, None, :] >= grid[None, None, :, None])
                 & rand_valid[:, :, None, :]).sum(dim=-1).float()  # [N, R, T]
    fp = fp_counts / nf[:, None, None]
    area = _trapezoid(tp[:, None, :].expand(fp.shape), fp)     # [N, R]
    return _nan_without_fixations(area.mean(dim=-1), n_fix)


def _exact_auc(s: torch.Tensor, f: torch.Tensor,
               other_f: Optional[torch.Tensor]) -> torch.Tensor:
    """The closed-form expectation of the Borji (other_f None) or shuffled
    sampler on the 0.1 grid: the trapezoid area is linear in fp, so
    E[area] = area(E[fp])."""
    grid = torch.arange(9, -1, -1, dtype=torch.float32, device=s.device) * 0.1
    ge = s[:, None, :] >= grid[None, :, None]                  # [N, T, P]
    n_fix = f.sum(dim=-1)
    nf = torch.clamp(n_fix, min=1).float()
    tp = (ge & f[:, None, :]).sum(dim=-1) / nf[:, None]
    if other_f is None:
        fp = ge.float().mean(dim=-1)                           # = E[fp_t]
    else:
        n_other = other_f.sum()
        q = ((ge & other_f[None, None, :]).sum(dim=-1)
             / torch.clamp(n_other, min=1).float())            # [N, T]
        cap = torch.minimum(n_fix, n_other).float()
        fp = (cap / nf)[:, None] * q
    return _nan_without_fixations(_trapezoid(tp, fp), n_fix)


def _fixated_values(s: torch.Tensor, f: torch.Tensor, max_fix: int):
    """Fixated values packed into capacity K (descending, -inf padded),
    the 1-based slot index k, the fixation counts and the slots' mask."""
    s_fix = torch.topk(torch.where(f, s, torch.full_like(s, -torch.inf)),
                       max_fix, dim=-1).values
    k = torch.arange(1, max_fix + 1, device=s.device)[None, :]
    n_fix = f.sum(dim=-1)
    return s_fix, k, n_fix, k <= n_fix[:, None]


def auc_borji_batch(pred: torch.Tensor, fixation: torch.Tensor,
                    generator: Optional[torch.Generator] = None,
                    max_fix: int = 64, n_rep: int = 100,
                    exact: bool = True) -> torch.Tensor:
    """Batched AUC-Borji (`evaluation_metrics.py:101-164`): negatives are
    uniform random pixels, as many as fixations, n_rep repeats.

    `exact=True` (default) computes the estimator's expectation in closed
    form (E[fp_t] is the fraction of pixels >= grid_t): the value the
    reference's Monte-Carlo converges to, with no sampling variance.
    `exact=False` keeps the faithful sampler.
    """
    s = _normalize_range(_flatten(pred).float())
    f = _flatten(fixation) > 0.5
    n, p_pixels = s.shape
    if exact:
        return _exact_auc(s, f, None)

    s_fix, _, _, fix_valid = _fixated_values(s, f, min(max_fix, p_pixels))
    max_fix = s_fix.shape[1]
    gen = _generator(generator, s.device)
    r = torch.randint(0, p_pixels, (n, n_rep * max_fix), generator=gen,
                      device=s.device)
    s_rand = torch.gather(s, 1, r).reshape(n, n_rep, max_fix)
    rand_valid = fix_valid[:, None, :].expand(s_rand.shape)
    return _auc_from_samples(s_fix, fix_valid, s_rand, rand_valid)


def auc_shuffled_batch(pred: torch.Tensor, fixation: torch.Tensor,
                       other_map: torch.Tensor,
                       generator: Optional[torch.Generator] = None,
                       max_fix: int = 64, n_rep: int = 100,
                       max_other: Optional[int] = None,
                       exact: bool = True) -> torch.Tensor:
    """Batched shuffled AUC (`evaluation_metrics.py:167-204`): negatives
    are drawn (without replacement, per repeat) from the pixels fixated in
    `other_map`, the union of M other frames' fixation maps.

    `exact=True` (default) is the sampler's closed-form expectation: for
    min(n_fix, n_other) draws without replacement from the other-fixated
    pixels, E[fp_t] = (cap / n_fix) * q_t with q_t the fraction of
    other-fixated pixels >= grid_t. With `exact=False`, `max_other` bounds
    the candidate set the sampler permutes (faithful when the other map
    has <= max_other fixated pixels; `evaluate_batch` sizes it from the
    union); None means all pixels.
    """
    s = _normalize_range(_flatten(pred).float())
    f = _flatten(fixation) > 0.5
    n, p_pixels = s.shape
    other = other_map.reshape(-1) > 0.5                        # [P]
    if exact:
        return _exact_auc(s, f, other)

    s_fix, k, n_fix, fix_valid = _fixated_values(s, f,
                                                 min(max_fix, p_pixels))
    max_fix = s_fix.shape[1]
    n_other = other.sum()
    mo = min(max_other if max_other is not None else p_pixels, p_pixels)

    # candidate slots: indices of (up to mo) other-fixated pixels
    cand_hit, cand_idx = torch.topk(other.float(), mo)
    cand_valid = cand_hit > 0.5                                # [mo]
    s_cand = s[:, cand_idx]                                    # [N, mo]

    # a random permutation of the candidate slots per (frame, repeat):
    # rank by uniform noise, invalid slots pushed to the end; keep K
    kk = min(max_fix, mo)
    gen = _generator(generator, s.device)
    noise = torch.rand((n, n_rep, mo), generator=gen, device=s.device)
    noise = torch.where(cand_valid[None, None, :], noise,
                        torch.full_like(noise, 2.0))
    neg_noise, neg_slot = torch.topk(-noise, kk, dim=-1)       # [N, R, kk]
    s_rand = torch.gather(s_cand, 1, neg_slot.reshape(n, -1)).reshape(
        n, n_rep, kk)
    sel_valid = neg_noise > -1.5   # the selected slot was a real candidate
    if kk < max_fix:
        pad = (0, max_fix - kk)
        s_rand = torch.nn.functional.pad(s_rand, pad)
        sel_valid = torch.nn.functional.pad(sel_valid, pad)

    # valid negatives: slot index < min(n_fix, n_other), a real candidate
    cap = torch.minimum(n_fix, n_other)
    rand_valid = ((k[None, :, :] <= cap[:, None, None]) & sel_valid
                  & fix_valid[:, None, :])
    return _auc_from_samples(s_fix, fix_valid, s_rand, rand_valid)


# ---------------------------------------------------------------------------
# Aggregate evaluation
# ---------------------------------------------------------------------------


def _preamble_stats(fixation: torch.Tensor,
                    other_map: torch.Tensor) -> tuple[int, int]:
    """(densest per-frame fixation count, other-union fixated-pixel
    count), read back from the device in one transfer."""
    dens = (_flatten(fixation) > 0.5).sum(dim=-1).max()
    n_other = (other_map > 0.5).sum()
    dens, n_other = torch.stack([dens, n_other]).tolist()
    return int(dens), int(n_other)


def build_other_map_union(fixations: torch.Tensor,
                          generator: Optional[torch.Generator] = None,
                          m: int = 10) -> torch.Tensor:
    """Union of M randomly chosen fixation maps
    (`evaluation_metrics.py:283-287`); M is capped at the population size.

    The choice is the port's own seeded draw (`torch.randperm` from
    `generator`, seed 0 when None): it cannot reproduce the JAX package's
    `jax.random.choice` stream, so the two packages' AUC_shuffled agree
    only when the caller passes the same `other_map` to both."""
    n = fixations.shape[0]
    gen = _generator(generator, fixations.device)
    idx = torch.randperm(n, generator=gen, device=fixations.device)[:min(m, n)]
    return (fixations[idx] > 0).sum(dim=0)


def _evaluate_chunk(pred: torch.Tensor, gt: torch.Tensor,
                    fixation: torch.Tensor, other_map: torch.Tensor,
                    generator: torch.Generator, metrics: Sequence[str],
                    max_fix: int, n_rep: int, max_other: Optional[int],
                    exact: bool) -> dict:
    # range-normalized in pred's own dtype; each metric then casts to f32
    norm_pred = _normalize_range(_flatten(pred)).reshape(pred.shape)
    out = {}
    for metric in metrics:
        if metric == "cc":
            out[metric] = cc_batch(norm_pred, gt)
        elif metric == "sim":
            out[metric] = sim_batch(norm_pred, gt)
        elif metric == "nss":
            out[metric] = nss_batch(norm_pred, fixation)
        elif metric == "kld":
            out[metric] = kld_batch(norm_pred, gt)
        elif metric == "AUC_Judd":
            out[metric] = auc_judd_batch(norm_pred, fixation, generator,
                                         max_fix=max_fix)
        elif metric == "AUC_Borji":
            out[metric] = auc_borji_batch(norm_pred, fixation, generator,
                                          max_fix=max_fix, n_rep=n_rep,
                                          exact=exact)
        elif metric == "AUC_shuffled":
            out[metric] = auc_shuffled_batch(norm_pred, fixation, other_map,
                                             generator, max_fix=max_fix,
                                             n_rep=n_rep, max_other=max_other,
                                             exact=exact)
        else:
            raise ValueError(f"unknown metric: {metric}")
    return out


@torch.no_grad()
def evaluate_batch(pred: torch.Tensor, gt: torch.Tensor,
                   fixation: torch.Tensor,
                   generator: Optional[torch.Generator] = None,
                   metrics: Sequence[str] = AVAILABLE_METRICS,
                   other_map: Optional[torch.Tensor] = None,
                   max_fix: int = 64, n_rep: int = 100,
                   chunk_size: Optional[int] = None,
                   exact: bool = True) -> dict:
    """Per-frame scores for each metric, {metric: [N] f32} on pred's device.

    Predictions are min-max normalized first (`evaluation_metrics.py:245`),
    in their own dtype. All maps share one [N, H, W] shape: the on-device
    protocol scores at gazemap scale; the original-scale protocol is
    `metrics_np`. `generator` (on the maps' device; seed 0 when None)
    draws the other-map union when `other_map` is None, AUC_Judd's jitter
    and, with `exact=False`, the samplers.

    Frames run in `chunk_size` slices, the last one padded to the chunk
    shape and its padding sliced off, as in the JAX package. The exact
    AUC paths form [chunk, 10, H*W] comparison tensors, so the default
    chunk budgets a fixed chunk*H*W working set (8192 frames at 49x49);
    the samplers' [chunk, n_rep, ...] tensors get 512 frames. The
    AUC_shuffled other map is the union over the WHOLE fixation set,
    built before chunking (`evaluation_metrics.py:283-287`).
    """
    if chunk_size is None:
        if exact:
            pixels = max(int(pred.shape[-2]) * int(pred.shape[-1]), 1)
            chunk_size = max(min(8192, (8192 * 49 * 49) // pixels), 64)
        else:
            chunk_size = 512
    generator = _generator(generator, pred.device)
    pred = pred.reshape(pred.shape[0], *pred.shape[-2:])
    n = pred.shape[0]
    if other_map is None:
        if "AUC_shuffled" in metrics:
            other_map = build_other_map_union(fixation, generator)
        else:
            other_map = fixation.new_zeros(fixation.shape[-2:])
    max_other = None
    needs_capacity = ("AUC_Judd" in metrics
                      or (not exact and any(m.startswith("AUC")
                                            for m in metrics)))
    if needs_capacity:
        # AUC_Judd and the samplers need threshold capacity >= the densest
        # fixation map; a power of two, as in the JAX package (the exact
        # Borji / shuffled paths work on full pixel masks)
        densest, n_other = _preamble_stats(fixation, other_map)
        if densest > max_fix:
            max_fix = 1 << (densest - 1).bit_length()
        if not exact and "AUC_shuffled" in metrics:
            max_other = min(1 << (max(n_other, 1) - 1).bit_length(),
                            pred.shape[-2] * pred.shape[-1])

    args = (other_map, generator, tuple(metrics), max_fix, n_rep, max_other,
            exact)
    if n <= chunk_size:
        return _evaluate_chunk(pred, gt, fixation, *args)

    def pad_to(x: torch.Tensor, size: int) -> torch.Tensor:
        return torch.cat([x, x.new_zeros((size - x.shape[0],) + x.shape[1:])])

    pieces: list[dict] = []
    for start in range(0, n, chunk_size):
        sl = slice(start, min(start + chunk_size, n))
        p, g, f = pred[sl], gt[sl], fixation[sl]
        valid = p.shape[0]
        if valid < chunk_size:
            p, g, f = (pad_to(x, chunk_size) for x in (p, g, f))
        out = _evaluate_chunk(p, g, f, *args)
        pieces.append({m: v[:valid] for m, v in out.items()})
    return {m: torch.cat([piece[m] for piece in pieces]) for m in pieces[0]}
