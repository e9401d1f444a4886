"""The comparison that decides `correct`: each number the reference
comparison produced against the cell's limit on it
(`rgp_bench/limits/<workload>.json`, each set in PERF.md from the sound
program's readings and the control's). A number passes when it is finite
and at most its limit; a missing number fails."""

from __future__ import annotations

import math

import torch


def judge(readings: dict, limits: dict) -> tuple:
    """-> (correct, {name: {"value", "limit"}}) over the cell's limits."""
    checks, ok = {}, True
    for name, limit in limits.items():
        value = readings.get(name)
        good = (isinstance(value, float) and math.isfinite(value)
                and value <= limit)
        ok = ok and good
        checks[name] = {"value": value, "limit": limit}
    return ok, checks


def map_l1(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """The L1 distance of each map pair (the sum over 49x49 of |p - r|, 0
    for equal maps, 2 for disjoint ones): [..., 49, 49] -> [...]."""
    return (got.double() - want.double()).abs().flatten(-2).sum(-1)


def map_spread(maps: list) -> float:
    """The mean L1 distance between the maps of two different videos at one
    timestep, over every pair in each [videos, T, 49, 49] tensor of
    `maps`."""
    total, pairs = 0.0, 0
    for m in maps:
        d = map_l1(m[:, None], m[None, :])        # [V, V, T]
        v = m.shape[0]
        total += float(d.sum())
        pairs += v * (v - 1) * m.shape[1]
    return total / pairs


def leaf_diffs(got: dict, want: dict) -> dict:
    """Each leaf's |got - want| (the norm of the difference), over the
    larger of that leaf's reference norm and the median leaf's."""
    norms = {n: float(want[n].double().norm()) for n in want}
    median = float(torch.tensor(list(norms.values())).median())
    return {n: float((got[n].double() - want[n].double()).norm())
            / max(norms[n], median, 1e-30) for n in want}


def leaf_gaps(got: dict, want: dict) -> dict:
    """Each leaf's gap | |got| - |want| | between the norms of two sets of
    tensors, over the larger of that leaf's reference norm and the median
    leaf's."""
    norms = {n: float(want[n].double().norm()) for n in want}
    median = float(torch.tensor(list(norms.values())).median())
    return {n: abs(float(got[n].double().norm()) - norms[n])
            / max(norms[n], median, 1e-30) for n in want}
