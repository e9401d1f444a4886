"""The program's own spans and counters (`train.profiler` of the port),
read once the traced window has closed: they record only while a torch
profiler does, so the process's buffer holds that window's.

A unit of work (a train step, a served request, a batch's put or wait) is
counted only where its root span was recorded, and a child only under a
recorded root: a span that was open when the profiler started is not
recorded, and its children, which opened inside the window, have no
parent. A program that keeps no records reads as None.
"""

from __future__ import annotations

from typing import Optional


def program_records() -> Optional[list]:
    """The program's span records, or None where it keeps none."""
    try:
        from recurrent_gaze_prediction_tpu_torch.train import profiler
    except ImportError:
        return None
    records = getattr(profiler, "records", None)
    return None if records is None else records()


def ms(record: dict) -> float:
    return (record["end_ns"] - record["start_ns"]) * 1e-6


def roots(records: list, name: str) -> list:
    """The recorded units `name`: spans of that name with no parent."""
    return [r for r in records if r["name"] == name and r["parent"] is None]


def children(records: list, units: list, name: str) -> list:
    """The spans `name` opened directly inside one of `units`."""
    ids = {u["id"] for u in units}
    return [r for r in records if r["name"] == name and r["parent"] in ids]


def mean_ms(records: Optional[list], root: str) -> Optional[float]:
    """The mean time of the recorded units `root`, ms."""
    units = roots(records or [], root)
    return sum(map(ms, units)) / len(units) if units else None


def per_unit_ms(records: Optional[list], root: str,
                child: str) -> Optional[float]:
    """The time of the spans `child` opened directly inside the recorded
    units `root`, ms per unit."""
    units = roots(records or [], root)
    if not units:
        return None
    return sum(map(ms, children(records, units, child))) / len(units)


def mean_count(records: Optional[list], root: str,
               counter: str) -> Optional[float]:
    """The mean of `counter` over the recorded units `root` that counted
    it."""
    values = [u["counts"][counter] for u in roots(records or [], root)
              if (u.get("counts") or {}).get(counter) is not None]
    return sum(values) / len(values) if values else None
