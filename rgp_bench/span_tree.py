"""Spans and counters under a recorded unit at any depth (`spans.py` reads
a unit's direct children): each record joined to the outermost recorded
span above it by the records' parent links."""

from __future__ import annotations

from typing import Optional

from rgp_bench import spans


def by_unit(records: list, root: str) -> dict:
    """{id of a recorded unit `root`: [the unit, then every record opened
    inside it at any depth]}."""
    by_id = {r["id"]: r for r in records}
    top: dict = {}

    def top_of(r: dict) -> int:
        path = []
        while r["id"] not in top and r["parent"] in by_id:
            path.append(r["id"])
            r = by_id[r["parent"]]
        found = top.get(r["id"], r["id"])
        for i in path + [r["id"]]:
            top[i] = found
        return found

    units = {u["id"]: [u] for u in spans.roots(records, root)}
    for r in records:
        t = top_of(r)
        if t in units and t != r["id"]:
            units[t].append(r)
    return units


def per_unit_ms(records: Optional[list], root: str,
                name: str) -> Optional[float]:
    """The time of the spans `name` at any depth under the recorded units
    `root`, ms per unit; None where no unit holds such a span."""
    units = by_unit(records or [], root)
    inside = [r for group in units.values() for r in group[1:]
              if r["name"] == name]
    if not inside:
        return None
    return sum(map(spans.ms, inside)) / len(units)


def per_unit_count(records: Optional[list], root: str,
                   counter: str) -> Optional[float]:
    """`counter` summed over each recorded unit `root` and the records
    inside it, the mean over the units that counted it; None where none
    did."""
    totals = []
    for group in by_unit(records or [], root).values():
        counted = [(r.get("counts") or {}).get(counter) for r in group]
        counted = [n for n in counted if n is not None]
        if counted:
            totals.append(sum(counted))
    return sum(totals) / len(totals) if totals else None
