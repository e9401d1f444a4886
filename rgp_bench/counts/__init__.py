"""The yardstick's arithmetic: the chip's published peaks and the
operations and bytes each part of a cell needs, counted from its shapes
alone (never from the program's own counters), 2 operations per
multiply-add. Work that the program recomputes is not counted."""
