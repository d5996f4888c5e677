"""Counters — global and per-host object/event counters with an end-of-run
summary, mirroring the reference's counter subsystem (SURVEY.md §2
"Counters / heartbeat", §5.1c)."""

from __future__ import annotations

from collections import Counter


class Counters:
    __slots__ = ("c",)

    def __init__(self) -> None:
        self.c: Counter = Counter()

    def add(self, name: str, n: int = 1) -> None:
        self.c[name] += n

    def get(self, name: str) -> int:
        return self.c.get(name, 0)

    def merge(self, other: "Counters") -> None:
        self.c.update(other.c)

    def summary(self) -> str:
        if not self.c:
            return "counters: (none)"
        items = ", ".join(f"{k}={v}" for k, v in sorted(self.c.items()))
        return f"counters: {items}"

    def as_dict(self) -> dict:
        return dict(sorted(self.c.items()))
