"""Streaming log-bucket histograms for deterministic percentiles.

A copy of shadow_tpu/telemetry/histogram.py.

The fixed bucket layout is the whole point: every run, plane, and policy
that observes the same sample multiset produces the same bucket counts,
so histogram state can be merged (bucket-wise addition), hashed, carried
through a checkpoint, and reduced to percentiles with pure integer math —
no stored sample lists, no float accumulation order to diverge.

Layout (HDR-histogram shaped, integers >= 0):
- values below ``2**(SUB_BITS + 1)`` are exact (one bucket per value);
- above that, each power-of-two octave splits into ``2**SUB_BITS``
  sub-buckets, giving a fixed ~``2**-SUB_BITS`` relative resolution
  (~3% at the default SUB_BITS = 5) at any magnitude.

Percentiles report the LOWER BOUND of the bucket containing the target
rank — a deterministic, conservative convention (the true quantile lies
within one bucket width above it). Ranks use ceil(q * n) in exact integer
arithmetic, the "nearest-rank" definition.
"""

from __future__ import annotations

SUB_BITS = 5
_SUB = 1 << SUB_BITS
_EXACT = _SUB << 1  # values below this get exact buckets


def bucket_index(v: int) -> int:
    """Map a non-negative integer sample to its fixed bucket index."""
    if v < _EXACT:
        return v
    e = v.bit_length() - 1  # e >= SUB_BITS + 1
    sub = (v >> (e - SUB_BITS)) & (_SUB - 1)
    return _EXACT + (e - SUB_BITS - 1) * _SUB + sub


def bucket_lower_bound(idx: int) -> int:
    """Smallest value mapping to bucket ``idx`` (inverse of bucket_index
    at bucket granularity)."""
    if idx < _EXACT:
        return idx
    g, sub = divmod(idx - _EXACT, _SUB)
    e = g + SUB_BITS + 1
    return (1 << e) + (sub << (e - SUB_BITS))


class LogHistogram:
    """Sparse fixed-layout log histogram of non-negative integers."""

    __slots__ = ("counts", "total")

    def __init__(self) -> None:
        self.counts: dict[int, int] = {}
        self.total = 0

    def add(self, v: int) -> None:
        if v < 0:
            v = 0
        idx = bucket_index(v)
        self.counts[idx] = self.counts.get(idx, 0) + 1
        self.total += 1

    def merge(self, other: "LogHistogram") -> None:
        for idx, n in other.counts.items():
            self.counts[idx] = self.counts.get(idx, 0) + n
        self.total += other.total

    def percentile(self, num: int, den: int) -> int:
        """Value at quantile num/den (e.g. 999, 1000 for p99.9): the lower
        bound of the bucket holding the ceil(q * total)-th sample (1-based
        nearest rank). Returns 0 for an empty histogram."""
        if self.total == 0:
            return 0
        rank = (self.total * num + den - 1) // den
        if rank < 1:
            rank = 1
        seen = 0
        for idx in sorted(self.counts):
            seen += self.counts[idx]
            if seen >= rank:
                return bucket_lower_bound(idx)
        return bucket_lower_bound(max(self.counts))  # unreachable

    def quantiles_ns_to_ms(self) -> dict:
        """The standard latency reduction: p50/p90/p99/p99.9 of ns samples
        reported in milliseconds (3 decimals, deterministic rounding)."""
        out = {}
        for label, num, den in (("p50", 50, 100), ("p90", 90, 100),
                                ("p99", 99, 100), ("p99_9", 999, 1000)):
            out[f"{label}_ms"] = round(self.percentile(num, den) / 1e6, 3)
        return out

    def state(self) -> dict:
        """Canonical serializable state (sorted bucket -> count)."""
        return {"total": self.total,
                "counts": {str(k): self.counts[k]
                           for k in sorted(self.counts)}}

    @classmethod
    def from_state(cls, d: dict) -> "LogHistogram":
        """Rebuild from state() output — the cross-process merge path
        (shard workers ship their histogram states to the parent, which
        merges them bucket-wise; mergeable by construction)."""
        h = cls()
        h.total = int(d["total"])
        h.counts = {int(k): int(v) for k, v in d["counts"].items()}
        return h

    @classmethod
    def merged(cls, states: list) -> "LogHistogram":
        """K-way merge of many state() dicts into one histogram — the
        cross-SEED reduction (the reference's fleet sweeps): pooled percentiles
        over every seed's samples. Bucket-wise addition is commutative
        and associative, so the merge order cannot change the result
        (shuffled orders give byte-identical states)."""
        h = cls()
        for st in states:
            h.merge(cls.from_state(st))
        return h
