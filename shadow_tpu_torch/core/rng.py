"""Deterministic random number generation.

The reference seeds one master RNG from config and derives a per-host RNG so
that host behavior is independent of scheduling order (SURVEY.md §2 "Host",
§2 parallelism item 5).  We use numpy's Philox counter-based generator keyed
by (master_seed, host_id): per-host streams are statistically independent and
reproducible regardless of which worker or round touches them.

Packet-loss sampling does NOT use these streams — it uses counter-based
threefry keyed on (seed, unit id, packet lane) so the host twin and the CUDA
kernels reproduce each other bit-for-bit (ops/prng.py).
"""

from __future__ import annotations

import numpy as np


def master_rng(seed: int) -> np.random.Generator:
    return np.random.Generator(np.random.Philox(key=np.uint64(seed)))


def host_rng(seed: int, host_id: int) -> np.random.Generator:
    """Per-host deterministic stream, independent of scheduling order."""
    return np.random.Generator(
        np.random.Philox(key=(np.uint64(seed) << np.uint64(16)) ^ np.uint64(host_id))
    )


def fault_rng(seed: int, stream: int) -> np.random.Generator:
    """Counter-based stream for fault-timeline draws (faults.py
    churn schedules), keyed on (master seed, stream id) in a domain separate
    from the host streams. Schedules are materialized once at startup from
    these draws, so they are reproducible and independent of scheduler
    policy, data plane, and event interleaving."""
    key = ((np.uint64(seed) << np.uint64(16)) ^ np.uint64(stream)
           ^ np.uint64(0xFA17 << 48))
    return np.random.Generator(np.random.Philox(key=key))
