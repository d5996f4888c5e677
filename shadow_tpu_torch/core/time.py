"""Simulated time types.

The reference keeps two clocks (SURVEY.md §2 "Timers & time"):

- ``SimulationTime``: nanoseconds since the simulation started.
- ``EmulatedTime``: nanoseconds since the UNIX epoch as seen by managed code;
  the simulation boots at a fixed, deterministic wall-clock instant so that
  applications reading the clock see identical values across runs.

We model both as plain ``int`` nanoseconds (Python ints are arbitrary
precision, so no overflow concerns CPU-side).
"""

from __future__ import annotations

import re

# Type aliases: both are int nanoseconds. Kept distinct in signatures for
# readability; there is deliberately no class wrapper on the hot path.
SimTime = int  # ns since simulation start
EmulatedTime = int  # ns since UNIX epoch

NS_PER_US = 1_000
NS_PER_MS = 1_000_000
NS_PER_SEC = 1_000_000_000

#: The simulation boots at 2000-01-01 00:00:00 UTC, a deterministic instant
#: (946684800 s since the epoch). Managed code reading the clock sees
#: EMULATED_EPOCH + sim_time.
EMULATED_EPOCH: EmulatedTime = 946_684_800 * NS_PER_SEC

#: Sentinel "never" time (far future, still fits comfortably in int64).
T_NEVER: SimTime = (1 << 62)


def emulated(sim_time: SimTime) -> EmulatedTime:
    """Convert simulation-relative time to the emulated wall clock."""
    return EMULATED_EPOCH + sim_time


def parse_time(value) -> SimTime:
    """Parse a config time value into ns.

    Accepts ints (seconds, matching the reference YAML's bare-number
    convention for ``stop_time``), floats (seconds), or strings with units:
    "10 ms", "1 min", "30s", "500 us", "100 ns", "1 h".
    """
    if isinstance(value, bool):
        raise ValueError(f"not a time value: {value!r}")
    if isinstance(value, int):
        return value * NS_PER_SEC
    if isinstance(value, float):
        return int(round(value * NS_PER_SEC))
    if not isinstance(value, str):
        raise ValueError(f"not a time value: {value!r}")

    s = value.strip().lower()
    m = re.fullmatch(r"([0-9.eE+-]+)\s*([a-zμ]*)", s)
    if m is None:
        raise ValueError(f"cannot parse time value {value!r}")
    num, unit = m.group(1), m.group(2)
    if unit.endswith("s") and unit not in ("s", "ns", "us", "μs", "ms"):
        unit = unit[:-1]  # strip plural: "seconds" -> "second"
    units = {
        "": NS_PER_SEC,  # bare numeric string: seconds
        "ns": 1, "nanosecond": 1,
        "us": NS_PER_US, "μs": NS_PER_US, "microsecond": NS_PER_US,
        "ms": NS_PER_MS, "msec": NS_PER_MS, "millisecond": NS_PER_MS,
        "s": NS_PER_SEC, "sec": NS_PER_SEC, "second": NS_PER_SEC,
        "m": 60 * NS_PER_SEC, "min": 60 * NS_PER_SEC, "minute": 60 * NS_PER_SEC,
        "h": 3600 * NS_PER_SEC, "hr": 3600 * NS_PER_SEC, "hour": 3600 * NS_PER_SEC,
    }
    if unit not in units:
        raise ValueError(f"unknown time unit in {value!r}")
    return int(round(float(num) * units[unit]))


def format_time(t: SimTime) -> str:
    """Human-readable rendering of a sim time (for logs)."""
    if t >= NS_PER_SEC:
        return f"{t / NS_PER_SEC:.6f}s"
    if t >= NS_PER_MS:
        return f"{t / NS_PER_MS:.3f}ms"
    if t >= NS_PER_US:
        return f"{t / NS_PER_US:.3f}us"
    return f"{t}ns"
