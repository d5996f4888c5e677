"""Unit parsing for config values (bandwidth, sizes).

The reference's YAML uses human-unit strings like ``1 Gbit`` for host
bandwidths and ``16 MiB`` for buffer sizes (SURVEY.md §5.6).  We normalize:

- bandwidth -> bytes per second (int)
- sizes     -> bytes (int)

Bit units are decimal (1 Gbit = 1e9 bit); byte units support both decimal
(kB/MB/GB) and binary (KiB/MiB/GiB) prefixes.
"""

from __future__ import annotations

_BIT_PREFIX = {
    "": 1, "k": 10**3, "kilo": 10**3, "m": 10**6, "mega": 10**6,
    "g": 10**9, "giga": 10**9, "t": 10**12, "tera": 10**12,
    # base-1024 bit prefixes (tornettools emits "... Kibit" bandwidths)
    "ki": 2**10, "kibi": 2**10, "mi": 2**20, "mebi": 2**20,
    "gi": 2**30, "gibi": 2**30, "ti": 2**40, "tebi": 2**40,
}

_BYTE_UNITS = {
    "b": 1, "byte": 1, "bytes": 1,
    "kb": 10**3, "kilobyte": 10**3, "kilobytes": 10**3,
    "mb": 10**6, "megabyte": 10**6, "megabytes": 10**6,
    "gb": 10**9, "gigabyte": 10**9, "gigabytes": 10**9,
    "tb": 10**12, "terabyte": 10**12, "terabytes": 10**12,
    "kib": 2**10, "kibibyte": 2**10, "kibibytes": 2**10,
    "mib": 2**20, "mebibyte": 2**20, "mebibytes": 2**20,
    "gib": 2**30, "gibibyte": 2**30, "gibibytes": 2**30,
    "tib": 2**40, "tebibyte": 2**40, "tebibytes": 2**40,
}


def _split_num_unit(s: str) -> tuple[float, str, str]:
    """Returns (number, lowercased unit, raw-case unit)."""
    s = s.strip()
    i = 0
    while i < len(s) and (s[i].isdigit() or s[i] in ".+-eE"):
        # guard against consuming the 'e' of a unit like "eb": require the
        # char after 'e'/'E' to be a digit or sign for it to count as exponent
        if s[i] in "eE" and not (i + 1 < len(s) and (s[i + 1].isdigit() or s[i + 1] in "+-")):
            break
        i += 1
    num = s[:i].strip()
    raw = s[i:].strip().replace(" ", "")
    if not num:
        raise ValueError(f"no numeric part in {s!r}")
    return float(num), raw.lower(), raw


def parse_bandwidth(value) -> int:
    """Parse a bandwidth config value into bytes/second.

    Accepts ints (bits/s? no — the reference convention is unit-suffixed
    strings; a bare int is taken as bytes/second), or strings:
    "1 Gbit" (per second implied), "10 Mbit/s", "125 MB/s", "1000 kibibyte/s".
    """
    if isinstance(value, (int, float)) and not isinstance(value, bool):
        return int(value)
    num, unit, raw = _split_num_unit(str(value))
    if raw.endswith("Bps"):  # capital B: bytes/sec (MBps = megabytes/s)
        base = unit[:-3]
        if base in _BIT_PREFIX:
            return int(num * _BIT_PREFIX[base])
    if unit.endswith("bps"):  # Mbps/Gbps/kbps are bit units
        base = unit[:-3]
        if base in _BIT_PREFIX:
            return int(num * _BIT_PREFIX[base] / 8)
    for suffix in ("/s", "ps", "persec", "persecond"):
        if unit.endswith(suffix) and unit not in _BYTE_UNITS:
            unit = unit[: -len(suffix)]
            break
    if unit.endswith("bit") or unit.endswith("bits"):
        base = unit[: unit.rindex("bit")]
        if base not in _BIT_PREFIX:
            raise ValueError(f"unknown bandwidth unit in {value!r}")
        return int(num * _BIT_PREFIX[base] / 8)
    if unit in _BYTE_UNITS:
        return int(num * _BYTE_UNITS[unit])
    raise ValueError(f"unknown bandwidth unit in {value!r}")


def parse_size(value) -> int:
    """Parse a size config value into bytes. Bare numbers are bytes."""
    if isinstance(value, (int, float)) and not isinstance(value, bool):
        return int(value)
    num, unit, _raw = _split_num_unit(str(value))
    if unit in _BYTE_UNITS:
        return int(num * _BYTE_UNITS[unit])
    if unit == "":
        return int(num)
    if unit.endswith("bit") or unit.endswith("bits"):
        base = unit[: unit.rindex("bit")]
        if base in _BIT_PREFIX:
            return int(num * _BIT_PREFIX[base] / 8)
    raise ValueError(f"unknown size unit in {value!r}")
