"""Sizes as Shadow's configs write them: a number and a unit, decimal
(``kB``, ``MB``, ``GB``) or binary (``KiB``, ``MiB``, ``GiB``); a bare
number is bytes."""

import re

UNITS = {"": 1, "b": 1, "B": 1, "byte": 1, "bytes": 1,
         "kB": 10**3, "KB": 10**3, "MB": 10**6, "GB": 10**9,
         "KiB": 2**10, "MiB": 2**20, "GiB": 2**30}
SIZE = re.compile(r"\s*([0-9.]+)\s*([A-Za-z]*)\s*")


def parse_size(text) -> int:
    m = SIZE.fullmatch(str(text))
    if m is None or m.group(2) not in UNITS:
        raise ValueError(f"not a size: {text!r}")
    return int(float(m.group(1)) * UNITS[m.group(2)])
