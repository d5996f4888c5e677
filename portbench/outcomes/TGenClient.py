"""A tgen client (args: size, count, mode, port, peer, ...) fetches
``count`` transfers of ``size`` bytes from each peer; each completed
transfer logs ``transfer-complete peer=<peer> bytes=<got> ...``."""

import re

from portbench.units import parse_size

LINE = re.compile(r"\] transfer-complete peer=(\S+) bytes=(\d+) ")


def expected(args) -> int:
    return int(args[1]) * len(args[4:])


def found(args, lines, apps) -> int:
    size, count, peers = parse_size(args[0]), int(args[1]), args[4:]
    done = dict.fromkeys(peers, 0)
    stray = 0
    for line in lines:
        m = LINE.search(line)
        if m is None:
            continue
        if m.group(1) in done and int(m.group(2)) >= size:
            done[m.group(1)] += 1
        else:
            stray += 1
    return sum(min(n, count) for n in done.values()) - stray - sum(
        max(n - count, 0) for n in done.values())
