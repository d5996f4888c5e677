"""A Tor client (args: relays, relay port, server, server port, size,
circuits, exits) builds ``circuits`` circuits over three distinct relays,
the last an exit, and fetches ``size`` bytes over each; each completed
fetch logs ``circuit-complete hops=['<guard>', '<middle>', '<exit>']
bytes=<got> ...``. Relays are ``relay<i>`` for i below the relay count,
exits those below the exit count, and each must be a host that runs a
relay (``TorRelay`` or ``TorExit``; an exit ``TorExit``)."""

import re

from portbench.units import parse_size

LINE = re.compile(r"\] circuit-complete hops=\[([^\]]*)\] bytes=(\d+) ")
RELAY = re.compile(r"relay(\d+)")


def expected(args) -> int:
    return int(args[5]) if len(args) > 5 else 1


def _sound(hops, n_relays, n_exits, apps) -> bool:
    idx = []
    for hop in hops:
        m = RELAY.fullmatch(hop)
        if m is None or int(m.group(1)) >= n_relays:
            return False
        idx.append(int(m.group(1)))
        if not apps.get(hop, set()) & {"TorRelay", "TorExit"}:
            return False
    return (len(set(idx)) == 3 and idx[2] < n_exits
            and "TorExit" in apps.get(hops[2], set()))


def found(args, lines, apps) -> int:
    n_relays = int(args[0])
    size = parse_size(args[4]) if len(args) > 4 else 100_000
    n_exits = int(args[6]) if len(args) > 6 else n_relays
    good = bad = 0
    for line in lines:
        m = LINE.search(line)
        if m is None:
            continue
        hops = [h.strip().strip("'\"") for h in m.group(1).split(",")]
        if (len(hops) == 3 and int(m.group(2)) >= size
                and _sound(hops, n_relays, n_exits, apps)):
            good += 1
        else:
            bad += 1
    return min(good, expected(args)) - bad - max(good - expected(args), 0)
