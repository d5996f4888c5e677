"""The completion check (outcome.py) reads a hosts/ tree's client logs
against the config: a tree in which every client did what its arguments
ask reads 0, and each way of falling short reads above it."""

import pytest

from portbench import outcome, spec

CONFIGS = {c["name"]: spec.ROOT / c["file"] for c in spec.load()["configs"]}


@pytest.fixture(scope="module")
def plans():
    return {name: outcome.Plan(path) for name, path in CONFIGS.items()}


def _write(tmp_path, plan, edit=None):
    """A hosts/ tree in which every client finished as asked; ``edit``
    may change (host, lines) before they are written."""
    for host, rule, args in plan.clients:
        if rule.__name__.endswith("TGenClient"):
            lines = [f"{i} [tgenclient.0] transfer-complete peer={p} "
                     f"bytes=1000000 elapsed_ms=9"
                     for i, p in enumerate(args[4:]) for _ in
                     range(int(args[1]))]
        else:
            lines = [f"5 [torclient.0] circuit-complete hops=['relay60', "
                     f"'relay70', 'relay{i % 50}'] bytes=500000 elapsed_ms=9"
                     for i in range(int(args[5]))]
        if edit is not None:
            lines = edit(host, lines)
        d = tmp_path / host
        d.mkdir(parents=True, exist_ok=True)
        (d / f"{host}.log").write_text("\n".join(lines) + "\n")
    return tmp_path


def _expected(plan):
    return sum(rule.expected(args) for _, rule, args in plan.clients)


def test_the_plans_read_every_client(plans):
    assert len(plans["tgen_1k"].clients) == 950
    assert _expected(plans["tgen_1k"]) == 1900
    assert len(plans["tor_400relay"].clients) == 600
    assert _expected(plans["tor_400relay"]) == 600
    assert "web9" in plans["tor_400relay"].apps


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_a_tree_that_did_as_asked_reads_0(name, plans, tmp_path):
    assert plans[name].shortfall(_write(tmp_path, plans[name])) == 0


def _first(change):
    """Apply ``change`` to the first client's lines only."""
    seen = []

    def edit(host, lines):
        seen.append(host)
        return change(lines) if len(seen) == 1 else lines
    return edit


@pytest.mark.parametrize("name,change,short", [
    ("tgen_1k", lambda ls: ls[1:], 1),
    ("tgen_1k", lambda ls: [ls[0].replace("1000000", "999999")] + ls[1:], 2),
    ("tgen_1k", lambda ls: ls + ls[:1], 1),
    ("tgen_1k", lambda ls: [ls[0].replace("peer=server", "peer=xserver")]
     + ls[1:], 2),
    ("tor_400relay", lambda ls: [], 1),
    ("tor_400relay", lambda ls: [ls[0].replace("'relay", "'relay9", 1)],
     2),
    ("tor_400relay", lambda ls: [ls[0].replace("relay70", "relay60")], 2),
    ("tor_400relay", lambda ls: [ls[0].replace("'relay0'", "'relay77'")],
     2),
    ("tor_400relay", lambda ls: [ls[0].replace("500000", "400000")], 2),
], ids=["tgen-missing", "tgen-short", "tgen-twice", "tgen-wrong-peer",
        "tor-missing", "tor-unknown-relay", "tor-repeated-hop",
        "tor-exit-not-an-exit", "tor-short"])
def test_each_shortfall_is_counted(name, change, short, plans, tmp_path):
    tree = _write(tmp_path, plans[name], _first(change))
    assert plans[name].shortfall(tree) == short


def test_a_missing_log_is_a_shortfall(plans, tmp_path):
    tree = _write(tmp_path, plans["tgen_1k"])
    host = plans["tgen_1k"].clients[3][0]
    (tree / host / f"{host}.log").unlink()
    assert plans["tgen_1k"].shortfall(tree) == 2
