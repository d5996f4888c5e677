"""A small GML (Graph Modelling Language) parser.

The reference loads network topologies from GML files (SURVEY.md §2 "GML
parser", "Network graph + routing"): nodes carry host bandwidth defaults,
edges carry latency and packet loss. This parser supports the subset Shadow
topologies use:

    graph [
      directed 1
      node [ id 0 host_bandwidth_up "1 Gbit" host_bandwidth_down "1 Gbit" ]
      edge [ source 0 target 0 latency "10 ms" packet_loss 0.0 ]
    ]

Values may be ints, floats, or quoted strings. Nested lists map to dicts;
repeated keys (node/edge) accumulate into lists.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

_TOKEN = re.compile(r'"((?:[^"\\]|\\.)*)"|\[|\]|[^\s\[\]"]+')


@dataclass
class GmlGraph:
    directed: bool = False
    attrs: dict = field(default_factory=dict)
    nodes: list[dict] = field(default_factory=list)
    edges: list[dict] = field(default_factory=list)


def _tokenize(text: str):
    # line-based so '#' comments swallow the rest of their line (quoted
    # strings are single-line in GML)
    for line in text.splitlines():
        for m in _TOKEN.finditer(line):
            if m.group(1) is not None:
                yield ("str", m.group(1))
                continue
            tok = m.group(0)
            if tok == "[":
                yield ("open", tok)
            elif tok == "]":
                yield ("close", tok)
            elif tok.startswith("#"):
                break  # comment: skip rest of line
            else:
                yield ("atom", tok)


def _coerce(kind: str, tok: str):
    if kind == "str":
        return tok
    try:
        return int(tok)
    except ValueError:
        pass
    try:
        return float(tok)
    except ValueError:
        pass
    return tok


def _parse_list(tokens) -> dict:
    """Parse the body of a [ ... ] list into a dict (repeated keys -> list)."""
    out: dict = {}

    def put(key, val):
        if key in ("node", "edge"):
            out.setdefault(key, []).append(val)
        elif key in out:
            prev = out[key]
            if not isinstance(prev, list):
                out[key] = [prev]
            out[key].append(val)
        else:
            out[key] = val

    while True:
        try:
            kind, tok = next(tokens)
        except StopIteration:
            return out
        if kind == "close":
            return out
        if kind not in ("atom", "str"):
            raise ValueError(f"unexpected token {tok!r} (expected key)")
        key = tok
        try:
            kind2, tok2 = next(tokens)
        except StopIteration:
            raise ValueError(f"GML input truncated after key {key!r}") from None
        if kind2 == "open":
            put(key, _parse_list(tokens))
        else:
            put(key, _coerce(kind2, tok2))


def parse_gml(text: str) -> GmlGraph:
    tokens = _tokenize(text)
    top = _parse_list(tokens)
    if "graph" not in top:
        raise ValueError("GML input has no 'graph [ ... ]' block")
    g = top["graph"]
    if isinstance(g, list):
        g = g[0]
    out = GmlGraph()
    out.directed = bool(g.pop("directed", 0))
    nodes = g.pop("node", [])
    edges = g.pop("edge", [])
    out.nodes = nodes if isinstance(nodes, list) else [nodes]
    out.edges = edges if isinstance(edges, list) else [edges]
    out.attrs = g
    return out


def parse_gml_file(path: str) -> GmlGraph:
    with open(path, "r") as f:
        return parse_gml(f.read())
