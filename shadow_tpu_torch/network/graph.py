"""Network topology graph, routing, and IP assignment.

Mirrors the reference's network-graph layer (SURVEY.md §1 layer 8, §2
"Network graph + routing"): load a GML topology (nodes carry default host
bandwidths; edges carry latency + packet loss), assign hosts to graph nodes,
assign IPs, and answer ``latency(src_node, dst_node)`` / ``reliability(src,
dst)`` queries from an all-pairs-shortest-path (APSP) table.

Memory note (SURVEY.md §7): hosts map to G graph nodes (G is small — a few
thousand even for full-Tor topologies), so we store dense (G, G) latency and
reliability matrices plus an O(H) host->node index vector. Nothing is ever
(H, H).

APSP algorithm: min-plus matrix "squaring" repeated ceil(log2(G)) times,
with the path reliability (product of per-edge (1 - loss)) carried along the
argmin decomposition, in numpy on the host; ties break on the first minimal
k, as in the reference package.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from shadow_tpu_torch.core.time import NS_PER_MS, SimTime, parse_time
from shadow_tpu_torch.network.gml import GmlGraph, parse_gml, parse_gml_file
from shadow_tpu_torch.utils.units import parse_bandwidth

#: Sentinel for "unreachable" in int64 latency matrices. Chosen so that
#: INF + INF still fits in int64 (min-plus sums saturate back to INF).
INF_I64 = np.int64(1) << np.int64(61)
#: Device kernels use int32 ns with this saturating infinity (~1.07 s).
#: Chosen so INF + INF still fits in int32 (min-plus sums saturate back).
INF_I32 = (np.int32(1) << np.int32(30)) - np.int32(1)


@dataclass
class NodeDefaults:
    bandwidth_up: Optional[int] = None  # bytes/sec
    bandwidth_down: Optional[int] = None  # bytes/sec


@dataclass
class NetworkGraph:
    """Loaded topology + routing tables.

    latency_ns: (G, G) int64, INF_I64 where unreachable, 0 on the diagonal
                unless the graph provides an explicit self-edge.
    reliability: (G, G) float32 in [0, 1]; product of (1 - loss) along the
                chosen shortest-latency path.
    """

    n_nodes: int
    latency_ns: np.ndarray
    reliability: np.ndarray
    node_defaults: list[NodeDefaults]
    node_id_map: dict[int, int] = field(default_factory=dict)  # gml id -> index

    @property
    def min_latency_ns(self) -> SimTime:
        """The conservative-PDES lookahead bound: the smallest finite
        nonzero latency anywhere in the table (including self-edges, which
        bound same-node host pairs)."""
        finite = self.latency_ns[self.latency_ns < INF_I64]
        finite = finite[finite > 0]
        if finite.size == 0:
            return NS_PER_MS  # degenerate graph: fall back to 1 ms rounds
        return int(finite.min())

    def latency(self, src_node: int, dst_node: int) -> SimTime:
        return int(self.latency_ns[src_node, dst_node])

    def reliability_of(self, src_node: int, dst_node: int) -> float:
        return float(self.reliability[src_node, dst_node])

    def reachable(self, src_node: int, dst_node: int) -> bool:
        return self.latency_ns[src_node, dst_node] < INF_I64


def _apsp_minplus(lat: np.ndarray, rel: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Min-plus repeated squaring; carries reliability along argmin paths.

    lat: (G, G) int64 with INF_I64 sentinels, 0 diagonal.
    rel: (G, G) float32, 1.0 diagonal.
    Ties on latency pick the first (lowest) intermediate k — matching
    jnp.argmin semantics so the device kernel reproduces this exactly.
    """
    g = lat.shape[0]
    steps = max(1, int(np.ceil(np.log2(max(g, 2)))))
    for _ in range(steps):
        # cand[i, j, k] = lat[i, k] + lat[k, j]; block over i to bound memory.
        new_lat = np.empty_like(lat)
        new_rel = np.empty_like(rel)
        block = max(1, min(g, int(4e7 // max(g * g, 1)) or 1))
        for i0 in range(0, g, block):
            i1 = min(g, i0 + block)
            # cand[i, k, j] = lat[i, k] + lat[k, j]
            cand = lat[i0:i1, :, None] + lat[None, :, :]
            cand = np.minimum(cand, INF_I64)  # saturate (2*INF fits int64)
            k_star = np.argmin(cand, axis=1)  # (b, G=j), first minimum
            new_lat[i0:i1] = np.take_along_axis(cand, k_star[:, None, :], axis=1)[:, 0, :]
            # gather reliability along the chosen decomposition only (no G^3
            # float product): rel[i, k*] * rel[k*, j]
            rel_ik = np.take_along_axis(rel[i0:i1], k_star, axis=1)
            rel_kj = rel[k_star, np.arange(g)[None, :]]
            new_rel[i0:i1] = rel_ik * rel_kj
        lat, rel = new_lat, new_rel
    return lat, rel


def _parse_loss(v) -> float:
    if v is None:
        return 0.0
    f = float(v)
    if not (0.0 <= f <= 1.0):
        raise ValueError(f"packet_loss must be in [0,1], got {f}")
    return f


def from_gml(gml: GmlGraph) -> NetworkGraph:
    nodes = gml.nodes
    edges = gml.edges
    g = len(nodes)
    if g == 0:
        raise ValueError("topology has no nodes")

    node_id_map: dict[int, int] = {}
    defaults: list[NodeDefaults] = []
    for idx, n in enumerate(nodes):
        nid = n.get("id", idx)
        if nid in node_id_map:
            raise ValueError(f"duplicate GML node id {nid}")
        node_id_map[nid] = idx
        d = NodeDefaults()
        if "host_bandwidth_up" in n:
            d.bandwidth_up = parse_bandwidth(n["host_bandwidth_up"])
        if "host_bandwidth_down" in n:
            d.bandwidth_down = parse_bandwidth(n["host_bandwidth_down"])
        defaults.append(d)

    lat = np.full((g, g), INF_I64, dtype=np.int64)
    rel = np.zeros((g, g), dtype=np.float32)
    np.fill_diagonal(lat, 0)
    np.fill_diagonal(rel, 1.0)

    for e in edges:
        try:
            s = node_id_map[e["source"]]
            t = node_id_map[e["target"]]
        except KeyError as exc:
            raise ValueError(f"edge references unknown node: {e}") from exc
        l_ns = parse_time(e.get("latency", "1 ms"))
        if l_ns <= 0:
            raise ValueError(f"edge latency must be > 0: {e}")
        loss = _parse_loss(e.get("packet_loss"))
        pairs = [(s, t)] if gml.directed else [(s, t), (t, s)]
        for a, b in pairs:
            if a == b:
                # self-edge: latency between two hosts on the same node
                if l_ns < lat[a, b] or lat[a, b] == 0:
                    lat[a, b] = l_ns
                    rel[a, b] = 1.0 - loss
            elif l_ns < lat[a, b]:
                lat[a, b] = l_ns
                rel[a, b] = 1.0 - loss

    # Hosts on the same node with no explicit self-edge: use the smallest
    # adjacent edge latency as a stand-in (diagonal must be > 0 for the
    # conservative lookahead to be sound for same-node pairs).
    for i in range(g):
        if lat[i, i] == 0:
            row = np.concatenate([lat[i, :i], lat[i, i + 1:]])
            finite = row[row < INF_I64]
            lat[i, i] = int(finite.min()) if finite.size else NS_PER_MS
            rel[i, i] = 1.0

    # APSP must not relax through the (host-pair) diagonal: set diag to 0 for
    # the solve (identity of min-plus), then restore self-latencies after.
    self_lat = lat.diagonal().copy()
    self_rel = rel.diagonal().copy()
    np.fill_diagonal(lat, 0)
    np.fill_diagonal(rel, 1.0)
    lat, rel = _apsp_minplus(lat, rel)
    np.fill_diagonal(lat, self_lat)
    np.fill_diagonal(rel, self_rel)

    return NetworkGraph(
        n_nodes=g,
        latency_ns=lat,
        reliability=rel,
        node_defaults=defaults,
        node_id_map=node_id_map,
    )


def one_gbit_switch(latency_ns: SimTime = NS_PER_MS) -> NetworkGraph:
    """The reference's built-in single-switch shorthand topology
    (SURVEY.md §5.6: '1 Gbit switch')."""
    bw = parse_bandwidth("1 Gbit")
    lat = np.full((1, 1), latency_ns, dtype=np.int64)
    rel = np.ones((1, 1), dtype=np.float32)
    return NetworkGraph(
        n_nodes=1,
        latency_ns=lat,
        reliability=rel,
        node_defaults=[NodeDefaults(bandwidth_up=bw, bandwidth_down=bw)],
        node_id_map={0: 0},
    )


def load_graph(spec: dict) -> NetworkGraph:
    """Load from a config ``network.graph`` section: type gml|1_gbit_switch,
    with ``file:`` path or ``inline:`` text for gml."""
    gtype = str(spec.get("type", "gml")).replace(" ", "_").lower()
    if gtype in ("1_gbit_switch", "1gbit_switch", "switch"):
        return one_gbit_switch()
    if gtype == "gml":
        if "file" in spec:
            path = spec["file"]
            if isinstance(path, dict):  # shadow's {path: ..., compression: ...}
                path = path["path"]
            return from_gml(parse_gml_file(path))
        if "inline" in spec:
            return from_gml(parse_gml(spec["inline"]))
        raise ValueError("network.graph of type gml needs 'file' or 'inline'")
    raise ValueError(f"unknown network.graph.type: {spec.get('type')!r}")
