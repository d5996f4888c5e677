"""Deterministic fault injection: link/host churn, partitions, degradation.

Shadow's headline use case is protocol behavior under ADVERSE networks, so
adversity is a first-class simulated input here, not a test-only hook: a
``faults:`` config section declares a timeline of events —

- ``link_down`` / ``link_up``: cut (restore) every path between two sets of
  graph nodes. A single edge is the 1x1 case; two sets form a bipartite
  partition. Cut pairs take INF latency in the APSP table, so in-flight
  emissions route through the engines' existing blackhole path.
- ``link_degrade``: multiply path latency, add loss probability, and/or
  scale the NIC bandwidth of hosts attached to the targeted nodes. The
  modified latencies and drop thresholds flow into the per-unit plane, the
  columnar plane, and the device draw kernel identically (both gather from
  ``graph.latency_ns`` / ``params.drop_thresh`` at the emission barrier),
  so cross-plane and numpy/device bit-identity is preserved.
- ``host_down`` / ``host_up``: crash (reboot) hosts. A crash tears down the
  host's sockets and parked ingress units and cancels its application
  timers; queued network arrivals stay queued and are discarded at
  delivery (so event counts match the columnar plane, whose resolved
  arrivals live outside the heap). Surviving peers discover the failure
  through their own RTO exponential backoff, terminating in ``ETIMEDOUT``.
  A reboot respawns the host's processes as fresh instances.
- ``churn``: seeded random up/down cycling (exponential
  ``mean_uptime``/``mean_downtime`` draws from the counter-based fault RNG
  in core/rng.py), materialized into explicit host_down/host_up actions at
  startup — reproducible and independent of scheduler policy.

Timing model: the controller applies due actions at round starts, i.e. an
action at time t takes effect at the first round boundary >= t (the same
quantization the conservative-PDES barrier already imposes on cross-host
effects). The round grid is identical across scheduler policies, so fault
application instants are policy-independent; the skip-ahead path treats the
next pending action as a wake-up so idle simulations cannot jump over a
transition. Latency factors are >= 1 by validation, so the conservative
lookahead (round width <= min BASE latency) stays sound under degradation.

Faults run on every data plane, including the C engine: the injector
rewrites the effective latency/loss/rate matrices and bucket arrays IN
PLACE, and native/colcore holds raw pointers into those same numpy
buffers, so a transition is visible to the C barrier at exactly the same
instant as the Python ones. Host crash/reboot additionally drives the C
core's explicit teardown hooks (Core.host_crash/host_boot) through
Host.crash/reboot. Determinism across policies AND across the C/Python
twins under churn is asserted by tests/test_faults.py.

The port of shadow_tpu/faults.py, with the live plane's runtime insertion
(``insert_runtime``, fed by live.py's command path). The port's C engine is
the reference's, so it holds the same raw pointers, and the device paths read
the rewritten thresholds where the reference's do: the draw plane gathers
``drop_thresh`` per window at the barrier, the mesh exchange takes each
unit's threshold from the same gather (its round tables, copied to the
card once, serve only the standalone round API).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from shadow_tpu_torch.config.schema import ConfigOptions
from shadow_tpu_torch.core.rng import fault_rng
from shadow_tpu_torch.core.time import SimTime, T_NEVER, format_time
from shadow_tpu_torch.network.fluid import bytes_over, clamped_refill
from shadow_tpu_torch.network.graph import INF_I64
from shadow_tpu_torch.ops.prng import quantize_loss


@dataclass(eq=False)
class FaultAction:
    """One materialized timeline entry (config events + expanded churn).

    eq=False: actions are compared by IDENTITY — degrade_end removes its
    ``ref`` from the active list with list.remove, and a generated __eq__
    over the numpy node-set fields would raise (ambiguous array truth)
    whenever two same-time degrade windows coexist."""

    t: SimTime
    kind: str  # link_down | link_up | link_degrade | degrade_end |
    #          host_down | host_up
    src: Optional[np.ndarray] = None  # node indices (graph index space)
    dst: Optional[np.ndarray] = None
    host_ids: list = field(default_factory=list)
    latency_factor: float = 1.0
    loss_add: float = 0.0
    bandwidth_scale: float = 1.0
    ref: Optional["FaultAction"] = None  # degrade_end -> its link_degrade


def _resolve_nodes(gml_ids, graph, all_but=None) -> np.ndarray:
    if gml_ids:
        out = []
        for nid in gml_ids:
            if nid not in graph.node_id_map:
                raise ValueError(f"faults: node id {nid} not in graph")
            out.append(graph.node_id_map[nid])
        return np.array(sorted(set(out)), dtype=np.intp)
    # empty dst set = "everything except the src side"
    rest = sorted(set(range(graph.n_nodes)) - set(all_but.tolist()))
    if not rest:
        raise ValueError("faults: dst_nodes empty and src_nodes covers "
                         "the whole graph")
    return np.array(rest, dtype=np.intp)


def _resolve_hosts(patterns, by_name) -> list:
    """Host-name patterns -> sorted host ids; a trailing ``*`` globs over
    quantity-expanded templates (``n3_*`` matches ``n3_0..n3_K``)."""
    ids = set()
    for pat in patterns:
        if pat.endswith("*"):
            pre = pat[:-1]
            matched = [hid for name, hid in by_name.items()
                       if name.startswith(pre)]
            if not matched:
                raise ValueError(f"faults: host pattern {pat!r} matches "
                                 f"no hosts")
            ids.update(matched)
        else:
            if pat not in by_name:
                raise ValueError(f"faults: unknown host {pat!r}")
            ids.add(by_name[pat])
    return sorted(ids)


def build_timeline(cfg: ConfigOptions, graph, by_name: dict,
                   stop: SimTime) -> list[FaultAction]:
    """Materialize config events + churn draws into one sorted action list.

    Pure function of (config, graph, seed): no simulation state involved,
    so the timeline is identical under every policy and data plane.
    """
    actions: list[FaultAction] = []
    # cfg.faults is None when the injector exists only for runtime live
    # commands (live.ensure_fault_injector): empty config timeline.
    events = cfg.faults.events if cfg.faults is not None else []
    churn = cfg.faults.churn if cfg.faults is not None else []
    for ev in events:
        a = FaultAction(t=ev.time, kind=ev.kind,
                        latency_factor=ev.latency_factor,
                        loss_add=ev.loss_add,
                        bandwidth_scale=ev.bandwidth_scale)
        if ev.kind in ("link_down", "link_up", "link_degrade"):
            a.src = _resolve_nodes(ev.src_nodes, graph)
            a.dst = _resolve_nodes(ev.dst_nodes, graph, all_but=a.src)
        else:
            a.host_ids = _resolve_hosts(ev.hosts, by_name)
        actions.append(a)
        if ev.duration is not None:
            end_kind = {"link_down": "link_up", "host_down": "host_up",
                        "link_degrade": "degrade_end"}[ev.kind]
            actions.append(FaultAction(
                t=ev.time + ev.duration, kind=end_kind, src=a.src,
                dst=a.dst, host_ids=a.host_ids, ref=a))
    for ch in churn:
        for hid in _resolve_hosts(ch.hosts, by_name):
            rng = fault_rng(cfg.general.seed, hid)
            t = ch.start_time
            up = True
            while True:
                mean = ch.mean_uptime if up else ch.mean_downtime
                # inverse-CDF exponential from one uniform draw: fully
                # specified arithmetic (Generator.exponential's ziggurat
                # would also be deterministic, but this is auditable)
                u = float(rng.random())
                t += max(int(-mean * np.log1p(-u)), 1)
                if t >= stop:
                    break
                actions.append(FaultAction(
                    t=t, kind="host_down" if up else "host_up",
                    host_ids=[hid]))
                up = not up
    actions.sort(key=lambda a: a.t)  # stable: same-t keeps build order
    return actions


class FaultInjector:
    """Runtime state: applies due timeline actions at round starts.

    Link state is recomputed from scratch on every link transition (base
    matrices + active degrades in timeline order + cut overlay) rather
    than patched incrementally — G is small, transitions are rare, and
    recomputation makes overlapping windows and exact restoration trivial.
    The effective matrices are written IN PLACE into ``graph.latency_ns``
    and ``params.drop_thresh`` (the same objects every plane gathers from
    at its barrier), so a transition is visible to all planes atomically
    at the next barrier.
    """

    def __init__(self, controller) -> None:
        self.ctl = controller
        self.engine = controller.engine
        self.graph = controller.graph
        self.params = controller.engine.params
        cfg = controller.cfg
        stop = cfg.general.stop_time
        self.actions = build_timeline(cfg, self.graph, controller._by_name,
                                      stop)
        # host lifecycle events cover both process models: pyapp plugins
        # and managed executables share the kill/spawn crash contract
        # (ManagedProcess.kill SIGKILLs + reaps the real guest at the
        # boundary; Host.reboot respawns a fresh instance)
        self.idx = 0
        self.applied = 0
        #: telemetry hook (telemetry/collector.py::record_fault): called
        #: once per applied action with (now, rounds, action) so fault
        #: windows are annotated in the metrics stream. Application order
        #: is deterministic, so the annotations are too.
        self.on_apply = None
        g = self.graph.n_nodes
        self._base_lat = self.graph.latency_ns.copy()
        self._base_rel = self.graph.reliability.copy()
        self._base_rate_up = self.params.rate_up.copy()
        self._base_rate_down = self.params.rate_down.copy()
        self._cut = np.zeros((g, g), dtype=np.int32)
        self._degrades: list[FaultAction] = []

    def next_time(self) -> SimTime:
        """Time of the next unapplied action (a skip-ahead wake-up)."""
        return self.actions[self.idx].t if self.idx < len(self.actions) \
            else T_NEVER

    def insert_runtime(self, acts: list[FaultAction]) -> None:
        """Insert live-command actions (live.materialize_command) into the
        unapplied tail, keeping it t-sorted.  A runtime action lands AFTER
        existing actions with the same t (command application is ordered
        after the config timeline at a shared boundary), and never before
        ``idx`` — an action due now is picked up by the ``apply_due`` call
        at this same boundary."""
        for a in acts:
            i = len(self.actions)
            while i > self.idx and self.actions[i - 1].t > a.t:
                i -= 1
            self.actions.insert(i, a)

    def apply_due(self, now: SimTime) -> None:
        """Apply every action with t <= now. Called by the controller at
        round start, before any host event of the round executes."""
        if self.idx >= len(self.actions) or self.actions[self.idx].t > now:
            return
        link_dirty = False
        log = self.ctl.log
        while self.idx < len(self.actions) and self.actions[self.idx].t <= now:
            a = self.actions[self.idx]
            self.idx += 1
            self.applied += 1
            if a.kind == "link_down":
                self._cut[np.ix_(a.src, a.dst)] += 1
                self._cut[np.ix_(a.dst, a.src)] += 1
                link_dirty = True
            elif a.kind == "link_up":
                self._cut[np.ix_(a.src, a.dst)] -= 1
                self._cut[np.ix_(a.dst, a.src)] -= 1
                np.maximum(self._cut, 0, out=self._cut)
                link_dirty = True
            elif a.kind == "link_degrade":
                self._degrades.append(a)
                link_dirty = True
            elif a.kind == "degrade_end":
                self._degrades.remove(a.ref)
                link_dirty = True
            elif a.kind == "host_down":
                # multi-process sharding: the fault timeline broadcasts to
                # every shard (identical actions, identical cursor), but
                # host lifecycle mutations touch only OWNED hosts — a
                # non-owned Host object here is pure topology, and its
                # down flag is never read on this shard (arrivals for it
                # divert to the owning shard before delivery)
                for hid in a.host_ids:
                    if not self.ctl.owns(hid):
                        continue
                    h = self.ctl.hosts[hid]
                    if not h.down:
                        h.crash(now)
            elif a.kind == "host_up":
                for hid in a.host_ids:
                    if not self.ctl.owns(hid):
                        continue
                    h = self.ctl.hosts[hid]
                    if h.down:
                        h.reboot(now)
            log.debug(f"fault at {format_time(now)}: {a.kind} "
                      f"(scheduled {format_time(a.t)})")
            if self.on_apply is not None:
                self.on_apply(now, self.ctl.rounds, a)
        if link_dirty:
            self._recompute(now)

    # -- effective link state ----------------------------------------------
    def _recompute(self, now: SimTime) -> None:
        g = self.graph.n_nodes
        lat = self._base_lat.astype(np.float64)
        rel = self._base_rel.astype(np.float64)
        for a in self._degrades:
            mask = np.zeros((g, g), dtype=bool)
            mask[np.ix_(a.src, a.dst)] = True
            mask[np.ix_(a.dst, a.src)] = True
            if a.latency_factor != 1.0:
                lat[mask] = np.floor(lat[mask] * a.latency_factor)
            if a.loss_add != 0.0:
                rel[mask] = rel[mask] - a.loss_add
        rel = np.clip(rel, 0.0, 1.0)
        lat_i = np.minimum(lat, float(INF_I64)).astype(np.int64)
        cut = self._cut > 0
        lat_i[cut] = INF_I64
        rel[cut] = 0.0
        self.graph.latency_ns[...] = lat_i
        self.params.drop_thresh[...] = quantize_loss(rel.astype(np.float32))
        self._apply_rates(now)

    def _apply_rates(self, now: SimTime) -> None:
        host_node = self.params.host_node
        scale = np.ones(host_node.shape[0], dtype=np.float64)
        for a in self._degrades:
            if a.bandwidth_scale != 1.0:
                nodes = np.union1d(a.src, a.dst)
                scale[np.isin(host_node, nodes)] *= a.bandwidth_scale
        new_up = np.maximum(
            (self._base_rate_up * scale).astype(np.int64), 1)
        new_down = np.maximum(
            (self._base_rate_down * scale).astype(np.int64), 1)
        p = self.params
        if (np.array_equal(new_up, p.rate_up)
                and np.array_equal(new_down, p.rate_down)):
            return
        eng = self.engine
        # settle the round-quantized ingress buckets for the elapsed window
        # at the OLD rates, so the change takes effect exactly at `now`
        dt = now - eng._last_refill
        if dt > 0:
            add = clamped_refill(p.rate_down, p.cap_down, dt)
            eng.tokens_down += np.minimum(add, p.cap_down - eng.tokens_down)
            eng._last_refill = now
        # settle the closed-form egress buckets: available(now) under the
        # old rate becomes the new accounting base — exact continuity, and
        # departures computed after this barrier use the new rate
        b = eng.buckets
        changed = (new_up != p.rate_up)
        if changed.any():
            avail = (b.tokens + bytes_over(p.rate_up, now - b.t_base)
                     - b.debt)
            b.tokens[changed] = np.minimum(avail, p.cap_up)[changed]
            b.t_base[changed] = now
            b.debt[changed] = 0
        p.rate_up[...] = new_up
        p.rate_down[...] = new_down
