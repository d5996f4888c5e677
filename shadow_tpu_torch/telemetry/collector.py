"""Deterministic simulation telemetry: samplers, flow records, percentiles.

The port of shadow_tpu/telemetry/collector.py, with its shard-worker
branches (parallel/shards.py) and the live plane's records (live.py): the
stream tee of every line written and a ``flows_snapshot`` at each sample.

This is the run-level observability layer the coarse totals (counters,
heartbeat) cannot provide: "what was fetch p99 during the partition
window?", "which NIC's queue saturated in round 40k?". It follows the
design of upstream Shadow's tornettools result extraction and NS-3's
FlowMonitor (PAPERS.md), but lives *inside* the simulator and is held to
the repo's determinism bar: both output streams are byte-identical across
scheduler policies, data planes, and the Python/C twins, and a resumed
checkpoint continues the streams bit-exactly — so telemetry doubles as a
cross-plane correctness gate, the same trick ``state_digests.jsonl``
proved out.

Two append-only JSONL streams land in the metrics directory (default: the
run's data_directory):

``metrics.jsonl``
    - one ``meta`` record at fresh-run start (host names, NIC rates/caps,
      the sample cadence) so readers need no side channel;
    - one ``fault`` record per applied fault transition (the fault
      timeline, in application order — what lets reports annotate
      windows);
    - one ``sample`` record every ``telemetry.sample_every`` of simulated
      time, taken at the first round boundary past each grid point:
      global counters plus per-host columns (egress/ingress token-bucket
      levels, deferred-ingress backlog, live app timers, connection
      cwnd/ssthresh/RTO aggregates, in-flight bytes, retransmit counts,
      down/blackhole status).

``flows.jsonl``
    - one lifecycle record per application flow (tgen fetches, gossip
      INV->GETDATA->TX fetches, tor circuit fetches), emitted at flow
      close with open time, time-to-first-byte, bytes, completion
      latency, retransmits, and terminal status. ``retx`` counts the
      RECORDING endpoint's sender-side loss events; for download-shaped
      flows (tgen, tor) the server half's retransmits surface in the
      sample stream's per-host ``retx`` column instead (reading the
      remote endpoint at close time would race the thread policies).

Determinism rules (the whole design hangs on these):
- Everything is keyed off SIM time and canonical event order — never wall
  clock. Samples happen at round boundaries; the round grid is identical
  across policies and planes.
- Before a sample, ``engine.flush_all()`` materializes in-flight draw
  batches (result-identical by construction — the determinism-sentinel
  discipline), so both planes sit at the same resolution frontier.
- Flow records buffer host-locally during a round (host event execution
  may be parallel) and flush at the round end in host-id order; within a
  host, records follow event execution order, which is canonical.
- Only plane-independent observables are sampled — the same contract as
  ``Host.state_fingerprint``: capped bucket levels (the vector and scalar
  bucket twins rebase differently), no BAND_NET heap entries, no columnar
  pending store.
- Serialization is canonical JSON (sorted keys, fixed separators, ints
  only) — byte-comparable with sha256, no float formatting hazards.

When telemetry is off, ``controller.telemetry is None`` and nothing here
runs: no per-event work, no per-round work beyond one None check.
"""

from __future__ import annotations

import json
from pathlib import Path

from shadow_tpu_torch.telemetry.histogram import LogHistogram

METRICS_FILE = "metrics.jsonl"
FLOWS_FILE = "flows.jsonl"

#: StreamSender.ssthresh init (transport.py / colcore.c): "not yet set"
_SSTHRESH_INF = 1 << 62


def _dumps(obj) -> str:
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


def _arr(v) -> str:
    return "[%s]" % ",".join(map(str, v))


def format_sample_line(g: dict, cols: dict, rounds: int, t: int) -> str:
    """THE canonical sample-record serialization (hand-rolled sorted-key
    JSON, byte-identical to json.dumps of the same mapping). Module-level
    so the sharded parent can assemble the exact line a single-process
    run would have written from merged per-shard columns."""
    return (
        '{"global":{"bucket_up":%s,"bytes_sent":%d,"events":%d,'
        '"tokens_down":%s,"units_blackholed":%d,"units_dropped":%d,'
        '"units_sent":%d},'
        '"hosts":{"blackholed":%s,"conns":%s,"cwnd":%s,"deferred":%s,'
        '"delivered":%s,"down":%s,"emitted":%s,"inflight":%s,'
        '"retx":%s,"rto_backoff_max":%s,"rto_retries":%s,'
        '"ssthresh_min":%s,"timers":%s},'
        '"kind":"sample","round":%d,"t":%d}'
        % (_arr(g["bucket_up"]), g["bytes_sent"], g["events"],
           _arr(g["tokens_down"]), g["units_blackholed"],
           g["units_dropped"], g["units_sent"],
           _arr(cols["blackholed"]), _arr(cols["conns"]),
           _arr(cols["cwnd"]), _arr(cols["deferred"]),
           _arr(cols["delivered"]), _arr(cols["down"]),
           _arr(cols["emitted"]), _arr(cols["inflight"]),
           _arr(cols["retx"]), _arr(cols["rto_backoff_max"]),
           _arr(cols["rto_retries"]), _arr(cols["ssthresh_min"]),
           _arr(cols["timers"]),
           rounds, t))


def host_columns(hosts) -> dict:
    """Per-host sampler columns for ``hosts`` (in the given order). The
    single-process sampler passes all hosts in id order; a shard worker
    passes its owned subset and the parent interleaves by host id."""
    from shadow_tpu_torch.core.events import BAND_NET

    c_def, c_tmr, c_cn, c_inf, c_cwnd = [], [], [], [], []
    c_ss, c_retx, c_rtr, c_bkf = [], [], [], []
    c_em, c_dl, c_down, c_bh = [], [], [], []
    for h in hosts:
        c_def.append(len(h.ingress_deferred)
                     + len(h.ingress_deferred_rows))
        c_tmr.append(h.equeue.live_count(exclude_band=BAND_NET))
        conns = h._conns
        inflight = cwnd = retx = retries = 0
        backoff_max = 0
        ss_min = 0
        if conns:
            for ep in conns.values():
                s = ep.sender
                inflight += int(s.snd_nxt) - int(s.snd_una)
                cwnd += int(s.cwnd)
                retx += int(s.loss_events)
                retries += int(s.retries)
                b = int(s.rto_backoff)
                if b > backoff_max:
                    backoff_max = b
                ss = int(s.ssthresh)
                if ss < _SSTHRESH_INF and (ss_min == 0 or ss < ss_min):
                    ss_min = ss
        c_cn.append(len(conns))
        c_inf.append(inflight)
        c_cwnd.append(cwnd)
        c_ss.append(ss_min)
        c_retx.append(retx)
        c_rtr.append(retries)
        c_bkf.append(backoff_max)
        c_em.append(h._n_emitted)
        c_dl.append(h._n_delivered)
        c_down.append(1 if h.down else 0)
        c_bh.append(h._n_blackholed)
    return {"blackholed": c_bh, "conns": c_cn, "cwnd": c_cwnd,
            "deferred": c_def, "delivered": c_dl, "down": c_down,
            "emitted": c_em, "inflight": c_inf, "retx": c_retx,
            "rto_backoff_max": c_bkf, "rto_retries": c_rtr,
            "ssthresh_min": c_ss, "timers": c_tmr}


class TelemetryCollector:
    """Owns the telemetry state of one run; hangs off the controller and
    rides its checkpoint pickle (histograms, sample cursor, flow counters
    — everything needed for a resumed run's streams to continue
    bit-exactly). Holds no open files: writes open-append-close per
    flush, like the determinism sentinel."""

    def __init__(self, tel_cfg) -> None:
        self.sample_every = int(tel_cfg.sample_every)
        self.metrics_dir = tel_cfg.metrics_dir  # None = data_directory
        self.next_sample = self.sample_every
        self.samples = 0
        self.flows_written = 0
        #: anything buffered for the next round-end flush (flow records,
        #: fault annotations). THE contract with the controller's round
        #: loop: every producer of pending records sets this, and the
        #: loop calls on_round_end whenever it is set (or a sample is
        #: due) — so new record kinds only need to set dirty
        self.dirty = False
        #: hosts holding unflushed flow records this round (appends are
        #: GIL-atomic under the thread policies; sorted by id at flush —
        #: the ack_hosts discipline)
        self.flow_hosts: list = []
        self._fault_pending: list = []  # fault records applied this round
        self.hist: dict[str, LogHistogram] = {}  # flow kind -> latencies
        self.flow_counts: dict[str, dict] = {}  # kind -> {ok, failed}
        self._fh: dict = {}  # cached append handles (runtime-only)
        self._enc: dict = {}  # value -> canonical JSON string (names etc.)
        #: serialized flow lines awaiting a file write — flushed to disk
        #: at samples, checkpoints, and run end (content and order are
        #: fixed at serialization time, so write batching cannot change
        #: the stream, only the syscall count)
        self._flow_lines: list = []
        #: multi-process sharding (parallel/shards.py): (shard_id, N) on
        #: a worker, else None. A sharded collector never writes
        #: metrics.jsonl itself: fault records and sample partials queue
        #: in _out_partials for the worker loop to ship to the parent,
        #: and flow lines land in a per-shard flows.shard<k>.jsonl the
        #: parent merges by (round, hid) at run end.
        self.shard = None
        self._out_partials: list = []

    # -- checkpoint/restore (shadow_tpu/checkpoint.py) ---------------------
    def __getstate__(self):
        d = self.__dict__.copy()
        d["_fh"] = {}  # open files never ride a snapshot; reopened lazily
        return d

    # -- paths -------------------------------------------------------------
    def _dir(self, controller) -> Path:
        d = (Path(self.metrics_dir) if self.metrics_dir
             else controller.data_dir)
        d.mkdir(parents=True, exist_ok=True)
        return d

    def _append(self, controller, name: str, lines: list) -> None:
        # handles are opened once and cached: an open()+mkdir per flush
        # measurably dragged the <=5% overhead budget on tgen_1k
        f = self._fh.get(name)
        if f is None:
            f = self._fh[name] = open(self._dir(controller) / name, "a")
        f.write("\n".join(lines) + "\n")
        # live operations tee (live.py): followers receive the
        # artifact lines verbatim as they are written. Wall-clock plane
        # only — publish never blocks and drops on slow readers, so the
        # on-disk streams stay the source of truth
        srv = getattr(controller, "live", None)
        if srv is not None:
            srv.publish_stream(name, lines)

    def _flows_name(self) -> str:
        return (FLOWS_FILE if self.shard is None
                else f"flows.shard{self.shard[0]}.jsonl")

    def sync(self, controller) -> None:
        """Flush buffered flow lines + cached handles to disk (checkpoint
        boundaries, samples, run end): the on-disk streams are complete
        at every graceful stop point."""
        if self._flow_lines:
            lines, self._flow_lines = self._flow_lines, []
            self._append(controller, self._flows_name(), lines)
        for f in self._fh.values():
            f.flush()

    def drain_partials(self) -> list:
        """Shard worker: pending fault-record lines + sample partials for
        the parent (in production order)."""
        out, self._out_partials = self._out_partials, []
        return out

    def export_merge_state(self) -> dict:
        """The mergeable reduction state (bucket histograms + flow
        counts): what a shard worker hands the parent at finalize and a
        sweep reducer folds across seeds."""
        return {"samples": self.samples,
                "flows_written": self.flows_written,
                "hist": {k: h.state() for k, h in self.hist.items()},
                "flow_counts": self.flow_counts}

    def adopt_merge_state(self, state: dict) -> None:
        """Install a reduction state (convert.telemetry_state_from_arrays
        of another collector's export_merge_state): sample and flow
        counters, histograms and outcome counts, and the next sample's
        time where ``state`` gives it."""
        self.samples = state["samples"]
        self.flows_written = state["flows_written"]
        self.hist = dict(state["hist"])
        self.flow_counts = {k: dict(v)
                            for k, v in state["flow_counts"].items()}
        if "next_sample" in state:
            self.next_sample = state["next_sample"]

    def export_state_json(self) -> str:
        """Canonical JSON of export_merge_state() — the per-seed sidecar
        the reference's fleet mode writes (telemetry_state.json), so a
        sweep reducer can k-way merge histogram states across seeds
        without re-parsing flows.jsonl."""
        return _dumps(self.export_merge_state())

    def close_files(self) -> None:
        for f in self._fh.values():
            f.close()
        self._fh = {}

    # -- run lifecycle -----------------------------------------------------
    def start_fresh(self, controller) -> None:
        """Fresh run (not a resume): truncate stale streams from a prior
        run into this directory and write the meta record readers key on
        (resumes append — the continuation of one stream)."""
        d = self._dir(controller)
        if self.shard is not None:
            # worker: own only the per-shard flow stream; the parent owns
            # metrics.jsonl (meta record included — shard 0 ships the
            # line, its params arrays are identical on every shard)
            (d / self._flows_name()).unlink(missing_ok=True)
            if self.shard[0] == 0:
                self._out_partials.append(
                    {"kind": "meta", "line": self._meta_line(controller)})
            return
        (d / METRICS_FILE).unlink(missing_ok=True)
        (d / FLOWS_FILE).unlink(missing_ok=True)
        self._append(controller, METRICS_FILE,
                     [self._meta_line(controller)])

    def _meta_line(self, controller) -> str:
        p = controller.engine.params
        return _dumps({
            "kind": "meta",
            "version": 1,
            "sample_every": self.sample_every,
            "seed": controller.cfg.general.seed,
            "hosts": [h.name for h in controller.hosts],
            "node": p.host_node.tolist(),
            "rate_up": p.rate_up.tolist(),
            "rate_down": p.rate_down.tolist(),
            "cap_up": p.cap_up.tolist(),
            "cap_down": p.cap_down.tolist(),
        })

    # -- flow records (called from model code via Host.record_flow) --------
    def note_flow_host(self, host) -> None:
        self.flow_hosts.append(host)
        self.dirty = True

    # -- fault annotations (FaultInjector.on_apply) ------------------------
    def record_fault(self, now, rounds, action) -> None:
        rec = {"kind": "fault", "t": now, "round": rounds,
               "action": action.kind, "scheduled_t": action.t}
        if action.kind in ("link_degrade", "degrade_end"):
            ref = action.ref if action.kind == "degrade_end" else action
            rec["latency_factor"] = ref.latency_factor
            rec["loss_add"] = ref.loss_add
            rec["bandwidth_scale"] = ref.bandwidth_scale
        if action.host_ids:
            rec["hosts"] = list(action.host_ids)
        if action.src is not None:
            rec["src_nodes"] = action.src.tolist()
        if action.dst is not None:
            rec["dst_nodes"] = action.dst.tolist()
        self._fault_pending.append(rec)
        self.dirty = True

    def _flush_faults(self, controller) -> None:
        recs, self._fault_pending = self._fault_pending, []
        if self.shard is not None:
            # fault application order is deterministic and identical on
            # every shard; only shard 0's collector has the on_apply hook
            # wired, and its records ship to the parent (which writes them
            # before any same-round sample — the single-process
            # on_round_end order)
            self._out_partials.extend(
                {"kind": "fault", "line": _dumps(r)} for r in recs)
        else:
            self._append(controller, METRICS_FILE,
                         [_dumps(r) for r in recs])

    # -- per-round hook (controller round loop) ----------------------------
    def on_round_end(self, controller, round_end) -> None:
        """Flush the round's records and take a due sample. The round
        loop times the call (sampling + flow flushes) as
        phase_wall["telemetry"], so the <=5% budget is directly
        attributable, independent of shared-machine noise."""
        self.dirty = False
        if self._fault_pending:
            self._flush_faults(controller)
        if self.flow_hosts:
            self._flush_flows(controller)
        if round_end >= self.next_sample:
            self._sample(controller, round_end)
            self.next_sample = (
                (round_end // self.sample_every) + 1) * self.sample_every

    def _enc_str(self, v) -> str:
        """Canonical JSON encoding of a (small-cardinality) value — host
        names, peer ids, flow kinds — cached so per-record serialization
        stays off json.dumps (measured against the <=5% wall budget)."""
        s = self._enc.get(v)
        if s is None:
            s = self._enc[v] = _dumps(v)
        return s

    def _flush_flows(self, controller) -> None:
        hosts, self.flow_hosts = self.flow_hosts, []
        if len(hosts) > 1:
            hosts.sort(key=lambda h: h.id)
        rounds = controller.rounds
        counts = self.flow_counts
        lines = []
        for h in hosts:
            buf, h._flow_buf = h._flow_buf, []
            hid = h.id
            name_j = self._enc_str(h.name)
            for (kind, peer, t_open, t_close, ttfb, nbytes, status,
                 retx, x) in buf:
                lat = t_close - t_open
                if status == "ok":
                    hist = self.hist.get(kind)
                    if hist is None:
                        hist = self.hist[kind] = LogHistogram()
                    hist.add(lat)
                c = counts.get(kind)
                if c is None:
                    c = counts[kind] = {"ok": 0, "failed": 0}
                c["ok" if status == "ok" else "failed"] += 1
                if x is not None:
                    # model-defined metric (e.g. ABR selected bitrate):
                    # mergeable sum/count so the summary, the sharded
                    # parent, and the fleet reducer all derive the same
                    # mean (keys appear only for kinds that carry x)
                    c["x_sum"] = c.get("x_sum", 0) + x
                    c["x_n"] = c.get("x_n", 0) + 1
                # hand-rolled canonical JSON (keys in sorted order, the
                # _dumps separators) — byte-identical to json.dumps of
                # the same mapping, at a fraction of its cost; "x" sorts
                # last and appears only when the model provided one
                lines.append(
                    '{"bytes":%d,"flow":%s,"hid":%d,"host":%s,'
                    '"latency_ns":%d,"peer":%s,"retx":%d,"round":%d,'
                    '"status":%s,"t_close":%d,"t_open":%d,"ttfb_ns":%s%s}'
                    % (nbytes, self._enc_str(kind), hid, name_j, lat,
                       self._enc_str(peer), retx, rounds,
                       self._enc_str(status), t_close, t_open,
                       "null" if ttfb is None else "%d" % ttfb,
                       "" if x is None else ',"x":%d' % x))
            self.flows_written += len(buf)
        self._flow_lines.extend(lines)

    # -- samplers ----------------------------------------------------------
    def _sample(self, controller, t) -> None:
        eng = controller.engine
        # materialize in-flight draws so both planes (and the lazy
        # coalescing inside each) sit at the same resolution frontier;
        # result-identical, so sampling runs stay byte-identical to
        # non-sampling runs. Under the C engine this also folds the
        # C-side counter deltas into the Python attrs read below.
        eng.flush_all()
        self.samples += 1
        if self.shard is not None:
            # shard worker: gather this shard's slice — owned hosts'
            # columns + this engine's counter/bucket partials — and ship
            # it to the parent, which interleaves the per-shard slices
            # into the byte-exact single-process sample line
            own = [h for h in controller.hosts if controller.owns(h.id)]
            ids = [h.id for h in own]
            levels = eng.buckets.levels(t)
            self._out_partials.append({
                "kind": "sample", "t": t, "ids": ids,
                "cols": host_columns(own),
                "g": {"units_sent": eng.units_sent,
                      "units_dropped": eng.units_dropped,
                      "units_blackholed": eng.units_blackholed,
                      "bytes_sent": eng.bytes_sent,
                      "events": controller.events,
                      "bucket_up": levels[ids].tolist(),
                      "tokens_down": eng.tokens_down[ids].tolist()},
            })
            self.sync(controller)  # flow lines land before the sample
            return
        g = eng.telemetry_sample(t)
        g["events"] = controller.events
        # column-building stays a tight local-alias loop: the sampler runs
        # once per sample grid point over EVERY host, and its wall rides
        # the <=5% telemetry budget on the bench row
        line = format_sample_line(g, host_columns(controller.hosts),
                                  controller.rounds, t)
        self.sync(controller)  # flows land before the sample's write
        self._append(controller, METRICS_FILE, [line])
        srv = getattr(controller, "live", None)
        if srv is not None:
            # flow-group percentile snapshot at the sample grid point:
            # the same reduction as the end-of-run summary, so a follower
            # watches the distributions converge live
            srv.publish({"type": "flows_snapshot", "t": t,
                         "round": controller.rounds,
                         "flows": self.summary()["flows"]})

    # -- end of run --------------------------------------------------------
    def finalize(self, controller) -> None:
        """Flush anything still buffered (the last round's flow closes and
        fault transitions) and close the stream handles."""
        if self._fault_pending:
            self._flush_faults(controller)
        if self.flow_hosts:
            self._flush_flows(controller)
        self.sync(controller)
        self.close_files()

    def summary(self) -> dict:
        """The run-summary reduction: per-flow-class counts and streaming
        latency percentiles. Deterministic — safe for summary-equality
        gates (never in VOLATILE_SUMMARY_KEYS)."""
        flows = {}
        for kind in sorted(self.flow_counts):
            c = self.flow_counts[kind]
            row = {"count": c["ok"] + c["failed"], "ok": c["ok"],
                   "failed": c["failed"]}
            if c.get("x_n"):
                # model metric mean (ABR: mean selected bitrate, b/s)
                row["x_mean"] = c["x_sum"] // c["x_n"]
            hist = self.hist.get(kind)
            if hist is not None and hist.total:
                row.update(hist.quantiles_ns_to_ms())
            flows[kind] = row
        return {"samples": self.samples, "flows_recorded": self.flows_written,
                "flows": flows}
