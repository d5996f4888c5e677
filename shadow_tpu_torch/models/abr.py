"""Video ABR sessions: rate-switching segment fetches against the fluid
NIC buckets, with playback-buffer stall accounting.

The third member of the modern-web family: a video
client fetches fixed-duration segments over the stream transport,
estimates throughput from each download, and walks a bitrate ladder —
the classic throughput-based ABR loop (buffer-capped, EWMA estimator,
safety factor). What makes it a SIMULATION workload rather than a toy:
segment downloads ride the same fluid token buckets, congestion control,
and SACK recovery as every other stream, so a `link_degrade` window
produces exactly the rate downshifts and rebuffering stalls a real
player would show — and the telemetry subsystem prices them:

- one ``abr.segment`` flow record per segment (bytes, TTFB, latency,
  retransmits) carrying the segment's selected bitrate in the record's
  ``x`` field — the summary and metrics_report reduce it to the mean
  selected rate;
- one ``abr.stall`` flow record per rebuffering event, whose latency IS
  the stall duration (stall-seconds and stall-duration percentiles come
  free from the generic flow machinery);
- counters ``abr_segments`` / ``abr_stall_ns`` / ``abr_rate_sum_bps``
  fold into the run summary (the quality/stall roll-up).

Determinism: the throughput estimator and ladder walk are integer
arithmetic over simulated timestamps; the playback model is event-driven
(advanced at segment completions) — byte-identical across scheduler
policies and the Python/C transport twins.

The port of shadow_tpu/models/abr.py, unchanged but for its imports. The
model has no C path of its own: its segment fetches ride the stream
transport, which the C engine carries where it runs the host.
"""

from __future__ import annotations

from shadow_tpu_torch.core.time import NS_PER_SEC
from shadow_tpu_torch.models.web import WebOrigin, fetch_counted


class AbrServer(WebOrigin):
    """Segment server: the origin protocol, serving GET <seg> <nbytes>.
    args: [port]"""


class AbrClient:
    """One video session.
    args: [server, port, n_segments, seg_ms, rate_bps, rate_bps, ...]

    ``rates`` is the bitrate ladder in bits/sec, ascending. Segment i's
    size is selected_rate * seg_ms / 8000 bytes.

    environment:
      ABR_STARTUP_SEGS   (default 2): buffered segments before playback
      ABR_BUFFER_CAP_SEC (default 12): max buffered content; downloads
                         pause while above the cap
      ABR_SAFETY_PCT     (default 80): pick the highest ladder rate <=
                         estimate * safety / 100
      ABR_RETRIES        (default 1): per-segment ETIMEDOUT reconnects
      ABR_IDLE_TIMEOUT_SEC (default 30): per-segment idle timeout — a
                         server gone silent mid-segment fails the fetch
                         with ETIMEDOUT instead of stranding the session
    """

    def __init__(self, api, args, env):
        self.api = api
        self.server = args[0] if args else "video0"
        self.port = int(args[1]) if len(args) > 1 else 80
        self.n_segments = int(args[2]) if len(args) > 2 else 10
        self.seg_ns = (int(args[3]) if len(args) > 3 else 2000) * 1_000_000
        self.rates = [int(r) for r in args[4:]] or [
            400_000, 1_000_000, 2_500_000, 5_000_000]
        self.startup_segs = int(env.get("ABR_STARTUP_SEGS", 2))
        self.buffer_cap_ns = int(
            float(env.get("ABR_BUFFER_CAP_SEC", 12)) * NS_PER_SEC)
        self.safety_pct = int(env.get("ABR_SAFETY_PCT", 80))
        self.retries = int(env.get("ABR_RETRIES", 1))
        self.idle_ns = int(
            float(env.get("ABR_IDLE_TIMEOUT_SEC", 30)) * NS_PER_SEC)
        # session state
        self.seg = 0
        self.rate = self.rates[0]  # start at the ladder floor
        self.est_bps = 0  # EWMA throughput estimate (bits/sec)
        self.buffer_ns = 0
        self.playing = False
        self.last_t = 0  # playback-accounting cursor
        self.stall_ns = 0
        self.stalls = 0
        self.rate_sum = 0
        self.downshifts = 0
        self.failed = 0
        host = getattr(api, "_host", None)
        self._tel = getattr(host, "telemetry", None)

    def start(self):
        self.server_id = self.api.resolve(self.server)
        self.last_t = self.api.now
        self._next_segment()

    # -- playback accounting ----------------------------------------------
    def _advance(self, now):
        """Drain the playback buffer over [last_t, now); any shortfall is
        a rebuffering stall (recorded as an ``abr.stall`` flow whose
        latency is the stall duration)."""
        if self.playing:
            elapsed = now - self.last_t
            if elapsed > self.buffer_ns:
                stall = elapsed - self.buffer_ns
                self.stall_ns += stall
                self.stalls += 1
                self.buffer_ns = 0
                if self._tel is not None:
                    self.api._host.record_flow(
                        "abr.stall", self.server, now - stall, None, 0,
                        "ok")
            else:
                self.buffer_ns -= elapsed
        self.last_t = now

    # -- download loop -----------------------------------------------------
    def _next_segment(self):
        if self.seg >= self.n_segments:
            self._finish()
            return
        want = self.rate * (self.seg_ns // 1_000_000) // 8000  # bytes
        if want <= 0:
            want = 1
        self._fetch_segment(self.seg, want, self.rate)

    def _fetch_segment(self, i, want, rate):
        def on_ok(conn, got_n, t_open, ttfb, now, retx):
            conn.close()
            self._segment_done(i, want, rate, t_open, ttfb, retx, now)

        def on_fail(msg):
            self.failed += 1
            self.seg += 1
            self._next_segment()  # skip the segment (a real player would)

        fetch_counted(self.api, self._tel, self.server_id, self.port,
                      b"seg%d" % i, want, flow_kind="abr.segment",
                      peer=self.server, retries=self.retries,
                      idle_ns=self.idle_ns, x=rate,
                      on_ok=on_ok, on_fail=on_fail)

    def _segment_done(self, i, nbytes, rate, t_open, ttfb, retx, now):
        if self._tel is not None:
            self.api._host.record_flow(
                "abr.segment", self.server, t_open, ttfb, nbytes, "ok",
                retx=retx, x=rate)
        self.rate_sum += rate
        self._advance(now)
        self.buffer_ns += self.seg_ns
        self.seg += 1
        if not self.playing and self.seg >= self.startup_segs:
            self.playing = True
            self.last_t = now  # startup latency is not a stall
        # throughput sample -> EWMA -> ladder walk
        elapsed = now - t_open
        if elapsed > 0:
            sample = nbytes * 8 * NS_PER_SEC // elapsed  # bits/sec
            self.est_bps = (sample if self.est_bps == 0
                            else (self.est_bps * 7 + sample) // 8)
        budget = self.est_bps * self.safety_pct // 100
        new_rate = self.rates[0]
        for r in self.rates:
            if r <= budget:
                new_rate = r
        if new_rate < self.rate:
            self.downshifts += 1
        self.rate = new_rate
        # buffer cap: hold the next request until playback drains room
        if self.playing and self.buffer_ns > self.buffer_cap_ns:
            self.api.after(self.buffer_ns - self.buffer_cap_ns,
                           self._next_segment)
        else:
            self._next_segment()

    def _finish(self):
        # drain the remaining buffer through playback before judging
        self._advance(self.api.now)
        n = self.seg - self.failed
        host = self.api._host
        host.counters.add("abr_segments", n)
        if self.stall_ns:
            host.counters.add("abr_stall_ns", self.stall_ns)
        if self.rate_sum:
            host.counters.add("abr_rate_sum_bps", self.rate_sum)
        mean_rate = self.rate_sum // n if n else 0
        self.api.log(
            f"abr session done: segments={n}/{self.n_segments} "
            f"mean_rate_bps={mean_rate} stalls={self.stalls} "
            f"stall_ms={self.stall_ns // 1_000_000} "
            f"downshifts={self.downshifts} failed={self.failed}")
        self.api.exit(0 if self.failed == 0 else 1)

    def stop(self):
        pass
