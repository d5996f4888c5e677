"""HTTP/CDN tier: clients -> edge caches -> origin, with hierarchical
page fan-out and a cache hit-ratio knob.

The port of shadow_tpu/models/web.py, unchanged but for its imports: its
flow records (``web.fetch``, ``web.origin``) go to ``Host.record_flow``, as
the reference's do.

The modern-web workload family's request/response backbone: production
traffic is not bulk fetches but page hierarchies —
resolve a name, fetch a main object, fan out subresource fetches, think,
repeat — served through an edge tier whose cache hit ratio decides how
much traffic reaches the origin. Three models:

- ``WebOrigin`` — the origin server: parses newline-framed
  ``GET <obj> <nbytes>`` requests off a stream connection and pushes
  ``nbytes`` counted bytes per request (tgen-style: no payload
  materialization, so big configs stay in memory).
- ``WebEdge`` — an edge cache: terminates client connections, serves
  cache HITS locally and proxies MISSES to the origin (store-and-forward
  over a fresh origin connection, one ``web.origin`` flow record per
  miss). The hit set is a deterministic hash knob — ``crc32(obj) % 100 <
  hit_pct`` — so a config dials the origin offload directly and every
  plane/policy computes the identical hit set.
- ``WebClient`` — the page loop: DNS-resolve the edge (models/dns.py
  DnsStub — one ``dns.resolve`` flow per lookup), fetch the page's main
  object, then fan out N subresource fetches in parallel, think
  (seeded-exponential), next page. One ``web.fetch`` flow record per
  object; ETIMEDOUT fetches retry up to WEB_RETRIES then count failed.

Request wire format (real payload bytes): ``GET <obj> <nbytes>\\n``.
Responses are counted bytes. Everything else is deterministic: object
ids derive from (host, page, index), edge choice and think times from
the per-host counter-based RNG, hits from crc32 — byte-identical across
scheduler policies and the Python/C transport twins (the transfer path
is exactly the machinery tgen already proves).
"""

from __future__ import annotations

import zlib

from shadow_tpu_torch.core.time import NS_PER_SEC


def parse_requests(buf: dict, payload) -> list[tuple[bytes, int]]:
    """Accumulate stream payload into ``buf["b"]`` and split off every
    complete ``GET <obj> <nbytes>\\n`` request. Malformed lines parse as
    (obj, 0) and are ignored by servers."""
    if payload is None:
        return []
    buf["b"] += payload
    out = []
    while b"\n" in buf["b"]:
        line, buf["b"] = buf["b"].split(b"\n", 1)
        parts = line.split()
        if len(parts) == 3 and parts[0] == b"GET":
            try:
                out.append((parts[1], int(parts[2])))
            except ValueError:
                pass
    return out


def request_line(obj: bytes, nbytes: int) -> bytes:
    return b"GET %s %d\n" % (obj, nbytes)


def fetch_counted(api, tel, target_id, port, obj, want, *, flow_kind,
                  peer, retries, idle_ns, x=None, on_ok, on_fail):
    """Fetch ``want`` counted bytes of ``obj`` from ``(target_id,
    port)`` over a fresh stream connection — the one fetch closure the
    whole family shares (WebClient objects, WebEdge origin proxying,
    AbrClient segments). Connect, send the request line, count response
    bytes, and resolve EXACTLY once: ``on_ok(conn, got_n, t_open, ttfb,
    now, retx)`` at completion (success flow recording stays with the
    caller — the groups differ in fields), or ``on_fail(msg)`` once
    ETIMEDOUT retries are exhausted, the peer closes short, or any other
    error lands. Failure flows are recorded here — exactly ONE per
    object, at retry exhaustion (status timeout/error, ``tel`` gating).
    ``retx`` — on both paths — folds the final attempt's transport
    retransmits plus the prior timed-out attempts. An armed idle
    timeout turns a silent established
    peer into ETIMEDOUT; late teardown noise after a completed fetch is
    ignored."""
    def attempt_fetch(attempt):
        t_open = api.now
        conn = api._host.connect(target_id, port)
        got = {"n": 0}
        first = {"t": None}

        def on_connected(now):
            conn.send(payload=request_line(obj, want))

        def on_data(nbytes, payload, now):
            if first["t"] is None:
                first["t"] = now
            got["n"] += nbytes
            if got["n"] >= want:
                on_ok(conn, got["n"], t_open, first["t"], now,
                      int(conn.sender.loss_events) + attempt)

        def on_error(msg):
            if got["n"] >= want:
                return  # late teardown noise after a completed fetch
            if "ETIMEDOUT" in msg and attempt < retries:
                attempt_fetch(attempt + 1)
                return
            # one failure record per OBJECT, at retry exhaustion — the
            # DnsStub discipline; intermediate timed-out attempts are
            # visible through retx on the final record
            if tel is not None:
                api._host.record_flow(
                    flow_kind, peer, t_open, first["t"], got["n"],
                    "timeout" if "ETIMEDOUT" in msg else "error",
                    retx=int(conn.sender.loss_events) + attempt, x=x)
            on_fail(msg)

        def on_close(now):
            if got["n"] < want:
                on_error("connection closed by peer (short response)")

        conn.on_connected = on_connected
        conn.on_data = on_data
        conn.on_error = on_error
        conn.on_close = on_close
        if idle_ns:
            conn.set_idle_timeout(idle_ns)
        conn.connect()

    attempt_fetch(0)


class WebOrigin:
    """Origin server. args: [port]"""

    def __init__(self, api, args, env):
        self.api = api
        self.port = int(args[0]) if args else 80
        self.served = 0

    def start(self):
        self.api.listen(self.port, self._on_accept)

    def _on_accept(self, conn, now):
        buf = {"b": b""}
        pending = {"n": 0}

        def push(room=0):
            if pending["n"] > 0:
                pending["n"] -= conn.send(pending["n"])

        def on_data(nbytes, payload, t):
            for _obj, want in parse_requests(buf, payload):
                if want > 0:
                    self.served += 1
                    pending["n"] += want
            push()

        conn.on_data = on_data
        conn.on_drain = push

    def stop(self):
        pass


def is_cache_hit(obj: bytes, hit_pct: int) -> bool:
    """The hit-ratio knob: deterministic per-object hash — the same
    ~hit_pct% of the object population hits on every plane/policy/run."""
    return zlib.crc32(obj) % 100 < hit_pct


class WebEdge:
    """Edge cache. args: [port, origin_name, origin_port, hit_pct]

    environment:
      WEB_EDGE_RETRIES (default 1): origin-fetch retries on ETIMEDOUT
                       before the client connection is closed (the
                       client's own on_close/retry then owns recovery)
      WEB_EDGE_IDLE_TIMEOUT_SEC (default 30): idle timeout on origin
                       connections, so an origin that goes silent
                       mid-response (crash, long partition) surfaces as
                       ETIMEDOUT instead of a stuck proxy fetch
    """

    def __init__(self, api, args, env):
        self.api = api
        self.port = int(args[0]) if args else 80
        self.origin = args[1] if len(args) > 1 else "origin0"
        self.origin_port = int(args[2]) if len(args) > 2 else 80
        self.hit_pct = int(args[3]) if len(args) > 3 else 80
        self.retries = int(env.get("WEB_EDGE_RETRIES", 1))
        self.idle_ns = int(
            float(env.get("WEB_EDGE_IDLE_TIMEOUT_SEC", 30)) * NS_PER_SEC)
        self.hits = 0
        self.misses = 0
        host = getattr(api, "_host", None)
        self._tel = getattr(host, "telemetry", None)

    def start(self):
        self.origin_id = self.api.resolve(self.origin)
        self.api.listen(self.port, self._on_accept)

    def _on_accept(self, conn, now):
        buf = {"b": b""}
        #: per-request FIFO of {want, ready}: the counted-byte protocol
        #: has no framing, so response bytes must leave in REQUEST order
        #: — a hit pipelined behind a pending miss waits for it
        queue = []
        pending = {"n": 0}
        dead = {"v": False}

        def push(room=0):
            if dead["v"]:
                return
            while queue and queue[0]["ready"]:
                pending["n"] += queue.pop(0)["want"]
            if pending["n"] > 0:
                pending["n"] -= conn.send(pending["n"])

        def on_data(nbytes, payload, t):
            for obj, want in parse_requests(buf, payload):
                if want <= 0:
                    continue
                entry = {"want": want, "ready": False}
                queue.append(entry)
                if is_cache_hit(obj, self.hit_pct):
                    self.hits += 1
                    entry["ready"] = True
                else:
                    self.misses += 1
                    self._fetch_origin(conn, obj, entry, push)
            push()

        def on_dead(*_a):
            # the client connection is gone (reset after DATA_RETRIES
            # during a partition, or fully closed): drop the response
            # backlog so a late origin-miss completion can't queue bytes
            # and re-arm RTO cycles on the dead sender
            dead["v"] = True
            queue.clear()
            pending["n"] = 0

        conn.on_data = on_data
        conn.on_drain = push
        conn.on_close = on_dead
        conn.on_error = on_dead

    def _fetch_origin(self, conn, obj, entry, push):
        """Proxy a miss: fetch ``entry["want"]`` counted bytes from the
        origin (store-and-forward), then mark the response entry ready —
        push() releases it in request order. A terminal origin failure
        closes the client connection — the client's on_close sees a
        short response and owns recovery — so a dead origin can never
        strand the client's page loop."""
        def on_ok(oc, got_n, t_open, ttfb, now, retx):
            if self._tel is not None:
                self.api._host.record_flow(
                    "web.origin", self.origin, t_open, ttfb, got_n,
                    "ok", retx=retx)
            oc.close()
            entry["ready"] = True
            push()

        fetch_counted(self.api, self._tel, self.origin_id,
                      self.origin_port, obj, entry["want"],
                      flow_kind="web.origin", peer=self.origin,
                      retries=self.retries, idle_ns=self.idle_ns,
                      on_ok=on_ok, on_fail=lambda msg: conn.close())

    def stop(self):
        self.api.log(f"edge done: hits={self.hits} misses={self.misses}")


class WebClient:
    """Page-fetch loop.
    args: [pages, fanout, main_bytes, sub_bytes, port, resolver, edge...]

    Each page: DNS-resolve a seeded-random edge from the list, fetch the
    main object, then ``fanout`` subresources in parallel, think, next.

    environment:
      WEB_THINK_SEC   (default 1.0): mean think time between pages
                      (seeded uniform on [0, 2*mean); 0 disables)
      WEB_RETRIES     (default 0): per-object ETIMEDOUT reconnects
      WEB_IDLE_TIMEOUT_SEC (default 30): per-fetch idle timeout — a
                      silent edge (crashed, partitioned past SYN
                      retries) fails the fetch with ETIMEDOUT instead
                      of stranding the page loop forever
      WEB_DNS_PORT    (default 53), DNS_RETRY_SEC (default 1),
      DNS_TRIES       (default 4): stub resolver knobs (models/dns.py)
    """

    def __init__(self, api, args, env):
        from shadow_tpu_torch.utils.units import parse_size

        self.api = api
        self.pages = int(args[0]) if args else 1
        self.fanout = int(args[1]) if len(args) > 1 else 4
        self.main_bytes = parse_size(args[2]) if len(args) > 2 else 100_000
        self.sub_bytes = parse_size(args[3]) if len(args) > 3 else 30_000
        self.port = int(args[4]) if len(args) > 4 else 80
        self.resolver = args[5] if len(args) > 5 else "resolver0"
        self.edges = args[6:]
        self.think_ns = int(
            float(env.get("WEB_THINK_SEC", 1.0)) * NS_PER_SEC)
        self.retries = int(env.get("WEB_RETRIES", 0))
        self.idle_ns = int(
            float(env.get("WEB_IDLE_TIMEOUT_SEC", 30)) * NS_PER_SEC)
        self.dns_port = int(env.get("WEB_DNS_PORT", 53))
        self.dns_retry_ns = int(
            float(env.get("DNS_RETRY_SEC", 1)) * NS_PER_SEC)
        self.dns_tries = int(env.get("DNS_TRIES", 4))
        self.pages_done = 0
        self.objects_ok = 0
        self.objects_failed = 0
        self.dns_failed = 0
        self.page_times = []
        host = getattr(api, "_host", None)
        self._tel = getattr(host, "telemetry", None)

    def start(self):
        from shadow_tpu_torch.models.dns import DnsStub

        if not self.edges:
            self.api.log("web client: no edges configured")
            self.api.exit(1)
            return
        self.stub = DnsStub(self.api, self.resolver, self.dns_port,
                            self.dns_retry_ns, self.dns_tries)
        self._page(0)

    # -- page machinery ----------------------------------------------------
    def _page(self, p):
        rng = self.api.rng
        edge = self.edges[int(rng.integers(0, len(self.edges)))]
        t_page = self.api.now

        def resolved(hid):
            if hid is None:
                self.dns_failed += 1
                self._page_done(p, t_page, failed=True)
                return
            self._fetch_page(p, hid, edge, t_page)

        self.stub.lookup(edge, resolved)

    def _fetch_page(self, p, edge_id, edge_name, t_page):
        me = self.api.host_id
        main_obj = b"h%d.p%d.m" % (me, p)
        state = {"left": 1 + self.fanout, "failed": 0}

        def one_done(ok):
            if not ok:
                state["failed"] += 1
            state["left"] -= 1
            if state["left"] == 0:
                self._page_done(p, t_page, failed=state["failed"] > 0)

        def main_done(ok):
            if not ok:
                # the page skeleton failed: subresources never start
                state["left"] = 1
                one_done(False)
                return
            one_done(True)
            for k in range(self.fanout):
                self._fetch(b"h%d.p%d.s%d" % (me, p, k), self.sub_bytes,
                            edge_id, edge_name, one_done)

        self._fetch(main_obj, self.main_bytes, edge_id, edge_name,
                    main_done)

    def _fetch(self, obj, want, edge_id, edge_name, done):
        def on_ok(conn, got_n, t_open, ttfb, now, retx):
            self.objects_ok += 1
            if self._tel is not None:
                self.api._host.record_flow(
                    "web.fetch", edge_name, t_open, ttfb, got_n, "ok",
                    retx=retx)
            conn.close()
            done(True)

        def on_fail(msg):
            self.objects_failed += 1
            done(False)

        fetch_counted(self.api, self._tel, edge_id, self.port, obj, want,
                      flow_kind="web.fetch", peer=edge_name,
                      retries=self.retries, idle_ns=self.idle_ns,
                      on_ok=on_ok, on_fail=on_fail)

    def _page_done(self, p, t_page, failed):
        self.pages_done += 1
        if not failed:
            self.page_times.append(self.api.now - t_page)
        if self.pages_done >= self.pages:
            self.api.log(
                f"web client done: pages={self.pages_done} "
                f"objects_ok={self.objects_ok} "
                f"objects_failed={self.objects_failed} "
                f"dns_failed={self.dns_failed}")
            self.api.exit(0 if self.objects_failed == 0
                          and self.dns_failed == 0 else 1)
            return
        delay = 1
        if self.think_ns > 0:
            delay = 1 + int(float(self.api.rng.random()) * 2 * self.think_ns)
        self.api.after(delay, lambda: self._page(p + 1))

    def stop(self):
        pass
