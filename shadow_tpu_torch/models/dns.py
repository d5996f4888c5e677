"""DNS resolution chains: authoritative servers, a caching recursive
resolver, and the stub client the web workload depends on.

The port of shadow_tpu/models/dns.py, unchanged but for its imports: the
stub's ``dns.resolve`` flow records go to ``Host.record_flow``, as the
reference's do.

The modern-web family needs name resolution as a
first-class simulated dependency — page fetch latency in production is
DNS + connect + transfer, and a resolver cache turns the first cost from
a multi-hop chain into a local hit. The model is deliberately small but
production-shaped:

- ``DnsAuth`` — an authoritative server: answers every query for a name
  the simulation can resolve with the target's host id (the simulated
  A record). One UDP round trip.
- ``DnsResolver`` — a caching RECURSIVE resolver: a client query either
  hits the TTL cache (answered immediately) or walks the configured
  upstream chain (root -> TLD -> authoritative, one UDP round trip per
  hop — the referral chain without zone-file bookkeeping), caches the
  final answer for ``DNS_TTL_SEC``, and answers every waiter that piled
  up behind the miss. Lost datagrams (lossy links, partitions) are
  repaired by a per-hop retry timer; exhausted retries answer SERVFAIL.
- ``DnsStub`` — the client half (not a process): owns an ephemeral UDP
  socket, matches answers to queries by qid, retries on timeout, and
  emits one ``dns.resolve`` flow record per lookup (ok / servfail /
  timeout) through the telemetry subsystem.

Wire format (payload bytes; sizes counted at ~72B per message):
query ``b"Q" + qid(4, BE) + name``; answer ``b"R" + qid + ascii host
id``; SERVFAIL ``b"N" + qid``.

Determinism: all timing is simulated, qids are per-socket counters, and
the cache is keyed on exact names — byte-identical across scheduler
policies and the Python/C transport twins (DNS rides datagrams, which
have no C fast path to diverge from).
"""

from __future__ import annotations

from shadow_tpu_torch.core.time import NS_PER_SEC

QUERY, ANSWER, SERVFAIL = b"Q", b"R", b"N"
DNS_MSG_BYTES = 72  # modeled wire size of every DNS message


def _pack(kind: bytes, qid: int, body: bytes = b"") -> bytes:
    return kind + qid.to_bytes(4, "big") + body


def _unpack(payload: bytes):
    return payload[:1], int.from_bytes(payload[1:5], "big"), payload[5:]


class DnsAuth:
    """Authoritative server. args: [port]"""

    def __init__(self, api, args, env):
        self.api = api
        self.port = int(args[0]) if args else 53
        self.answered = 0

    def start(self):
        self.sock = self.api.udp_socket(self.port)
        self.sock.on_datagram = self._on_msg

    def _on_msg(self, nbytes, payload, src_addr, now):
        if payload is None or payload[:1] != QUERY:
            return
        _k, qid, name = _unpack(payload)
        try:
            hid = self.api.resolve(name.decode())
        except (KeyError, ValueError):
            self.sock.sendto(src_addr[0], src_addr[1],
                             payload=_pack(SERVFAIL, qid),
                             nbytes=DNS_MSG_BYTES)
            return
        self.answered += 1
        self.sock.sendto(src_addr[0], src_addr[1],
                         payload=_pack(ANSWER, qid, str(hid).encode()),
                         nbytes=DNS_MSG_BYTES)

    def stop(self):
        pass


class DnsResolver:
    """Caching recursive resolver. args: [port, upstream, upstream, ...]

    The upstream list is the referral chain (e.g. root, tld, auth): a
    cache miss queries each in order, one round trip per hop; the LAST
    hop's answer is authoritative and enters the cache.

    environment:
      DNS_TTL_SEC    (default 60): cache lifetime of an answer
      DNS_RETRY_SEC  (default 1):  per-hop retransmit timer
      DNS_TRIES      (default 4):  per-hop attempts before SERVFAIL
    """

    def __init__(self, api, args, env):
        self.api = api
        self.port = int(args[0]) if args else 53
        self.upstreams = args[1:]
        self.ttl_ns = int(float(env.get("DNS_TTL_SEC", 60)) * NS_PER_SEC)
        self.retry_ns = int(float(env.get("DNS_RETRY_SEC", 1)) * NS_PER_SEC)
        self.tries = int(env.get("DNS_TRIES", 4))
        self.cache: dict[bytes, tuple[bytes, int]] = {}  # name -> (ans, exp)
        self.hits = 0
        self.misses = 0
        #: in-flight recursions by name: {"waiters": [(src, qid)...], ...}
        self._pending: dict[bytes, dict] = {}
        self._next_qid = 0

    def start(self):
        self.sock = self.api.udp_socket(self.port)
        self.sock.on_datagram = self._on_msg
        self.up_ids = [self.api.resolve(u) for u in self.upstreams]

    def _on_msg(self, nbytes, payload, src_addr, now):
        if payload is None:
            return
        kind, qid, body = _unpack(payload)
        if kind == QUERY:
            self._client_query(body, src_addr, qid, now)
        elif kind in (ANSWER, SERVFAIL):
            self._upstream_reply(kind, qid, body, now)

    def _client_query(self, name, src_addr, qid, now):
        ent = self.cache.get(name)
        if ent is not None and now < ent[1]:
            self.hits += 1
            self.sock.sendto(src_addr[0], src_addr[1],
                             payload=_pack(ANSWER, qid, ent[0]),
                             nbytes=DNS_MSG_BYTES)
            return
        self.misses += 1
        pend = self._pending.get(name)
        if pend is not None:  # recursion already running: pile on
            pend["waiters"].append((src_addr, qid))
            return
        self._pending[name] = {"waiters": [(src_addr, qid)], "hop": 0,
                               "attempt": 0, "qid": -1, "timer": None}
        self._query_hop(name, now)

    def _query_hop(self, name, now):
        pend = self._pending[name]
        qid = self._next_qid
        self._next_qid += 1
        pend["qid"] = qid
        pend["attempt"] += 1
        up = self.up_ids[pend["hop"]]
        # upstreams listen on the same port by convention
        self.sock.sendto(up, self.port,
                         payload=_pack(QUERY, qid, name),
                         nbytes=DNS_MSG_BYTES)
        pend["timer"] = self.api.after(
            self.retry_ns, lambda: self._hop_timeout(name))

    def _hop_timeout(self, name):
        pend = self._pending.get(name)
        if pend is None:
            return
        pend["timer"] = None
        if pend["attempt"] >= self.tries:
            self._finish(name, None)
            return
        self._query_hop(name, self.api.now)

    def _upstream_reply(self, kind, qid, body, now):
        # match the reply to its recursion by qid (names are unique keys;
        # a stale reply after a retry re-query simply misses)
        for name, pend in self._pending.items():
            if pend["qid"] == qid:
                break
        else:
            return
        if pend["timer"] is not None:
            self.api.cancel(pend["timer"])
            pend["timer"] = None
        if kind == SERVFAIL:
            self._finish(name, None)
            return
        pend["hop"] += 1
        pend["attempt"] = 0
        if pend["hop"] >= len(self.up_ids):
            # the final hop's answer is authoritative
            self.cache[name] = (body, now + self.ttl_ns)
            self._finish(name, body)
        else:
            self._query_hop(name, now)

    def _finish(self, name, answer):
        pend = self._pending.pop(name)
        for (src_addr, qid) in pend["waiters"]:
            if answer is None:
                self.sock.sendto(src_addr[0], src_addr[1],
                                 payload=_pack(SERVFAIL, qid),
                                 nbytes=DNS_MSG_BYTES)
            else:
                self.sock.sendto(src_addr[0], src_addr[1],
                                 payload=_pack(ANSWER, qid, answer),
                                 nbytes=DNS_MSG_BYTES)

    def stop(self):
        self.api.log(f"dns resolver done: hits={self.hits} "
                     f"misses={self.misses} cached={len(self.cache)}")


class DnsStub:
    """The client half of a lookup (owned by a workload model, not a
    process): per-lookup timeout/retry and one ``dns.resolve`` flow
    record per lookup. ``cb(hid_or_none)`` fires exactly once."""

    def __init__(self, api, resolver: str, port: int,
                 retry_ns: int, tries: int):
        self.api = api
        self.resolver = resolver
        self.resolver_id = api.resolve(resolver)
        self.port = port
        self.retry_ns = retry_ns
        self.tries = tries
        self.sock = api.udp_socket()  # ephemeral
        self.sock.on_datagram = self._on_msg
        self._next_qid = 0
        self._out: dict[int, dict] = {}  # qid -> lookup state

    def lookup(self, name: str, cb) -> None:
        qid = self._next_qid
        self._next_qid += 1
        self._out[qid] = {"name": name.encode(), "cb": cb, "attempt": 0,
                          "t_open": self.api.now, "timer": None}
        self._send(qid)

    def _send(self, qid):
        st = self._out[qid]
        st["attempt"] += 1
        self.sock.sendto(self.resolver_id, self.port,
                         payload=_pack(QUERY, qid, st["name"]),
                         nbytes=DNS_MSG_BYTES)
        st["timer"] = self.api.after(self.retry_ns,
                                     lambda: self._timeout(qid))

    def _timeout(self, qid):
        st = self._out.get(qid)
        if st is None:
            return
        st["timer"] = None
        if st["attempt"] >= self.tries:
            del self._out[qid]
            self._record(st, None, "timeout")
            st["cb"](None)
            return
        self._send(qid)

    def _on_msg(self, nbytes, payload, src_addr, now):
        if payload is None:
            return
        kind, qid, body = _unpack(payload)
        st = self._out.pop(qid, None)
        if st is None:
            return  # stale duplicate (a retry already won)
        if st["timer"] is not None:
            self.api.cancel(st["timer"])
        if kind == ANSWER:
            self._record(st, now, "ok")
            st["cb"](int(body.decode()))
        else:
            self._record(st, now, "servfail")
            st["cb"](None)

    def _record(self, st, t_answer, status):
        self.api._host.record_flow(
            "dns.resolve", self.resolver, st["t_open"], t_answer,
            DNS_MSG_BYTES, status, retx=st["attempt"] - 1)
