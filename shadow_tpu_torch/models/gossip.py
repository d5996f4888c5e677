"""The port of shadow_tpu/models/gossip.py, unchanged but for its imports.
Message handling runs in the C engine (``core.gossip_register``) whenever
the engine runs the host with telemetry off and no packet capture; with
telemetry on, fetch timing lives here and the handlers stay in Python, as
in the reference.

Bitcoin-like inv/getdata/tx gossip flood (BASELINE.md config 4).

Each node picks k peers (deterministically from its host RNG), originates
transactions on a timer, and floods them: announce (INV, 64B) -> request
(GETDATA, 64B) -> payload (TX, ~400B), all over datagrams. Stresses event
fan-out: one tx triggers O(k) messages per hop across the network.
"""

from __future__ import annotations

from shadow_tpu_torch.core.time import NS_PER_SEC

INV, GETDATA, TX = b"I", b"G", b"T"
TX_SIZE = 400


class GossipNode:
    """args: [port, n_hosts, k_peers, txs_to_originate, interval_sec]

    Peers are chosen as deterministic random host ids != self. Host names
    must be resolvable as ``node{i}`` (use quantity expansion with a host
    template named ``node``).

    environment GOSSIP_REANNOUNCE_SEC=S (default 0 = off): an originator
    re-announces its own transactions every S seconds — the minimal
    churn-survival behavior (a flood cut off by a partition or a crashed
    first hop restarts after the network heals; peers that already hold
    the tx answer nothing, so a healthy network sees only the INVs).
    """

    def __init__(self, api, args, env):
        self.api = api
        self.port = int(args[0]) if args else 7000
        self.n_hosts = int(args[1]) if len(args) > 1 else 10
        self.k = int(args[2]) if len(args) > 2 else 4
        self.originate = int(args[3]) if len(args) > 3 else 1
        self.interval = float(args[4]) if len(args) > 4 else 1.0
        self.reannounce = float(env.get("GOSSIP_REANNOUNCE_SEC", 0))
        self.seen: set[bytes] = set()
        self.own: list[bytes] = []  # txids this node originated
        self.received_tx = 0
        self.originated = 0
        self._c = None  # C gossip state (set in start when available)
        #: telemetry (shadow_tpu/telemetry/): pending GETDATA send times
        #: by txid — a flow record per INV->GETDATA->TX fetch closes when
        #: the TX lands. None when telemetry is off (zero per-message
        #: work; the C gossip twin then keeps the hot half).
        self._pending: dict = None

    def start(self):
        self.sock = self.api.udp_socket(self.port)
        self.sock.on_datagram = self._on_msg
        rng = self.api.rng
        me = self.api.host_id
        peers = set()
        while len(peers) < min(self.k, self.n_hosts - 1):
            p = int(rng.integers(0, self.n_hosts))
            if p != me:
                peers.add(p)
        self.peers = sorted(peers)
        # delegate the hot half (message handling, announce fan-out, the
        # seen set) to the C engine when the plane runs one — identical
        # logic, identical emissions (tests/test_colcore.py asserts the
        # whole output tree matches the pure-Python run)
        self._c = None
        host = getattr(self.api, "_host", None)
        cp = getattr(host, "colplane", None)
        core = getattr(cp, "_c", None)
        tel = getattr(host, "telemetry", None)
        if tel is not None:
            # telemetry: fetch timing lives in the model, so message
            # handling stays in Python — bit-identical to the C twin
            # (test_colcore asserts the whole output tree matches), only
            # wall time moves; the fetch records need the GETDATA instant
            self._pending = {}
        elif core is not None and host.pcap is None:
            self._c = core.gossip_register(host.id, self.port, self.peers)
        if self.originate > 0:
            delay = int((0.25 + 0.5 * float(rng.random())) * self.interval * NS_PER_SEC)
            self.api.after(delay, self._originate)
            if self.reannounce > 0:
                self.api.after(int(self.reannounce * NS_PER_SEC),
                               self._reannounce)

    def _originate(self):
        self.originated += 1
        txid = f"{self.api.host_id}:{self.originated}".encode()
        self.own.append(txid)
        if self._c is not None:
            self._c.originate(txid)
        else:
            self.seen.add(txid)
            self._announce(txid)
        if self.originated < self.originate:
            self.api.after(int(self.interval * NS_PER_SEC), self._originate)

    def _reannounce(self):
        for txid in self.own:
            self._announce(txid)
        self.api.after(int(self.reannounce * NS_PER_SEC), self._reannounce)

    def _announce(self, txid: bytes, exclude: int = -1):
        for p in self.peers:
            if p != exclude:
                self.sock.sendto(p, self.port, payload=INV + txid, nbytes=64)

    def _on_msg(self, nbytes, payload, src_addr, now):
        if self._c is not None:
            # Python-delivered paths (deferred-ingress drains, fragmented
            # datagrams) re-enter the C state so seen/counters stay single
            self._c.on_msg(payload, src_addr[0], now)
            return
        if payload is None:
            return
        kind, txid = payload[:1], payload[1:]
        src_host, src_port = src_addr
        if kind == INV:
            if txid not in self.seen:
                pend = self._pending
                if pend is not None and txid not in pend:
                    # first GETDATA for this txid opens the fetch flow
                    if len(pend) > 4096:  # bound memory like _partial
                        pend.pop(next(iter(pend)))
                    pend[txid] = now
                self.sock.sendto(src_host, self.port, payload=GETDATA + txid, nbytes=64)
        elif kind == GETDATA:
            self.sock.sendto(src_host, self.port, payload=TX + txid, nbytes=TX_SIZE)
        elif kind == TX:
            if txid not in self.seen:
                self.seen.add(txid)
                self.received_tx += 1
                pend = self._pending
                if pend is not None:
                    t_open = pend.pop(txid, None)
                    if t_open is not None:
                        # datagram fetch: the TX is the first (and last)
                        # payload byte, so TTFB == completion latency
                        self.api._host.record_flow(
                            "gossip_fetch", src_host, t_open, now,
                            nbytes, "ok")
                self._announce(txid, exclude=src_host)

    def stop(self):
        received, known = self.received_tx, len(self.seen)
        if self._c is not None:
            received, known = self._c.stats()
        self.api.log(
            f"gossip done: originated={self.originated} received={received} "
            f"known={known}"
        )
