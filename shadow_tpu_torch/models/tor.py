"""The port of shadow_tpu/models/tor.py, unchanged but for its imports: the
relay, exit and client, the C relay data path (``core.relay_new``,
``exit_stream``) and the C client sink (``core.tor_client_sink``) when the
C engine runs the host; the clients' ``tor_fetch`` flow records go to
``Host.record_flow``, as the reference's do.

Tor-shaped onion-routing workload (BASELINE.md config #3).

Models the traffic *shape* of the reference's headline use case — the Tor
network simulated by Shadow — without the cryptography: clients build
3-hop circuits (guard, middle, exit chosen deterministically from the
per-host RNG), telescope them with CREATE/EXTEND cells, then stream data
through the circuit from a destination server via the exit. Every hop is a
separate simulated TCP stream; relays maintain a circuit table and forward
cells/bytes hop by hop, so the model exercises multi-hop stream relaying,
connection fan-in at relays, and cascaded congestion control — the load
profile of BASELINE config #3 (tornettools-shaped topologies).

Wire protocol (framed over the byte stream; send boundaries may split but
never merge, and byte counts are exact):
  control cell: 12 real bytes [type:1][circ:2][len:2][pad:7] + len real
                payload bytes (e.g. the EXTEND target's name)
  data:         a DATA header cell followed by `len` counted bytes
                (synthetic payload — only byte counts matter)

Cell types: CREATE, CREATED, EXTEND, EXTENDED, BEGIN, CONNECTED, DATA, END.
"""

from __future__ import annotations

from shadow_tpu_torch.utils.units import parse_size

HDR = 12
CREATE, CREATED, EXTEND, EXTENDED, BEGIN, CONNECTED, DATA, END = range(8)


def cell(ctype: int, circ: int, payload: bytes = b"") -> bytes:
    return (bytes([ctype]) + circ.to_bytes(2, "big")
            + len(payload).to_bytes(2, "big") + b"\0" * 7 + payload)


def data_header(circ: int, body_len: int) -> bytes:
    """A DATA cell header announcing `body_len` counted bytes to follow."""
    return (bytes([DATA]) + circ.to_bytes(2, "big")
            + body_len.to_bytes(2, "big") + b"\0" * 7)


class FrameReader:
    """Reassembles the framed protocol from (nbytes, payload|None) chunks.

    Control bytes arrive as real payload; DATA bodies arrive as counted
    synthetic bytes. on_cell(type, circ, payload); on_body(circ, nbytes).
    """

    def __init__(self, on_cell, on_body, on_data_hdr=None):
        self.buf = b""
        self.body_left = 0
        self.body_circ = 0
        self.on_cell = on_cell
        self.on_body = on_body
        self.on_data_hdr = on_data_hdr  # (circ, body_len); relays forward it

    def feed(self, nbytes: int, payload) -> None:
        if self.body_left > 0 and payload is None:
            take = min(nbytes, self.body_left)
            self.body_left -= take
            self.on_body(self.body_circ, take)
            if nbytes > take:  # next body's bytes can't precede its header
                raise ValueError("framing error: stray counted bytes")
            return
        if payload is None:
            raise ValueError("framing error: counted bytes outside DATA body")
        self.buf += payload
        while len(self.buf) >= HDR:
            ctype = self.buf[0]
            circ = int.from_bytes(self.buf[1:3], "big")
            ln = int.from_bytes(self.buf[3:5], "big")
            if ctype == DATA:
                self.buf = self.buf[HDR:]
                self.body_left = ln
                self.body_circ = circ
                if self.on_data_hdr is not None:
                    self.on_data_hdr(circ, ln)
                return  # counted body follows in subsequent chunks
            if len(self.buf) < HDR + ln:
                return
            payload_bytes = self.buf[HDR: HDR + ln]
            self.buf = self.buf[HDR + ln:]
            self.on_cell(ctype, circ, payload_bytes)


class _Conn:
    """One framed connection (either direction) owned by a relay/client.

    Writes go through a pending queue pumped by on_drain: send() accepts
    only what the bounded socket send buffer can hold, and a partially
    written frame header would desync the peer's FrameReader."""

    __slots__ = ("ep", "reader", "pending")

    def __init__(self, ep, on_cell, on_body, on_data_hdr=None):
        self.ep = ep
        self.reader = FrameReader(on_cell, on_body, on_data_hdr)
        self.pending = []  # ('p', bytes, offset) | ('n', count)
        ep.on_data = lambda n, p, now: self.reader.feed(n, p)
        ep.on_drain = lambda room: self._pump()

    def write(self, payload: bytes) -> None:
        self.pending.append(["p", payload, 0])
        self._pump()

    def write_counted(self, nbytes: int) -> None:
        self.pending.append(["n", nbytes])
        self._pump()

    def _pump(self) -> None:
        while self.pending:
            head = self.pending[0]
            if head[0] == "p":
                sent = self.ep.send(payload=head[1][head[2]:])
                head[2] += sent
                done = head[2] >= len(head[1])
            else:
                sent = self.ep.send(nbytes=head[1])
                head[1] -= sent
                done = head[1] <= 0
            if done:
                self.pending.pop(0)
            if sent == 0 and not done:
                return  # buffer full; on_drain resumes

    def close_when_drained(self) -> None:
        if not self.pending:
            self.ep.close()
        else:
            prev = self.ep.on_drain

            def pump_then_close(room):
                prev(room)
                if not self.pending:
                    self.ep.close()

            self.ep.on_drain = pump_then_close


class TorRelay:
    """args: [or_port]"""

    def __init__(self, api, args, env):
        self.api = api
        self.port = int(args[0]) if args else 9001
        # circuit table: (conn id, circ) -> (peer conn, peer circ) both ways
        self.table = {}
        self.conns = {}
        self._next_conn = 0
        self._next_circ = 1
        self.cells_relayed = 0
        self.bytes_relayed = 0
        self._c = None  # C relay data path (plain relays on the C engine)

    def _c_engine(self):
        """The engine gate shared by relay and exit starts: the C relay
        data path engages when the C engine runs this host and no pcap
        capture needs the Python dispatch."""
        host = getattr(self.api, "_host", None)
        core = getattr(getattr(host, "colplane", None), "_c", None)
        if core is not None and host.pcap is None:
            return core
        return None

    def start(self):
        # relays delegate the hot path (frame parsing, circuit
        # forwarding, pending-write pumping) to the C engine; the control
        # plane (EXTEND connects, teardown observation) stays here.
        # TorExit runs the same C relay in exit mode (BEGIN cells reach
        # its _on_ctrl; the reframe loop is a C ExitStream).
        core = self._c_engine()
        if type(self) is TorRelay and core is not None:
            self._c = core.relay_new(self.api._host.id, self._on_ctrl)
            self.api.listen(self.port, self._on_accept_c)
            return
        self.api.listen(self.port, self._on_accept)

    # -- C data-path control plane -----------------------------------------
    def _on_accept_c(self, ep, now):
        self._c.add_conn(ep)

    def _on_ctrl(self, cid, ctype, circ, payload):
        # only EXTEND-at-circuit-head reaches Python: open the next-hop
        # connection and splice a fresh segment into the C table
        target, port = payload.decode().rsplit(":", 1)
        ep = self.api.connect(target, int(port))
        ncid = self._c.add_conn(ep)
        ncirc = self._c.splice(cid, circ, ncid)
        ep.on_connected = lambda now: self._c.write_cell(
            ncid, CREATE, ncirc)
        ep.connect()

    def _new_conn(self, ep):
        cid = self._next_conn
        self._next_conn += 1
        conn = _Conn(ep,
                     lambda t, c, p: self._on_cell(cid, t, c, p),
                     lambda c, n: self._on_body(cid, c, n),
                     lambda c, ln: self._on_data_hdr(cid, c, ln))
        self.conns[cid] = conn
        # circuit teardown cascades along the connection chain: when one
        # side closes, close every spliced peer connection too
        ep.on_close = lambda now: self._on_conn_close(cid)
        return cid, conn

    def _on_conn_close(self, cid):
        self.conns.pop(cid, None)
        peers = [v for k, v in self.table.items() if k[0] == cid]
        self.table = {k: v for k, v in self.table.items()
                      if k[0] != cid and v[0] != cid}
        for ncid, _ in peers:
            pc = self.conns.get(ncid)
            if pc is not None:
                pc.close_when_drained()

    def _on_accept(self, ep, now):
        self._new_conn(ep)

    def _on_cell(self, cid, ctype, circ, payload):
        api = self.api
        key = (cid, circ)
        if ctype == CREATE:
            self.conns[cid].write(cell(CREATED, circ))
            return
        if ctype == EXTEND and key not in self.table:
            # this relay is the circuit's current endpoint: open a
            # connection to the named next relay and splice a new segment
            # (an EXTEND for a further hop falls through to forwarding)
            target, port = payload.decode().rsplit(":", 1)
            ep = api.connect(target, int(port))
            ncid, nconn = self._new_conn(ep)
            ncirc = self._next_circ
            self._next_circ += 1
            self.table[key] = (ncid, ncirc)
            self.table[(ncid, ncirc)] = key

            def on_connected(now):
                nconn.write(cell(CREATE, ncirc))

            ep.on_connected = on_connected
            ep.connect()
            return
        if ctype == CREATED:
            back = self.table.get((cid, circ))
            if back is not None:
                self.conns[back[0]].write(cell(EXTENDED, back[1]))
            return
        # everything else forwards along the circuit unchanged
        nxt = self.table.get(key)
        if nxt is None:
            return
        self.cells_relayed += 1
        self.conns[nxt[0]].write(cell(ctype, nxt[1], payload))

    def _on_data_hdr(self, cid, circ, body_len):
        nxt = self.table.get((cid, circ))
        if nxt is not None:
            self.conns[nxt[0]].write(data_header(nxt[1], body_len))

    def _on_body(self, cid, circ, nbytes):
        nxt = self.table.get((cid, circ))
        if nxt is None:
            return
        self.bytes_relayed += nbytes
        self.conns[nxt[0]].write_counted(nbytes)

    def stop(self):
        cells, nbytes = self.cells_relayed, self.bytes_relayed
        if self._c is not None:
            cells, nbytes = self._c.stats()
        self.api.log(f"relay done: cells={cells} bytes={nbytes}")


class TorExit(TorRelay):
    """An exit relay: terminates BEGIN cells by fetching from the
    destination (a tgen-format server) and streaming DATA back.

    On the C engine the whole data path is native (round 5): forwarding
    rides the C relay like plain relays, and the server->client reframe
    loop runs as a C ExitStream — only the BEGIN/EXTEND control cells
    (one each per circuit) reach Python.

    args: [or_port]
    """

    def start(self):
        core = self._c_engine()
        if core is not None:
            self._c = core.relay_new(self.api._host.id, self._on_ctrl,
                                     True)
            self.api.listen(self.port, self._on_accept_c)
            return
        self.api.listen(self.port, self._on_accept)

    def _on_ctrl(self, cid, ctype, circ, payload):
        if ctype != BEGIN:
            super()._on_ctrl(cid, ctype, circ, payload)
            return
        # exit termination: connect to the destination, announce
        # CONNECTED, and hand the reframe loop to the C stream
        dest, port, want = payload.decode().split(":")
        api = self.api
        ep = api.connect(dest, int(port))
        want_n = int(want)

        def on_connected(now):
            ep.send(payload=str(want_n).encode().rjust(8))
            self._c.write_cell(cid, CONNECTED, circ)

        ep.on_connected = on_connected
        self._c.exit_stream(ep, cid, circ, want_n)
        ep.connect()

    def _on_cell(self, cid, ctype, circ, payload):
        if ctype != BEGIN or (cid, circ) in self.table:
            # mid-circuit relays forward BEGIN; only the endpoint exits
            super()._on_cell(cid, ctype, circ, payload)
            return
        dest, port, want = payload.decode().split(":")
        api = self.api
        ep = api.connect(dest, int(port))
        got = {"n": 0}
        want_n = int(want)

        def on_connected(now):
            ep.send(payload=str(want_n).encode().rjust(8))
            self.conns[cid].write(cell(CONNECTED, circ))

        def on_data(nbytes, p, now):
            got["n"] += nbytes
            # re-frame the fetched bytes as circuit DATA toward the client
            out = self.conns[cid]
            out.write(data_header(circ, nbytes))
            out.write_counted(nbytes)
            if got["n"] >= want_n:
                ep.close()
                out.write(cell(END, circ))

        ep.on_connected = on_connected
        ep.on_data = on_data
        ep.connect()


class TorClient:
    """args: [n_relays, relay_port, server, server_port, size, circuits,
              n_exits?]

    Relay hosts must be named relay0..relayN-1; when ``n_exits`` is given,
    relay0..relay{n_exits-1} are the exit-capable population (the
    generator places TorExit processes there) and the circuit's LAST hop
    is drawn from it — a plain TorRelay cannot terminate a BEGIN. Without
    it, every relay is assumed exit-capable (the pre-round-4 behavior).
    The client telescopes guard->middle->exit, BEGINs a fetch of `size`
    bytes from `server`, and records completion.
    """

    def __init__(self, api, args, env):
        self.api = api
        self.n_relays = int(args[0])
        self.relay_port = int(args[1])
        self.server = args[2]
        self.server_port = int(args[3])
        self.size = parse_size(args[4]) if len(args) > 4 else 100_000
        self.n_circuits = int(args[5]) if len(args) > 5 else 1
        self.n_exits = int(args[6]) if len(args) > 6 else self.n_relays
        self.completed = 0
        self.failed = 0
        self.attempted = 0
        self.completion_times = []  # ns, fetch end-to-end (incl. build)
        self.build_times = []  # ns, telescoping (CREATE..last EXTENDED)

    def start(self):
        for _ in range(self.n_circuits):
            self._build_circuit()

    def _pick_hops(self):
        # exit drawn FIRST (from the exit-capable population), then
        # guard/middle from the full relay range excluding it — the
        # other order can spin forever when every exit is already a
        # guard/middle (e.g. n_exits=1)
        rng = self.api.rng
        exit_r = int(rng.integers(0, self.n_exits))
        hops = [exit_r]
        while len(hops) < 3:
            r = int(rng.integers(0, self.n_relays))
            if r not in hops:
                hops.append(r)
        return [f"relay{hops[1]}", f"relay{hops[2]}", f"relay{exit_r}"]

    def _build_circuit(self):
        api = self.api
        hops = self._pick_hops()
        self.attempted += 1
        t0 = api.now
        circ = 1
        # stage: hops established so far (guard = 1); bd: telescoping-done
        # instant — the tor fetch's TTFB analog for the telemetry flow
        # record (observable identically under the Python closures and the
        # C tor sink: both fire on_ctrl for every control cell)
        state = {"stage": 0, "bd": None}
        tel = getattr(getattr(api, "_host", None), "telemetry", None)

        ep = api.connect(hops[0], self.relay_port)

        def advance():
            if state["stage"] < 3:
                nxt = hops[state["stage"]]
                conn.write(cell(
                    EXTEND, circ, f"{nxt}:{self.relay_port}".encode()))
            else:
                conn.write(cell(
                    BEGIN, circ,
                    f"{self.server}:{self.server_port}:{self.size}".encode()))

        def finish_fetch(got):
            elapsed = api.now - t0
            if got >= self.size:
                self.completed += 1
                self.completion_times.append(elapsed)
                api.log(f"circuit-complete hops={hops} bytes={got} "
                        f"elapsed_ms={elapsed // 1_000_000}")
            else:
                self.failed += 1
            if tel is not None:
                api._host.record_flow(
                    "tor_fetch", self.server, t0, state["bd"], got,
                    "ok" if got >= self.size else "error",
                    retx=int(ep.sender.loss_events))
            ep.close()
            self._finish()

        def on_ctrl(ctype, got):
            if ctype in (CREATED, EXTENDED):
                state["stage"] += 1
                if state["stage"] == 3:  # telescoping done; BEGIN follows
                    self.build_times.append(api.now - t0)
                    state["bd"] = api.now
                advance()
            elif ctype == END:
                finish_fetch(got)

        host = getattr(api, "_host", None)
        core = getattr(getattr(host, "colplane", None), "_c", None)
        make_sink = getattr(core, "tor_client_sink", None)
        if make_sink is not None and host.pcap is None:
            # C-engine endpoint: frame parsing, DATA-body byte counting,
            # AND the circuit-build control plane run in native/colcore
            # (TorSink). The sink holds the three pre-built advance
            # frames and answers each CREATED/EXTENDED natively through
            # its own pending-write queue; Python sees exactly two
            # events per circuit — the stage-3 EXTENDED (record the
            # build time) and END (finish the fetch). Exact twin of the
            # closures below (same cells, same order, same instants).
            frames = (
                cell(EXTEND, circ, f"{hops[1]}:{self.relay_port}".encode()),
                cell(EXTEND, circ, f"{hops[2]}:{self.relay_port}".encode()),
                cell(BEGIN, circ,
                     f"{self.server}:{self.server_port}:{self.size}"
                     .encode()),
            )

            def on_ctrl_c(ctype, c, payload, got):
                if ctype == END:
                    finish_fetch(got)
                else:  # the stage-3 EXTENDED: telescoping done
                    self.build_times.append(api.now - t0)
                    state["bd"] = api.now

            conn = make_sink(ep, on_ctrl_c, frames)
        else:
            got = {"n": 0}

            def on_cell(ctype, c, payload):
                on_ctrl(ctype, got["n"])

            def on_body(c, nbytes):
                got["n"] += nbytes

            conn = _Conn(ep, on_cell, on_body)

        def on_connected(now):
            conn.write(cell(CREATE, circ))

        def on_error(msg):
            self.failed += 1
            api.log(f"circuit-failed hops={hops}: {msg}")
            if tel is not None:
                api._host.record_flow(
                    "tor_fetch", self.server, t0, state["bd"], 0,
                    "timeout" if "ETIMEDOUT" in msg else "error",
                    retx=int(ep.sender.loss_events))
            self._finish()

        ep.on_connected = on_connected
        ep.on_error = on_error
        ep.connect()

    def _finish(self):
        if self.completed + self.failed >= self.n_circuits:
            self.api.log(
                f"tor client done: {self.completed}/{self.n_circuits} ok")
            self.api.exit(0 if self.failed == 0 else 1)

    def stop(self):
        pass
