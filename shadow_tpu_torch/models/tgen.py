"""tgen-shaped stream transfer workload.

Models the behavior of the reference's canonical workload (the tgen traffic
generator run as a managed process; SURVEY.md §1, BASELINE.md configs 1-2):
clients connect to servers, request a transfer of N bytes, the server
streams the bytes back, and the client records the completion. Repeats
``count`` times per peer, either round-robin or to every peer (all-to-all).

Request wire format (8 bytes of real payload): the requested size encoded
as decimal ASCII. Everything else is synthetic byte counts (no payload
materialization), which is what lets 100k-host configs fit in memory.
"""

from __future__ import annotations

from shadow_tpu_torch.core.time import NS_PER_MS, NS_PER_SEC


class TGenServer:
    """args: [port]"""

    def __init__(self, api, args, env):
        self.api = api
        self.port = int(args[0]) if args else 8080
        self.transfers = 0

    def start(self):
        self.api.listen(self.port, self._on_accept)
        self.api.log(f"tgen server listening on {self.port}")

    def _on_accept(self, conn, now):
        serve = getattr(conn, "tgen_serve", None)
        if serve is not None:
            # C-engine endpoint: request parsing and counted-byte pushing
            # run in the C engine (exact twin of the closures below, which
            # remain the Python-plane path); only the once-per-transfer
            # request notification comes back here
            def on_request(want):
                self.transfers += 1

            serve(on_request)
            return
        pending = {"n": 0}

        def push(room=0):
            # send() may accept only part (bounded send buffer); the rest
            # streams out through on_drain as acks free space
            if pending["n"] > 0:
                pending["n"] -= conn.send(pending["n"])

        def on_data(nbytes, payload, t):
            if payload is not None:
                try:
                    want = int(payload.decode().strip())
                except ValueError:
                    want = 0
                if want > 0:
                    self.transfers += 1
                    pending["n"] += want
                    push()

        conn.on_data = on_data
        conn.on_drain = push

    def stop(self):
        pass


class TGenClient:
    """args: [size, count, mode, port, peer, peer, ...]

    size:  bytes per transfer ("1 MB" style units ok)
    count: transfers per peer
    mode:  "serial" (one at a time round-robin) | "parallel" (all at once)

    environment TGEN_RETRIES=N (default 0): a transfer that dies with
    ETIMEDOUT (crashed peer, unhealed partition — the transport's terminal
    RTO path) reconnects up to N times before counting as failed, so churn
    configs run to completion. Non-timeout errors never retry.

    environment TGEN_IDLE_TIMEOUT_SEC=S (default 0 = off): arm the
    transport idle timeout on each connection — a client that is purely
    RECEIVING has no outstanding data, so only this detects a peer that
    crashed mid-response.
    """

    def __init__(self, api, args, env):
        from shadow_tpu_torch.utils.units import parse_size

        self.api = api
        self.size = parse_size(args[0]) if args else 1_000_000
        self.count = int(args[1]) if len(args) > 1 else 1
        self.mode = args[2] if len(args) > 2 else "serial"
        self.port = int(args[3]) if len(args) > 3 else 8080
        self.peers = args[4:]
        self.retries = int(env.get("TGEN_RETRIES", 0))
        self.idle_timeout_ns = int(
            float(env.get("TGEN_IDLE_TIMEOUT_SEC", 0)) * NS_PER_SEC)
        self.retried = 0
        self.completed = 0
        self.failed = 0
        self.total = self.count * len(self.peers)
        self.completion_times = []

    def start(self):
        if not self.peers:
            self.api.log("tgen client: no peers configured")
            self.api.exit(1)
            return
        if self.mode == "parallel":
            for peer in self.peers:
                for _ in range(self.count):
                    self._start_transfer(peer)
        else:
            self._serial_queue = [
                peer for _ in range(self.count) for peer in self.peers
            ]
            self._start_transfer(self._serial_queue.pop(0))

    def _start_transfer(self, peer, attempt=0):
        t_start = self.api.now
        conn = self.api.connect(peer, self.port)

        def on_connected(now):
            conn.send(payload=str(self.size).encode().rjust(8))

        def finish(now, got):
            elapsed = now - t_start
            self.completion_times.append(elapsed)
            self.completed += 1
            self.api.log(
                f"transfer-complete peer={peer} bytes={got} "
                f"elapsed_ms={elapsed // NS_PER_MS}"
            )
            conn.close()
            self._next()

        def on_error(msg):
            if "ETIMEDOUT" in msg and attempt < self.retries:
                self.retried += 1
                self.api.log(
                    f"transfer-retry peer={peer} attempt={attempt + 1}: {msg}")
                self._start_transfer(peer, attempt + 1)
                return
            self.failed += 1
            self.api.log(f"transfer-failed peer={peer}: {msg}")
            self._next()

        tgen_client = getattr(conn, "tgen_client", None)
        if tgen_client is not None:
            # C-engine endpoint: received-byte counting runs in the C
            # engine; finish fires once per transfer with the same
            # (now, got) the Python closure would compute
            tgen_client(self.size, finish)
        else:
            got = {"n": 0}

            def on_data(nbytes, payload, now):
                got["n"] += nbytes
                if got["n"] >= self.size:
                    finish(now, got["n"])

            conn.on_data = on_data
        conn.on_connected = on_connected
        conn.on_error = on_error
        if self.idle_timeout_ns:
            conn.set_idle_timeout(self.idle_timeout_ns)
        conn.connect()

    def _next(self):
        if self.completed + self.failed >= self.total:
            self.api.log(
                f"tgen client done: {self.completed}/{self.total} ok, "
                f"{self.failed} failed"
            )
            self.api.exit(0 if self.failed == 0 else 1)
            return
        if self.mode != "parallel" and self._serial_queue:
            self._start_transfer(self._serial_queue.pop(0))

    def stop(self):
        pass
