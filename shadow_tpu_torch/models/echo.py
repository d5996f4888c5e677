"""Minimal UDP echo pair — the simulator's smoke-test workload."""

from __future__ import annotations

from shadow_tpu_torch.core.time import NS_PER_SEC


class EchoServer:
    """args: [port]"""

    def __init__(self, api, args, env):
        self.api = api
        self.port = int(args[0]) if args else 9000

    def start(self):
        sock = self.api.udp_socket(self.port)
        sock.on_datagram = self._on_dgram
        self.sock = sock
        self.api.log(f"echo server listening on {self.port}")

    def _on_dgram(self, nbytes, payload, src_addr, now):
        src_host, src_port = src_addr
        self.sock.sendto(src_host, src_port, nbytes=nbytes, payload=payload)

    def stop(self):
        pass


class EchoClient:
    """args: [server, port, count?, payload?]"""

    def __init__(self, api, args, env):
        self.api = api
        self.server = args[0]
        self.port = int(args[1]) if len(args) > 1 else 9000
        self.count = int(args[2]) if len(args) > 2 else 3
        self.payload = (args[3].encode() if len(args) > 3 else b"ping")
        self.sent = 0
        self.received = 0
        self.rtts = []
        self._t_sent = {}

    def start(self):
        self.sock = self.api.udp_socket()
        self.sock.on_datagram = self._on_reply
        self._send_next()

    def _send_next(self):
        if self.sent >= self.count:
            return
        self.sent += 1
        self._t_sent[self.sent] = self.api.now
        server_id = self.api.resolve(self.server)
        self.sock.sendto(server_id, self.port, payload=self.payload)
        self.api.after(NS_PER_SEC, self._send_next)

    def _on_reply(self, nbytes, payload, src_addr, now):
        self.received += 1
        t0 = self._t_sent.get(self.received)
        if t0 is not None:
            rtt = now - t0
            self.rtts.append(rtt)
            self.api.log(f"echo reply {self.received}/{self.count} rtt={rtt}ns")
        if self.received >= self.count:
            self.api.exit(0)

    def stop(self):
        pass
