"""Minimal HTTP/1.0 server plugin — a destination for real HTTP clients
(e.g. a CPython guest using urllib) running inside the simulation.

args: [port, body_bytes]
"""

from __future__ import annotations


class HttpServer:
    def __init__(self, api, args, env):
        self.api = api
        self.port = int(args[0]) if args else 80
        self.body = int(args[1]) if len(args) > 1 else 100_000
        self.served = 0

    def start(self):
        self.api.listen(self.port, self._on_accept)

    def _on_accept(self, conn, now):
        req = {"buf": b""}

        def push(room=0):
            if req.get("left", 0) > 0:
                req["left"] -= conn.send(req["left"])

        def on_data(nbytes, payload, t):
            if "left" in req:
                return  # request already answered
            req["buf"] += payload or b""
            if b"\r\n\r\n" not in req["buf"]:
                return
            self.served += 1
            head = (f"HTTP/1.0 200 OK\r\nContent-Length: {self.body}\r\n"
                    f"Content-Type: application/octet-stream\r\n\r\n")
            conn.send(payload=head.encode())
            req["left"] = self.body
            push()

        conn.on_data = on_data
        conn.on_drain = push

    def stop(self):
        pass
