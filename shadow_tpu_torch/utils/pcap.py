"""Per-host pcap capture of simulated traffic.

Reference analog: SURVEY.md §2 "Pcap capture" (optional per-host pcap files
for wireshark analysis). Classic pcap format (not pcapng), LINKTYPE_RAW
(101): each record is a synthesized IPv4 packet — TCP for stream units, UDP
for datagrams — sized to the unit's wire size and truncated to the
configured capture size. One record per *unit* (a unit models up to
MAX_PKTS MTU packets travelling together; the record's orig_len reports the
full wire size, so byte accounting in analysis tools stays exact).

A copy of shadow_tpu/utils/pcap.py: the same records, byte for byte.
"""

from __future__ import annotations

import socket
import struct
from typing import Optional

from shadow_tpu_torch.core.time import NS_PER_SEC
from shadow_tpu_torch.network import unit as U

LINKTYPE_RAW = 101

_TCP_FLAGS = {
    U.SYN: 0x02, U.SYNACK: 0x12, U.DATA: 0x18,  # PSH|ACK
    U.ACK: 0x10, U.FIN: 0x11, U.FINACK: 0x11,
}


class PcapWriter:
    def __init__(self, path, snaplen: int = 65535) -> None:
        self.snaplen = int(snaplen)
        self._f = open(path, "wb")
        self._f.write(struct.pack(
            "<IHHiIII", 0xA1B2C3D4, 2, 4, 0, 0, self.snaplen, LINKTYPE_RAW))
        self.records = 0

    def capture(self, unit, t_ns: int, src_ip: str, dst_ip: str) -> None:
        self.capture_fields(unit.kind, unit.src_port, unit.dst_port,
                            unit.nbytes, unit.seq, unit.payload, t_ns,
                            src_ip, dst_ip)

    def capture_fields(self, kind: int, src_port: int, dst_port: int,
                       nbytes: int, seq: int, payload, t_ns: int,
                       src_ip: str, dst_ip: str) -> None:
        if kind == U.DGRAM:
            l4 = struct.pack(">HHHH", src_port, dst_port, 8 + nbytes, 0)
            proto = socket.IPPROTO_UDP
        else:
            l4 = struct.pack(">HHIIBBHHH", src_port, dst_port,
                             seq & 0xFFFFFFFF, 0, 5 << 4,
                             _TCP_FLAGS.get(kind, 0x10), 65535, 0, 0)
            proto = socket.IPPROTO_TCP
        payload = payload or b"\0" * nbytes
        total = 20 + len(l4) + len(payload)
        ip = struct.pack(">BBHHHBBH4s4s", 0x45, 0, total, self.records & 0xFFFF,
                         0, 64, proto, 0, socket.inet_aton(src_ip),
                         socket.inet_aton(dst_ip))
        pkt = (ip + l4 + payload)[: self.snaplen]
        self._f.write(struct.pack("<IIII", t_ns // NS_PER_SEC,
                                  (t_ns % NS_PER_SEC) // 1000, len(pkt), total))
        self._f.write(pkt)
        self.records += 1

    def close(self) -> None:
        self._f.close()


def read_packet_count(path) -> int:
    """Count records in a classic pcap file (tests/tooling helper)."""
    with open(path, "rb") as f:
        f.read(24)
        n = 0
        while True:
            hdr = f.read(16)
            if len(hdr) < 16:
                return n
            incl = struct.unpack("<IIII", hdr)[2]
            f.seek(incl, 1)
            n += 1
