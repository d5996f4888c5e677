"""Transmission units — the simulator's wire-level quantum.

The reference models individual packets (SURVEY.md §2 "Packet"); we batch at
a slightly coarser quantum called a *unit*: up to experimental.unit_mtus
MTU-sized packets
that travel together (loss is still sampled per MTU packet inside the unit,
see network/fluid.py). Streams are chunked into units by the
transport; datagrams are fragmented into units by the socket layer. This
keeps per-round batches small enough for Python assembly while the math
stays per-packet-faithful.

uid layout: (host_id << 32) | per-host counter — globally unique and
assignable without cross-thread/cross-process coordination, so unit
creation is deterministic under every scheduler policy AND every
sim_shards partition (the uid doubles as the canonical BAND_NET event
key). The 32-bit counter keeps host ids inside uid_hi below the
threefry packet lane (fluid.PKT_SHIFT), admitting 2**26 hosts.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from shadow_tpu_torch.core.time import SimTime
from shadow_tpu_torch.network.fluid import HARD_MAX_PKTS, HEADER, MTU

# unit kinds
SYN, SYNACK, DATA, ACK, FIN, FINACK, DGRAM = range(7)
KIND_NAMES = ("SYN", "SYNACK", "DATA", "ACK", "FIN", "FINACK", "DGRAM")


@dataclass(slots=True)
class Unit:
    """One unit of the per-unit plane (network/engine.py, behind the
    thread policies). The columnar plane carries the same fields as a
    tuple row and never builds one."""

    uid: int
    src: int  # source host id
    dst: int  # destination host id
    size: int  # wire bytes (payload + HEADER)
    t_emit: SimTime
    kind: int
    src_port: int
    dst_port: int
    nbytes: int = 0  # application payload byte count
    payload: Optional[bytes] = None
    seq: int = 0  # stream byte offset / datagram id
    frag_idx: int = 0
    nfrags: int = 1

    @property
    def npkts(self) -> int:
        return min(max(1, -(-self.size // MTU)), HARD_MAX_PKTS)


def wire_size(payload_bytes: int) -> int:
    return payload_bytes + HEADER
