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

# unit kinds
SYN, SYNACK, DATA, ACK, FIN, FINACK, DGRAM = range(7)
