"""The determinism sentinel: canonical per-round state digests.

The part of shadow_tpu/checkpoint.py this package has ported (checkpoint
write and restore are not ported yet; config load refuses
``checkpoint_every``). ``state_digest`` hashes the same plane-independent
state with the same canonical encoding as the reference, so the port's
``state_digests.jsonl`` stream equals the reference's for the same config
and seed, and ``tools/bisect_divergence.py --a REF --b PORT`` names the
first round where they part.
"""

from __future__ import annotations

import hashlib
import json
import struct

import numpy as np

DIGEST_FILE = "state_digests.jsonl"


def _feed(h, obj) -> None:
    """Canonical byte encoding of the digest structure (type-tagged,
    length-prefixed; dict keys sorted) — stable across runs, policies,
    and platforms."""
    if obj is None:
        h.update(b"N")
    elif isinstance(obj, bool):
        h.update(b"T" if obj else b"F")
    elif isinstance(obj, (int, np.integer)):
        h.update(b"i%d;" % int(obj))
    elif isinstance(obj, float):
        h.update(b"f" + struct.pack("<d", obj))
    elif isinstance(obj, str):
        b = obj.encode()
        h.update(b"s%d:" % len(b) + b)
    elif isinstance(obj, (bytes, bytearray)):
        h.update(b"b%d:" % len(obj) + bytes(obj))
    elif isinstance(obj, (list, tuple)):
        h.update(b"[%d;" % len(obj))
        for x in obj:
            _feed(h, x)
    elif isinstance(obj, dict):
        h.update(b"{%d;" % len(obj))
        for k in sorted(obj):
            _feed(h, k)
            _feed(h, obj[k])
    elif isinstance(obj, np.ndarray):
        h.update(b"a" + str(obj.dtype).encode() + b"|"
                 + str(obj.shape).encode() + b"|")
        h.update(np.ascontiguousarray(obj).tobytes())
    else:
        raise TypeError(
            f"state digest: unhashable field type {type(obj).__name__}")


def _digest(obj) -> str:
    h = hashlib.sha256()
    _feed(h, obj)
    return h.hexdigest()


def state_digest(controller, sim_now: int):
    """Returns ``(global_digest_hex, {host_name: digest_hex})`` over the
    plane-independent state at the round boundary ``sim_now``.

    Calls ``engine.flush_all()`` first so both data planes (and the lazy
    draw coalescing inside each) sit at the same resolution frontier —
    early resolution is result-identical, so a digesting run stays
    byte-identical to a non-digesting one.
    """
    eng = controller.engine
    eng.flush_all()
    hosts = {}
    for h in controller.hosts:
        hosts[h.name] = _digest(h.state_fingerprint())
    g = {
        "t": sim_now,
        "rounds": controller.rounds,
        "events": controller.events,
        "units_sent": eng.units_sent,
        "units_dropped": eng.units_dropped,
        "units_blackholed": eng.units_blackholed,
        "bytes_sent": eng.bytes_sent,
        "ev_key": eng._ev_key,
        "tokens_down": eng.tokens_down,
        # egress buckets: hash the canonical observable, not the raw
        # (t_base, tokens, debt) triple — capped available-at-now
        # (fluid.TokenBuckets.levels, shared with the telemetry samplers)
        # is identical across planes: any divergence in actual bucket
        # BEHAVIOR must show here or in the unit counters.
        "bucket_avail": eng.buckets.levels(sim_now),
        "last_refill": eng._last_refill,
        # the effective latency/loss/rate matrices are deliberately NOT
        # hashed: they are pure functions of the config (pinned by
        # config_digest) and the applied-action cursor below, and at 10k+
        # graph nodes re-hashing O(nodes^2) matrices every sample would
        # dominate sentinel cost. A corrupted matrix without a moved
        # cursor still surfaces within a round or two through the arrival
        # times, unit counters, and endpoint state it must perturb.
        "faults": ((controller.faults.idx, controller.faults.applied)
                   if controller.faults is not None else None),
        "hosts": hosts,
    }
    return _digest(g), hosts


def emit_digest(controller, sim_now: int) -> None:
    """Append one sentinel record to <data_dir>/state_digests.jsonl."""
    g, hosts = state_digest(controller, sim_now)
    controller.data_dir.mkdir(parents=True, exist_ok=True)
    rec = {"round": controller.rounds, "t": sim_now, "digest": g,
           "hosts": hosts}
    with open(controller.data_dir / DIGEST_FILE, "a") as f:
        f.write(json.dumps(rec, sort_keys=True) + "\n")
