"""The network data plane: closed-form fluid token buckets + loss sampling.

A copy of shadow_tpu/network/fluid.py. The token buckets are a closed form
rather than a round-by-round iteration:

**While a source is backlogged its bucket never idles at capacity, so the
available-token curve is linear in time.** The departure time of the unit at
cumulative FIFO byte offset Q is therefore

    t_dep = max(t_emit, t_base + ceil((Q - T) * 1e9 / rate))

with (t_base, T) the bucket's accounting base — pure integer math, O(1) per
unit, evaluated once at the unit's emission barrier. No retries, no per-round
device sync, and the result is independent of the round width W (the
conservative-PDES window only gates *when* cross-host effects are applied,
never the computed times).

Semantics owned by this module (both the numpy and device paths consume
them; there is exactly ONE implementation of the bucket math, host-side):
- Buckets accrue tokens continuously at ``rate`` bytes/sec (integer ns math,
  floored once over the whole interval — no per-round floor truncation).
- Saturation (clamp at capacity) is evaluated lazily at emission barriers:
  if a bucket would exceed capacity at barrier time t_now, its base is reset
  to (t_now, cap). While backlogged a bucket can't saturate, so this is
  exact whenever it matters; for an idle bucket it quantizes the saturation
  instant to the barrier that next touches the source (documented choice).
- Loss is sampled per MTU-sized packet within a unit with counter-based
  threefry draws keyed on (seed, uid, packet index) — a pure function of
  unit identity, so numpy and the GPU produce identical drops in any order
  (SURVEY.md §7 "Determinism across backends").

All quantities are integers (bytes, ns). The only floats anywhere are the
float64 loss-threshold precompute at startup (quantize_loss).

Unit sizes are bounded by the configured quantum (experimental.unit_mtus,
default MAX_UNIT): streams are chunked
by the transport (network/transport.py), datagrams are fragmented
by the socket layer. Loss probability scales with unit size exactly the same
way on both backends with pure integer compares.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from shadow_tpu_torch.core.time import NS_PER_SEC, SimTime
from shadow_tpu_torch.ops.prng import threefry2x32, quantize_loss

MTU = 1500  # bytes on the wire per packet
HEADER = 40  # modeled header overhead per unit and per ack
MAX_UNIT = 10 * MTU  # DEFAULT max wire bytes per transmission unit
MAX_PKTS = 10  # = MAX_UNIT / MTU, loss draws per unit (default quantum)
#: experimental.unit_mtus can widen the fluid quantum up to this bound;
#: the per-packet counter packing (PKT_SHIFT) reserves 6 bits, and uid
#: packing ((hid << 32) | ctr: host id sits in uid_hi, the 32-bit
#: per-host counter in uid_lo) then caps host ids at 2**26 (enforced in
#: NetParams.build — the bound that admits the 1M-host topologies;
#: a host would need 2**32 lifetime emissions to overflow its counter)
HARD_MAX_PKTS = 64
PKT_SHIFT = 26  # packet-lane index position inside the threefry counter
MIN_CAP = 16384  # token bucket capacity floor: one default MAX_UNIT + room
#: per-host rate ceiling (bytes/sec) keeping rate * 1e9 within uint64
#: (the closed-form math runs its two sub-second products in uint64)
MAX_RATE = 16_000_000_000  # 128 Gbit/s


@dataclass
class NetParams:
    """Static per-simulation network parameters."""

    host_node: np.ndarray  # (H,) int32: host -> graph node index
    rate_up: np.ndarray  # (H,) int64 bytes/sec
    rate_down: np.ndarray  # (H,) int64 bytes/sec
    cap_up: np.ndarray  # (H,) int64 bucket capacity, < 2**31
    cap_down: np.ndarray  # (H,) int64
    latency_ns: np.ndarray  # (G, G) int64
    drop_thresh: np.ndarray  # (G, G) uint32 q24 drop probability
    seed: int

    @classmethod
    def build(
        cls,
        host_node: np.ndarray,
        rate_up: np.ndarray,
        rate_down: np.ndarray,
        latency_ns: np.ndarray,
        reliability: np.ndarray,
        seed: int,
        round_ns: SimTime,
        max_unit: int = MAX_UNIT,
    ) -> "NetParams":
        rate_up = np.asarray(rate_up, dtype=np.int64)
        rate_down = np.asarray(rate_down, dtype=np.int64)
        if (rate_up <= 0).any() or (rate_down <= 0).any():
            raise ValueError("host bandwidths must be > 0")
        if len(host_node) >= (1 << PKT_SHIFT):
            # uid packing: uid_hi IS the host id, the packet lane
            # occupies uid_hi bits PKT_SHIFT.. — they must not overlap
            raise ValueError(
                f"host count exceeds 2**{PKT_SHIFT} (uid packing bound)")
        if (rate_up > MAX_RATE).any() or (rate_down > MAX_RATE).any():
            raise ValueError(
                f"host bandwidth exceeds {MAX_RATE} B/s "
                f"(= {MAX_RATE * 8 / 1e9:.0f} Gbit/s), the integer-exact "
                "ceiling of the closed-form bucket math"
            )
        # capacity floor: at least one full unit (+ header) must fit, or a
        # max-size unit could never clear the bucket
        floor = max(MIN_CAP, max_unit + HEADER)
        cap_up = np.maximum(rate_up * round_ns // NS_PER_SEC, floor)
        cap_down = np.maximum(rate_down * round_ns // NS_PER_SEC, floor)
        limit = (np.int64(1) << np.int64(31)) - 1
        # capacities stay int32-safe so offsets fit device-side arrays
        cap_up = np.minimum(cap_up, limit - 1)
        cap_down = np.minimum(cap_down, limit - 1)
        return cls(
            host_node=np.asarray(host_node, dtype=np.int32),
            rate_up=rate_up,
            rate_down=rate_down,
            cap_up=cap_up,
            cap_down=cap_down,
            latency_ns=np.asarray(latency_ns, dtype=np.int64),
            drop_thresh=quantize_loss(reliability),
            seed=int(seed),
        )


def bytes_over(rate: np.ndarray, dt_ns) -> np.ndarray:
    """Exact ``rate * dt // 1e9`` without overflow (dt may be hours): split
    dt into whole seconds + remainder ns; the remainder product runs in
    uint64 (< 2**64 given rate <= MAX_RATE and r < 1e9)."""
    dt_ns = np.asarray(dt_ns, dtype=np.int64)
    q, r = dt_ns // NS_PER_SEC, dt_ns % NS_PER_SEC
    frac = (rate.astype(np.uint64) * r.astype(np.uint64) // np.uint64(NS_PER_SEC))
    return rate * q + frac.astype(np.int64)


def clamped_refill(rate: np.ndarray, cap: np.ndarray, dt_ns: int) -> np.ndarray:
    """Token refill for an elapsed window of dt_ns, pre-clamped to capacity
    (down-link ingress buckets, which stay round-quantized host-side)."""
    return np.minimum(bytes_over(rate, dt_ns), cap).astype(np.int64)


class TokenBuckets:
    """Per-source closed-form egress buckets — THE bucket implementation.

    State per source: (t_base ns, T tokens at t_base, debt bytes committed
    since t_base). Available tokens at barrier time t:
    ``T + bytes_over(rate, t - t_base) - debt``. All int64, exact.
    """

    def __init__(self, params: NetParams) -> None:
        h = params.rate_up.shape[0]
        self.params = params
        self.t_base = np.zeros(h, dtype=np.int64)
        self.tokens = params.cap_up.copy()  # T at t_base
        self.debt = np.zeros(h, dtype=np.int64)

    def available(self, t_now: SimTime) -> np.ndarray:
        p = self.params
        return self.tokens + bytes_over(p.rate_up, t_now - self.t_base) - self.debt

    def levels(self, t_now: SimTime) -> np.ndarray:
        """Capped available-at-now — THE canonical plane-independent
        bucket observable (the vector path rebases every source each
        barrier while the scalar twin rebases lazily, an outcome-identical
        representation difference; capping removes it). Shared by the
        determinism sentinel (checkpoint.state_digest) and the telemetry
        samplers (telemetry/collector.py)."""
        return np.minimum(self.available(t_now), self.params.cap_up)

    def rebase(self, t_now: SimTime) -> None:
        """Clamp saturated buckets to capacity at t_now (lazy, exact for any
        source that still has committed departures pending — see module doc)."""
        p = self.params
        avail = self.available(t_now)
        sat = avail > p.cap_up
        if sat.any():
            self.t_base[sat] = t_now
            self.tokens[sat] = p.cap_up[sat]
            self.debt[sat] = 0

    def depart_times(self, src: np.ndarray, size: np.ndarray,
                     t_emit: np.ndarray, t_now: SimTime) -> np.ndarray:
        """Departure time for each unit of a (src-sorted, per-source FIFO)
        batch emitted by barrier time t_now. Commits the batch (updates debt).

        Returns (N,) int64 ns. Vectorized closed form; see module docstring.
        """
        self.rebase(t_now)
        n = src.shape[0]
        if n == 0:
            return np.zeros(0, dtype=np.int64)
        p = self.params
        size64 = size.astype(np.int64)
        csum = np.cumsum(size64)
        seg_first = np.ones(n, dtype=bool)
        seg_first[1:] = src[1:] != src[:-1]
        seg_base = np.where(seg_first, csum - size64, 0)
        seg_base = np.maximum.accumulate(seg_base)
        cum_in_seg = csum - seg_base

        need = self.debt[src] + cum_in_seg - self.tokens[src]  # X = Q - T
        rate = p.rate_up[src]
        q, r = need // rate, need % rate  # floor semantics fine: need>0 below
        # ceil(r * 1e9 / rate) with the product in uint64 (r < rate <= MAX_RATE)
        frac = (r.astype(np.uint64) * np.uint64(NS_PER_SEC)
                + rate.astype(np.uint64) - np.uint64(1)) // rate.astype(np.uint64)
        t_off = q * NS_PER_SEC + frac.astype(np.int64)
        t_ready = np.where(need > 0, self.t_base[src] + t_off, np.int64(0))
        t_dep = np.maximum(t_emit.astype(np.int64), t_ready)

        # commit: debt += per-source batch totals (exact integer segment sums)
        starts = np.flatnonzero(seg_first)
        self.debt[src[starts]] += np.add.reduceat(size64, starts)
        return t_dep

    def depart_times_scalar(self, src_l, size_l, t_emit_l,
                            t_now: SimTime) -> list:
        """Exact scalar twin of depart_times for tiny batches (numpy's
        fixed per-op cost dominates them). Python ints are arbitrary
        precision, so the arithmetic matches the vector path bit-for-bit;
        rebase runs lazily on the touched sources only — outcome-identical
        (an untouched saturated bucket clamps to capacity at whichever
        barrier next reads it, with the same resulting state)."""
        p = self.params
        t_base, tokens, debt = self.t_base, self.tokens, self.debt
        rate_up, cap_up = p.rate_up, p.cap_up
        for s in set(src_l):
            rate = int(rate_up[s])
            dt = t_now - int(t_base[s])
            q, r = divmod(dt, NS_PER_SEC)
            avail = (int(tokens[s]) + rate * q + rate * r // NS_PER_SEC
                     - int(debt[s]))
            if avail > int(cap_up[s]):
                t_base[s] = t_now
                tokens[s] = cap_up[s]
                debt[s] = 0
        out = []
        cum: dict = {}
        for i, s in enumerate(src_l):
            qsum = cum.get(s, 0) + size_l[i]
            cum[s] = qsum
            need = int(debt[s]) + qsum - int(tokens[s])
            if need > 0:
                rate = int(rate_up[s])
                q, r = divmod(need, rate)
                t_ready = (int(t_base[s]) + q * NS_PER_SEC
                           + (r * NS_PER_SEC + rate - 1) // rate)
            else:
                t_ready = 0
            te = t_emit_l[i]
            out.append(te if te > t_ready else t_ready)
        for s, qsum in cum.items():
            debt[s] += qsum
        return out


def loss_flags(seed: int, uid_lo: np.ndarray, uid_hi: np.ndarray,
               npkts: np.ndarray, thresh: np.ndarray) -> np.ndarray:
    """numpy twin of the device draw kernel (ops/propagate.py): per-packet
    threefry draws; a unit is dropped iff any of its first npkts draws is
    below its threshold. Bit-identical to the device by construction (same
    integer arithmetic, tests/test_torch_propagate.py)."""
    n = uid_lo.shape[0]
    out = np.zeros(n, dtype=bool)
    live = thresh > 0  # threshold 0 can never hit; skip the draw work
    if not live.any():
        return out
    lo, hi = uid_lo[live].astype(np.uint32), uid_hi[live].astype(np.uint32)
    npk, th = npkts[live], thresh[live]
    k = int(npk.max())
    pkt = np.arange(k, dtype=np.uint32)[None, :]
    c0 = np.broadcast_to(lo[:, None], (lo.shape[0], k))
    c1 = hi[:, None] | (pkt << np.uint32(PKT_SHIFT))
    k0 = np.uint32(seed & 0xFFFFFFFF)
    k1 = np.uint32((seed >> 32) & 0xFFFFFFFF)
    draws, _ = threefry2x32(k0, k1, c0, c1)
    draws = (draws >> np.uint32(8)).astype(np.uint32)
    hit = (draws < th.astype(np.uint32)[:, None]) & (pkt < npk.astype(np.uint32)[:, None])
    out[live] = hit.any(axis=1)
    return out
