"""Plain NumPy reference of the simulator's loss draws.

A frozen copy of Threefry-2x32 (Salmon et al., "Parallel Random Numbers:
As Easy as 1, 2, 3", SC'11; the Random123 rotation constants and key
schedule), written from the paper and not from the program. The simulator
states that a unit of ``npkts`` packets is lost iff some packet lane
``p < min(npkts, width)`` draws a 24-bit value ``x0 >> 8`` below the
unit's threshold, where ``(x0, x1) = threefry2x32_20(key, (uid_lo,
uid_hi | p << 26))`` and ``key = (seed mod 2**32, seed >> 32)``. A
threshold of 0 never drops.

``rounds`` is 20 everywhere but in the control (``control.py``), which
puts the 13-round variant, the lightest that the paper still finds
Crush-resistant, in the program's place to show that the comparison
fails it.
"""

from __future__ import annotations

import numpy as np

ROTATIONS = (13, 15, 26, 6, 17, 29, 16, 24)
PARITY = 0x1BD11BDA
PKT_SHIFT = 26
M32 = 0xFFFFFFFF
#: units drawn at once: bounds the temporaries to a few tens of MB
CHUNK = 1 << 17


def threefry2x32(k0: int, k1: int, c0: np.ndarray, c1: np.ndarray,
                 rounds: int = 20) -> tuple:
    """Threefry-2x32 with ``rounds`` rounds of uint32 counter arrays
    ``c0``, ``c1`` under the key (k0, k1): a key injection after every
    fourth round."""
    u = np.uint32
    ks = (k0 & M32, k1 & M32, (k0 ^ k1 ^ PARITY) & M32)
    x0 = c0.astype(u) + u(ks[0])
    x1 = c1.astype(u) + u(ks[1])
    for r in range(rounds):
        rot = ROTATIONS[r % 8]
        x0 += x1
        x1 = (x1 << u(rot)) | (x1 >> u(32 - rot))
        x1 ^= x0
        if r % 4 == 3:
            s = r // 4 + 1
            x0 += u(ks[s % 3])
            x1 += u((ks[(s + 1) % 3] + s) & M32)
    return x0, x1


def lane_draws(seed: int, uid_lo, uid_hi, lanes, width: int,
               rounds: int = 20) -> tuple:
    """(n, width) 24-bit draws of lanes 0..width-1 of n units, and the
    (n, width) mask of the lanes that count (p < lanes)."""
    lo = np.asarray(uid_lo, dtype=np.uint32)
    hi = np.asarray(uid_hi, dtype=np.uint32)
    pkt = np.arange(width, dtype=np.uint32)
    c0 = np.broadcast_to(lo[:, None], (len(lo), width))
    c1 = hi[:, None] | (pkt << np.uint32(PKT_SHIFT))
    x0, _ = threefry2x32(seed & M32, (seed >> 32) & M32, c0, c1, rounds)
    valid = pkt[None, :] < np.asarray(lanes, dtype=np.int64)[:, None]
    return x0 >> np.uint32(8), valid


def loss_flags(seed: int, uid_lo, uid_hi, npkts, thresh, width: int,
               rounds: int = 20) -> np.ndarray:
    """(n,) bool: which units the stated draw drops."""
    th = np.asarray(thresh, dtype=np.int64)
    out = np.zeros(len(th), dtype=bool)
    live = np.flatnonzero(th > 0)
    lanes = np.minimum(np.asarray(npkts, dtype=np.int64), width)
    lo = np.asarray(uid_lo, dtype=np.int64)
    hi = np.asarray(uid_hi, dtype=np.int64)
    for i in range(0, len(live), CHUNK):
        ix = live[i:i + CHUNK]
        draws, valid = lane_draws(seed, lo[ix], hi[ix], lanes[ix], width,
                                  rounds)
        out[ix] = ((draws < th[ix, None]) & valid).any(axis=1)
    return out


def lanes_to_decide(seed: int, uid_lo, uid_hi, npkts, thresh,
                    width: int) -> np.ndarray:
    """(n,) threefry evaluations that deciding each unit needs: none for
    a threshold of 0, else its lanes up to and including the first that
    drops it, or all min(npkts, width) lanes when none does."""
    th = np.asarray(thresh, dtype=np.int64)
    out = np.zeros(len(th), dtype=np.int64)
    live = np.flatnonzero(th > 0)
    lanes = np.minimum(np.asarray(npkts, dtype=np.int64), width)
    lo = np.asarray(uid_lo, dtype=np.int64)
    hi = np.asarray(uid_hi, dtype=np.int64)
    for i in range(0, len(live), CHUNK):
        ix = live[i:i + CHUNK]
        draws, valid = lane_draws(seed, lo[ix], hi[ix], lanes[ix], width)
        hit = (draws < th[ix, None]) & valid
        out[ix] = np.where(hit.any(axis=1), hit.argmax(axis=1) + 1,
                           valid.sum(axis=1))
    return out
