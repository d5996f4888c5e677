"""Device kernels for the data-plane hot math: batched per-packet loss draws.

The port of shadow_tpu/ops/propagate.py. What is hot is the loss sampling:
20-round threefry2x32 x up to ``width`` packet lanes per unit, a pure
function of (seed, uid, npkts, threshold) with no state and no feedback.

Two kernels, each a hand-written CUDA kernel (csrc/draw.cu) beside a plain
PyTorch version of the same function in this module:

- ``draw_flags`` (replaces ``_draw_kernel``): (4, P) uint32
  [uid_lo, uid_hi, npkts, thresh] -> (P/8,) uint8 drop flags, bit-packed
  little-endian (``np.packbits(..., bitorder="little")``);
- ``min_draw`` (replaces ``_min_draw_kernel``): (3, P) uint32
  [uid_lo, uid_hi, npkts] -> (P,) uint32 minimum 24-bit draw over the first
  min(npkts, width) lanes, 0xFFFFFFFF when there is none.

Each wrapper checks dtype, shape, contiguity and device, runs the plain
version for a CPU tensor, and for a CUDA tensor launches its kernel on the
current stream or raises: there is no fallback. ``LAUNCHES`` counts the
kernel launches per kernel (plain runs are not launches).

Design notes (carried over from the reference):
- Stateless kernels: the host gathers each unit's q24 drop threshold from
  the (G,G) table and ships ONE packed array; no device-resident state, so
  small batches can route to the bit-identical numpy twin
  (fluid.loss_flags) with no semantic difference.
- Static shapes: batches pad to power-of-two buckets between MIN_BUCKET
  and the configured cap (padded rows carry npkts 0 and thresh 0 and can
  never hit).
- Deferred readback: ``dispatch`` stages the packed batch in pinned host
  memory, copies it to the card and the result back without blocking, and
  records a CUDA event; the result is only *consumed* when the simulation
  clock reaches the batch's causal deadline (``DrawHandle.is_ready`` polls
  the event, ``read`` waits on it), so the round trip overlaps later host
  rounds instead of stalling each one.
- The threefry key is data (a kernel argument), not a build constant: one
  build serves every seed, which the fleet's shared draw plane relies on.
- calibrate() measures the real dispatch+readback latency and the numpy
  twin's per-unit cost once at startup, giving the engine an evidence-based
  floor for routing batches. Both paths produce identical flags and event
  order is canonical, so the floor cannot affect simulation results.
"""

from __future__ import annotations

import time as _walltime  # detlint: ok(wallclock): device attach/calibration wall measures

import numpy as np
import torch

from shadow_tpu_torch.network.fluid import MAX_PKTS, PKT_SHIFT, loss_flags
from shadow_tpu_torch.ops import devcfg
from shadow_tpu_torch.ops.prng import threefry2x32_torch

#: padded-bucket floor; buckets are powers of two between MIN and the cap
MIN_BUCKET = 256
SENTINEL = 0xFFFFFFFF

#: kernel launches per kernel since the last reset_launches(); only CUDA
#: launches count (the plain version on a CPU tensor is not a launch)
LAUNCHES = {"draw_flags": 0, "min_draw": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _bucket(n: int, cap: int) -> int:
    """Next power-of-two >= n (n never exceeds the engine's chunk cap)."""
    b = MIN_BUCKET
    while b < n:
        b <<= 1
    return b


# -- plain PyTorch versions ---------------------------------------------------

def _lane_draws(lo: torch.Tensor, hi: torch.Tensor, lanes: torch.Tensor,
                seed_key, width: int):
    """24-bit threefry draws of packet lanes 0..width-1 of each unit, and
    which lanes count (p < lanes): two (..., width) int64 tensors for the
    units' (...) int64 uid words ``lo``, ``hi`` and lane counts ``lanes``
    (uint32 values)."""
    pkt = torch.arange(width, dtype=torch.int64, device=lo.device)
    c0 = lo[..., None].expand(*lo.shape, width)
    c1 = hi[..., None] | (pkt << PKT_SHIFT)
    x0, _ = threefry2x32_torch(int(seed_key[0]), int(seed_key[1]), c0, c1)
    return x0 >> 8, pkt < lanes[..., None]


def _packed_draws(packed: torch.Tensor, seed_key, width: int):
    """_lane_draws of a (rows, P) uint32 batch [uid_lo, uid_hi, npkts, ...]:
    (P, width) draws and lane mask."""
    rows = packed.to(torch.int64)
    return _lane_draws(rows[0], rows[1], rows[2], seed_key, width)


def packbits_little(flags: torch.Tensor) -> torch.Tensor:
    """(P,) bool -> (P/8,) uint8, as np.packbits(bitorder="little")."""
    w = (1 << torch.arange(8, dtype=torch.int64, device=flags.device))
    return (flags.to(torch.int64).view(-1, 8) * w).sum(1).to(torch.uint8)


def draw_flags_plain(packed: torch.Tensor, seed_key,
                     width: int = MAX_PKTS) -> torch.Tensor:
    """Plain version of the draw_flags kernel (and of the reference's
    _draw_kernel): a unit drops iff some lane p < min(npkts, width) has
    its 24-bit draw below the unit's threshold."""
    draws, valid = _packed_draws(packed, seed_key, width)
    thresh = packed[3].to(torch.int64)[:, None]
    return packbits_little(((draws < thresh) & valid).any(dim=1))


def min_draw_plain(packed: torch.Tensor, seed_key,
                   width: int = MAX_PKTS) -> torch.Tensor:
    """Plain version of the min_draw kernel (and of the reference's
    _min_draw_kernel)."""
    draws, valid = _packed_draws(packed, seed_key, width)
    m = torch.where(valid, draws, torch.full_like(draws, SENTINEL))
    return m.min(dim=1).values.to(torch.uint32)


# -- wrappers -----------------------------------------------------------------

def _check(packed: torch.Tensor, rows: int, width: int, what: str) -> None:
    if not isinstance(packed, torch.Tensor):
        raise TypeError(f"{what}: packed must be a torch.Tensor")
    if packed.dtype != torch.uint32:
        raise TypeError(f"{what}: packed must be uint32, got {packed.dtype}")
    if packed.dim() != 2 or packed.shape[0] != rows:
        raise ValueError(
            f"{what}: packed must be ({rows}, P), got {tuple(packed.shape)}")
    p = packed.shape[1]
    if p <= 0 or p % 32:
        raise ValueError(f"{what}: P must be a positive multiple of 32, "
                         f"got {p}")
    if not packed.is_contiguous():
        raise ValueError(f"{what}: packed must be contiguous")
    if not 1 <= width <= 64:
        raise ValueError(f"{what}: width must be in [1, 64], got {width}")
    if packed.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {packed.device}")


def _key_words(seed_key) -> tuple:
    return int(seed_key[0]) & SENTINEL, int(seed_key[1]) & SENTINEL


def draw_flags(packed: torch.Tensor, seed_key,
               width: int = MAX_PKTS) -> torch.Tensor:
    """Per-unit drop flags, bit-packed: (4, P) uint32 -> (P/8,) uint8.
    ``seed_key`` is the (2,) threefry key [seed_lo, seed_hi] (any
    indexable of ints). CPU tensor: the plain version. CUDA tensor: the
    kernel on the current stream, or an exception."""
    _check(packed, 4, width, "draw_flags")
    if packed.device.type == "cpu":
        return draw_flags_plain(packed, seed_key, width)
    lib = devcfg.kernel_lib("draw")
    p = packed.shape[1]
    out = torch.empty(p // 8, dtype=torch.uint8, device=packed.device)
    k0, k1 = _key_words(seed_key)
    code = lib.shadow_draw_flags(
        packed.data_ptr(), p, k0, k1, width, out.data_ptr(),
        torch.cuda.current_stream(packed.device).cuda_stream)
    devcfg.check_launch(lib, code, "draw_flags")
    LAUNCHES["draw_flags"] += 1
    return out


def min_draw(packed: torch.Tensor, seed_key,
             width: int = MAX_PKTS) -> torch.Tensor:
    """Per-unit minimum 24-bit draw: (3, P) uint32 -> (P,) uint32.
    CPU tensor: the plain version. CUDA tensor: the kernel on the current
    stream, or an exception."""
    _check(packed, 3, width, "min_draw")
    if packed.device.type == "cpu":
        return min_draw_plain(packed, seed_key, width)
    lib = devcfg.kernel_lib("draw")
    p = packed.shape[1]
    out = torch.empty(p, dtype=torch.uint32, device=packed.device)
    k0, k1 = _key_words(seed_key)
    code = lib.shadow_min_draw(
        packed.data_ptr(), p, k0, k1, width, out.data_ptr(),
        torch.cuda.current_stream(packed.device).cuda_stream)
    devcfg.check_launch(lib, code, "min_draw")
    LAUNCHES["min_draw"] += 1
    return out


# -- deferred-readback handles ------------------------------------------------

class DrawHandle:
    """An in-flight device draw: read() yields the (n,) bool flags."""

    __slots__ = ("_out", "_event", "_n")

    def __init__(self, out: torch.Tensor, event, n: int) -> None:
        self._out = out  # host tensor (pinned for a CUDA dispatch)
        self._event = event  # torch.cuda.Event, or None when synchronous
        self._n = n

    def read(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        packed = self._out.numpy()
        return np.unpackbits(packed, bitorder="little")[: self._n].astype(bool)

    def is_ready(self) -> bool:
        """True when the device result has landed host-side — read() will
        not stall."""
        return self._event is None or self._event.query()


class MinDrawHandle:
    """An in-flight speculative min-draw batch: read() yields (n,) uint32
    prefix-min draws (see min_draw)."""

    __slots__ = ("_out", "_event", "_n")

    def __init__(self, out: torch.Tensor, event, n: int) -> None:
        self._out = out
        self._event = event
        self._n = n

    def read(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._out.numpy()[: self._n]

    def is_ready(self) -> bool:
        return self._event is None or self._event.query()


class DeviceDrawPlane:
    """Dispatches loss-draw batches to the card (or, for ``device="cpu"``,
    to the plain PyTorch versions on the CPU).

    The numpy twin is fluid.loss_flags; tests/test_torch_propagate.py
    asserts the two produce identical flags for identical inputs.
    """

    #: every speculative wave pads to this one bucket (warmed at
    #: attach_cached); callers chunk bigger waves at this size
    SPEC_BUCKET = 16384

    def __init__(self, seed: int, max_batch: int = 65536,
                 max_pkts: int = MAX_PKTS, device: str = "cuda") -> None:
        self.device = devcfg.select_device(device)
        self.seed = int(seed)
        self.max_batch = int(max_batch)
        self.max_pkts = int(max_pkts)  # kernel packet-lane width
        self._cuda = self.device.type == "cuda"
        if self._cuda:
            devcfg.kernel_lib("draw")  # build or load now, not mid-round

    def _seed_key(self, seed) -> np.ndarray:
        """(2,) uint32 threefry key for ``seed`` (None = the plane's own).
        Passed to the kernels as data, so serving another simulation's
        seed reuses the same build."""
        s = self.seed if seed is None else int(seed)
        return np.array([s & 0xFFFFFFFF, (s >> 32) & 0xFFFFFFFF],
                        dtype=np.uint32)

    def _launch(self, kernel, cols, p: int, seed, out_dtype, out_len: int):
        """Stage ``cols`` (padded to p) on the host, run ``kernel`` on the
        plane's device, and start the copy of its result back. Returns
        (host result tensor, event or None)."""
        n = cols[0].shape[0]
        stage = torch.empty((len(cols), p), dtype=torch.uint32,
                            pin_memory=self._cuda)
        a = stage.numpy()
        for r, col in enumerate(cols):
            a[r, :n] = col
        a[:, n:] = 0
        key = self._seed_key(seed)
        if not self._cuda:
            return kernel(stage, key, self.max_pkts), None
        dev_in = stage.to(self.device, non_blocking=True)
        dev_out = kernel(dev_in, key, self.max_pkts)
        host = torch.empty(out_len, dtype=out_dtype, pin_memory=True)
        host.copy_(dev_out, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        return host, ev

    def dispatch(self, uid_lo: np.ndarray, uid_hi: np.ndarray,
                 npkts: np.ndarray, thresh: np.ndarray,
                 seed: int = None) -> DrawHandle:
        """Launch one batch (any length <= max_batch) and start the async
        device->host copy; returns a handle to read when due. ``seed``
        overrides the plane's seed for this batch."""
        n = uid_lo.shape[0]
        p = _bucket(n, self.max_batch)
        out, ev = self._launch(draw_flags, (uid_lo, uid_hi, npkts, thresh),
                               p, seed, torch.uint8, p // 8)
        return DrawHandle(out, ev, n)

    def dispatch_min(self, uid_lo: np.ndarray, uid_hi: np.ndarray,
                     npkts: np.ndarray, min_bucket: int = 0,
                     seed: int = None) -> MinDrawHandle:
        """Launch one speculative min-draw batch with the async
        device->host copy started. ``min_bucket`` pins the padded shape;
        ``seed`` overrides the plane's seed."""
        n = uid_lo.shape[0]
        p = max(_bucket(n, self.max_batch), min_bucket)
        out, ev = self._launch(min_draw, (uid_lo, uid_hi, npkts), p, seed,
                               torch.uint32, p)
        return MinDrawHandle(out, ev, n)

    _cache: dict = {}  # (seed, max_batch, max_pkts, device) -> entry

    @classmethod
    def attach_cached(cls, seed: int, max_batch: int, max_pkts: int,
                      device: str = "cuda", should_abort=None):
        """Process-wide attach cache: (plane, dev_s, np_per_unit) for this
        parameter tuple, building + calibrating on first use, so a process
        that runs many short Controllers pays the kernel load, warm-up and
        calibration once. Pure wall-clock policy: the plane is stateless,
        so sharing it across runs cannot change results.

        ``should_abort`` (callable -> bool) is polled between the attach
        phases; when it fires, the partial attach is discarded (nothing
        cached) and None is returned."""
        key = (int(seed), int(max_batch), int(max_pkts), str(device))
        hit = cls._cache.get(key)
        if hit is None:
            if should_abort is not None and should_abort():
                return None
            plane = cls(seed, max_batch, max_pkts=max_pkts, device=device)
            if should_abort is not None and should_abort():
                return None
            dev_s, np_per_unit = plane.calibrate()
            # launch every shape this plane can dispatch once, so the first
            # run's round loop pays no first-launch costs
            plane.warm_shapes(should_abort=should_abort)
            if should_abort is not None and should_abort():
                return None  # partially warmed: do not cache
            if len(cls._cache) >= 4:  # a handful of configs per process
                cls._cache.pop(next(iter(cls._cache)))
            hit = cls._cache[key] = (plane, dev_s, np_per_unit)
        return hit

    def warm_shapes(self, should_abort=None) -> None:
        """Dispatch every padded bucket shape of the draw kernel plus the
        pinned speculative min-draw shape once. Pure wall-clock work:
        flags are never read for results here. ``should_abort`` is polled
        between shapes (attach teardown)."""
        b = MIN_BUCKET
        while True:
            if should_abort is not None and should_abort():
                return
            z = np.zeros(b, dtype=np.uint32)
            self.dispatch(z, z, z, z).read()
            if b >= self.max_batch:
                break
            b <<= 1
        if should_abort is not None and should_abort():
            return
        k = self.SPEC_BUCKET
        z = np.zeros(k, dtype=np.uint32)
        self.dispatch_min(z, z, z, min_bucket=k).read()

    def calibrate(self, n_probe: int = 4096) -> tuple[float, float]:
        """Measure (device seconds per dispatch+readback at n_probe, numpy
        seconds per unit). Used by the engine to set the routing floor; has
        no effect on simulation results (both paths are bit-identical)."""
        rng = np.random.default_rng(0)
        lo = rng.integers(0, 1 << 32, n_probe, dtype=np.uint64).astype(np.uint32)
        hi = rng.integers(0, 1 << 32, n_probe, dtype=np.uint64).astype(np.uint32)
        npk = np.full(n_probe, self.max_pkts, np.uint32)
        th = np.full(n_probe, 1 << 10, np.uint32)
        self.dispatch(lo, hi, npk, th).read()  # first launch + warm
        t0 = _walltime.perf_counter()
        self.dispatch(lo, hi, npk, th).read()
        dev_s = _walltime.perf_counter() - t0
        t0 = _walltime.perf_counter()
        loss_flags(self.seed, lo, hi, npk, th)
        np_per_unit = (_walltime.perf_counter() - t0) / n_probe
        return dev_s, np_per_unit
