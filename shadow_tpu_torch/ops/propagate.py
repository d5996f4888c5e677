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
  and the configured cap. The kernels take the real unit count n: they
  draw nothing for the padding and write its flags as 0 (its minima as
  SENTINEL), as the reference's padded rows (npkts 0, thresh 0) give.
- Deferred readback: ``dispatch`` fills a page-locked slot of its bucket
  (DrawSlot, made once and reused), launches the kernel on the slot in
  place (it reads the batch and writes the result through their device
  addresses: no copy, no allocation) and records the slot's CUDA event;
  the result is only *consumed* when the simulation clock reaches the
  batch's causal deadline (``DrawHandle.is_ready`` polls the event,
  ``read`` waits on it, copies the result out and frees the slot), so the
  round trip overlaps later host rounds instead of stalling each one.
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


def _packed_draws(packed: torch.Tensor, seed_key, width: int,
                  n: int | None = None):
    """_lane_draws of a (rows, P) uint32 batch [uid_lo, uid_hi, npkts, ...]
    whose first ``n`` units (all by default) are real: (P, width) draws and
    lane mask (no lane of a unit past n counts)."""
    rows = packed.to(torch.int64)
    lanes = rows[2]
    if n is not None and n < rows.shape[1]:
        real = torch.arange(rows.shape[1], device=rows.device) < n
        lanes = torch.where(real, lanes, torch.zeros_like(lanes))
    return _lane_draws(rows[0], rows[1], lanes, seed_key, width)


def packbits_little(flags: torch.Tensor) -> torch.Tensor:
    """(P,) bool -> (P/8,) uint8, as np.packbits(bitorder="little")."""
    w = (1 << torch.arange(8, dtype=torch.int64, device=flags.device))
    return (flags.to(torch.int64).view(-1, 8) * w).sum(1).to(torch.uint8)


def draw_flags_plain(packed: torch.Tensor, seed_key, width: int = MAX_PKTS,
                     n: int | None = None) -> torch.Tensor:
    """Plain version of the draw_flags kernel (and of the reference's
    _draw_kernel): a unit drops iff some lane p < min(npkts, width) has
    its 24-bit draw below the unit's threshold; units past ``n`` never
    drop."""
    draws, valid = _packed_draws(packed, seed_key, width, n)
    thresh = packed[3].to(torch.int64)[:, None]
    return packbits_little(((draws < thresh) & valid).any(dim=1))


def min_draw_plain(packed: torch.Tensor, seed_key, width: int = MAX_PKTS,
                   n: int | None = None) -> torch.Tensor:
    """Plain version of the min_draw kernel (and of the reference's
    _min_draw_kernel); units past ``n`` read SENTINEL."""
    draws, valid = _packed_draws(packed, seed_key, width, n)
    m = torch.where(valid, draws, torch.full_like(draws, SENTINEL))
    return m.min(dim=1).values.to(torch.uint32)


# -- wrappers -----------------------------------------------------------------

def _check(packed: torch.Tensor, rows: int, width: int, n, what: str) -> int:
    """Validate a wrapper's arguments; returns the real unit count."""
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
    n = p if n is None else int(n)
    if not 0 <= n <= p:
        raise ValueError(f"{what}: n must be in [0, {p}], got {n}")
    return n


def _key_words(seed_key) -> tuple:
    return int(seed_key[0]) & SENTINEL, int(seed_key[1]) & SENTINEL


#: kernel -> (its rows of input, its output's dtype, its output's length
#: at bucket P, its plain version); the kernels' entry points in
#: csrc/draw.cu are shadow_<kernel>
_KERNELS = {
    "draw_flags": (4, torch.uint8, lambda p: p // 8, draw_flags_plain),
    "min_draw": (3, torch.uint32, lambda p: p, min_draw_plain),
}


def _launch_kernel(name: str, packed_ptr: int, p: int, n: int, seed_key,
                   width: int, out_ptr: int, stream: int) -> None:
    """Launch ``name`` (csrc/draw.cu) on the card addresses of its (rows,
    P) input and its output, and count the launch, or raise."""
    lib = devcfg.kernel_lib("draw")
    k0, k1 = _key_words(seed_key)
    code = getattr(lib, f"shadow_{name}")(packed_ptr, p, n, k0, k1, width,
                                          out_ptr, stream)
    devcfg.check_launch(lib, code, name)
    LAUNCHES[name] += 1


def _wrapper(name: str, packed: torch.Tensor, seed_key, width: int,
             n) -> torch.Tensor:
    rows, dtype, out_len, plain = _KERNELS[name]
    n = _check(packed, rows, width, n, name)
    if packed.device.type == "cpu":
        return plain(packed, seed_key, width, n)
    p = packed.shape[1]
    out = torch.empty(out_len(p), dtype=dtype, device=packed.device)
    _launch_kernel(name, packed.data_ptr(), p, n, seed_key, width,
                   out.data_ptr(),
                   torch.cuda.current_stream(packed.device).cuda_stream)
    return out


def draw_flags(packed: torch.Tensor, seed_key, width: int = MAX_PKTS,
               n: int | None = None) -> torch.Tensor:
    """Per-unit drop flags, bit-packed: (4, P) uint32 -> (P/8,) uint8, of
    which the first ``n`` units (all by default) are real and the rest read
    0. ``seed_key`` is the (2,) threefry key [seed_lo, seed_hi] (any
    indexable of ints). CPU tensor: the plain version. CUDA tensor: the
    kernel on the current stream, or an exception."""
    return _wrapper("draw_flags", packed, seed_key, width, n)


def min_draw(packed: torch.Tensor, seed_key, width: int = MAX_PKTS,
             n: int | None = None) -> torch.Tensor:
    """Per-unit minimum 24-bit draw: (3, P) uint32 -> (P,) uint32, of which
    the first ``n`` units (all by default) are real and the rest read
    SENTINEL. CPU tensor: the plain version. CUDA tensor: the kernel on the
    current stream, or an exception."""
    return _wrapper("min_draw", packed, seed_key, width, n)


# -- page-locked slots and deferred-readback handles --------------------------

class DrawSlot:
    """The buffers of one dispatch of ``kernel`` at bucket ``p``, made once
    and reused: the packed (rows, P) input (``inp``, a numpy view) and the
    output (``out``), in page-locked host memory on a card (plain host
    memory on the CPU), and one CUDA event. The kernel reads the input and
    writes the output in place through their device addresses, so a
    dispatch queues no copy and allocates nothing."""

    __slots__ = ("kernel", "p", "host_in", "host_out", "inp", "out",
                 "event", "_ptrs")

    def __init__(self, kernel: str, p: int, device) -> None:
        rows, dtype, out_len, _ = _KERNELS[kernel]
        cuda = device.type == "cuda"
        self.kernel, self.p = kernel, p
        self.host_in = torch.zeros((rows, p), dtype=torch.uint32,
                                   pin_memory=cuda)
        self.host_out = torch.zeros(out_len(p), dtype=dtype,
                                    pin_memory=cuda)
        self.inp = self.host_in.numpy()
        self.out = self.host_out.numpy()
        self.event = torch.cuda.Event() if cuda else None
        self._ptrs = ((devcfg.device_pointer(self.host_in, "draw"),
                       devcfg.device_pointer(self.host_out, "draw"))
                      if cuda else None)

    def launch(self, n: int, seed_key, width: int, stream) -> None:
        """Run the kernel on the first ``n`` units of ``inp`` into ``out``:
        on a card queued on ``stream`` with the event recorded after it, on
        the CPU the plain version at once."""
        if self.event is None:
            self.host_out.copy_(_wrapper(self.kernel, self.host_in,
                                         seed_key, width, n))
            return
        _launch_kernel(self.kernel, self._ptrs[0], self.p, n, seed_key,
                       width, self._ptrs[1], stream.cuda_stream)
        self.event.record(stream)


class _SlotHandle:
    """An in-flight dispatch on a DrawSlot. read() waits for the kernel,
    copies the result out of the slot and gives the slot back to its
    plane; a handle dropped unread gives it back once the kernel is done."""

    __slots__ = ("_plane", "_slot", "_n", "_result")

    def __init__(self, plane, slot: DrawSlot, n: int) -> None:
        self._plane = plane
        self._slot = slot
        self._n = n
        self._result = None

    def _copy_out(self, out: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def read(self) -> np.ndarray:
        if self._result is None:
            slot = self._slot
            if slot.event is not None:
                slot.event.synchronize()
            self._result = self._copy_out(slot.out)
            self._slot = None
            self._plane._give(slot)
        return self._result

    def is_ready(self) -> bool:
        """True when the device result has landed host-side — read() will
        not stall."""
        slot = self._slot
        return slot is None or slot.event is None or slot.event.query()

    def __del__(self) -> None:
        slot = self._slot
        if slot is not None:
            if slot.event is not None:
                slot.event.synchronize()  # the kernel may still write it
            self._plane._give(slot)


class DrawHandle(_SlotHandle):
    """An in-flight device draw: read() yields the (n,) bool flags."""

    __slots__ = ()

    def _copy_out(self, out: np.ndarray) -> np.ndarray:
        n = self._n
        return np.unpackbits(out[:(n + 7) // 8],
                             bitorder="little")[:n].astype(bool)


class MinDrawHandle(_SlotHandle):
    """An in-flight speculative min-draw batch: read() yields (n,) uint32
    prefix-min draws (see min_draw), a copy the slot's reuse leaves
    alone."""

    __slots__ = ()

    def _copy_out(self, out: np.ndarray) -> np.ndarray:
        return out[:self._n].copy()


class DeviceDrawPlane:
    """Dispatches loss-draw batches to the card (or, for ``device="cpu"``,
    to the plain PyTorch versions on the CPU).

    Each (kernel, bucket) keeps a list of free DrawSlots. A dispatch takes
    one (making another when all are in flight: up to
    network.devroute.WINDOW_SLOTS windows, the chunks of an oversized
    batch and the speculative waves can be in flight at once), fills the
    real units' columns, launches and records the slot's event; reading
    the handle gives the slot back. Units past the real ones are never
    read, so a slot needs no clearing between batches of different
    sizes.

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
        self._free: dict = {}  # (kernel, P) -> [DrawSlot] not in flight
        if self._cuda:
            devcfg.kernel_lib("draw")  # build or load now, not mid-round

    def _seed_key(self, seed) -> np.ndarray:
        """(2,) uint32 threefry key for ``seed`` (None = the plane's own).
        Passed to the kernels as data, so serving another simulation's
        seed reuses the same build."""
        s = self.seed if seed is None else int(seed)
        return np.array([s & 0xFFFFFFFF, (s >> 32) & 0xFFFFFFFF],
                        dtype=np.uint32)

    def slots(self, kernel: str, p: int) -> list:
        """The free slots of bucket ``p`` of ``kernel``."""
        return self._free.setdefault((kernel, p), [])

    def _give(self, slot: DrawSlot) -> None:
        self.slots(slot.kernel, slot.p).append(slot)

    def _launch(self, kernel: str, cols, p: int, seed) -> DrawSlot:
        """Fill a free slot of bucket ``p`` with ``cols`` and run
        ``kernel`` on it; returns the slot, in flight."""
        free = self.slots(kernel, p)
        try:
            slot = free.pop()  # atomic under the GIL
        except IndexError:
            slot = DrawSlot(kernel, p, self.device)
        n = cols[0].shape[0]
        a = slot.inp
        for r, col in enumerate(cols):
            a[r, :n] = col
        slot.launch(n, self._seed_key(seed), self.max_pkts,
                    torch.cuda.current_stream(self.device)
                    if self._cuda else None)
        return slot

    def dispatch(self, uid_lo: np.ndarray, uid_hi: np.ndarray,
                 npkts: np.ndarray, thresh: np.ndarray,
                 seed: int = None) -> DrawHandle:
        """Launch one batch (any length <= max_batch); returns a handle to
        read when due. ``seed`` overrides the plane's seed for this
        batch."""
        n = uid_lo.shape[0]
        p = _bucket(n, self.max_batch)
        slot = self._launch("draw_flags", (uid_lo, uid_hi, npkts, thresh),
                            p, seed)
        return DrawHandle(self, slot, n)

    def dispatch_min(self, uid_lo: np.ndarray, uid_hi: np.ndarray,
                     npkts: np.ndarray, min_bucket: int = 0,
                     seed: int = None) -> MinDrawHandle:
        """Launch one speculative min-draw batch. ``min_bucket`` pins the
        padded shape; ``seed`` overrides the plane's seed."""
        n = uid_lo.shape[0]
        p = max(_bucket(n, self.max_batch), min_bucket)
        slot = self._launch("min_draw", (uid_lo, uid_hi, npkts), p, seed)
        return MinDrawHandle(self, slot, n)

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
        pinned speculative min-draw shape once, which leaves a slot in
        each bucket. Pure wall-clock work: flags are never read for
        results here. ``should_abort`` is polled between shapes (attach
        teardown)."""
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
