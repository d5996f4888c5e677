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

and, for a batch split over device entries, one launch a card for the
pieces its entries hold (``draw_flags_entry``, ``min_draw_entry``: the
same per-block body over a table of pieces, each into its entry's own
output region; ``draw_flags_entry_plain``, ``min_draw_entry_plain``).

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

import threading
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
LAUNCHES = {"draw_flags": 0, "min_draw": 0, "draw_flags_entry": 0,
            "min_draw_entry": 0}
#: DeviceDrawPlane's pieces drawn on the card by device entry index since
#: the last reset_launches(): a batch split over n entries counts once on
#: each (one entry kernel launch a card draws its entries' pieces)
ENTRY_LAUNCHES: dict = {}
#: pieces one launch of an entry kernel draws: the size limit of the piece
#: table it takes in its parameters (csrc/draw.cu kMaxPieces)
MAX_PIECES = 32
#: the fleet's DrawServer launches from one thread per member: the count's
#: read-modify-write takes this lock so that no launch goes uncounted
_LAUNCH_LOCK = threading.Lock()


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    ENTRY_LAUNCHES.clear()


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
    """_lane_draws of the first ``n`` units (all by default) of a (rows, P)
    uint32 batch [uid_lo, uid_hi, npkts, ...]: (n, width) draws and lane
    mask."""
    rows = packed[:, :n].to(torch.int64)
    return _lane_draws(rows[0], rows[1], rows[2], seed_key, width)


def packbits_little(flags: torch.Tensor) -> torch.Tensor:
    """(P,) bool -> (P/8,) uint8, as np.packbits(bitorder="little")."""
    w = (1 << torch.arange(8, dtype=torch.int64, device=flags.device))
    return (flags.to(torch.int64).view(-1, 8) * w).sum(1).to(torch.uint8)


def draw_flags_plain(packed: torch.Tensor, seed_key, width: int = MAX_PKTS,
                     n: int | None = None) -> torch.Tensor:
    """Plain version of the draw_flags kernel (and of the reference's
    _draw_kernel): a unit drops iff some lane p < min(npkts, width) has
    its 24-bit draw below the unit's threshold; units past ``n`` never
    drop (and draw nothing)."""
    p = packed.shape[1]
    n = p if n is None else n
    flags = torch.zeros(p, dtype=torch.bool, device=packed.device)
    if n:
        draws, valid = _packed_draws(packed, seed_key, width, n)
        thresh = packed[3, :n].to(torch.int64)[:, None]
        flags[:n] = ((draws < thresh) & valid).any(dim=1)
    return packbits_little(flags)


def min_draw_plain(packed: torch.Tensor, seed_key, width: int = MAX_PKTS,
                   n: int | None = None) -> torch.Tensor:
    """Plain version of the min_draw kernel (and of the reference's
    _min_draw_kernel); units past ``n`` read SENTINEL (and draw
    nothing)."""
    p = packed.shape[1]
    n = p if n is None else n
    out = torch.full((p,), SENTINEL, dtype=torch.int64, device=packed.device)
    if n:
        draws, valid = _packed_draws(packed, seed_key, width, n)
        m = torch.where(valid, draws, torch.full_like(draws, SENTINEL))
        out[:n] = m.min(dim=1).values
    return out.to(torch.uint32)


def piece_width(p: int, k: int) -> int:
    """Units a piece of a batch padded to bucket ``p`` and split over ``k``
    entries: the batch pads to a multiple of 8 k (so each piece's
    bit-packed flags start on a byte) and splits evenly, as the reference
    shards it (shadow_tpu/ops/propagate.py:197)."""
    q = 8 * k
    return -(-max(p, q) // q) * q // k


def region_width(piece: int) -> int:
    """An entry's output region, in units: its piece rounded up to the
    kernels' 32, so no flag word holds two pieces' bits."""
    return -(-piece // 32) * 32


def piece_table(n: int, piece: int, pieces) -> np.ndarray:
    """(len(pieces), 2) int64 rows [first column, real units] of pieces
    ``pieces`` (indices, in the order one launch draws them) of an
    ``n``-unit batch split into pieces of ``piece`` units: a piece past the
    batch's end has 0 real units."""
    cols = np.asarray(pieces, dtype=np.int64) * piece
    return np.stack([cols, np.clip(n - cols, 0, piece)], axis=1)


def _entry_plain(plain, packed: torch.Tensor, seed_key, width: int, table,
                 region: int) -> torch.Tensor:
    rows = packed.shape[0]
    outs = []
    for col, n in np.asarray(table)[:, :2].tolist():
        x = packed.new_zeros((rows, region))
        x[:, :n] = packed[:, col:col + n]
        outs.append(plain(x, seed_key, width, n))
    return torch.stack(outs)


def draw_flags_entry_plain(packed: torch.Tensor, seed_key,
                           width: int = MAX_PKTS, table=None,
                           region: int = 32) -> torch.Tensor:
    """Plain version of the draw_flags_entry kernel: (len(table), region /
    8) uint8, row i the draw_flags_plain flags of the piece of ``table``'s
    row i ([first column, real units, ...]) of the (4, P) batch
    ``packed``, padded to ``region`` units."""
    return _entry_plain(draw_flags_plain, packed, seed_key, width, table,
                        region)


def min_draw_entry_plain(packed: torch.Tensor, seed_key,
                         width: int = MAX_PKTS, table=None,
                         region: int = 32) -> torch.Tensor:
    """Plain version of the min_draw_entry kernel: (len(table), region)
    uint32, row i the min_draw_plain minima of table row i's piece of the
    (3, P) batch, padded to ``region`` units with SENTINEL."""
    return _entry_plain(min_draw_plain, packed, seed_key, width, table,
                        region)


# -- wrappers -----------------------------------------------------------------

def _check(packed: torch.Tensor, rows: int, width: int, n, what: str,
           p_mult: int = 32) -> int:
    """Validate a wrapper's arguments; returns the real unit count."""
    if not isinstance(packed, torch.Tensor):
        raise TypeError(f"{what}: packed must be a torch.Tensor")
    if packed.dtype != torch.uint32:
        raise TypeError(f"{what}: packed must be uint32, got {packed.dtype}")
    if packed.dim() != 2 or packed.shape[0] != rows:
        raise ValueError(
            f"{what}: packed must be ({rows}, P), got {tuple(packed.shape)}")
    p = packed.shape[1]
    if p <= 0 or p % p_mult:
        raise ValueError(f"{what}: P must be a positive multiple of "
                         f"{p_mult}, got {p}")
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
                   width: int, out_ptr: int, stream: int,
                   entry: int = None) -> None:
    """Launch ``name`` (csrc/draw.cu) on the card addresses of its (rows,
    P) input and its output (the stream's card must be current), and count
    the launch (under ``entry`` too, for a plane's), or raise."""
    lib = devcfg.kernel_lib("draw")
    k0, k1 = _key_words(seed_key)
    code = getattr(lib, f"shadow_{name}")(packed_ptr, p, n, k0, k1, width,
                                          out_ptr, stream)
    devcfg.check_launch(lib, code, name)
    with _LAUNCH_LOCK:
        LAUNCHES[name] += 1
        if entry is not None:
            ENTRY_LAUNCHES[entry] = ENTRY_LAUNCHES.get(entry, 0) + 1


def _wrapper(name: str, packed: torch.Tensor, seed_key, width: int,
             n) -> torch.Tensor:
    rows, dtype, out_len, plain = _KERNELS[name]
    n = _check(packed, rows, width, n, name)
    if packed.device.type == "cpu":
        return plain(packed, seed_key, width, n)
    p = packed.shape[1]
    out = torch.empty(out_len(p), dtype=dtype, device=packed.device)
    with devcfg.current(packed.device):
        _launch_kernel(name, packed.data_ptr(), p, n, seed_key, width,
                       out.data_ptr(),
                       torch.cuda.current_stream(packed.device).cuda_stream)
    return out


def _launch_entry_kernel(name: str, packed_ptr: int, p: int, rows_ptr: int,
                         count: int, region: int, seed_key, width: int,
                         stream: int, entries=()) -> None:
    """Launch ``name`` (draw_flags_entry or min_draw_entry, csrc/draw.cu)
    over the (rows, P) batch at ``packed_ptr`` for ``count`` pieces, whose
    rows ((count, 3) int64 [first column, real units, output address]) are
    at ``rows_ptr`` (the launch copies them into its parameters), and
    count the launch and each of ``entries``' pieces, or raise."""
    lib = devcfg.kernel_lib("draw")
    k0, k1 = _key_words(seed_key)
    code = getattr(lib, f"shadow_{name}")(packed_ptr, p, rows_ptr, count,
                                          region, k0, k1, width, stream)
    devcfg.check_launch(lib, code, name)
    with _LAUNCH_LOCK:
        LAUNCHES[name] += 1
        for i in entries:
            ENTRY_LAUNCHES[i] = ENTRY_LAUNCHES.get(i, 0) + 1


def _entry_wrapper(name: str, packed: torch.Tensor, seed_key, width: int,
                   table, region: int) -> torch.Tensor:
    rows, dtype, out_len, plain = _KERNELS[name]
    entry = f"{name}_entry"
    _check(packed, rows, width, None, entry, p_mult=1)
    table = np.asarray(table, dtype=np.int64).reshape(-1, 2)
    p = packed.shape[1]
    if region <= 0 or region % 32:
        raise ValueError(f"{entry}: region must be a positive multiple of "
                         f"32, got {region}")
    if not 1 <= len(table) <= MAX_PIECES:
        raise ValueError(f"{entry}: {len(table)} pieces, want 1.."
                         f"{MAX_PIECES} (the launch's piece table)")
    cols, ns = table[:, 0], table[:, 1]
    if (cols < 0).any() or (ns < 0).any() or (ns > region).any() \
            or (cols + ns > p).any():
        raise ValueError(f"{entry}: a piece lies outside the batch of {p} "
                         f"or its region of {region}: {table.tolist()}")
    if packed.device.type == "cpu":
        return _entry_plain(plain, packed, seed_key, width, table, region)
    out = torch.empty((len(table), out_len(region)), dtype=dtype,
                      device=packed.device)
    full = np.empty((len(table), 3), dtype=np.int64)
    full[:, :2] = table
    full[:, 2] = out.data_ptr() + np.arange(len(table)) * out.stride(0) \
        * out.element_size()
    with devcfg.current(packed.device):
        _launch_entry_kernel(
            entry, packed.data_ptr(), p, full.ctypes.data, len(full), region,
            seed_key, width,
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


def draw_flags_entry(packed: torch.Tensor, seed_key, width: int = MAX_PKTS,
                     table=None, region: int = 32) -> torch.Tensor:
    """The drop flags of pieces of a (4, P) batch: (len(table), region / 8)
    uint8, row i for ``table`` row i ([first column, real units], at most
    MAX_PIECES rows), each piece's flags padded to ``region`` units. CPU
    tensor: the plain version. CUDA tensor: one draw_flags_entry launch on
    the current stream, or an exception."""
    return _entry_wrapper("draw_flags", packed, seed_key, width, table,
                          region)


def min_draw_entry(packed: torch.Tensor, seed_key, width: int = MAX_PKTS,
                   table=None, region: int = 32) -> torch.Tensor:
    """The minima of pieces of a (3, P) batch: (len(table), region) uint32,
    as draw_flags_entry. CPU tensor: the plain version. CUDA tensor: one
    min_draw_entry launch on the current stream, or an exception."""
    return _entry_wrapper("min_draw", packed, seed_key, width, table,
                          region)


# -- page-locked slots and deferred-readback handles --------------------------

class DrawSlot:
    """The buffers of one dispatch of ``kernel`` at bucket ``p`` on
    ``device``, made once and reused: the packed (rows, P) input (``inp``,
    a numpy view) and the output (``out``), in page-locked host memory on a
    card (plain host memory on the CPU), and one CUDA event. The kernel
    reads the input and writes the output in place through their device
    addresses, so a dispatch queues no copy and allocates nothing."""

    __slots__ = ("kernel", "p", "device", "host_in", "host_out", "inp",
                 "out", "event", "_ptrs")

    def __init__(self, kernel: str, p: int, device) -> None:
        rows, dtype, out_len, _ = _KERNELS[kernel]
        cuda = device.type == "cuda"
        self.kernel, self.p, self.device = kernel, p, device
        self.host_in = torch.zeros((rows, p), dtype=torch.uint32,
                                   pin_memory=cuda)
        self.host_out = torch.zeros(out_len(p), dtype=dtype,
                                    pin_memory=cuda)
        self.inp = self.host_in.numpy()
        self.out = self.host_out.numpy()
        self.event = torch.cuda.Event() if cuda else None
        self._ptrs = None
        if cuda:
            with devcfg.current(device):
                self._ptrs = (devcfg.device_pointer(self.host_in, "draw"),
                              devcfg.device_pointer(self.host_out, "draw"))

    def launch(self, n: int, seed_key, width: int, stream) -> None:
        """Run the kernel on the first ``n`` units of ``inp`` into ``out``:
        on a card queued on ``stream`` (the slot's card's) with the event
        recorded after it, on the CPU the plain version at once."""
        if self.event is None:
            self.host_out.copy_(_wrapper(self.kernel, self.host_in,
                                         seed_key, width, n))
            return
        with devcfg.current(self.device):
            _launch_kernel(self.kernel, self._ptrs[0], self.p, n, seed_key,
                           width, self._ptrs[1], stream.cuda_stream, 0)
            self.event.record(stream)

    def wait(self) -> None:
        if self.event is not None:
            self.event.synchronize()

    def done(self) -> bool:
        return self.event is None or self.event.query()


class SplitSlot:
    """The buffers of one dispatch of ``kernel`` at bucket ``p`` split over
    a plane's device entries (``groups``: devcfg.group_entries of them),
    made once and reused: the whole padded batch, (rows, k * piece) in
    ``inp``, and one output region an entry, row i of ``out``
    (region_width(piece) units: no flag word holds two pieces' bits), in
    page-locked host memory that every card maps (plain host memory on CPU
    entries), and one CUDA event a card. A dispatch fills the batch once
    and runs the entry kernel once a card, over a table of that card's
    pieces (piece_table, with each region's address); the kernel reads the
    batch and writes the regions in place. On CPU entries the plain entry
    version runs once a group on the same table."""

    __slots__ = ("kernel", "p", "piece", "region", "groups", "host_in",
                 "host_out", "inp", "out", "_launches")

    def __init__(self, kernel: str, p: int, piece: int, groups) -> None:
        rows, dtype, out_len, _ = _KERNELS[kernel]
        k = sum(len(ix) for _, ix in groups)
        cuda = groups[0][0].type == "cuda"
        self.kernel, self.p, self.piece = kernel, p, piece
        self.region = region_width(piece)
        self.groups = groups
        self.host_in = torch.zeros((rows, k * piece), dtype=torch.uint32,
                                   pin_memory=cuda)
        self.host_out = torch.zeros((k, out_len(self.region)), dtype=dtype,
                                    pin_memory=cuda)
        self.inp = self.host_in.numpy()
        self.out = self.host_out.numpy()
        row_bytes = self.out.strides[0]
        #: per group: (device, its entries, its rows [first column, real
        #: units, output address], their address, the first columns as
        #: ints, the batch's address on the device, the event)
        self._launches = []
        for dev, ix in groups:
            table = np.zeros((len(ix), 3), dtype=np.int64)
            table[:, :2] = piece_table(0, piece, ix)
            in_ptr = event = None
            if cuda:
                with devcfg.current(dev):
                    in_ptr = devcfg.device_pointer(self.host_in, "draw")
                    out_ptr = devcfg.device_pointer(self.host_out, "draw")
                table[:, 2] = out_ptr + np.asarray(ix) * row_bytes
                event = torch.cuda.Event()
            self._launches.append((dev, ix, table, table.ctypes.data,
                                   table[:, 0].tolist(), in_ptr, event))

    def launch(self, n: int, seed_key, width: int) -> None:
        """Run the kernel on the first ``n`` units of ``inp``: one launch
        a card on its current stream with its event recorded after it; on
        CPU entries the plain version at once, one call a group."""
        piece, p = self.piece, self.inp.shape[1]
        entry = f"{self.kernel}_entry"
        for dev, ix, table, table_ptr, cols, in_ptr, event in self._launches:
            for j, col in enumerate(cols):  # piece_table's real units
                table[j, 1] = min(max(n - col, 0), piece)
            if event is None:
                self.out[list(ix)] = _entry_plain(
                    _KERNELS[self.kernel][3], self.host_in, seed_key, width,
                    table, self.region).numpy()
                continue
            with devcfg.current(dev):
                stream = torch.cuda.current_stream(dev)
                _launch_entry_kernel(entry, in_ptr, p, table_ptr, len(ix),
                                     self.region, seed_key, width,
                                     stream.cuda_stream, ix)
                event.record(stream)

    def wait(self) -> None:
        for *_, event in self._launches:
            if event is not None:
                event.synchronize()

    def done(self) -> bool:
        return all(event is None or event.query()
                   for *_, event in self._launches)


class _SlotHandle:
    """An in-flight dispatch on a DrawSlot or a SplitSlot. read() waits for
    the kernels (one event a card), copies the result out of the slot (a
    split batch's pieces in entry order) and gives the slot back to its
    plane; a handle dropped unread gives it back once the kernels are
    done."""

    __slots__ = ("_plane", "_slot", "_n", "_result")

    def __init__(self, plane, slot, n: int) -> None:
        self._plane = plane
        self._slot = slot
        self._n = n
        self._result = None

    def _copy_out(self, slot) -> np.ndarray:
        raise NotImplementedError

    def read(self) -> np.ndarray:
        if self._result is None:
            slot = self._slot
            slot.wait()
            self._result = self._copy_out(slot)
            self._slot = None
            self._plane._give(slot)
        return self._result

    def is_ready(self) -> bool:
        """True when the device result has landed host-side — read() will
        not stall."""
        return self._slot is None or self._slot.done()

    def wait(self) -> None:
        """Block until the kernels have written the result; read() then
        only copies it out."""
        if self._slot is not None:
            self._slot.wait()

    def __del__(self) -> None:
        if self._slot is not None:
            self._slot.wait()  # the kernel may still write it
            self._plane._give(self._slot)


class DrawHandle(_SlotHandle):
    """An in-flight device draw: read() yields the (n,) bool flags."""

    __slots__ = ()

    def _copy_out(self, slot) -> np.ndarray:
        n = self._n
        bits = (slot.out[:(n + 7) // 8] if slot.out.ndim == 1 else
                slot.out[:, :slot.piece // 8].reshape(-1))
        return np.unpackbits(bits, bitorder="little")[:n].astype(bool)


class MinDrawHandle(_SlotHandle):
    """An in-flight speculative min-draw batch: read() yields (n,) uint32
    prefix-min draws (see min_draw), a copy the slot's reuse leaves
    alone."""

    __slots__ = ()

    def _copy_out(self, slot) -> np.ndarray:
        if slot.out.ndim == 1:
            return slot.out[:self._n].copy()
        return slot.out[:, :slot.piece].flatten()[:self._n]


class DeviceDrawPlane:
    """Dispatches loss-draw batches to the card (or, for ``device="cpu"``,
    to the plain PyTorch versions on the CPU).

    ``n_shards`` > 1 (experimental.tpu_mesh_shards; 0 = every entry of
    ``device``, clamped to them as the reference clamps to its devices)
    splits each batch along the unit axis over that many device entries
    (devcfg.select_devices): the batch pads to a multiple of 8 n, so each
    piece's bit-packed flags start on a byte (piece_width), and piece i is
    entry i's. The entries are grouped by device (devcfg.group_entries):
    a dispatch is one draw_flags_entry (min_draw_entry) launch a card over
    its entries' pieces, in a SplitSlot; the handle waits on one event a
    card and reads the pieces in entry order. The kernels are elementwise
    along the unit axis, so the split changes no value.

    Each (kernel, bucket) keeps a list of free slots (DrawSlots on one
    entry, SplitSlots over several). A dispatch takes one (making another
    when all are in flight: up to network.devroute.WINDOW_SLOTS windows,
    the chunks of an oversized batch and the speculative waves can be in
    flight at once), fills the real units' columns, launches and records
    the slot's events; reading the handle gives the slot back. Units past
    the real ones are never read, so a slot needs no clearing between
    batches of different sizes.

    The numpy twin is fluid.loss_flags; tests/test_torch_propagate.py
    asserts the two produce identical flags for identical inputs.
    """

    #: every speculative wave pads to this one bucket (warmed at
    #: attach_cached); callers chunk bigger waves at this size
    SPEC_BUCKET = 16384

    def __init__(self, seed: int, max_batch: int = 65536,
                 max_pkts: int = MAX_PKTS, device: str = "cuda",
                 n_shards: int = 0) -> None:
        entries = devcfg.select_devices(device)
        n = n_shards if n_shards > 0 else len(entries)
        #: the entries the batches split over, in piece order
        self.entries = entries[:min(n, len(entries))]
        self.n_shards = len(self.entries)
        self.device = self.entries[0]
        #: ((device, (entry, ...)), ...): one launch a device a split batch
        self.groups = devcfg.group_entries(self.entries)
        most = max(len(ix) for _, ix in self.groups)
        if self.n_shards > 1 and self.device.type == "cuda" \
                and most > MAX_PIECES:
            raise ValueError(
                f"DeviceDrawPlane: {most} entries on one card, more than "
                f"the {MAX_PIECES} pieces one draw launch takes")
        self.seed = int(seed)
        self.max_batch = int(max_batch)
        self.max_pkts = int(max_pkts)  # kernel packet-lane width
        self._cuda = self.device.type == "cuda"
        #: (kernel, P) -> [DrawSlot or SplitSlot] not in flight
        self._free: dict = {}
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

    def _give(self, slot) -> None:
        self.slots(slot.kernel, slot.p).append(slot)

    def _launch(self, kernel: str, cols, p: int, seed):
        """Fill a free slot of bucket ``p`` with ``cols`` and run ``kernel``
        on it, on the one entry or split over the entries; returns the
        slot, in flight."""
        free = self.slots(kernel, p)
        try:
            # atomic under the GIL: threads sharing the plane (the fleet's
            # DrawServer) never take one slot twice, and a slot returns to
            # the list only once its handle is read or dropped
            slot = free.pop()
        except IndexError:
            slot = (DrawSlot(kernel, p, self.device) if self.n_shards == 1
                    else SplitSlot(kernel, p,
                                   piece_width(p, self.n_shards),
                                   self.groups))
        n = cols[0].shape[0]
        a = slot.inp
        for r, col in enumerate(cols):
            a[r, :n] = col
        if self.n_shards > 1:
            slot.launch(n, self._seed_key(seed), self.max_pkts)
        else:
            slot.launch(n, self._seed_key(seed), self.max_pkts,
                        torch.cuda.current_stream(slot.device)
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
        slot = self._launch("draw_flags", (uid_lo, uid_hi, npkts, thresh), p,
                            seed)
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

    #: (seed, max_batch, max_pkts, device, n_shards) -> entry
    _cache: dict = {}

    @classmethod
    def attach_cached(cls, seed: int, max_batch: int, max_pkts: int,
                      device: str = "cuda", should_abort=None,
                      n_shards: int = 0):
        """Process-wide attach cache: (plane, dev_s, np_per_unit) for this
        parameter tuple, building + calibrating on first use, so a process
        that runs many short Controllers pays the kernel load, warm-up and
        calibration once. Pure wall-clock policy: the plane is stateless,
        so sharing it across runs cannot change results.

        ``should_abort`` (callable -> bool) is polled between the attach
        phases; when it fires, the partial attach is discarded (nothing
        cached) and None is returned."""
        key = (int(seed), int(max_batch), int(max_pkts), str(device),
               int(n_shards))
        hit = cls._cache.get(key)
        if hit is None:
            if should_abort is not None and should_abort():
                return None
            plane = cls(seed, max_batch, max_pkts=max_pkts, device=device,
                        n_shards=n_shards)
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


# -- the fleet's shared draw service ------------------------------------------

#: authkey for the fleet draw-service socket (local AF_UNIX only; the
#: socket path lives in a mode-0700 directory — the key is a protocol
#: sanity check, not the access control)
DRAW_SERVICE_AUTHKEY = b"shadow-tpu-draw-service-v1"


def draw_service_address() -> str:
    """A fresh AF_UNIX path for a ``DrawServer``, in a new directory only
    this user can enter (0700). The server unlinks the socket when it
    closes; whoever asked for the path removes its directory
    (``shutil.rmtree(os.path.dirname(address))``)."""
    import os
    import tempfile

    d = tempfile.mkdtemp(prefix="stpt_draw_")
    os.chmod(d, 0o700)
    return os.path.join(d, "sock")


class DrawServer:
    """The fleet parent's shared draw plane: ONE attach
    (DeviceDrawPlane.attach_cached — kernel load, calibration and warm-up
    paid once, one CUDA context) serving every member simulation's draw
    windows over an AF_UNIX socket (fleet.py owns the member-side proxy).
    The kernels take the threefry key as data, so M members with M seeds
    share the one plane.

    Protocol (multiprocessing.connection, one serving thread per member):
      member -> ("hello", seed)
      server -> ("ok", dev_s, np_per_unit, SPEC_BUCKET, max_batch)
               | ("error", None, message)        # the attach failed
      member -> ("draw", rid, seed, lo, hi, npk, th)
               | ("min", rid, seed, lo, hi, npk, min_bucket) | ("bye",)
      server -> (rid, result_array)              # FIFO per member
               | ("error", rid, message)         # a launch or read failed

    Every serving thread launches on the device's default stream (torch's
    current stream is per thread, and no thread here sets one), so all
    members' launches queue on the card in one order; each DrawSlot's
    event marks its own. The slots are handed out under the GIL (see
    DeviceDrawPlane._launch) and the launch counts under a lock.

    Unlike the reference's, a failure is never hidden: a failed attach or
    launch is sent to the member, which raises it (its seed fails and the
    fleet's retry budget reruns it), and is kept in ``errors`` for the
    sweep's summary; the member never falls back to the host twin."""

    def __init__(self, seed: int, max_batch: int = 65536,
                 max_pkts: int = MAX_PKTS, *, address: str,
                 device: str = "cuda", n_shards: int = 0) -> None:
        from multiprocessing.connection import Listener

        self.address = address  # see draw_service_address
        # the listener accepts at once while the attach runs on a sibling
        # thread: a member's hello waits (polling its own abort) for the
        # plane to publish, and runs the host twin meanwhile, as a
        # standalone run does before its background attach publishes
        self._listener = Listener(address, family="AF_UNIX", backlog=64,
                                  authkey=DRAW_SERVICE_AUTHKEY)
        self._attach_args = (int(seed), int(max_batch), int(max_pkts),
                             str(device))
        #: experimental.tpu_mesh_shards: the plane splits its batches over
        #: that many of ``device``'s entries (0 = all of them)
        self._n_shards = int(n_shards)
        self.plane = None
        self.dev_s = 0.0
        self.np_per_unit = 0.0
        self.attach_wall = 0.0
        #: launches the attach itself made (calibration and warm-up)
        self.attach_launches = {k: 0 for k in LAUNCHES}
        #: batches served per kernel, and their units
        self.served = {"draw_flags": 0, "min_draw": 0}
        self.served_units = 0
        #: every failure sent to a member (attach, launch or read)
        self.errors: list = []
        self._attach_error = None
        self._lock = threading.Lock()
        self._closing = False
        self._ready = threading.Event()
        self._members: list = []  # the serving threads
        self._attach_thread = threading.Thread(
            target=self._attach, name="draw-server-attach", daemon=True)
        self._attach_thread.start()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="draw-server-accept",
            daemon=True)
        self._accept_thread.start()

    @property
    def served_batches(self) -> int:
        return sum(self.served.values())

    def _error(self, what: str, exc: BaseException) -> str:
        msg = f"fleet draw service: {what} failed: {exc!r}"
        with self._lock:
            self.errors.append(msg)
        return msg

    def _attach(self) -> None:
        t0 = _walltime.perf_counter()
        before = dict(LAUNCHES)
        try:
            hit = DeviceDrawPlane.attach_cached(
                *self._attach_args, should_abort=lambda: self._closing,
                n_shards=self._n_shards)
        except Exception as exc:  # noqa: BLE001 — sent to every member
            self._attach_error = self._error("attach", exc)
            self._ready.set()
            return
        if hit is None:  # close() raced the attach
            self._ready.set()
            return
        self.plane, self.dev_s, self.np_per_unit = hit
        self.attach_wall = _walltime.perf_counter() - t0
        # nothing is served before _ready is set: these are the attach's
        self.attach_launches = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
        self._ready.set()

    def _accept_loop(self) -> None:
        while not self._closing:
            try:
                conn = self._listener.accept()
            except (OSError, EOFError):
                # the listener closed, or one connection's handshake broke
                # off (close()'s wake-up among them)
                if self._closing:
                    break
                continue
            except Exception:  # noqa: BLE001 — one member's handshake
                continue
            t = threading.Thread(target=self._serve, args=(conn,),
                                 name="draw-server-member", daemon=True)
            self._members.append(t)
            t.start()

    def _serve(self, conn) -> None:
        """Serve one member connection: dispatch each request on the
        shared plane at once, answer in FIFO order. The blocking read at
        the bottom happens only when no new request waits in the pipe —
        the member that sent it is either blocked on exactly this
        response or still running its rounds, so serving the oldest
        handle first is always progress. Once the server closes, the
        thread answers what is already in the pipe and ends."""
        from collections import deque

        pending: deque = deque()
        try:
            msg = conn.recv()
            if not (isinstance(msg, tuple) and msg and msg[0] == "hello"):
                return
            while not self._ready.wait(0.25):
                if self._closing:
                    return
            plane = self.plane
            if plane is None:
                conn.send(("error", None, self._attach_error
                           or "fleet draw service: closed during attach"))
                return
            if plane.device.type == "cuda":
                # the pieces' launches make their own entry's card current
                torch.cuda.set_device(plane.device)
            conn.send(("ok", self.dev_s, self.np_per_unit,
                       plane.SPEC_BUCKET, plane.max_batch))
            while True:
                if pending and pending[0][1].is_ready():
                    if not self._answer(conn, *pending.popleft()):
                        return
                    continue
                if conn.poll(0.001 if pending else 0.25):
                    msg = conn.recv()
                    op = msg[0]
                    if op == "bye":
                        break
                    rid, seed, lo, hi, npk, arg = msg[1:7]
                    try:
                        if op == "draw":
                            h = plane.dispatch(lo, hi, npk, arg, seed=seed)
                        else:  # "min"
                            h = plane.dispatch_min(lo, hi, npk,
                                                   min_bucket=arg, seed=seed)
                    except Exception as exc:  # noqa: BLE001 — to the member
                        conn.send(("error", rid, self._error("launch", exc)))
                        return
                    pending.append((rid, h))
                    with self._lock:
                        self.served["draw_flags" if op == "draw"
                                    else "min_draw"] += 1
                        self.served_units += len(lo)
                elif pending:
                    if not self._answer(conn, *pending.popleft()):
                        return
                elif self._closing:
                    return
        except (EOFError, OSError):
            pass  # the member exited or lost its connection
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _answer(self, conn, rid: int, h) -> bool:
        """Send request ``rid``'s result, or its failure (then False)."""
        try:
            out = h.read()
        except Exception as exc:  # noqa: BLE001 — to the member
            conn.send(("error", rid, self._error("read", exc)))
            return False
        conn.send((rid, out))
        return True

    def close(self) -> None:
        import socket

        self._closing = True
        # closing the listener does not wake a thread blocked in accept():
        # poke it with a bare connection (no handshake, which would wait
        # forever on an accept loop that has already seen _closing)
        try:
            with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
                s.settimeout(1.0)
                s.connect(self.address)
        except OSError:
            pass
        try:
            self._listener.close()
        except OSError:
            pass
        self._accept_thread.join(timeout=2)
        # every request already sent is served and counted before close
        # returns (a member that is still connected loses its connection)
        for t in self._members:
            t.join(timeout=30)
        # attach_cached polls _closing between its phases, so this wait is
        # bounded by one of them
        self._attach_thread.join(timeout=120)
