"""The draw batch split over device entries: one entry-kernel launch a card.

DeviceDrawPlane(n_shards=k) splits each draw batch into k pieces of
``piece_width(p, k)`` units, piece i entry i's, as the reference shards its
batch over k devices (shadow_tpu/ops/propagate.py:197, :229). The port
groups the entries by device (devcfg.group_entries) and draws each group's
pieces in one draw_flags_entry / min_draw_entry launch over a table of
pieces (piece_table: first column and real units; the card's rows add the
output region's address). On CPU entries the plain entry versions run
once a group on the same table, which is what these tests exercise; the
kernels are held against the plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py. The grouping and the tables
are pure and are tested here for card entries too. Tolerance 0: every
value is integer.
"""

import numpy as np
import pytest
import torch

from shadow_tpu.ops import propagate as ref_prop
from shadow_tpu.ops.propagate import DeviceDrawPlane as RefDrawPlane
from shadow_tpu_torch.ops import devcfg
from shadow_tpu_torch.ops import propagate as prop

CPU = torch.device("cpu")
SEED = (1 << 33) + 4242


def _cards(*idx):
    return tuple(torch.device("cuda", i) for i in idx)


def _cols(rng, n, rows=4):
    lo = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    hi = rng.integers(0, 1 << 26, n, dtype=np.uint64).astype(np.uint32)
    npk = rng.integers(0, 14, n).astype(np.uint32)
    npk[::7] = 0
    th = rng.choice(np.array([0, 1, 1 << 10, 1 << 18, 1 << 24],
                             dtype=np.uint32), n)
    return (lo, hi, npk, th)[:rows]


def _key(seed):
    return np.array([seed & 0xFFFFFFFF, seed >> 32], np.uint32)


def _plane(k: int, **kw):
    return prop.DeviceDrawPlane(SEED, 65536, max_pkts=10,
                                device=",".join(["cpu"] * k), n_shards=k,
                                **kw)


# -- the grouping and the piece tables ----------------------------------------

@pytest.mark.parametrize("entries, groups", [
    (_cards(0, 0, 0, 0), ((torch.device("cuda", 0), (0, 1, 2, 3)),)),
    (_cards(0, 1), ((torch.device("cuda", 0), (0,)),
                    (torch.device("cuda", 1), (1,)))),
    (_cards(0, 1, 0), ((torch.device("cuda", 0), (0, 2)),
                       (torch.device("cuda", 1), (1,)))),
    ((CPU,) * 4, ((CPU, (0, 1, 2, 3)),))],
    ids=["one_card_x4", "two_cards", "interleaved", "cpu_x4"])
def test_group_entries_one_group_a_device(entries, groups):
    """One group a device, in the order of its first entry, each group's
    entries in piece order; the exchange's entry_plan launches the same
    groups."""
    assert devcfg.group_entries(entries) == groups


@pytest.mark.parametrize("k", [2, 3, 4, 8])
@pytest.mark.parametrize("p", [256, 1024, 16384, 65536])
def test_piece_width_pads_as_the_reference(p, k):
    """k pieces cover the reference's padded batch (a multiple of 8 k at
    or above the bucket) exactly; each region is its piece rounded up to
    32 units."""
    piece = prop.piece_width(p, k)
    q = 8 * k
    assert piece * k == -(-max(p, q) // q) * q
    assert piece % 8 == 0
    region = prop.region_width(piece)
    assert region % 32 == 0 and piece <= region < piece + 32


@pytest.mark.parametrize("entries", [
    _cards(0, 0, 0, 0), _cards(0, 1), _cards(0, 1, 0), _cards(1, 0, 1, 0)],
    ids=["one_card_x4", "two_cards", "interleaved", "interleaved_x4"])
@pytest.mark.parametrize("n", [0, 1, 5, 64, 150, 256])
def test_piece_tables_cover_the_batch_once(entries, n):
    """Each card's table names its own pieces (columns i * piece) in
    entry order; over the cards the real units cover [0, n) exactly once,
    and a piece past the batch's end (a small batch) has 0 real units."""
    k = len(entries)
    piece = prop.piece_width(256, k)
    covered = np.zeros(piece * k, dtype=int)
    for _dev, ix in devcfg.group_entries(entries):
        table = prop.piece_table(n, piece, ix)
        assert table.shape == (len(ix), 2) and table.dtype == np.int64
        for i, (col, real) in zip(ix, table.tolist()):
            assert col == i * piece
            assert real == max(0, min(piece, n - i * piece))
            covered[col:col + real] += 1
    assert covered[:n].tolist() == [1] * n and not covered[n:].any()


def test_piece_table_empty_pieces():
    table = prop.piece_table(5, 64, (0, 1, 2, 3))
    assert table.tolist() == [[0, 5], [64, 0], [128, 0], [192, 0]]
    assert prop.piece_table(200, 64, (3, 1)).tolist() == [[192, 8], [64, 64]]


# -- the plain entry versions -------------------------------------------------

@pytest.mark.parametrize("k", [2, 3, 4, 8])
@pytest.mark.parametrize("n", [1, 7, 33, 300])
def test_entry_plain_equals_the_reference_batch(k, n):
    """The plain entry versions over every piece, cut to each piece's
    units and joined in entry order, equal the reference's programs on the
    whole padded batch; each region past its piece's real units holds the
    pads (flags 0, minima SENTINEL), an empty piece's whole region too."""
    rng = np.random.default_rng(k * 1000 + n)
    p = prop._bucket(n, 65536)
    piece = prop.piece_width(p, k)
    region = prop.region_width(piece)
    cols = _cols(rng, n)
    packed = np.zeros((4, piece * k), np.uint32)
    for r, c in enumerate(cols):
        packed[r, :n] = c
    table = prop.piece_table(n, piece, range(k))
    x = torch.from_numpy(packed)
    flags = prop.draw_flags_entry_plain(x, _key(SEED), 10, table, region)
    mins = prop.min_draw_entry_plain(x[:3].contiguous(), _key(SEED), 10,
                                     table, region)
    assert flags.shape == (k, region // 8) and flags.dtype == torch.uint8
    assert mins.shape == (k, region) and mins.dtype == torch.uint32
    want_flags = np.asarray(ref_prop._draw_kernel(packed, _key(SEED),
                                                  width=10))
    want_mins = np.asarray(ref_prop._min_draw_kernel(packed[:3], _key(SEED),
                                                     width=10))
    np.testing.assert_array_equal(
        flags[:, :piece // 8].reshape(-1).numpy(), want_flags)
    np.testing.assert_array_equal(mins[:, :piece].reshape(-1).numpy(),
                                  want_mins)
    for i, (_col, real) in enumerate(table.tolist()):
        assert not flags[i, -(-real // 8):].any()
        assert (mins[i, real:] == prop.SENTINEL).all()


def test_entry_wrapper_on_cpu_is_the_plain_version():
    """draw_flags_entry / min_draw_entry on a CPU tensor run the plain
    version (no launch is counted) on a table of two of four pieces, as
    card 0 of cuda:0,cuda:1,cuda:0 draws them."""
    rng = np.random.default_rng(3)
    piece = prop.piece_width(256, 3)
    x = torch.from_numpy(np.stack(_cols(rng, 3 * piece)))
    table = prop.piece_table(2 * piece - 5, piece, (0, 2))
    region = prop.region_width(piece)
    before = dict(prop.LAUNCHES)
    got = prop.draw_flags_entry(x, _key(SEED), 10, table, region)
    assert torch.equal(got, prop.draw_flags_entry_plain(
        x, _key(SEED), 10, table, region))
    got = prop.min_draw_entry(x[:3].contiguous(), _key(SEED), 10, table,
                              region)
    assert torch.equal(got, prop.min_draw_entry_plain(
        x[:3].contiguous(), _key(SEED), 10, table, region))
    assert prop.LAUNCHES == before and table[1].tolist() == [2 * piece, 0]


@pytest.mark.parametrize("table, region, needle", [
    ([[0, 10]] * 33, 32, "33 pieces"),
    ([[0, 10]], 48, "multiple of 32"),
    ([[0, 40]], 32, "outside"),
    ([[250, 10]], 32, "outside"),
    ([[-1, 1]], 32, "outside")])
def test_entry_wrapper_refusals(table, region, needle):
    x = torch.zeros((4, 256), dtype=torch.uint32)
    with pytest.raises(ValueError, match=needle):
        prop.draw_flags_entry(x, _key(SEED), 10, table, region)


# -- the split plane against the reference's ----------------------------------

@pytest.mark.parametrize("k", [2, 3, 8])
@pytest.mark.parametrize("size", [1, 7, 8, 33, 4096, 65536])
def test_split_plane_matches_the_reference(k, size):
    """DeviceDrawPlane over k CPU entries against the reference's over k
    devices: the flags, the min-draws, and the min-draws at the pinned
    SPEC_BUCKET (tests/test_torch_multidevice.py holds k = 4)."""
    ref = RefDrawPlane(SEED, 65536, n_shards=k, max_pkts=10)
    port = _plane(k)
    assert port.n_shards == k and port.groups == ((CPU, tuple(range(k))),)
    rng = np.random.default_rng(size + k)
    lo, hi, npk, th = _cols(rng, size)
    np.testing.assert_array_equal(port.dispatch(lo, hi, npk, th).read(),
                                  ref.dispatch(lo, hi, npk, th).read())
    np.testing.assert_array_equal(port.dispatch_min(lo, hi, npk).read(),
                                  ref.dispatch_min(lo, hi, npk).read())
    spec = port.SPEC_BUCKET
    if size <= spec:
        np.testing.assert_array_equal(
            port.dispatch_min(lo, hi, npk, min_bucket=spec, seed=9).read(),
            ref.dispatch_min(lo, hi, npk, min_bucket=spec, seed=9).read())


def test_split_slot_layout():
    """A split slot holds the whole padded batch and one region an entry
    (the piece rounded up to 32: 88 -> 96 units over three entries), and
    one dispatch takes one slot; the plane keeps it per (kernel, bucket)."""
    plane = _plane(3)
    rng = np.random.default_rng(11)
    h = plane.dispatch(*_cols(rng, 100))
    slot = h._slot
    assert isinstance(slot, prop.SplitSlot)
    assert (slot.piece, slot.region) == (88, 96)
    assert slot.inp.shape == (4, 264) and slot.out.shape == (3, 12)
    assert plane.slots("draw_flags", 256) == []
    h.read()
    assert plane.slots("draw_flags", 256) == [slot]
    m = plane.dispatch_min(*_cols(rng, 100, rows=3))
    assert m._slot.out.shape == (3, 96) and m._slot.out.dtype == np.uint32
    m.read()
    assert not prop.ENTRY_LAUNCHES


def test_split_smaller_batch_after_larger_reads_no_stale_unit():
    """A 5,000-unit batch, then 7 units in the same slot (pieces 1-3
    empty), then 2,000: each reads the one-entry plane's result, and the
    empty pieces' regions hold only pads."""
    split, one = _plane(4), prop.DeviceDrawPlane(SEED, 65536, max_pkts=10,
                                                 device="cpu")
    rng = np.random.default_rng(13)
    for n in (5000, 7, 2000):
        p = prop._bucket(n, 65536)
        b = _cols(rng, n)
        h = split.dispatch(*b)
        slot = h._slot
        np.testing.assert_array_equal(h.read(), one.dispatch(*b).read())
        if n == 7:
            assert not slot.out[1:].any()
        m = split.dispatch_min(*b[:3], min_bucket=8192)
        mslot = m._slot
        np.testing.assert_array_equal(
            m.read(), one.dispatch_min(*b[:3], min_bucket=8192).read())
        if n == 7:
            assert (mslot.out[1:] == prop.SENTINEL).all()
            assert (mslot.out[0, 7:] == prop.SENTINEL).all()
        assert len(split.slots("draw_flags", p)) == 1
    assert len(split.slots("min_draw", 8192)) == 1


def test_split_handles_read_out_of_order_and_dropped():
    """Five split dispatches in flight at once, each in a slot of its own,
    read last first; a dropped handle gives its slot back."""
    split, one = _plane(4), prop.DeviceDrawPlane(SEED, 65536, max_pkts=10,
                                                 device="cpu")
    rng = np.random.default_rng(17)
    batches = [_cols(rng, n) for n in (200, 17, 256, 1, 90)]
    handles = [split.dispatch(*b) for b in batches]
    assert len({id(h._slot) for h in handles}) == 5
    assert split.slots("draw_flags", 256) == []
    for b, h in reversed(list(zip(batches, handles))):
        np.testing.assert_array_equal(h.read(), one.dispatch(*b).read())
    assert len(split.slots("draw_flags", 256)) == 5
    h = split.dispatch_min(*batches[0][:3])
    assert h.is_ready()
    del h
    assert len(split.slots("min_draw", 256)) == 1


def test_split_plane_warms_every_bucket():
    """warm_shapes and calibrate run the split launch at every bucket and
    leave one split slot in each."""
    plane = prop.DeviceDrawPlane(SEED, 1024, max_pkts=10,
                                 device="cpu,cpu,cpu,cpu", n_shards=4)
    plane.warm_shapes()
    plane.calibrate(n_probe=512)
    for p in (256, 512, 1024):
        assert [type(s) for s in plane.slots("draw_flags", p)] == [
            prop.SplitSlot]
    assert len(plane.slots("min_draw", plane.SPEC_BUCKET)) == 1
