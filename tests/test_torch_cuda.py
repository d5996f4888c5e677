"""Tests that need a CUDA card: the port's hand-written kernels against
their plain PyTorch versions on the card (chip_smoke.py runs the full
sweep). This file imports neither jax nor the reference package, so it
runs on a card machine without JAX, without the JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Without a card every test skips.
"""

import numpy as np
import pytest
import torch

from shadow_tpu_torch.network.fluid import NetParams
from shadow_tpu_torch.ops import propagate as prop
from shadow_tpu_torch.ops import transport_kernels as tk
from shadow_tpu_torch.parallel import mesh
from shadow_tpu_torch.parallel.mesh import MeshDataPlane

SEEDS = (11, (1 << 32) + 11)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _params(h=13, g=4):
    rng = np.random.default_rng(5)
    lat = rng.integers(3_000_000, 40_000_000, (g, g)).astype(np.int64)
    np.fill_diagonal(lat, 2_000_000)
    rate = rng.integers(2_000_000, 50_000_000, h)
    rate[0] = 16_000_000_000  # MAX_RATE: the uint64 edge
    return NetParams.build(
        host_node=rng.integers(0, g, h).astype(np.int32), rate_up=rate,
        rate_down=rate, latency_ns=lat,
        reliability=np.full((g, g), 0.97, np.float32), seed=SEEDS[1],
        round_ns=2_000_000)


def _batch(rng, h, k, t_now):
    src = np.sort(rng.integers(0, h, k))
    return (src, rng.integers(0, h, k), rng.integers(60, 15000, k),
            t_now + np.sort(rng.integers(0, 2_000_000, k)),
            np.arange(k, dtype=np.int64) + (1 << 40))


@pytest.mark.cuda
def test_draw_kernels_match_plain_on_card(dev):
    rng = np.random.default_rng(7)
    for p in (256, 1024):
        x = np.zeros((4, p), np.uint32)
        x[0] = rng.integers(0, 1 << 32, p, dtype=np.uint64)
        x[1] = rng.integers(0, 1 << 26, p)
        x[2] = rng.integers(0, 12, p)
        x[3] = rng.choice(np.array([0, 1, 1 << 20, 1 << 24]), p)
        x = torch.from_numpy(x).to(dev)
        for seed in SEEDS:
            key = (seed & 0xFFFFFFFF, seed >> 32)
            assert torch.equal(prop.draw_flags(x, key, 10),
                               prop.draw_flags_plain(x, key, 10))
            x3 = x[:3].contiguous()
            assert torch.equal(prop.min_draw(x3, key, 10),
                               prop.min_draw_plain(x3, key, 10))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 8])
def test_mesh_kernels_match_plain_on_card(dev, n):
    rng = np.random.default_rng(9 + n)
    for m, w in ((256, 256), (1024, 2048)):
        u = np.zeros((6, n, m), np.int64)
        u[0] = rng.integers(0, 13, (n, m))
        u[1] = rng.integers(0, 10 ** 11, (n, m))
        u[2] = rng.integers(0, 1 << 50, (n, m))
        u[3] = rng.integers(0, 12, (n, m))
        u[4] = rng.choice(np.array([0, 9000, 1 << 24]), (n, m))
        u[5] = rng.random((n, m)) < 0.7
        x = torch.from_numpy(u).to(dev)
        w = min(w, n * m)
        for seed in SEEDS:
            got = mesh.mesh_exchange(x, seed, 10, w)
            want = mesh.exchange_rounds_plain(x, seed, 10, w)
            assert all(torch.equal(a, b) for a, b in zip(got, want))
    plane = MeshDataPlane(_params(), n_shards=n, units_per_shard=64,
                          device="cuda")
    units = plane.shard_units(*_batch(rng, 13, 60, 10 ** 9))
    for seed in SEEDS:
        got = mesh.mesh_round_step(plane.state, units, plane._tables,
                                   10 ** 9, seed, 10)
        want = mesh.round_step_plain(plane.state, units, plane._tables,
                                     10 ** 9, seed, 10)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        uk = units[None].expand(8, -1, -1, -1).contiguous()
        tk = torch.arange(1, 9, device=dev) * 10 ** 9
        got = mesh.mesh_scan(plane.state, uk, plane._tables, tk, seed, 10)
        want = mesh.scan_rounds_plain(plane.state, uk, plane._tables, tk,
                                      seed, 10)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 17, 161, 4096, 70000])
def test_ack_advance_matches_plain_on_card(dev, n):
    """The transport kernel against its plain version on the card, and the
    whole DeviceAckKernel.run round trip against the numpy host version,
    on a sweep of every branch (chip_smoke.ack_sweep)."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    cols = cs.ack_sweep(np, np.random.default_rng(n), n)
    x = torch.from_numpy(np.stack(cols)).to(dev)
    tk.reset_launches()
    got = tk.ack_advance_device(x)
    assert tk.LAUNCHES["ack_advance"] == 1
    assert torch.equal(got, torch.stack(tk.ack_advance_torch(*x.unbind(0))))
    for a, b in zip(tk.DeviceAckKernel("cuda").run(*cols),
                    tk.ack_advance(*cols)):
        assert np.array_equal(a, b)
