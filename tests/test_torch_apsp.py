"""Device APSP: the port's plain version (shadow_tpu_torch/ops/apsp.py, on
the CPU) against the reference's jitted program (shadow_tpu/ops/apsp.py,
XLA on the CPU) on the same numpy tables. Whole arrays must be equal,
tolerance 0: latency, and reliability compared as raw float32 bits,
unreachable pairs included. The CUDA kernel is held to the plain version
in tests/test_torch_cuda.py and chip_smoke.py."""

import numpy as np
import pytest
import torch
import yaml

from shadow_tpu.network.graph import INF_I64 as REF_INF_I64
from shadow_tpu.ops.apsp import apsp_device as ref_apsp
from shadow_tpu_torch.network.gml import parse_gml, parse_gml_file
from shadow_tpu_torch.network.graph import (
    INF_I32, INF_I64, _apsp_minplus, apsp_inputs)
from shadow_tpu_torch.ops import apsp


def empty(g):
    lat = np.full((g, g), INF_I64, dtype=np.int64)
    rel = np.zeros((g, g), dtype=np.float32)
    np.fill_diagonal(lat, 0)
    np.fill_diagonal(rel, 1.0)
    return lat, rel


def link(lat, rel, i, j, ns, r):
    lat[i, j] = lat[j, i] = ns
    rel[i, j] = rel[j, i] = np.float32(r)


def random_graph(g, rng, p_edge=0.3, max_lat_ms=80):
    lat, rel = empty(g)
    for i in range(g):
        for j in range(i + 1, g):
            if rng.random() < p_edge:
                link(lat, rel, i, j,
                     int(rng.integers(1_000_000, max_lat_ms * 1_000_000)),
                     1.0 - rng.random() * 0.05)
    return lat, rel


def assert_same(lat, rel):
    """Port (plain, CPU) == reference (XLA, CPU), whole arrays."""
    assert INF_I64 == REF_INF_I64
    r_lat, r_rel = ref_apsp(lat.copy(), rel.copy())
    p_lat, p_rel = apsp.apsp_device(lat.copy(), rel.copy(), device="cpu")
    assert p_lat.dtype == np.int64 and p_rel.dtype == np.float32
    np.testing.assert_array_equal(p_lat, r_lat)
    np.testing.assert_array_equal(p_rel.view(np.int32), r_rel.view(np.int32))
    return p_lat, p_rel


@pytest.mark.parametrize("g", [1, 2, 3, 7, 16, 17, 40, 64])
def test_random_graphs_equal_reference(g):
    assert_same(*random_graph(g, np.random.default_rng(100 + g)))


def _topology(name):
    if name == "tornet400":
        return parse_gml_file("examples/topology_tornet400.gml")
    cfg = yaml.safe_load(open(f"examples/{name}.yaml"))
    return parse_gml(cfg["network"]["graph"]["inline"])


@pytest.mark.parametrize("name,g", [("tornet400", 30), ("tor_1m", 64),
                                    ("tgen_1k", 32)])
def test_real_topologies_equal_reference(name, g):
    lat, rel = apsp_inputs(_topology(name))
    assert lat.shape == (g, g)
    p_lat, _ = assert_same(lat, rel)
    # and the routing table graph.py builds with numpy, off the diagonal
    n_lat, _ = _apsp_minplus(lat.copy(), rel.copy())
    np.testing.assert_array_equal(p_lat, n_lat)


@pytest.mark.parametrize("g", [2, 5, 16, 33])
def test_unit_latency_ring_ties(g):
    lat, rel = empty(g)
    rng = np.random.default_rng(g)
    for i in range(g):
        link(lat, rel, i, (i + 1) % g, 1, rng.choice([1.0, 0.5, 0.99]))
    assert_same(lat, rel)


@pytest.mark.parametrize("rows,cols", [(4, 4), (5, 7), (8, 8)])
def test_unit_latency_grid_ties(rows, cols):
    g = rows * cols
    lat, rel = empty(g)
    rng = np.random.default_rng(g)
    for r in range(rows):
        for c in range(cols):
            i = r * cols + c
            if c + 1 < cols:
                link(lat, rel, i, i + 1, 1, 1.0 - 0.01 * rng.integers(0, 4))
            if r + 1 < rows:
                link(lat, rel, i, i + cols, 1, 1.0 - 0.01 * rng.integers(0, 4))
    assert_same(lat, rel)


def test_disconnected_components():
    rng = np.random.default_rng(9)
    lat, rel = random_graph(10, rng, p_edge=0.6)
    # sever node 9 entirely, and split 0-3 from the rest
    lat[9, :] = lat[:, 9] = INF_I64
    rel[9, :] = rel[:, 9] = 0.0
    lat[9, 9], rel[9, 9] = 0, 1.0
    for i in range(4):
        for j in range(4, 10):
            lat[i, j] = lat[j, i] = INF_I64
            rel[i, j] = rel[j, i] = 0.0
    p_lat, _ = assert_same(lat, rel)
    assert (p_lat[:4, 4:] == INF_I64).all() and (p_lat[9, :9] == INF_I64).all()


def test_chain_of_24_hops():
    g = 24
    lat, rel = empty(g)
    for i in range(g - 1):
        link(lat, rel, i, i + 1, 1_000_000 * (i + 1), 0.99)
    p_lat, _ = assert_same(lat, rel)
    assert p_lat[0, g - 1] == sum(1_000_000 * (i + 1) for i in range(g - 1))


def test_subnormal_products():
    """Products below 2**-126, operands below it, and the rounding edge
    where a product just below 2**-126 rounds up to it: flushed exactly as
    the reference's XLA program flushes them."""
    vals = [1e-20, 1e-30, 2.0 ** -63, 2.0 ** -64, 1 - 2.0 ** -23,
            2.0 ** -126 * (1 + 2.0 ** -23), 2.0 ** -126, 1e-40, 0.5, 1.0]
    rng = np.random.default_rng(3)
    lat, rel = empty(40)
    for i in range(40):
        for j in range(i + 1, 40):
            if rng.random() < 0.25:
                link(lat, rel, i, j, int(rng.integers(1, 4)),
                     vals[rng.integers(0, len(vals))])
    _, p_rel = assert_same(lat, rel)
    assert (p_rel == 0).any()
    # the direct products on the edge cases
    a = torch.tensor([1 - 2.0 ** -23, 1 - 2.0 ** -24, 1.0, 1e-20],
                     dtype=torch.float32)
    b = torch.tensor([2.0 ** -126 * (1 + 2.0 ** -23), 2.0 ** -126, 1e-40,
                      1e-20], dtype=torch.float32)
    assert apsp._ftz_mul(a, b).view(torch.int32).tolist() == [
        0x00800000, 0, 0, 0]


def test_edge_at_inf_i32_raises():
    lat, rel = empty(3)
    link(lat, rel, 0, 1, int(INF_I32), 1.0)
    with pytest.raises(ValueError, match="device APSP unsupported"):
        apsp.apsp_device(lat, rel, device="cpu")
    with pytest.raises(ValueError, match="device APSP unsupported"):
        ref_apsp(lat, rel)
    link(lat, rel, 0, 1, int(INF_I32) - 1, 1.0)
    assert_same(lat, rel)


def test_reachable_pairs_equal_numpy_minplus():
    """As tests/test_apsp_device.py holds the reference: exact agreement
    with graph.py's numpy solver on reachable pairs."""
    rng = np.random.default_rng(5)
    for g in (3, 7, 17, 40):
        lat, rel = random_graph(g, rng)
        n_lat, n_rel = _apsp_minplus(lat.copy(), rel.copy())
        p_lat, p_rel = apsp.apsp_device(lat, rel, device="cpu")
        reach = n_lat < INF_I64
        np.testing.assert_array_equal(p_lat < INF_I64, reach)
        np.testing.assert_array_equal(p_lat[reach], n_lat[reach])
        np.testing.assert_array_equal(p_rel[reach], n_rel[reach])


def test_blocking_and_steps_do_not_change_results():
    lat, rel = random_graph(23, np.random.default_rng(8), p_edge=0.2)
    a = apsp.apsp_device(lat, rel, block=16, device="cpu")
    b = apsp.apsp_device(lat, rel, block=5, device="cpu")
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1].view(np.int32), b[1].view(np.int32))
    assert apsp.squaring_steps(1) == 1 and apsp.squaring_steps(17) == 5


def test_wrapper_refuses_bad_inputs():
    lat = torch.zeros((4, 4), dtype=torch.int32)
    rel = torch.ones((4, 4), dtype=torch.float32)
    with pytest.raises(TypeError):
        apsp.squarings(lat.long(), rel, 1)
    with pytest.raises(ValueError):
        apsp.squarings(lat[:3], rel, 1)
    with pytest.raises(ValueError):
        apsp.squarings(lat.t(), rel.t(), 1)
    before = dict(apsp.LAUNCHES)
    apsp.squarings(lat, rel, 2)  # CPU: the plain version, no launch
    assert apsp.LAUNCHES == before
