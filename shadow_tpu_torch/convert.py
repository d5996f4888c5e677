"""Carry simulation state across from the reference package.

In this simulator the state that plays the part of a model's weights is the
network parameter set (``NetParams``): host placement, NIC rates and bucket
capacities, the (G, G) latency table and the q24 drop thresholds every loss
draw compares against. ``net_params_from_arrays`` builds the port's
``NetParams`` from those fields given as plain numpy arrays — e.g. the
fields of a ``shadow_tpu.network.fluid.NetParams`` — so the tests can feed
both packages the same state without this package importing the reference.

``mesh_state_from_arrays`` carries the other state of the mesh data plane,
its sharded egress bucket state (``t_base``, ``tokens``, ``debt``, each
(N, Hs): row i = shard i's hosts), into the port's plane
(``parallel.mesh.MeshDataPlane.set_state``), so two planes can start from
the same state mid-run.

``transport_columns_from_arrays`` carries the device transport's state:
a column snapshot of every stream endpoint (``hid``, ``local_port``,
``remote_host``, ``remote_port`` and the transport columns of
``network.devtransport.COLUMNS``, each (n,) int64), as the reference's
``shadow_tpu.network.devtransport.export_columns`` writes it, into the
port's snapshot, which ``network.devtransport.adopt_columns`` writes back
into live endpoints; ``transport_columns_to_arrays`` is the way back.

``telemetry_state_from_arrays`` carries the telemetry collector's state
(its sample and flow counters, the per-flow-kind latency histograms and
outcome counts), as the reference collector's ``export_merge_state``
writes it, into the port's collector, so two collectors can continue from
the same state and be compared on what they write.
"""

from __future__ import annotations

import numpy as np
import torch

from shadow_tpu_torch.core.time import SimTime
from shadow_tpu_torch.network.fluid import MAX_UNIT, NetParams

#: the NetParams array fields carried across
FIELDS = ("host_node", "rate_up", "rate_down", "cap_up", "cap_down",
          "latency_ns", "drop_thresh")


def net_params_from_arrays(d: dict, seed: int, round_ns: SimTime,
                           max_unit: int = MAX_UNIT) -> NetParams:
    """The port's NetParams from ``d``, a dict of numpy arrays named as
    NetParams' fields (``host_node``, ``rate_up``, ``rate_down``,
    ``cap_up``, ``cap_down``, ``latency_ns``, ``drop_thresh``).

    The rates go through the port's own validation and capacity rule
    (``NetParams.build`` with ``round_ns`` and ``max_unit``); the given
    capacities must equal what that rule derives, or the arrays came from
    another configuration and ValueError is raised. The thresholds are
    taken as given: they are already quantized (q24), and re-deriving them
    from a reliability matrix could only lose bits."""
    missing = sorted(set(FIELDS) - set(d))
    if missing:
        raise ValueError(f"net_params_from_arrays: missing fields {missing}")
    a = {k: np.asarray(d[k]) for k in FIELDS}
    for k in FIELDS:
        if not np.issubdtype(a[k].dtype, np.integer):
            raise ValueError(f"net_params_from_arrays: {k} must be an "
                             f"integer array, got {a[k].dtype}")
    h = a["host_node"].shape
    g = a["latency_ns"].shape
    if len(h) != 1 or any(a[k].shape != h for k in (
            "rate_up", "rate_down", "cap_up", "cap_down")):
        raise ValueError("net_params_from_arrays: per-host arrays must all "
                         "be (H,)")
    if len(g) != 2 or g[0] != g[1] or a["drop_thresh"].shape != g:
        raise ValueError("net_params_from_arrays: latency_ns and drop_thresh "
                         "must both be (G, G)")
    if (a["drop_thresh"] > (1 << 24)).any():
        raise ValueError("net_params_from_arrays: drop_thresh exceeds q24")
    built = NetParams.build(
        host_node=a["host_node"], rate_up=a["rate_up"],
        rate_down=a["rate_down"], latency_ns=a["latency_ns"],
        reliability=np.ones(g, dtype=np.float32), seed=seed,
        round_ns=round_ns, max_unit=max_unit)
    for k in ("cap_up", "cap_down"):
        if not np.array_equal(getattr(built, k), a[k]):
            raise ValueError(
                f"net_params_from_arrays: {k} does not follow from the "
                f"rates at round_ns={round_ns}, max_unit={max_unit}")
    built.drop_thresh = a["drop_thresh"].astype(np.uint32)
    return built


def mesh_state_from_arrays(t_base, tokens, debt) -> torch.Tensor:
    """The (3, N, Hs) int64 bucket state [t_base, tokens, debt] of a mesh
    plane from three (N, Hs) integer arrays (numpy, or anything
    ``np.asarray`` reads, such as a reference plane's sharded arrays)."""
    a = [np.asarray(x) for x in (t_base, tokens, debt)]
    for name, x in zip(("t_base", "tokens", "debt"), a):
        if not np.issubdtype(x.dtype, np.integer):
            raise ValueError(f"mesh_state_from_arrays: {name} must be an "
                             f"integer array, got {x.dtype}")
        if x.ndim != 2 or x.shape != a[0].shape:
            raise ValueError("mesh_state_from_arrays: t_base, tokens and "
                             "debt must all be (N, Hs)")
    return torch.from_numpy(np.stack(a).astype(np.int64))


def transport_columns_from_arrays(d: dict) -> dict:
    """The port's endpoint column snapshot from ``d``, a dict of integer
    arrays named as ``network.devtransport.KEY_COLUMNS + COLUMNS`` (for
    example the reference's ``export_columns``): every column present,
    1-D and of one length; returned as int64 copies in canonical order.
    Raises ValueError on a missing, extra, non-integer or ragged
    column."""
    from shadow_tpu_torch.network.devtransport import COLUMNS, KEY_COLUMNS

    names = KEY_COLUMNS + COLUMNS
    missing = [k for k in names if k not in d]
    extra = sorted(set(d) - set(names))
    if missing or extra:
        raise ValueError(f"transport_columns_from_arrays: missing columns "
                         f"{missing}, unknown columns {extra}")
    out = {}
    for k in names:
        a = np.asarray(d[k])
        if not np.issubdtype(a.dtype, np.integer) or a.ndim != 1:
            raise ValueError(f"transport_columns_from_arrays: {k} must be "
                             f"a 1-D integer array, got {a.dtype} "
                             f"{a.shape}")
        out[k] = a.astype(np.int64)
    if len({len(a) for a in out.values()}) != 1:
        raise ValueError("transport_columns_from_arrays: columns differ "
                         "in length")
    return out


def transport_columns_to_arrays(cols: dict) -> dict:
    """A port snapshot (``export_columns``) as plain numpy int64 arrays
    under the reference's column names, in its order."""
    return transport_columns_from_arrays(cols)


#: the collector state carried across: its sample and flow counters, the
#: per-kind latency histograms and the per-kind outcome counts
TELEMETRY_FIELDS = ("samples", "flows_written", "hist", "flow_counts")


def _int(x, what: str) -> int:
    if isinstance(x, bool) or not isinstance(x, (int, np.integer)):
        raise ValueError(f"telemetry_state_from_arrays: {what} must be an "
                         f"integer, got {type(x).__name__}")
    return int(x)


def telemetry_state_from_arrays(d: dict) -> dict:
    """The port's telemetry collector state from ``d``, the reference
    collector's exported state (``export_merge_state``): ``samples`` and
    ``flows_written`` (integers), ``hist`` (flow kind -> a
    ``LogHistogram.state()`` dict: ``total`` and ``counts``, bucket index
    -> count, indices as strings or integers) and ``flow_counts`` (flow
    kind -> ``ok``, ``failed`` and, for kinds that carry a model metric,
    ``x_sum`` and ``x_n``); Python or numpy integers. Optional:
    ``next_sample``, the sim time of the next sample. Returns the same
    fields as the port holds them (histograms as ``LogHistogram``),
    which ``TelemetryCollector.adopt_merge_state`` installs. Raises
    ValueError on a missing or unknown field, a non-integer value, a
    negative count or a histogram whose total is not the sum of its
    buckets."""
    from shadow_tpu_torch.telemetry.histogram import LogHistogram

    missing = [k for k in TELEMETRY_FIELDS if k not in d]
    extra = sorted(set(d) - set(TELEMETRY_FIELDS) - {"next_sample"})
    if missing or extra:
        raise ValueError(f"telemetry_state_from_arrays: missing fields "
                         f"{missing}, unknown fields {extra}")
    out = {k: _int(d[k], k) for k in ("samples", "flows_written")}
    if "next_sample" in d:
        out["next_sample"] = _int(d["next_sample"], "next_sample")
    hist = {}
    for kind, st in d["hist"].items():
        counts = {_int(int(i) if isinstance(i, str) else i,
                       f"hist[{kind!r}] bucket"):
                  _int(n, f"hist[{kind!r}] count")
                  for i, n in st["counts"].items()}
        total = _int(st["total"], f"hist[{kind!r}] total")
        if min(counts.values(), default=0) < 0 or min(counts, default=0) < 0:
            raise ValueError(f"telemetry_state_from_arrays: hist[{kind!r}] "
                             f"holds a negative bucket or count")
        if total != sum(counts.values()):
            raise ValueError(f"telemetry_state_from_arrays: hist[{kind!r}] "
                             f"total {total} is not the sum of its buckets")
        h = LogHistogram()
        h.total = total
        h.counts = {i: counts[i] for i in sorted(counts)}
        hist[str(kind)] = h
    out["hist"] = hist
    flow_counts = {}
    for kind, c in d["flow_counts"].items():
        row = {k: _int(v, f"flow_counts[{kind!r}][{k!r}]")
               for k, v in c.items()}
        if not {"ok", "failed"} <= set(row) or not set(row) <= {
                "ok", "failed", "x_sum", "x_n"}:
            raise ValueError(f"telemetry_state_from_arrays: flow_counts"
                             f"[{kind!r}] must hold ok and failed (and "
                             f"x_sum, x_n), got {sorted(row)}")
        flow_counts[str(kind)] = row
    out["flow_counts"] = flow_counts
    for k in ("samples", "flows_written"):
        if out[k] < 0:
            raise ValueError(f"telemetry_state_from_arrays: {k} < 0")
    return out
