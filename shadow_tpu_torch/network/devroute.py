"""Shared device-routing machinery for the two data planes.

The port of shadow_tpu/network/devroute.py. Both the per-unit plane
(network/engine.py, behind the thread policies) and the columnar plane
(network/colplane.py, behind tpu_batch and tpu_mesh) route loss-draw
batches either to the numpy twin (fluid.loss_flags) or to the CUDA
kernels (ops/propagate.py) — the paths are bit-identical, so routing is
pure wall-clock policy. The thread policies run backend numpy, which
attaches no device: every batch takes the twin. Under
``scheduler_policy: tpu_mesh`` the columnar plane builds the mesh data
plane instead (parallel/mesh.py; ``mesh_plane``). This base class
carries what that routing needs:

- background device attach + floor calibration (simulations start on the
  numpy twin and switch over when the device publishes); a failed attach
  raises on the simulation thread — on a CUDA device a failed build or
  launch is an error, never a silent fall back to the twin,
- the adaptive floor: realized readback stalls are compared against what
  the numpy twin would have cost; the floor backs off x4 when the device
  is clearly losing and decays back toward the calibrated floor when it
  stops (a starved floor also decays on a round-count cooldown). An
  explicit tpu_device_floor never moves, unlike the reference's, so that
  the windows such a run dispatches do not depend on how long its reads
  took,
- fused multi-round device windows: draw batches accumulate lazily across
  rounds and dispatch as ONE device launch per causal window instead of
  one per round, with a two-slot in-flight pipeline (deferred readbacks
  overlap subsequent host rounds) and a live break-even estimate from
  window telemetry deciding when the device is worth engaging at all.
  Windows below the floor, and windows that find both slots busy, resolve
  on the host twin: that is the reference's determinism-safe routing, and
  the run summary counts the windows the device served,
- fleet members (fleet.py): with the sweep's shared draw service named in
  ``SHADOW_TPU_DRAW_SERVICE``, auto mode connects a ``FleetDrawClient``
  to the parent's one attach instead of attaching the card; a service
  that cannot be reached raises, as a failed attach does,
- teardown safety (close() joins the attach thread and releases a fleet
  proxy),
- the latency/deferred/outstanding accessors the controller polls.
"""

from __future__ import annotations

import os

from shadow_tpu_torch.core.time import SimTime, T_NEVER
from shadow_tpu_torch.ops.devcfg import DrawServiceError

#: deferred windows in flight at once (double-buffered handles): window
#: N's device execution overlaps the build of window N+1; a third window
#: waits (stays lazy) rather than queueing unbounded device memory
WINDOW_SLOTS = 2
#: EMA weight for the per-window fixed-cost estimate (dispatch + stall)
_BE_ALPHA = 0.25
#: hysteresis around the break-even unit count: engage above 1.25x,
#: release below 0.8x — so a window size hovering at break-even does not
#: flap the routing decision every window
_BE_ENGAGE = 1.25
_BE_RELEASE = 0.8
#: a fleet member's draw-service address (the reference's name)
SERVICE_ENV = "SHADOW_TPU_DRAW_SERVICE"


class DeviceRoutedPlane:
    """Mixin state + helpers; subclasses populate graph/params/_deferred/
    outstanding and call _init_device_routing() from __init__."""

    def _init_device_routing(self, backend: str, tpu_options, params,
                             device: str = "cuda") -> None:
        self.max_batch = int(
            getattr(tpu_options, "tpu_max_batch", 65536) or 65536)
        self.max_pkts = int(getattr(tpu_options, "unit_mtus", 10) or 10)
        self.device = None
        self.device_floor = float("inf")
        self._dev_stall = 0.0
        self._dev_reads = 0
        self._dev_units = 0
        self._dev_warm = False  # first read (attach) is excluded
        self._floor_cooldown = 0  # rounds until a starved floor decays
        self._np_per_unit = 4e-6  # refined by calibration when available
        self._floor0 = float("inf")  # calibrated floor: decay lower bound
        self._floor_forced = False  # explicit tpu_device_floor > 0: the
        #                             operator owns routing; break-even
        #                             estimation and probe clamping yield
        #: fused-window state (experimental.device_window_rounds; 0 = auto)
        self.window_rounds = int(
            getattr(tpu_options, "device_window_rounds", 0) or 0)
        self._win_open_rounds = 0  # barriers since the window opened
        self._win_inflight = 0  # dispatched windows not yet fully read
        self._win_engaged = False  # hysteresis state of the flush gate
        self._win_cost_ema = 0.0  # seconds of host wall per window
        self.dev_windows = 0  # fused windows dispatched to the device
        self.dev_window_units = 0  # units those windows carried
        self.spec_hits = 0  # C-plane speculative-window consults served
        self.spec_draws = 0  # C-plane inline draws (speculation missed)
        self._max_window_units = 0  # biggest window this run has seen
        self._probe_clamped = False  # probing suppressed
        #: speculative forward windows (C plane only; colplane drives)
        self._spec_on = False
        self._spec_checked = False
        self._spec_clamped = False  # live economics turned speculation off
        self._spec_pending = []
        self._spec_round = 0
        self._spec_spend = 0.0  # wall seconds speculation itself cost
        self._spec_units = 0  # rows speculation itself dispatched
        self._bg_thread = None
        self._bg_error = None  # a failed attach, re-raised on the sim thread
        self._svc_addr = None  # the fleet draw service this plane uses
        self._svc_abort = False
        self.mesh_plane = None
        if backend == "mesh":
            self._init_mesh(tpu_options, params, device)
        if backend != "tpu":
            return  # the mesh and thread policies dispatch no draw window
        #: draw batches split over this many device entries (0 = all)
        self._draw_shards = int(
            getattr(tpu_options, "tpu_mesh_shards", 0) or 0)
        floor = int(getattr(tpu_options, "tpu_device_floor", 0) or 0)
        if floor < 0:
            # device draws disabled: the numpy twin serves every batch
            # (the ablation row — results are bit-identical by
            # construction, only wall time moves)
            return
        if floor > 0:
            from shadow_tpu_torch.ops.propagate import DeviceDrawPlane

            self.device = DeviceDrawPlane(params.seed, self.max_batch,
                                          max_pkts=self.max_pkts,
                                          device=device,
                                          n_shards=self._draw_shards)
            self.device_floor = floor
            self._floor_forced = True
            return
        svc = os.environ.get(SERVICE_ENV)
        if svc:
            # fleet member (fleet.py): route the draw windows to the fleet
            # parent's ONE shared attach instead of attaching the card.
            # The proxy connects on the background thread (the parent's
            # attach may still be warming) and publishes like a device
            # plane; the run draws on the host twin until it does, as
            # before any background attach publishes
            import threading

            self._svc_addr = svc
            self._bg_thread = threading.Thread(
                target=self._bg_connect_service, args=(svc, params.seed),
                daemon=True)
            self._bg_thread.start()
            return
        # auto mode: kernel build/load, warm-up and floor calibration run
        # on a background thread — except when a previous run of this
        # process already attached this parameter tuple, in which case the
        # cached plane (and its calibration) publishes SYNCHRONOUSLY so the
        # device is live from round 0. Probe the cache via sys.modules so a
        # cold process does not import torch's CUDA state on the main
        # thread just to find an empty cache. Both paths are bit-identical
        # and event order is canonical, so WHEN the device comes online
        # cannot affect results — only wall time.
        import sys

        mod = sys.modules.get("shadow_tpu_torch.ops.propagate")
        key = (int(params.seed), self.max_batch, self.max_pkts, device,
               self._draw_shards)
        hit = (mod.DeviceDrawPlane._cache.get(key)
               if mod is not None else None)
        if hit is not None:
            self._publish_device(*hit)
        else:
            import threading

            self._bg_thread = threading.Thread(
                target=self._bg_init_device, args=(params.seed, device),
                daemon=True)
            self._bg_thread.start()

    def _init_mesh(self, tpu_options, params, device: str) -> None:
        """scheduler_policy: tpu_mesh — each causal window's loss draws,
        arrival exchange and lookahead minimum run as one sharded program
        (parallel/mesh.py), hosts sharded over N shards, one a device entry
        of ``device`` (devcfg.select_devices): N = tpu_mesh_shards or every
        entry, and more shards than entries are refused, as the reference
        refuses more shards than devices. One entry holds its one shard in
        the one-device layout. Bit-identical to the host planes, so the
        policy cannot change results."""
        from shadow_tpu_torch.ops import devcfg
        from shadow_tpu_torch.parallel.mesh import MeshDataPlane

        entries = devcfg.select_devices(device)
        n_shards = int(getattr(tpu_options, "tpu_mesh_shards", 0) or 0)
        if n_shards > len(entries):
            raise ValueError(
                f"config error: experimental.tpu_mesh_shards={n_shards} "
                f"exceeds the {len(entries)} device "
                f"entr{'y' if len(entries) == 1 else 'ies'} of --device "
                f"{device} (tpu_mesh puts one shard on each entry; name "
                f"more, e.g. --device {','.join([str(entries[0])] * n_shards)})")
        n = n_shards or len(entries)
        # per-shard slot width of the standalone round API: tracks
        # realistic per-barrier chunk sizes, not max_batch
        ups = max(256, min(2048, 4096 // n))
        self.mesh_plane = MeshDataPlane(
            params, n_shards=n, units_per_shard=ups,
            devices=entries if n > 1 else None, max_pkts=self.max_pkts,
            device=device)

    def _publish_device(self, plane, dev_s: float,
                        np_per_unit: float) -> None:
        if np_per_unit > 0:
            self._np_per_unit = np_per_unit
            self.device_floor = max(512, min(
                int(dev_s / np_per_unit), self.max_batch))
            self._floor0 = self.device_floor
        self.device = plane  # publish last (reads are GIL-atomic)

    def _bg_init_device(self, seed: int, device: str) -> None:
        try:
            from shadow_tpu_torch.ops.propagate import DeviceDrawPlane

            self._publish_device(*DeviceDrawPlane.attach_cached(
                seed, self.max_batch, self.max_pkts, device,
                n_shards=self._draw_shards))
        except BaseException as exc:  # noqa: BLE001 — re-raised below
            self._bg_error = exc

    def _bg_connect_service(self, address: str, seed: int) -> None:
        """Fleet member: connect to the parent's shared draw service and
        publish the proxy as this run's device plane. A service that
        cannot be reached, or refuses with its attach's error, fails the
        run (raise_attach_error): the reference degrades to a local attach
        and then to the host twin here, the port never does. A run that
        ends while the reached service is still attaching drew on the host
        twin throughout, as a standalone run that ends before its
        background attach publishes."""
        try:
            from shadow_tpu_torch.fleet import FleetDrawClient

            proxy = FleetDrawClient.connect(
                address, seed, self.max_batch, self.max_pkts,
                abort=lambda: self._svc_abort)
        except BaseException as exc:  # noqa: BLE001 — re-raised below
            self._bg_error = (exc if isinstance(exc, DrawServiceError)
                              else DrawServiceError(
                                  f"fleet draw service at {address!r}: "
                                  f"{exc!r}"))
            return
        if proxy is not None:
            self._publish_device(proxy, proxy.dev_s, proxy.np_per_unit)

    def raise_attach_error(self) -> None:
        """Re-raise a failed background attach (or fleet draw-service
        connect, by its own name) on the calling thread."""
        exc = self._bg_error
        if exc is not None:
            self._bg_error = None
            if isinstance(exc, DrawServiceError):
                raise exc
            raise RuntimeError(f"device attach failed: {exc}") from exc

    def close(self) -> None:
        """Join the background device-attach threads (the draw plane's and
        the device transport's, if any), release a fleet draw-service
        proxy, drop the C engine (its counters were folded by flush_all)
        and raise the error an attach hit. A service connect still
        waiting on the parent's attach is aborted, not waited out."""
        self._svc_abort = True
        t = self._bg_thread
        if t is not None and t.is_alive():
            t.join()
        devt = getattr(self, "devt", None)
        if devt is not None:
            devt.close()
        d = self.device
        if d is not None and hasattr(d, "close_client"):
            d.close_client()
        self._c = None
        self._spec_pending = []
        self.raise_attach_error()

    # -- checkpoint/restore (checkpoint.py) ---------------------------------
    #: what lives on the card, in page-locked memory or on a thread: the
    #: draw plane (its DrawSlots and in-flight handles), the mesh plane
    #: (its ExchangeStages), the attach thread and its error, the C
    #: engine, the speculative min_draw waves and the device transport
    #: (its AckSlots). All are rebuilt by reattach_device and the
    #: controller's _reattach_runtime, and all are result-transparent:
    #: routing is wall-clock policy.
    _RUNTIME_KEYS = ("device", "mesh_plane", "_bg_thread", "_bg_error",
                     "_c", "_spec_pending", "devt")

    def __getstate__(self):
        d = self.__dict__.copy()
        for k in self._RUNTIME_KEYS:
            d.pop(k, None)
        # flush_all resolved every window before the state walk
        d["_win_inflight"] = 0
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        self.device = None
        self.mesh_plane = None
        self._bg_thread = None
        self._bg_error = None
        self._c = None
        self._spec_pending = []
        # speculation starts cold: the waves are a cache of a pure
        # function, never simulation state
        self._spec_on = False
        self._spec_checked = False
        self._spec_clamped = False
        self.devt = None  # reattached by Controller._reattach_runtime

    def reattach_device(self, tpu_options, device: str = "cuda") -> None:
        """Restore-time twin of __init__'s device hookup, on the resume
        invocation's device: re-runs attach, calibration and floor state
        from scratch. Calibration state is not carried across a resume —
        the adaptive floor cannot change results, only wall time."""
        self._init_device_routing(self.backend, tpu_options, self.params,
                                  device)

    # -- adaptive floor + window break-even ---------------------------------
    def break_even_units(self) -> int:
        """Units at which one fused window dispatch beats the host twin,
        from live telemetry: the EMA'd per-window host cost (dispatch wall
        + readback stall) divided by the calibrated per-unit host cost.
        Before the first window lands, fall back to the calibrated floor
        (same quantity measured at attach time)."""
        if self._win_cost_ema > 0.0 and self._np_per_unit > 0.0:
            return max(256, int(self._win_cost_ema / self._np_per_unit))
        return int(self._floor0) if self._floor0 != float("inf") else 4096

    def window_gate_units(self, engaged: bool) -> float:
        """The unit count a deferred window must reach to route to the
        device. An explicitly forced tpu_device_floor IS the gate (the
        operator owns routing — tests and A/B runs rely on it); otherwise
        the live break-even estimate applies with hysteresis: 1.25x to
        engage, and a currently-engaged window releases only below 0.8x,
        so a size hovering at break-even does not flap the decision."""
        if self._floor_forced:
            return self.device_floor
        return max(self.device_floor,
                   (_BE_RELEASE if engaged else _BE_ENGAGE)
                   * self.break_even_units())

    def _record_window(self, n_units: int, host_cost: float) -> None:
        """One fused window landed: fold its realized host-side cost
        (dispatch wall + any readback stall) into the break-even EMA and
        the run counters."""
        self.dev_windows += 1
        self.dev_window_units += n_units
        if not self._dev_warm:
            self._dev_warm = True  # compile/attach window: not signal
            return
        if self._win_cost_ema == 0.0:
            self._win_cost_ema = host_cost
        else:
            self._win_cost_ema += _BE_ALPHA * (host_cost - self._win_cost_ema)

    def _note_window_units(self, n_units: int) -> None:
        """Track the biggest causal window this config has produced and
        clamp device probing when the config provably cannot reach
        break-even : if even the largest window
        is under 25% of break-even, re-probing the device on a cadence
        only burns dispatches — stop until the traffic shape changes."""
        if self._floor_forced:
            if n_units > self._max_window_units:
                self._max_window_units = n_units
            return
        if n_units > self._max_window_units:
            self._max_window_units = n_units
            if self._probe_clamped and \
                    n_units >= 0.25 * self.break_even_units():
                self._probe_clamped = False
        elif (not self._probe_clamped
              and self._max_window_units > 0
              and self._dev_warm
              and self._max_window_units < 0.25 * self.break_even_units()):
            self._probe_clamped = True

    def _floor_cooldown_tick(self) -> None:
        """Called on barriers that did NOT use the device: a backed-off
        floor must be able to recover even when it now starves the device
        entirely (no reads -> no stall windows). When probing is clamped
        (the config's windows cannot reach break-even) the decay pauses:
        recovering the floor would only re-probe a device that provably
        loses at this config's window sizes. A forced floor never
        moves (see _floor_settle)."""
        if self._probe_clamped or self._floor_forced:
            return
        if self.device_floor > self._floor0 and self._floor_cooldown > 0:
            self._floor_cooldown -= 1
            if self._floor_cooldown == 0:
                self.device_floor = max(self._floor0, self.device_floor // 4)
                self._floor_cooldown = 512
                self._dev_stall = 0.0
                self._dev_reads = 0
                self._dev_units = 0

    def _record_dev_read(self, dt: float, n_units: int) -> None:
        if not self._dev_warm:
            self._dev_warm = True  # compile/attach stall: not signal
        else:
            self._dev_stall += dt
            self._dev_reads += 1
            self._dev_units += n_units

    def _floor_settle(self) -> None:
        """Every 8 realized device reads, compare stalls against what the
        numpy twin would have cost for the same units: back off only when
        the device is clearly LOSING, decay back toward the live
        break-even estimate (never below the calibrated floor) when it
        stops (results are identical either way).

        An explicitly forced tpu_device_floor never moves: the operator
        owns routing, so the windows such a run dispatches are a function
        of the run alone and not of how long its reads took (the reference
        backs a forced floor off too, so under load its count varies)."""
        if self._floor_forced:
            return
        if self._dev_reads < 8:
            return
        np_cost = self._np_per_unit * self._dev_units
        lo = max(self._floor0, float(self.break_even_units()))
        if self._dev_stall > 4 * np_cost + 0.02:
            self.device_floor = min(self.device_floor * 4, 1 << 30)
            self._floor_cooldown = 512
        elif self._dev_stall < np_cost and self.device_floor > lo:
            self.device_floor = max(lo, self.device_floor // 4)
        self._dev_stall = 0.0
        self._dev_reads = 0
        self._dev_units = 0

    def device_summary(self) -> dict:
        """Window/speculation telemetry for the run summary (wall-clock
        routing state — volatile across runs, never simulation state)."""
        return {
            "windows_dispatched": self.dev_windows,
            "window_units": self.dev_window_units,
            "spec_hits": self.spec_hits,
            "spec_draws": self.spec_draws,
            "break_even_units": self.break_even_units(),
            "max_window_units": self._max_window_units,
            "probe_clamped": self._probe_clamped,
            "spec_clamped": self._spec_clamped,
            "window_rounds": self.window_rounds or "auto",
        }

    def heartbeat_note(self) -> str:
        """One heartbeat-line fragment describing the routing decision."""
        if self.device is None and self.mesh_plane is None:
            return "dev=off"
        state = "clamped" if self._probe_clamped else (
            "engaged" if self.dev_windows else "probing")
        if self._spec_clamped:
            state += "+spec_clamped"
        elif self.spec_hits:
            state += "+spec"
        return (f"dev={state} windows={self.dev_windows} "
                f"be={self.break_even_units()} "
                f"maxwin={self._max_window_units}")

    # -- telemetry (telemetry/) --------------------------------------------
    def telemetry_sample(self, t_now: SimTime) -> dict:
        """Engine-side half of one telemetry sample: run-global counters
        plus the per-host NIC token-bucket levels, all plane-independent
        (capped egress availability via fluid.TokenBuckets.levels; the
        round-quantized ingress tokens are shared state — the C engine
        mutates the same numpy array). Caller flushes in-flight draws
        first so every plane sits at the same resolution frontier."""
        return {
            "units_sent": self.units_sent,
            "units_dropped": self.units_dropped,
            "units_blackholed": self.units_blackholed,
            "bytes_sent": self.bytes_sent,
            "bucket_up": self.buckets.levels(t_now).tolist(),
            "tokens_down": self.tokens_down.tolist(),
        }

    # -- accessors shared by the controller --------------------------------
    def latency_between(self, src_host: int, dst_host: int) -> SimTime:
        p = self.params
        return int(self.graph.latency_ns[p.host_node[src_host],
                                         p.host_node[dst_host]])

    def has_immediate_work(self) -> bool:
        """True if the next round must run even with empty event queues
        (deferred ingress backlog waiting on token refill)."""
        return bool(self._deferred)

    def earliest_outstanding(self) -> SimTime:
        """Earliest event time any in-flight draw batch can produce."""
        return min((b.deadline for b in self.outstanding), default=T_NEVER)
