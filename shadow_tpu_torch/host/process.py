"""Plugin processes: Python workloads running inside the simulation.

A workload is a Python class driven by simulated callbacks, declared in
config as ``path: pyapp:<module>:<Class>``. Any other path is a real,
unmodified Linux executable run as a managed process under the preload
shim (native/managed.py); both share ``ProcessLifecycle``'s exit
accounting and expected_final_state check.

Configs are shared with the reference package, so a path into
``shadow_tpu.models`` loads the port's own copy of that model from
``shadow_tpu_torch.models`` (see plugin_module).

Plugin apps see only the ProcessAPI facade — simulated sockets, simulated
time, per-host RNG — never real OS resources, so a plugin run is fully
deterministic and policy-independent.
"""

from __future__ import annotations

import importlib
from typing import Callable, Optional

from shadow_tpu_torch.config.schema import ProcessOptions
from shadow_tpu_torch.core.time import SimTime, emulated
from shadow_tpu_torch.network.transport import DatagramSocket, StreamEndpoint


class ProcessAPI:
    """The world as a plugin app sees it."""

    def __init__(self, host, proc: "PluginProcess") -> None:
        self._host = host
        self._proc = proc

    # identity / environment
    @property
    def host_name(self) -> str:
        return self._host.name

    @property
    def host_id(self) -> int:
        return self._host.id

    @property
    def rng(self):
        return self._host.rng

    # time
    @property
    def now(self) -> SimTime:
        return self._host.now

    @property
    def wallclock_ns(self) -> int:
        return emulated(self._host.now)

    def after(self, delay_ns: SimTime, fn: Callable[[], None]) -> int:
        return self._host.schedule_in(delay_ns, fn)

    def cancel(self, handle: int) -> None:
        self._host.cancel(handle)

    # naming
    def resolve(self, name_or_ip: str) -> int:
        """Resolve a host name or IP string to a host id (simulated DNS)."""
        return self._host.controller.resolve(name_or_ip)

    # sockets
    def listen(self, port: int, on_accept: Callable[[StreamEndpoint, SimTime], None]) -> None:
        self._host.listen(port, on_accept)

    def connect(self, remote: str, port: int) -> StreamEndpoint:
        """Create a stream connection. Set callbacks on the returned endpoint,
        then call .connect() on it."""
        return self._host.connect(self._host.controller.resolve(remote), port)

    def udp_socket(self, port: Optional[int] = None) -> DatagramSocket:
        return self._host.udp_socket(port)

    # logging & lifecycle
    def log(self, msg: str) -> None:
        self._host.log(f"{self._host.now} [{self._proc.name}] {msg}")

    def exit(self, code: int = 0) -> None:
        self._proc.finish(code)


#: the reference's model namespace, as configs name it, and the port's
MODEL_PREFIX = "shadow_tpu.models."
PORT_MODEL_PREFIX = "shadow_tpu_torch.models."


def plugin_module(mod_name: str) -> str:
    """The module a pyapp path names, with the reference's model namespace
    mapped onto the port's."""
    if mod_name.startswith(MODEL_PREFIX):
        return PORT_MODEL_PREFIX + mod_name[len(MODEL_PREFIX):]
    return mod_name


class ProcessLifecycle:
    """Shared exit accounting + expected_final_state validation for both
    plugin processes and native managed processes (native/managed.py)."""

    def finish(self, code: int) -> None:
        self.running = False
        if self.exit_code is None:
            self.exit_code = code
            self.host.counters.add("processes_exited", 1)

    def check_final_state(self) -> Optional[str]:
        """Validate expected_final_state at sim end; returns an error or None."""
        exp = self.opts.expected_final_state
        if exp is None:
            return None
        if exp == "running":
            if not self.running:
                return (f"{self.host.name}/{self.name}: expected running, "
                        f"exited {self.exit_code}")
            return None
        if isinstance(exp, dict) and "exited" in exp:
            want = int(exp["exited"])
            if self.running:
                return f"{self.host.name}/{self.name}: expected exit {want}, still running"
            if self.exit_code != want:
                return (f"{self.host.name}/{self.name}: expected exit {want}, "
                        f"got {self.exit_code}")
            return None
        if isinstance(exp, dict) and "signaled" in exp:
            # managed processes record signal deaths as -signum
            want = -int(exp["signaled"])
            if self.running:
                return (f"{self.host.name}/{self.name}: expected signal "
                        f"{-want}, still running")
            if self.exit_code != want:
                return (f"{self.host.name}/{self.name}: expected signal "
                        f"{-want}, got exit code {self.exit_code}")
            return None
        return f"{self.host.name}/{self.name}: unrecognized expected_final_state {exp!r}"


class PluginProcess(ProcessLifecycle):
    """Lifecycle wrapper for one configured plugin-process instance."""

    PYAPP_PREFIX = "pyapp:"

    @classmethod
    def is_plugin_path(cls, path: str) -> bool:
        return path.startswith(cls.PYAPP_PREFIX)

    def __init__(self, host, opts: ProcessOptions, index: int) -> None:
        self.host = host
        self.opts = opts
        self.name = f"{_basename(opts.path)}.{index}"
        self.exit_code: Optional[int] = None
        self.running = False
        self.spawned = False  # ever spawned (host reboot respects start_time)
        self.app = None

    #: spec -> app class; import_module per spawn costs an import-lock
    #: round trip, which 100k same-model clients pay 100k times
    _app_classes: dict = {}

    def spawn(self) -> None:
        """The process start event (reference analog: SURVEY.md §3.2)."""
        spec = self.opts.path[len(self.PYAPP_PREFIX):]
        app_cls = self._app_classes.get(spec)
        if app_cls is None:
            try:
                mod_name, cls_name = spec.rsplit(":", 1)
            except ValueError as exc:
                raise ValueError(
                    f"bad pyapp path {self.opts.path!r} "
                    f"(want pyapp:module:Class)"
                ) from exc
            mod = importlib.import_module(plugin_module(mod_name))
            app_cls = getattr(mod, cls_name)
            self._app_classes[spec] = app_cls
        api = ProcessAPI(self.host, self)
        self.app = app_cls(api, list(self.opts.args), dict(self.opts.environment))
        self.running = True
        self.spawned = True
        self.host.counters.add("processes_spawned", 1)
        self.app.start()

    def shutdown(self) -> None:
        """The configured shutdown_time fired (graceful stop request)."""
        if self.running and self.app is not None:
            stop = getattr(self.app, "stop", None)
            if stop is not None:
                stop()
            if self.running:  # app didn't exit itself
                self.finish(0)

    def kill(self) -> None:
        """Host crash (faults.py): the process dies instantly — no stop()
        callback, no exit code (it neither exited nor was signaled in the
        simulated world). A reboot respawns a fresh instance via spawn()."""
        if self.running:
            self.running = False
            self.app = None


def _basename(path: str) -> str:
    if path.startswith(PluginProcess.PYAPP_PREFIX):
        return path.rsplit(":", 1)[-1].lower()
    return path.rsplit("/", 1)[-1]
