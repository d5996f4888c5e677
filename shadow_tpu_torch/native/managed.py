"""Managed processes: real, unmodified Linux executables inside the sim.

Reference analog: SURVEY.md §2 "Process / ManagedThread" + §3.2/3.3 (spawn
handshake, seccomp trap, strict turn-taking). The division of labor is
deliberately different from upstream: the C shim (csrc/shim/shim.c) is
DUMB — it forwards trapped syscalls verbatim over a fixed-fd socketpair —
and this module owns every bit of emulation: the descriptor table, the
socket bridge onto the simulated transport, the emulated clock, blocking
semantics, and guest memory access (native/memory.py, process_vm_readv).

Turn-taking: the managed process is *always* blocked except between our
reply and its next request. The pump loop services syscalls at the current
sim instant (app compute costs zero sim time, upstream's default model);
a syscall that must wait (nanosleep, connect, recv on an empty buffer,
send into a full buffer) parks the process — no reply — and a host event
or transport callback later resumes the pump. The blocking socket read
releases the GIL, so hosts running managed processes get real OS-thread
parallelism under thread_per_core — the phase-4 payoff promised in
core/scheduler.py.

v1 emulation surface (grown as workloads need): write/read on stdio and
virtual sockets, socket/connect/send/recv/close/shutdown + sockname peers
+ sockopt stubs, nanosleep/clock_nanosleep, clock_gettime/gettimeofday/
time, getrandom (deterministic, per-host RNG), stdin EOF. bind/listen/
accept (server side) intentionally return -ENOSYS until implemented.
"""

from __future__ import annotations

import hashlib
import mmap
import os
import socket
import struct
import subprocess
import threading
from pathlib import Path
from typing import Optional

from shadow_tpu_torch.core.time import NS_PER_SEC, SimTime, emulated
from shadow_tpu_torch.host.process import ProcessLifecycle
from shadow_tpu_torch.native.memory import ProcessMemory
from shadow_tpu_torch.native.vfs import RETRY_NATIVE, HostVFS

SHIM_IPC_FD = 995
IPC_LOW = 932  # per-thread channel window [IPC_LOW, SHIM_IPC_FD]
VFD_BASE = 0x100000
HELLO = 0xFFFFFFFF
# thread-management pseudo-syscalls (shim-side analogs in native/shim/shim.c)
SPAWN_THREAD = 0xFFFFFFF0  # -> reply carries slot + SCM_RIGHTS channel fd
THREAD_HELLO = 0xFFFFFFF1  # new thread checks in; reply is its first turn
THREAD_JOIN = 0xFFFFFFF2   # arg0 = slot; reply is the thread's retval
THREAD_EXIT = 0xFFFFFFF3   # arg0 = retval; thread finishes dying natively
FORK_INTENT = 0xFFFFFFF4   # -> reply carries embryo id + SCM_RIGHTS fd
FORK_COMMIT = 0xFFFFFFF5   # args = (embryo id, real child pid) -> vpid
RESOLVE = 0xFFFFFFF6       # arg0 = guest ptr to a hostname -> IPv4 (u32)
AUDIT_NOTE = 0xFFFFFFF7    # arg0 = unemulated syscall nr, first native use
#: reply sentinel: "a ring memfd + role follows, then the real result"
#: (native/shring.h shared-memory pipe fast path; outside the errno
#: range, distinct from vfs.RETRY_NATIVE's -1000000)
MAPRING = -1000001

# -- shim fast-plane ABI (C twin: native/shring.h; tools/twincheck audits
# every constant below against the header — drift cannot merge) ----------
SHIM_PAGE_FLAGS = 4         # clock-page u64 word indices
SHIM_PAGE_CLS_TIME = 5
SHIM_PAGE_CLS_IDENT = 6
SHIM_PAGE_CLS_RING_R = 7
SHIM_PAGE_CLS_RING_W = 8
SHIM_PAGE_CLS_READY = 9
SHIM_PAGE_OPLOG_N = 15
SHIM_PAGE_F_FAST = 1        # flags word bit0: fast plane enabled
SHIM_READY_OFF = 256        # per-vfd readiness bytes [OFF, OFF+LEN)
SHIM_READY_LEN = 768
SHIM_READY_VALID = 1
SHIM_READY_IN = 2
SHIM_READY_OUT = 4
SHIM_READY_HUP = 8
SHIM_READY_ERR = 16
SHIM_OPLOG_OFF = 1024       # socket-op log [OFF, OFF + 8*MAX)
SHIM_OPLOG_MAX = 383
SHIM_OP_RECV = 1
SHIM_OP_SEND = 2
SHRING_OFF_FLAGS = 44       # struct shring field offsets (new fields)
SHRING_OFF_WBUDGET = 56
SHRING_F_HUP = 1
SHRING_F_ERR = 2
SHRING_F_SOCK = 4
SHRING_CAP_MIN = 4096
SHRING_CAP_MAX = 1 << 24

#: clock-page class word -> host counter (fold reads then zeroes, in
#: this order; the per-class counters are informational — the "syscalls"
#: fold uses the total in word [2], so totals stay mode-invariant)
_SHIM_CLASS_COUNTERS = (
    (SHIM_PAGE_CLS_TIME, "shim_fast_time"),
    (SHIM_PAGE_CLS_IDENT, "shim_fast_identity"),
    (SHIM_PAGE_CLS_RING_R, "shim_fast_ring_read"),
    (SHIM_PAGE_CLS_RING_W, "shim_fast_ring_write"),
    (SHIM_PAGE_CLS_READY, "shim_fast_readiness"),
)

# operator escape hatch for A/B determinism runs: with the fast plane
# forced off, every guest op takes the worker round trip and all
# simulated observables must stay byte-identical (tools/ci.sh gates it)
# detlint: ok(envread): host-side A/B switch, never sim state
_FASTPATH_ON = os.environ.get("SHADOW_TPU_SHIM_FASTPATH", "1") != "0"


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 1).bit_length()


SYS_wait4, SYS_exit_group, SYS_pipe, SYS_pipe2 = 61, 231, 22, 293
SYS_dup, SYS_dup2, SYS_dup3 = 32, 33, 292
SYS_fstat, SYS_lseek, SYS_newfstatat = 5, 8, 262
SYS_sendfile, SYS_sigaltstack = 40, 131
SYS_getrlimit, SYS_setrlimit, SYS_prlimit64 = 97, 160, 302
SYS_signalfd, SYS_signalfd4 = 282, 289
SYS_splice, SYS_tee = 275, 276
SYS_inotify_init, SYS_inotify_add_watch = 253, 254
SYS_inotify_rm_watch, SYS_inotify_init1 = 255, 294
# the virtual file surface (native/vfs.py)
SYS_pread64, SYS_pwrite64 = 17, 18
SYS_open, SYS_stat, SYS_lstat, SYS_access = 2, 4, 6, 21
SYS_fsync, SYS_fdatasync, SYS_truncate, SYS_ftruncate = 74, 75, 76, 77
SYS_getcwd, SYS_chdir, SYS_fchdir, SYS_rename, SYS_mkdir = 79, 80, 81, 82, 83
SYS_rmdir, SYS_creat, SYS_unlink, SYS_readlink = 84, 85, 87, 89
SYS_getdents64, SYS_openat, SYS_mkdirat, SYS_unlinkat = 217, 257, 258, 263
SYS_renameat, SYS_readlinkat, SYS_faccessat = 264, 267, 269
SYS_renameat2, SYS_statx, SYS_faccessat2 = 316, 332, 439
AT_FDCWD = -100
AT_REMOVEDIR = 0x200
AT_SYMLINK_NOFOLLOW = 0x100


def _sfd(v: int) -> int:
    """Sign-extend a syscall fd argument. AT_FDCWD arrives either as a
    full u64 pattern (0xFFFF...FF9C) or as a 32-bit one (0xFFFFFF9C)
    when the libc wrapper writes the int arg with a 32-bit mov and the
    upper register half happens to be zero. No legitimate fd lives in
    [2^31, 2^32) (vfds start at 0x100000), so both decode safely."""
    if v >= (1 << 63):
        return v - (1 << 64)
    if 0x80000000 <= v <= 0xFFFFFFFF:
        return v - (1 << 32)
    return v
SYS_close_range = 436
SYS_select, SYS_pselect6 = 23, 270
SYS_kill = 62
SYS_socketpair = 53
SYS_uname = 63
SYS_times, SYS_clock_getres = 100, 229
SYS_sched_getaffinity, SYS_sysinfo = 204, 99
SYS_mmap = 9
SYS_getrusage = 98
from shadow_tpu_torch.native.identity import SIM_CPUS  # noqa: E402 (why 1
# CPU: see identity.py — the spin-free machine identity)
# default-terminate signals the worker emulates for guest-to-guest kill
# every Linux default-terminate signal (+ realtime 34..64, all default-
# terminate); STOP/CONT/TSTP (19,18,20..22) and default-ignores excluded
_TERM_SIGS = ({1, 2, 3, 4, 5, 6, 7, 8, 10, 11, 12, 13, 14, 15, 16,
               24, 25, 26, 27, 29, 30, 31} | set(range(34, 65)))
_IGN_SIGS = {17, 23, 28}  # CHLD URG WINCH: default-ignore
WNOHANG, ECHILD, ESRCH = 1, 10, 3
MAX_THREADS = 64           # slots 1..63 map to shim fds 994..932
SYS_futex = 202
FUTEX_WAIT, FUTEX_WAKE, FUTEX_REQUEUE, FUTEX_CMP_REQUEUE = 0, 1, 3, 4
FUTEX_WAKE_OP, FUTEX_WAIT_BITSET, FUTEX_WAKE_BITSET = 5, 9, 10
FUTEX_CLOCK_REALTIME = 256
FUTEX_BITSET_ALL = 0xFFFFFFFF

# x86-64 syscall numbers
SYS_read, SYS_write, SYS_close = 0, 1, 3
SYS_readv, SYS_writev = 19, 20
SYS_nanosleep = 35
SYS_socket, SYS_connect, SYS_accept, SYS_sendto, SYS_recvfrom = 41, 42, 43, 44, 45
SYS_sendmsg, SYS_recvmsg, SYS_shutdown, SYS_bind, SYS_listen = 46, 47, 48, 49, 50
SYS_getsockname, SYS_getpeername = 51, 52
SYS_setsockopt, SYS_getsockopt = 54, 55
SYS_gettimeofday, SYS_time = 96, 201
SYS_clock_gettime, SYS_clock_nanosleep = 228, 230
SYS_getrandom = 318
SYS_accept4 = 288
SYS_poll, SYS_ppoll = 7, 271
SYS_ioctl, SYS_fcntl = 16, 72
SYS_epoll_create, SYS_epoll_create1 = 213, 291
SYS_epoll_ctl, SYS_epoll_wait, SYS_epoll_pwait = 233, 232, 281
SYS_getpid, SYS_getppid, SYS_gettid = 39, 110, 186
SYS_timerfd_create, SYS_timerfd_settime, SYS_timerfd_gettime = 283, 286, 287
SYS_eventfd, SYS_eventfd2 = 284, 290
TFD_TIMER_ABSTIME = 1
#: clock ids whose origin is boot == sim start (monotonic + cputime
#: families); the realtime family stays epoch-based (core/time.EMULATED_EPOCH)
MONO_CLOCKS = (1, 2, 3, 4, 6, 7)

POLLIN, POLLOUT, POLLERR, POLLHUP = 0x001, 0x004, 0x008, 0x010
EPOLL_CTL_ADD, EPOLL_CTL_DEL, EPOLL_CTL_MOD = 1, 2, 3
EPOLLIN, EPOLLOUT, EPOLLERR, EPOLLHUP = 0x001, 0x004, 0x008, 0x010
F_GETFD, F_SETFD, F_GETFL, F_SETFL = 1, 2, 3, 4
O_NONBLOCK = 0o4000
O_CLOEXEC = 0o2000000
FIONREAD, FIONBIO = 0x541B, 0x5421
SYS_clone, SYS_fork, SYS_vfork, SYS_execve, SYS_clone3 = 56, 57, 58, 59, 435

EPERM, EBADF, EAGAIN, EFAULT, EINVAL, EPIPE = 1, 9, 11, 14, 22, 32
ESPIPE = 29
E2BIG = 7
ENOSYS, ENOTCONN, ECONNRESET, ETIMEDOUT, EAFNOSUPPORT, ENETUNREACH = (
    38, 107, 104, 110, 97, 101)

def _zeroed_sets(sets, nbytes: int):
    """Fresh all-zero fd_set buffers shaped like ``sets``."""
    return [bytearray(nbytes) if s is not None else None for s in sets]


#: _read_req sentinel: the guest held its turn past the watchdog deadline
#: (experimental.guest_turn_timeout) without making a syscall. Shaped like
#: a (nr, args) tuple so handshake sites treat it as a plain failure.
_TIMEDOUT = (-2, ())

_BLOCK = object()  # service() sentinel: no reply yet, process parked
_DETACH = object()  # service() sentinel: reply 0, then stop reading this
                    # thread's channel forever (it announced its exit)
_REPLIED = object()  # service() sentinel: reply already sent inline
_EMBRYO = object()  # ready-queue sentinel: read THREAD_HELLO before granting
_EXITGROUP = object()  # service() sentinel: reply, SIGKILL the whole
                       # process (exit_group semantics), reap immediately
_EXECED = object()  # service() sentinel: execve succeeded — the OLD real
                    # process was killed and replaced; no reply, stop
                    # reading the dead channel

#: spawn serialization: the child end of the socketpair rides a FIXED fd
#: number (the seccomp filter bakes it in), so concurrent spawns on
#: different scheduler threads must not interleave the dup2/Popen window
_SPAWN_LOCK = threading.Lock()

#: how long (real seconds) to wait for the shim's HELLO before concluding
#: LD_PRELOAD injection failed (statically linked binary, setuid, ...)
HANDSHAKE_TIMEOUT_S = 30.0

_reserved_ipc_slot = False


#: a child interpreter that installs a seccomp filter sending getpid to
#: SECCOMP_RET_TRAP and exits 0 only if the trap reached its SIGSYS
#: handler: the interposition the shim is built on, tried for real (a
#: sandboxed kernel such as gVisor traps correctly yet answers EINVAL to
#: SECCOMP_GET_ACTION_AVAIL, the reference's probe)
_TRAP_PROBE = """
import ctypes, signal, struct, sys
libc = ctypes.CDLL(None, use_errno=True)
seen = []
signal.signal(signal.SIGSYS, lambda *a: seen.append(1))
prog = [(0x20, 0, 0, 0), (0x15, 0, 1, 39), (0x06, 0, 0, 0x00030000),
        (0x06, 0, 0, 0x7fff0000)]
raw = b"".join(struct.pack("HBBI", *i) for i in prog)
buf = ctypes.create_string_buffer(raw, len(raw))
class Fprog(ctypes.Structure):
    _fields_ = [("len", ctypes.c_ushort), ("filter", ctypes.c_void_p)]
fp = Fprog(len(prog), ctypes.cast(buf, ctypes.c_void_p))
if libc.prctl(38, 1, 0, 0, 0) or libc.prctl(22, 2, ctypes.byref(fp), 0, 0):
    sys.exit(2)
libc.syscall(39)
sys.exit(0 if seen else 3)
"""


def missing_kernel_features() -> list:
    """The kernel features the managed-process plane needs that this
    machine lacks (empty when all are there): memfd_create (the shared
    rings and synthesized files), process_vm_readv (guest memory) and a
    seccomp filter's SECCOMP_RET_TRAP reaching a SIGSYS handler (the
    shim's syscall interposition; tried in a child interpreter)."""
    import ctypes

    missing = []
    try:
        os.close(os.memfd_create("cap-probe", 0))
    except (OSError, AttributeError):
        missing.append("memfd_create")
    try:
        libc = ctypes.CDLL(None, use_errno=True)

        class _Iovec(ctypes.Structure):
            _fields_ = [("base", ctypes.c_void_p),
                        ("len", ctypes.c_size_t)]

        src = ctypes.create_string_buffer(b"probe!!", 8)
        dst = ctypes.create_string_buffer(8)
        liov = _Iovec(ctypes.cast(dst, ctypes.c_void_p), 8)
        riov = _Iovec(ctypes.cast(src, ctypes.c_void_p), 8)
        if libc.process_vm_readv(os.getpid(), ctypes.byref(liov), 1,
                                 ctypes.byref(riov), 1, 0) != 8:
            missing.append("process_vm_readv")
    except OSError as e:  # no libc through ctypes
        missing.append(f"ctypes/libc probe failed: {e}")
    import sys

    try:
        trap = subprocess.run([sys.executable, "-c", _TRAP_PROBE],
                              capture_output=True, timeout=60).returncode
    except (OSError, subprocess.TimeoutExpired) as e:
        trap = e
    if trap != 0:
        missing.append(f"seccomp SECCOMP_RET_TRAP (probe: {trap})")
    return missing


def _reserve_ipc_slot() -> None:
    """Pin /dev/null onto SHIM_IPC_FD so the process-wide fd allocator can
    never hand that number to an unrelated file; spawns dup2 over it and
    restore it afterwards. Without this, a large sim would eventually
    allocate fd 995 to some live object and the next spawn's dup2 would
    silently destroy it."""
    global _reserved_ipc_slot
    if _reserved_ipc_slot:
        return
    try:
        os.fstat(SHIM_IPC_FD)
        raise RuntimeError(
            f"fd {SHIM_IPC_FD} (SHIM_IPC_FD) is already in use in this "
            f"process; managed processes need it reserved")
    except OSError:
        pass
    devnull = os.open(os.devnull, os.O_RDWR)
    os.dup2(devnull, SHIM_IPC_FD)
    os.close(devnull)
    _reserved_ipc_slot = True

TIMER_ABSTIME = 1


def _shim_lib() -> Path:
    """The preload shim: ``SHADOW_SHIM_LIB`` when set, else the port's
    build of csrc/shim/shim.c, made at first use (native/__init__.py); a
    failed build raises with the compiler's output."""
    from shadow_tpu_torch.native import shim_lib

    return shim_lib()


class VSocket:
    """One virtual descriptor: a simulated socket (stream, listener,
    datagram) or an epoll instance."""

    __slots__ = ("vfd", "kind", "endpoint", "rxbuf", "peer_closed",
                 "connected", "connect_err", "bound_port", "listening",
                 "accept_q", "nonblock", "dgram_q", "udp", "dgram_peer",
                 "interest",
                 "expirations", "interval_ns", "deadline", "timer_handle",
                 "evt_counter", "refs", "pipe", "pipe_out", "timer_clock",
                 "vfile", "sig_mask", "sig_q", "watches", "next_wd",
                 "ino_q", "sockring")

    def __init__(self, vfd: int, kind: str = "stream") -> None:
        self.vfd = vfd
        self.kind = kind  # stream | dgram | epoll | timer | event | pipe_r/w
        self.endpoint = None
        self.rxbuf = bytearray()
        self.peer_closed = False
        self.connected = False
        self.connect_err = 0
        self.bound_port = 0
        self.listening = False
        self.accept_q: list = []  # pre-wired VSockets awaiting accept()
        self.nonblock = False
        self.dgram_q: list = []  # (payload bytes|b"", nbytes, src, sport)
        self.udp = None  # DatagramSocket when bound
        self.dgram_peer = None  # connected-UDP default peer: (host_id, port)
        self.interest: dict = {}  # epoll: vfd -> (events, userdata)
        # timerfd state
        self.expirations = 0
        self.interval_ns = 0
        self.deadline = 0
        self.timer_handle = None
        # eventfd state
        self.evt_counter = 0
        self.timer_clock = 0  # timerfd: clockid the deadlines are based on
        self.vfile = None  # VFile when kind is file/dir (native/vfs.py)
        self.sockring = None  # SockRing once ESTABLISHED + offered
        # fork support: open-file-description refcount (a forked child's fd
        # table shares VSocket objects; the backing object closes when the
        # LAST table entry referencing it closes, like the kernel's)
        self.refs = 1
        self.pipe = None  # PipeBuf when kind is pipe_r/pipe_w (read side
        # for "spair" duplex ends)
        self.pipe_out = None  # "spair": the buffer this end WRITES
        self.sig_mask = 0  # signalfd: u64 signal mask
        self.sig_q: list = []  # signalfd: pending (signo, sender_vpid)
        self.watches: dict = {}  # inotify: wd -> watched real path
        self.next_wd = 1  # inotify: next watch descriptor
        self.ino_q: list = []  # inotify: pending packed events


class PipeBuf:
    """The shared buffer behind a pipe's two ends — usable from EITHER
    process of a forked pair (reference analog: cross-process pipes of the
    descriptor table, SURVEY.md §2 row 12). Readers/writers park with their
    owning (process, thread) recorded here so wakeups cross processes.

    Byte storage is behind the avail/room/append_bytes/take/peek accessors
    so RingPipeBuf can back them with a guest-shared memory ring."""

    CAP = 65536

    __slots__ = ("buf", "r_end", "w_end", "waiting", "procs")

    def __init__(self) -> None:
        self.buf = bytearray()
        self.r_end = None  # the pipe_r VSocket (refs==0 -> no readers)
        self.w_end = None  # the pipe_w VSocket (refs==0 -> EOF)
        self.waiting: list = []  # (proc, thread) parked on this pipe
        self.procs: set = set()  # processes holding an end (poll wakeups)

    @property
    def readers(self) -> int:
        return self.r_end.refs if self.r_end is not None else 0

    @property
    def writers(self) -> int:
        return self.w_end.refs if self.w_end is not None else 0

    # -- byte storage ------------------------------------------------------
    def avail(self) -> int:
        return len(self.buf)

    def room(self) -> int:
        return self.CAP - len(self.buf)

    def append_bytes(self, data: bytes) -> None:
        self.buf += data

    def take(self, k: int) -> bytes:
        out = bytes(self.buf[:k])
        del self.buf[:k]
        return out

    def peek(self, k: int) -> bytes:
        return bytes(self.buf[:k])

    def sync_refs(self) -> None:
        pass  # ring variant mirrors readers/writers into the shared header

    def set_waiters(self, on: bool) -> None:
        pass  # ring variant flags the shared header for the shim

    def maybe_retire(self) -> None:
        pass  # ring variant releases the mmap/memfd when fully done

    def wake(self) -> None:
        self.sync_refs()
        parked, self.waiting = self.waiting, []
        for proc, th in parked:
            w = th.waiting
            if not w or th.dead or w[0] not in ("pipe_r", "pipe_w",
                                                "sendfile", "splice"):
                continue
            proc._pipe_retry(th, w)
        self.set_waiters(bool(self.waiting))
        # retire only AFTER the retry loop: a parked thread re-delivered
        # above (e.g. EOF) must not find a closed ring under its accessors
        self.maybe_retire()
        for proc in list(self.procs):
            if proc.running:
                proc._notify()  # pollers (possibly in the other process)


class RingPipeBuf(PipeBuf):
    """A PipeBuf whose bytes live in a guest-shared memory ring
    (native/shring.h) — the reference's shared-memory data channel
    (SURVEY.md §2 ⭐Shmem allocator / shim-side service): the worker
    SCM_RIGHTS-mints the memfd to each guest that touches an end, and the
    shim then serves non-blocking reads/writes entirely locally (zero
    worker round trips); only blocking edges (empty read, full or
    atomic-split write, EPIPE) forward here. Strict turn-taking makes the
    shared state race-free: exactly one of {worker, any guest thread}
    runs at any instant.

    Header layout (struct shring): magic u32, cap u32, rpos u64, wpos
    u64, readers u32, writers u32, has_waiters u32, dirty u32, fast_ok
    u32, pad u32, shim_ops u64. rpos/wpos are free-running counters."""

    __slots__ = ("memfd", "mm", "registry", "attached")
    HDR = 4096
    MAGIC = 0x53524E47

    def __init__(self, registry: dict) -> None:
        super().__init__()
        self.buf = None  # storage is the ring, not the bytearray
        self.memfd = os.memfd_create("shring", 0)
        os.ftruncate(self.memfd, self.HDR + self.CAP)
        self.mm = mmap.mmap(self.memfd, self.HDR + self.CAP)
        struct.pack_into("<II", self.mm, 0, self.MAGIC, self.CAP)
        struct.pack_into("<I", self.mm, 40, 1)  # fast_ok
        #: controller-scoped registry of live rings, INSERTION-ORDERED
        #: (a dict used as an ordered set): the wake scan walks it when a
        #: guest's fast-op counter moved, and multi-ring wake order must
        #: be deterministic run-to-run. Retired when both ends close, so
        #: one sim's rings never leak into the next.
        self.registry = registry
        registry[self] = None
        #: set once both ends are wired (sync_refs at creation); the
        #: retire/fast-off guards key on THIS, not r_end — a spair
        #: shutdown(SHUT_RD) nulls r_end and must not defeat them
        self.attached = False

    # positions
    def _rw(self):
        return struct.unpack_from("<QQ", self.mm, 8)

    def avail(self) -> int:
        if self.mm.closed:  # retired ring: nothing readable
            return 0
        r, w = self._rw()
        return w - r

    def room(self) -> int:
        if self.mm.closed:
            return self.CAP
        r, w = self._rw()
        return self.CAP - (w - r)

    def append_bytes(self, data: bytes) -> None:
        r, w = self._rw()
        off = w % self.CAP
        first = min(self.CAP - off, len(data))
        self.mm[self.HDR + off:self.HDR + off + first] = data[:first]
        if len(data) > first:
            rest = len(data) - first
            self.mm[self.HDR:self.HDR + rest] = data[first:]
        struct.pack_into("<Q", self.mm, 16, w + len(data))

    def peek(self, k: int) -> bytes:
        r, _w = self._rw()
        off = r % self.CAP
        first = min(self.CAP - off, k)
        out = self.mm[self.HDR + off:self.HDR + off + first]
        if k > first:
            out += self.mm[self.HDR:self.HDR + (k - first)]
        return out

    def take(self, k: int) -> bytes:
        out = self.peek(k)
        r, _w = self._rw()
        struct.pack_into("<Q", self.mm, 8, r + k)
        return out

    def sync_refs(self) -> None:
        if self.mm.closed:
            return
        if self.r_end is not None or self.w_end is not None:
            self.attached = True
        struct.pack_into("<II", self.mm, 24, self.readers, self.writers)
        if self.attached and self.readers == 0:
            # nobody may read (last close OR shutdown(SHUT_RD)): local
            # service must stop — a fork sibling's installed mapping
            # would otherwise fast-read bytes that must EOF
            struct.pack_into("<I", self.mm, 40, 0)  # fast_ok off

    def maybe_retire(self) -> None:
        """Release the mmap/memfd once both ends are closed AND nothing
        is parked here (wake() calls this after its retry loop — closing
        earlier would yank the ring from under a parked thread's EOF
        delivery; VERDICT r5 review finding)."""
        if (not self.mm.closed and self.r_end is not None
                and self.readers == 0 and self.writers == 0
                and not self.waiting):
            self.registry.pop(self, None)
            self.mm.close()
            os.close(self.memfd)

    def set_waiters(self, on: bool) -> None:
        if not self.mm.closed:  # wake() may have just retired the ring
            struct.pack_into("<I", self.mm, 32, 1 if on else 0)

    def dirty(self) -> bool:
        return (not self.mm.closed
                and struct.unpack_from("<I", self.mm, 36)[0] != 0)

    def clear_dirty(self) -> None:
        if not self.mm.closed:
            struct.pack_into("<I", self.mm, 36, 0)


class SockRing:
    """Per-connection RX/TX ring pair for an ESTABLISHED managed stream
    socket (native/shring.h with SHRING_F_SOCK set). Unlike RingPipeBuf,
    these rings MIRROR authoritative transport state rather than store
    it: the worker appends every delivered payload to RX (invariant: RX
    unread == len(vs.rxbuf)) and refreshes the TX ring's wbudget =
    send_buffer - buffered before every service reply, while the shim
    consumes RX / fills TX locally and logs each op in the clock-page
    oplog. The worker replays that log IN ORDER at the next fold, so the
    simulated transport sees the exact slow-path call sequence and every
    observable is byte-identical with the fast plane on or off. Exact
    because of strict turn-taking: transport state is frozen for the
    whole guest turn, so budgets/readiness published at reply time
    cannot go stale mid-turn."""

    __slots__ = ("cap", "rx_fd", "tx_fd", "rx", "tx", "dead")
    HDR = RingPipeBuf.HDR
    MAGIC = RingPipeBuf.MAGIC

    def __init__(self, cap: int) -> None:
        self.cap = cap
        self.dead = False
        self.rx_fd, self.rx = self._mk(cap)
        self.tx_fd, self.tx = self._mk(cap)

    def _mk(self, cap: int):
        fd = os.memfd_create("sockring", 0)
        os.ftruncate(fd, self.HDR + cap)
        mm = mmap.mmap(fd, self.HDR + cap)
        struct.pack_into("<II", mm, 0, self.MAGIC, cap)
        struct.pack_into("<II", mm, 24, 1, 1)  # readers/writers: wired
        struct.pack_into("<I", mm, 40, 1)      # fast_ok
        struct.pack_into("<I", mm, SHRING_OFF_FLAGS, SHRING_F_SOCK)
        return fd, mm

    # -- RX mirror: worker appends on delivery; rpos advances either
    #    in-shim (local read, oplogged) or here (slow-path consume) -----
    def rx_unread(self) -> int:
        r, w = struct.unpack_from("<QQ", self.rx, 8)
        return w - r

    def rx_room(self) -> int:
        return self.cap - self.rx_unread()

    def rx_append(self, data) -> None:
        r, w = struct.unpack_from("<QQ", self.rx, 8)
        off = w % self.cap
        first = min(self.cap - off, len(data))
        self.rx[self.HDR + off:self.HDR + off + first] = data[:first]
        if len(data) > first:
            rest = len(data) - first
            self.rx[self.HDR:self.HDR + rest] = data[first:]
        struct.pack_into("<Q", self.rx, 16, w + len(data))

    def rx_advance(self, k: int) -> None:
        r = struct.unpack_from("<Q", self.rx, 8)[0]
        struct.pack_into("<Q", self.rx, 8, r + k)

    # -- TX: shim appends within wbudget (oplogged); replay takes -------
    def tx_take(self, k: int) -> bytes:
        r, _w = struct.unpack_from("<QQ", self.tx, 8)
        off = r % self.cap
        first = min(self.cap - off, k)
        out = self.tx[self.HDR + off:self.HDR + off + first]
        if k > first:
            out += self.tx[self.HDR:self.HDR + (k - first)]
        struct.pack_into("<Q", self.tx, 8, r + k)
        return out

    def set_wbudget(self, n: int) -> None:
        struct.pack_into("<Q", self.tx, SHRING_OFF_WBUDGET, n)

    def sync_flags(self, vs) -> None:
        if self.rx.closed:
            return
        fl = SHRING_F_SOCK
        if vs.peer_closed:
            fl |= SHRING_F_HUP
        if vs.connect_err:
            fl |= SHRING_F_ERR
        struct.pack_into("<I", self.rx, SHRING_OFF_FLAGS, fl)
        struct.pack_into("<I", self.tx, SHRING_OFF_FLAGS, fl)

    def kill(self) -> None:
        """Permanent fast-off (mirror overflow, shutdown, socket error,
        teardown): the shim checks fast_ok on every local op, so any
        still-installed alias mapping stops serving immediately and all
        traffic takes the worker round trip again."""
        self.dead = True
        if not self.rx.closed:
            struct.pack_into("<I", self.rx, 40, 0)
            struct.pack_into("<I", self.tx, 40, 0)

    def retire(self) -> None:
        """Last fd-table reference is gone (every shim mapping was
        dropped before its close forwarded): release the mappings."""
        if self.rx.closed:
            return
        self.kill()
        self.rx.close()
        self.tx.close()
        os.close(self.rx_fd)
        os.close(self.tx_fd)


class GuestThread:
    """One thread of a managed guest: its IPC channel + scheduling state.

    Reference analog: ManagedThread (SURVEY.md §2 "Process / ManagedThread").
    Exactly one thread of a process runs at a time (strict turn-taking);
    the rest are parked either on a sim continuation (``waiting``) or in
    the ready queue awaiting their turn grant.
    """

    __slots__ = ("slot", "sock", "waiting", "dead", "retval", "joiners",
                 "joined", "altstack")

    def __init__(self, slot: int, sock: socket.socket) -> None:
        self.slot = slot
        self.sock = sock
        self.altstack = None  # sigaltstack bookkeeping: (sp, flags, size)
        self.waiting = None  # (kind, ...) while parked on a continuation
        self.dead = False
        self.retval = 0  # pthread-style exit value (int64, reply-ready)
        self.joiners: list = []  # GuestThreads parked in join on this one
        self.joined = False  # slot recyclable only once dead AND joined


class GuestJournal:
    """Append-only record of one managed guest's observation stream: every
    worker reply (turn grant) with its result, issuing thread slot, and the
    emulated clock word published alongside it. Two consumers: (a) the
    running ``(n, sha256)`` cursor is the guest's position in its
    replayable history — recorded in re-execution snapshots
    (checkpoint.py, format version 2) and verified when a restore's re-executed
    prefix reaches the snapshot boundary; (b) the jsonl file itself
    (``<data_dir>/guest_oplogs/``) is byte-identical run to run, so a
    cursor mismatch can be diffed down to the first divergent grant. Pure
    side plane: nothing here feeds simulation state, so journaling on/off
    cannot change results (the bench's ``managed_ckpt_overhead`` row
    measures its wall cost)."""

    __slots__ = ("path", "n", "_h", "_f")

    def __init__(self, path: Path) -> None:
        path.parent.mkdir(parents=True, exist_ok=True)
        self.path = path
        self.n = 0
        self._h = hashlib.sha256()
        self._f = open(path, "a")

    def record(self, slot: int, ret: int, clk: int) -> None:
        self.n += 1
        self._h.update(b"%d|%d|%d|%d\n" % (self.n, slot, ret, clk))
        if self._f is not None:
            self._f.write('{"n":%d,"slot":%d,"ret":%d,"clk":%d}\n'
                          % (self.n, slot, ret, clk))

    def cursor(self) -> dict:
        if self._f is not None:
            self._f.flush()
        return {"n": self.n, "sha": self._h.hexdigest()}

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


class ManagedProcess(ProcessLifecycle):
    """Lifecycle + syscall service for one real executable in the sim.

    Mirrors PluginProcess's surface (spawn/shutdown/finish/check_final_state)
    so the controller treats both uniformly.
    """

    def __init__(self, host, opts, index: int) -> None:
        self.host = host
        self.opts = opts
        self.name = f"{Path(opts.path).name}.{index}"
        self.exit_code: Optional[int] = None
        self.running = False
        self.spawned = False  # ever spawned (host reboot respects start_time)
        #: observation journal (GuestJournal) when the controller armed
        #: re-execution snapshots; survives crash/respawn — one stream
        #: per record
        self._journal = None
        self.app = None  # parity with PluginProcess (no plugin object)
        self.proc: Optional[subprocess.Popen] = None
        self.mem: Optional[ProcessMemory] = None
        self.sock: Optional[socket.socket] = None
        self._time_map: Optional[mmap.mmap] = None
        self._time_path: Optional[Path] = None
        self.fds: dict[int, VSocket] = {}
        self._next_vfd = VFD_BASE
        self._files: dict[int, object] = {}  # 1/2 -> open capture files
        # threading state: slot -> GuestThread; _cur = thread being serviced
        self.threads: dict[int, GuestThread] = {}
        self._cur: Optional[GuestThread] = None
        self._next_slot = 1
        self._ready: list = []  # (thread, reply) queue awaiting turn grants
        self._pumping = False
        self.futexes: dict[int, list] = {}  # uaddr -> [(thread, mask), ...]
        self.fd_cloexec: set[int] = set()  # vfds closed at execve
        self._strace = None  # open file when strace_logging_mode != off
        #: guest fds already offered their ring mapping (per process
        #: image; cleared at execve — the replacement shim starts empty)
        self._ring_offered: set[int] = set()
        gen = host.controller.cfg.general
        self._syscall_latency = 1000 if gen.model_unblocked_syscall_latency else 0
        #: master gate for every worker-GRANTED shim fast path (socket
        #: rings, in-shim poll, raw-time service via the clock-page flags
        #: word); identity + libc-time interposition are shim-intrinsic
        #: and stay on in every mode. Off under strace (which must see
        #: every call), modeled syscall latency (each call must cost sim
        #: time), or the SHADOW_TPU_SHIM_FASTPATH=0 escape hatch.
        self._fast_plane = (
            _FASTPATH_ON and self._syscall_latency == 0
            and host.controller.cfg.experimental.strace_logging_mode == "off")
        #: ESTABLISHED-socket ring pairs by guest fd (page-owner process
        #: only: vfd numbering is per-process, so a fork child's fds
        #: could collide with the parent's — children service sockets on
        #: the slow path and the shim drops SOCK rings at fork)
        self._sock_rings: dict[int, SockRing] = {}
        #: oplog replay map: (vfd - VFD_BASE) -> VSocket (owner process)
        self._oplog_vs: dict[int, VSocket] = {}
        #: vfds a worker-serviced poll referenced; their readiness bytes
        #: are published on the clock page at every reply (non-ring fds
        #: only — ring-backed readiness is computed in-shim, live)
        self._ready_watch: set[int] = set()
        #: per-syscall-number worker round-trip census for the bench
        #: audit table (controller-scoped, NOT host.counters: it must
        #: stay out of determinism fingerprints)
        self._slow_nrs = host.controller.__dict__.setdefault(
            "_shim_slow_nrs", {})
        #: guest watchdog (experimental.guest_turn_timeout): wall seconds a
        #: turn may last without a syscall before the guest is killed and
        #: the host downed (spin-wait livelock containment; 0 = off)
        self._turn_timeout = float(
            host.controller.cfg.experimental.guest_turn_timeout or 0.0)
        #: shim-fastpath liveness: SockRing positions at the last watchdog
        #: timeout. A guest streaming through its rings in-shim makes no
        #: syscalls for whole timeout windows, yet is doing real work —
        #: the watchdog only fires once the rings are frozen across a full
        #: window too (ring movement, NOT the clock-page ops counter: a
        #: spin-wait livelock advances ops forever and would never fire)
        self._shim_prog = None
        # reference: max_unapplied_cpu_latency — modeled syscall latency
        # accumulates and is applied to the clock in batches of this size
        # (fewer, coarser clock bumps; 0 = apply each immediately)
        self._max_unapplied = host.controller.cfg.experimental.\
            max_unapplied_cpu_latency
        self._unapplied = 0
        self._spin_t = -1  # busy-loop detector: syscalls at one sim instant
        self._spin_n = 0
        #: experimental.native_audit: syscall numbers this process ran
        #: against the host kernel (reported once each by the shim)
        self.audit_native: set[int] = set()
        #: default-on reality boundary: syscall numbers the worker sent
        #: back for native re-issue (RETRY_NATIVE) in THIS process
        self.native_vfs: set[int] = set()
        #: the per-host virtual file surface (native/vfs.py): synthesized
        #: /etc files, host-data-dir tree, native passthrough elsewhere
        self.vfs = HostVFS(self)
        self.vfs.on_mutate = self._ino_mutate  # inotify bridge
        # deterministic virtual pid (real pids would leak host scheduling
        # nondeterminism into any guest that prints or hashes its pid)
        self.vpid = 1000 + host.id * 64 + index
        # fork support
        self._exit_hint = None  # true exit code captured from exit_group
        self._signal_hint = None  # -signum from an emulated kill(2)
        self.children: list = []  # forked ManagedProcess records
        self.parent_proc = None
        self.reaped = False  # consumed by the parent's wait4
        self.real_pid = None  # adopted children: kernel pid (no Popen)
        self._embryos: dict = {}  # embryo id -> worker-side channel sock

    # the syscall-service sites park/peek the CURRENT thread's wait state;
    # continuations instead search all threads via _find_waiter
    @property
    def _waiting(self):
        return self._cur.waiting if self._cur is not None else None

    @_waiting.setter
    def _waiting(self, value):
        self._cur.waiting = value

    def _find_waiter(self, *preds):
        """First parked thread (slot order) whose wait matches: each pred is
        (kinds, obj) — wait[0] in kinds and (obj is None or wait[1] is obj)."""
        for slot in sorted(self.threads):
            th = self.threads[slot]
            w = th.waiting
            if w is None or th.dead:
                continue
            for kinds, obj in preds:
                if w[0] in kinds and (obj is None or w[1] is obj):
                    return th, w
        return None, None

    def _open_strace(self) -> None:
        # reference analog: strace_logging (SURVEY.md §5.1): every
        # emulated syscall with args and result. "deterministic" omits
        # the sim timestamp so logs diff clean across configs whose
        # timing legitimately differs.
        mode = self.host.controller.cfg.experimental.strace_logging_mode
        if mode != "off":
            ddir = Path(self.host.controller.data_dir) / "hosts" / self.host.name
            ddir.mkdir(parents=True, exist_ok=True)
            self._strace = open(ddir / f"{self.name}.strace", "w")
            self._strace_times = mode != "deterministic"

    def _new_clock_page(self) -> None:
        """Create (or replace) this record's guest-shared clock page.
        Page layout: [0:8] emulated ns, [8:16] vpid (the shim's identity
        fast path serves getpid/gettid from here — no worker round trip;
        forked children share the parent's page and keep forwarding),
        [16:24] shim fast-op counter, [24:32] the worker's fold cursor
        (native/shring.h). Used by spawn and by execve (the replacement
        image owns a fresh page — a fork-child record has none)."""
        old = getattr(self, "_time_map", None)
        ddir = Path(self.host.controller.data_dir) / "hosts" / self.host.name
        ddir.mkdir(parents=True, exist_ok=True)
        self._time_path = ddir / f"{self.name}.clock"
        with open(self._time_path, "wb") as f:
            f.write(b"\0" * 4096)
        tf = open(self._time_path, "r+b")
        self._time_map = mmap.mmap(tf.fileno(), 4096)
        tf.close()
        self._time_map[8:16] = struct.pack("<q", self.vpid)
        if self._fast_plane:
            # arm the shim's worker-granted fast paths (raw time, local
            # poll, socket rings); zero = forward everything (strace /
            # modeled latency / SHADOW_TPU_SHIM_FASTPATH=0)
            struct.pack_into("<q", self._time_map, 8 * SHIM_PAGE_FLAGS,
                             SHIM_PAGE_F_FAST)
        if old is not None and self.parent_proc is None:
            # repeated execs: release the superseded mapping (fork-child
            # records borrow the parent's map — never close that one)
            old.close()

    # -- lifecycle ---------------------------------------------------------
    def _reset_for_respawn(self) -> None:
        """A host reboot respawns this record as a fresh instance
        (Host.reboot -> spawn after kill): drop every per-life table the
        crashed guest left behind, exactly as __init__ built them. The
        observation journal (if any) deliberately survives — a respawned
        guest's grants continue the same per-record stream, which is what
        makes crash/reboot runs re-execution-checkpointable."""
        self.proc = None
        self.real_pid = None
        self.mem = None
        self.sock = None
        self.fds = {}
        self._next_vfd = VFD_BASE
        self._files = {}
        self.threads = {}
        self._cur = None
        self._next_slot = 1
        self._ready = []
        self._pumping = False
        self.futexes = {}
        self.fd_cloexec = set()
        self._ring_offered = set()
        self._sock_rings = {}
        self._oplog_vs = {}
        self._ready_watch = set()
        self._spin_t = -1
        self._spin_n = 0
        self._exit_hint = None
        self._signal_hint = None
        self.children = []
        self._embryos = {}
        self._unapplied = 0
        self.audit_native = set()
        self.native_vfs = set()
        self.vfs = HostVFS(self)
        self.vfs.on_mutate = self._ino_mutate

    def spawn(self) -> None:
        lib = _shim_lib()
        if not lib.exists():
            raise FileNotFoundError(
                f"{lib} missing — build the native shim first: make -C native")
        if self.spawned:
            self._reset_for_respawn()
        self._new_clock_page()
        ddir = self._time_path.parent  # hosts/<name>/ (capture files etc.)
        # detlint: ok(envread): guests inherit the operator environment
        env = dict(os.environ)
        env.update(self.opts.environment)
        env.update({
            "LD_PRELOAD": str(lib),
            "SHADOW_SHIM": "1",
            "SHADOW_TIME_SHM": str(self._time_path),
        })
        if self.host.controller.cfg.experimental.native_audit:
            env["SHADOW_AUDIT"] = "1"
        with _SPAWN_LOCK:
            _reserve_ipc_slot()
            parent, child = socket.socketpair(socket.AF_UNIX, socket.SOCK_STREAM)
            os.dup2(child.fileno(), SHIM_IPC_FD)
            child.close()
            try:
                # the guest's REAL stdio points at the capture files,
                # unbuffered (the shared file description means worker-
                # trapped writes and any native slip-throughs interleave
                # at one offset). Not /dev/null: tools fstat their stdout
                # and change behavior on it — GNU grep goes quiet-mode on
                # a devnull stdout. Opened into _files as each succeeds so
                # a failing spawn cannot leak handles.
                self._files[1] = open(ddir / f"{self.name}.stdout", "wb",
                                      buffering=0)
                self._files[2] = open(ddir / f"{self.name}.stderr", "wb",
                                      buffering=0)
                try:
                    self.proc = subprocess.Popen(
                        [self.opts.path] + list(self.opts.args),
                        env=env,
                        pass_fds=(SHIM_IPC_FD,),
                        stdout=self._files[1],
                        stderr=self._files[2],
                        cwd=str(ddir),
                    )
                except BaseException:
                    for f in self._files.values():
                        f.close()
                    self._files.clear()
                    raise
            finally:
                devnull = os.open(os.devnull, os.O_RDWR)
                os.dup2(devnull, SHIM_IPC_FD)  # restore the reservation
                os.close(devnull)
        self.sock = parent
        self.threads = {0: GuestThread(0, parent)}
        self._cur = self.threads[0]
        self.mem = ProcessMemory(self.proc.pid)
        self.running = True
        self.spawned = True
        self.host.counters.add("processes_spawned", 1)
        self._open_strace()
        ctl = self.host.controller
        jdir = getattr(ctl, "guest_journal_dir", None)
        if jdir is not None and self._journal is None:
            self._journal = GuestJournal(
                jdir / f"{self.host.name}.{self.name}.guest_oplog.jsonl")
        note = getattr(ctl, "note_guest_pid", None)
        if note is not None:  # hand-rolled controllers in tests lack it
            note(self)

        # handshake with a real-time bound: a binary the preload cannot
        # enter (static link, setuid) would otherwise hang the scheduler
        main = self.threads[0]
        self.sock.settimeout(HANDSHAKE_TIMEOUT_S)
        try:
            req = self._read_req(main)
        finally:
            self.sock.settimeout(None)
        if req is None or req[0] != HELLO:
            self.proc.kill()
            self._exited()
            raise RuntimeError(
                f"{self.host.name}/{self.name}: shim handshake failed — is "
                f"{self.opts.path!r} dynamically linked? (LD_PRELOAD cannot "
                f"enter static or setuid binaries)")
        self._resume(main, 0)  # grant the first turn and pump

    def shutdown(self) -> None:
        if self.running and self.proc is not None:
            import signal as _signal

            sig = getattr(_signal, self.opts.shutdown_signal, _signal.SIGKILL)
            self.proc.send_signal(sig)
            try:
                # whenever this event can run, the process is parked on the
                # IPC channel (not mid-turn), so a termination signal takes
                # effect without a grant; handlers that ignore it get the
                # reference's escalation: SIGKILL
                self.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self.proc.kill()
            self._exited()

    def reap(self) -> None:
        """Sim over (reference §3.5): kill and reap a still-running child."""
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
            self._exited()
        elif self.proc is None and self.real_pid is not None and self.running:
            try:
                os.kill(self.real_pid, 9)
            except ProcessLookupError:
                pass
            self._exited()

    # -- execve: worker-mediated respawn -----------------------------------
    def _read_ptr_array(self, ptr: int, cap: int = 65536):
        """Read a NULL-terminated array of C-string pointers (argv/envp).
        Returns the list, None on a bad read (EFAULT), or the string
        "2BIG" when the array exceeds ``cap`` entries (real kernels bound
        the TOTAL argv+envp bytes, not the entry count; 64k entries is
        far past any real environment, so hitting it means a runaway or
        unterminated array — report E2BIG like the kernel's limit)."""
        out = []
        for i in range(cap):
            v = struct.unpack("<Q", self.mem.read(ptr + 8 * i, 8))[0]
            if v == 0:
                return out
            cs = self._read_cstr(v)
            if cs is None:
                return None
            out.append(cs)
        return "2BIG"

    def _do_exec(self, args):
        """execve as a respawn: spawn a fresh managed process (clean
        filter stack — the old in-place re-exec died in the new image's
        dynamic linker once file syscalls started trapping) into THIS
        record: same vpid, vfd table, stdio captures, clock page, strace
        stream, and audit set. The old real process is killed while its
        shim blocks in the forward — success never returns, like the real
        execve. Works from any thread and under audit mode."""
        path = self._read_cstr(args[0])
        if path is None:
            return -EFAULT
        argv = self._read_ptr_array(args[1]) if args[1] else None
        envp = self._read_ptr_array(args[2]) if args[2] else []
        if argv is None and args[1]:
            return -EFAULT
        if envp is None:
            return -EFAULT
        if argv == "2BIG" or envp == "2BIG":
            return -E2BIG
        if not argv:
            argv = [path]
        real = path
        r = self.vfs.resolve(AT_FDCWD, path)
        if r is not None:
            if r[0] == "synth":
                return -EACCES  # synthesized files are not executable
            # "host" (data-dir) and "wnative" (worker-tracked cwd outside
            # the root) both carry the absolute real path — exec either;
            # relative paths after a chdir outside the data dir resolve
            # to "wnative" and must keep working
            real = r[1]
        if not os.path.isfile(real):
            return -2  # ENOENT
        if not os.access(real, os.X_OK):
            return -EACCES
        env = {}
        for e in envp:
            k, _, v = e.partition("=")
            env[k] = v
        # the replacement image gets its OWN clock page: a fork-child
        # record shares the parent's page (parent's vpid; no _time_path
        # at all, which used to leak "None" into the env and silently
        # cost exec'd pipeline stages every shim fast path — found in
        # round 5 when the ring counter stayed at zero)
        self._new_clock_page()
        env.update({
            "LD_PRELOAD": str(_shim_lib()),
            "SHADOW_SHIM": "1",
            "SHADOW_TIME_SHM": str(self._time_path),
        })
        if self.host.controller.cfg.experimental.native_audit:
            env["SHADOW_AUDIT"] = "1"
        cwd = self.vfs.cwd if os.path.isdir(self.vfs.cwd) else None
        # spawn the replacement FIRST: a failed execve must leave the
        # calling process unchanged (POSIX), so nothing destructive
        # happens until the new image exists
        with _SPAWN_LOCK:
            _reserve_ipc_slot()
            parent, child = socket.socketpair(socket.AF_UNIX,
                                              socket.SOCK_STREAM)
            os.dup2(child.fileno(), SHIM_IPC_FD)
            child.close()
            try:
                try:
                    newproc = subprocess.Popen(
                        argv, executable=real, env=env,
                        pass_fds=(SHIM_IPC_FD,),
                        stdout=self._files.get(1),
                        stderr=self._files.get(2),
                        cwd=cwd,
                    )
                except OSError as exc:
                    parent.close()
                    return -(exc.errno or EACCES)
            finally:
                devnull = os.open(os.devnull, os.O_RDWR)
                os.dup2(devnull, SHIM_IPC_FD)
                os.close(devnull)
        # point of no return: reap sibling-thread records (exec kills the
        # real siblings), sweep FD_CLOEXEC vfds, retire the old process
        cur = self._cur
        old_threads = self.threads
        for t in list(old_threads.values()):
            if t is not cur and not t.dead:
                t.retval = 0
                self._thread_gone(t)
            if t is not cur:
                t.joined = True
        for fd in sorted(self.fd_cloexec):  # FD_CLOEXEC sweep
            vs = self.fds.pop(fd, None)
            if vs is not None:
                self._close_vs(vs)
        self.fd_cloexec.clear()
        old_proc, old_pid, old_sock = self.proc, self.real_pid, self.sock
        if old_proc is not None:
            old_proc.kill()
            old_proc.wait()
        elif old_pid is not None:
            try:
                os.kill(old_pid, 9)
            except ProcessLookupError:
                pass
        for t in old_threads.values():  # close every per-thread channel
            if t.sock is not None and t.sock is not old_sock:
                try:
                    t.sock.close()
                except OSError:
                    pass
        if old_sock is not None:
            old_sock.close()
        self.proc = newproc
        self.real_pid = None
        self.mem = ProcessMemory(newproc.pid)
        self.sock = parent
        self.threads = {0: GuestThread(0, parent)}
        main = self.threads[0]
        note = getattr(self.host.controller, "note_guest_pid", None)
        if note is not None:
            note(self)
        self._ring_offered.clear()  # the replacement shim starts unmapped
        self._sock_rings.clear()  # re-offered on first use (same rings)
        self._ready_watch.clear()  # fresh page: readiness region is zero
        self.host.counters.add("execs", 1)
        if self._strace is not None:
            self._strace.write(f"+++ execve {real} +++\n")
        # fresh-image handshake, then queue its first turn grant (drained
        # when the old thread's pump returns)
        parent.settimeout(HANDSHAKE_TIMEOUT_S)
        try:
            req = self._read_req(main)
        finally:
            parent.settimeout(None)
        if req is None or req[0] != HELLO:
            newproc.kill()
            self._exited()
            return _EXECED
        self._resume(main, 0)
        return _EXECED

    # -- IPC ---------------------------------------------------------------
    def _read_req(self, th: GuestThread):
        buf = b""
        while len(buf) < 56:
            try:
                chunk = th.sock.recv(56 - len(buf))
            except socket.timeout:
                return _TIMEDOUT
            except OSError:
                return None
            if not chunk:
                return None
            buf += chunk
        nr = struct.unpack_from("<Q", buf, 0)[0]
        args = struct.unpack_from("<6Q", buf, 8)
        return nr, args

    def _reply(self, th: GuestThread, ret: int) -> None:
        clk = emulated(self.host.now)
        self._time_map[:8] = struct.pack("<q", clk)
        if self._fast_plane and self.parent_proc is None:
            self._refresh_fast_state()
        if self._journal is not None:
            # every grant the guest will ever observe passes through here
            # (strict turn-taking): the journal cursor after this record
            # IS the guest's position in its replayable history
            self._journal.record(th.slot, ret, clk)
        th.sock.sendall(struct.pack("<q", ret))

    def _refresh_fast_state(self) -> None:
        """Re-arm the shim's local world view before handing the turn
        back: per-connection TX budgets + HUP/ERR flags, and readiness
        bytes for watched non-ring vfds. Exact for the whole guest turn
        because transport state is frozen while the guest runs (strict
        turn-taking); every worker-serviced op ends here, so the view is
        refreshed before the guest can consult it again."""
        for fd, sr in self._sock_rings.items():
            if sr.dead:
                continue
            vs = self.fds.get(fd)
            if vs is None or vs.endpoint is None:
                continue
            snd = vs.endpoint.sender
            sr.set_wbudget(max(0, snd.send_buffer - snd.buffered))
            sr.sync_flags(vs)
        if self._ready_watch:
            tm = self._time_map
            for fd in self._ready_watch:
                vs = self.fds.get(fd)
                idx = fd - VFD_BASE
                if vs is None or not self._ready_byte_ok(vs):
                    tm[SHIM_READY_OFF + idx] = 0  # shim must forward
                    continue
                b = SHIM_READY_VALID
                if self._readable(vs):
                    b |= SHIM_READY_IN
                if self._writable(vs):
                    b |= SHIM_READY_OUT
                if vs.peer_closed:
                    b |= SHIM_READY_HUP
                if vs.connect_err:
                    b |= SHIM_READY_ERR
                tm[SHIM_READY_OFF + idx] = b

    def _drop_fast_fd(self, fd: int) -> None:
        """This fd number is going away (close / dup-over): forget its
        fast-plane state. The VSocket's SockRing itself survives while
        other references (dup aliases) remain; _close_vs retires it when
        the LAST reference goes."""
        self._sock_rings.pop(fd, None)
        self._ready_watch.discard(fd)
        if (self.parent_proc is None and self._time_map is not None
                and 0 <= fd - VFD_BASE < SHIM_READY_LEN):
            self._time_map[SHIM_READY_OFF + (fd - VFD_BASE)] = 0

    @staticmethod
    def _ready_byte_ok(vs: VSocket) -> bool:
        """Publish a page readiness byte only for fds with NO ring-
        capable backing: the shim's own local ring ops would make a
        published byte stale mid-turn, so ring-backed fds are evaluated
        from live ring state in-shim instead (shim_poll_local)."""
        if vs.sockring is not None:
            return False
        for pb in (vs.pipe, vs.pipe_out):
            if isinstance(pb, RingPipeBuf):
                return False
        return True

    def _maybe_offer_ring(self, fd: int, vs: VSocket, role: int, ret):
        """First read/write on a ring-pipe end from this process image:
        piggyback the ring's memfd on the reply (MAPRING sentinel +
        SCM_RIGHTS + the real result) so the shim serves subsequent
        non-blocking ops on this fd locally (native/shring.h). ``fd`` is
        the guest's actual fd (dup aliases each get their own offer)."""
        pb = self._wbuf(vs) if role else vs.pipe
        # offer only for fds whose read/write actually TRAPS (gen_bpf.py:
        # read traps fd 0 + vfds, write traps fd 1/2 + vfds) — a pipe on
        # fd 3..931 never reaches the worker, so a mapping there would be
        # inert and leak a shim table slot
        traps = fd >= VFD_BASE or (fd == 0 if role == 0 else fd in (1, 2))
        if (not traps or not isinstance(pb, RingPipeBuf) or pb.mm.closed
                or not isinstance(ret, int)
                or (fd, role) in self._ring_offered):
            return ret
        self._ring_offered.add((fd, role))
        th = self._cur
        try:
            th.sock.sendall(struct.pack("<q", MAPRING))
            th.sock.sendmsg([struct.pack("<q", role)],
                            [(socket.SOL_SOCKET, socket.SCM_RIGHTS,
                              struct.pack("<i", pb.memfd))])
            self._reply(th, ret)
        except OSError:
            return ret  # channel died; the pump notices on its next read
        return _REPLIED

    def _maybe_offer_sock(self, fd: int, ret):
        """First serviced read/write/recv/send on an ESTABLISHED stream
        from the page-owner image: publish the per-connection RX/TX ring
        pair over the service reply (two MAPRING offers + the real
        result — the same wire mechanism as pipe rings), so subsequent
        ready-data ops on this fd complete in-shim. Socket rings are
        MIRRORS of transport state; see SockRing."""
        if (not self._fast_plane or self.parent_proc is not None
                or not isinstance(ret, int)
                or fd < VFD_BASE or fd - VFD_BASE >= (1 << 24)
                or (fd, 0) in self._ring_offered):
            return ret
        vs = self.fds.get(fd)
        if (vs is None or vs.kind != "stream" or vs.endpoint is None
                or not vs.connected or vs.peer_closed or vs.connect_err
                or vs.listening):
            return ret
        sr = vs.sockring
        if sr is None:
            ep = vs.endpoint
            cap = _next_pow2(max(ep.receiver.recv_buffer,
                                 ep.sender.send_buffer, SHRING_CAP_MIN))
            if cap > SHRING_CAP_MAX:
                return ret
            sr = vs.sockring = SockRing(cap)
            if vs.rxbuf:  # mirror invariant holds from birth
                sr.rx_append(bytes(vs.rxbuf))
        if sr.dead:
            return ret
        self._ring_offered.add((fd, 0))
        self._ring_offered.add((fd, 1))
        # register BEFORE the reply: _reply's refresh must arm wbudget
        self._sock_rings[fd] = sr
        self._oplog_vs[fd - VFD_BASE] = vs
        th = self._cur
        try:
            for role, memfd in ((0, sr.rx_fd), (1, sr.tx_fd)):
                th.sock.sendall(struct.pack("<q", MAPRING))
                th.sock.sendmsg([struct.pack("<q", role)],
                                [(socket.SOL_SOCKET, socket.SCM_RIGHTS,
                                  struct.pack("<i", memfd))])
            self._reply(th, ret)
        except OSError:
            return ret  # channel died; the pump notices on its next read
        return _REPLIED

    def _fold_fast_ops(self) -> None:
        """Fold shim-local ring ops into the syscall counters and wake
        anything parked on a ring the guest touched. The op counter lives
        on the clock page (slot [2]; the fold cursor in [3] — ON the page
        so fork-shared pages fold each op exactly once, to whichever
        related process traps first; deterministic under strict
        turn-taking). Called on every received request: any shim-local
        activity strictly precedes the guest's next trap."""
        tm = self._time_map
        # socket oplog FIRST: replaying the shim's in-shim recv/send
        # sequence against the simulated transport — in arrival order,
        # before the trapped syscall is serviced — reproduces the slow
        # path's exact event schedule (window-update acks, drain wakes)
        nlog = struct.unpack_from("<q", tm, 8 * SHIM_PAGE_OPLOG_N)[0]
        if nlog:
            self._replay_oplog(tm, nlog)
            struct.pack_into("<q", tm, 8 * SHIM_PAGE_OPLOG_N, 0)
        ops, cur = struct.unpack_from("<qq", tm, 16)
        if ops == cur:
            return
        struct.pack_into("<q", tm, 24, ops)
        d = ops - cur
        c = self.host.counters
        c.add("syscalls", d)
        c.add("shim_fast_syscalls", d)
        # per-class census (informational: host.state_fingerprint filters
        # the shim_fast_ prefix, so these never gate determinism)
        for word, name in _SHIM_CLASS_COUNTERS:
            k = struct.unpack_from("<q", tm, 8 * word)[0]
            if k:
                struct.pack_into("<q", tm, 8 * word, 0)
                c.add(name, k)
        reg = self.host.controller.__dict__.get("_ring_registry")
        if reg:
            for pb in [p for p in reg if p.dirty()]:
                pb.clear_dirty()
                pb.wake()

    def _replay_oplog(self, tm, nlog: int) -> None:
        """Apply the shim's logged in-shim socket ops to the simulated
        transport, in order. Socket rings belong to the page OWNER (the
        root of a fork chain) — a child's trap folds the shared page, so
        replay resolves vfds through the owner's map."""
        owner = self
        while owner.parent_proc is not None:
            owner = owner.parent_proc
        for i in range(min(nlog, SHIM_OPLOG_MAX)):
            word = struct.unpack_from("<Q", tm, SHIM_OPLOG_OFF + 8 * i)[0]
            nbytes = word & 0xFFFFFFFF
            op = word >> 56
            idx = (word >> 32) & 0xFFFFFF
            vs = owner._oplog_vs.get(idx)
            sr = None if vs is None else vs.sockring
            if vs is None or sr is None:
                continue  # ring retired with ops in flight: cannot happen
                # mid-turn (close traps AFTER the fold); tolerated anyway
            if op == SHIM_OP_RECV:
                # the shim consumed nbytes from the RX ring (rpos already
                # advanced); drop the same prefix from the authoritative
                # buffer and let the receiver ack the window update
                del vs.rxbuf[:nbytes]
                owner._rx_consumed(vs)
            elif op == SHIM_OP_SEND:
                data = sr.tx_take(nbytes)
                accepted = 0
                if vs.endpoint is not None:
                    accepted = vs.endpoint.send(payload=bytes(data))
                if accepted != nbytes:
                    # the wbudget contract (send always accepts in full)
                    # broke — fail LOUDLY and fall back to the slow path
                    # forever on this connection
                    import sys as _sys

                    print(
                        f"shadow_tpu_torch: {self.host.name}/{self.name} socket"
                        f" ring replay short ({accepted}/{nbytes} vfd"
                        f" {VFD_BASE + idx}) — wbudget contract violated;"
                        f" ring disabled", file=_sys.stderr)
                    sr.kill()

    def _pump(self, th: GuestThread) -> None:
        """Service one thread's syscalls until it blocks in sim time, yields
        the turn, or the process exits."""
        self._cur = th
        if self._turn_timeout:
            # every read below is a turn-wait (the guest is never blocked
            # on US between our reply and its next request), so one socket
            # timeout covers the whole pump
            th.sock.settimeout(self._turn_timeout)
        while True:
            req = self._read_req(th)
            if req is _TIMEDOUT:
                prog = self._ring_progress()
                if prog is not None and prog != self._shim_prog:
                    # the shim moved its fast-plane rings (consumed RX /
                    # filled TX in-shim) during the window: the guest is
                    # streaming without syscalls, not livelocked — re-arm
                    # and keep waiting
                    self._shim_prog = prog
                    continue
                self._watchdog_fire(th)
                return
            if req is None:
                if th.slot == 0:
                    self._exited()  # main channel EOF == process death
                else:
                    self._thread_gone(th)
                return
            self._fold_fast_ops()
            nr, args = req
            # worker round-trip census by syscall number (bench audit
            # table; controller-scoped so fingerprints never see it)
            self._slow_nrs[nr] = self._slow_nrs.get(nr, 0) + 1
            try:
                ret = self._service(nr, args)
            except OSError:
                ret = -EFAULT  # guest memory went away (racing exit)
            if ret is _BLOCK:
                self._flush_cpu_lat()  # timeouts must see consumed CPU time
                self._trace(nr, args, "<blocked>")
                return
            if ret in (_DETACH, _EXITGROUP):
                self._flush_cpu_lat()
            if ret is _DETACH:
                # thread announced exit: reply so it can finish dying
                # natively, then never read its channel again
                self._trace(nr, args, 0)
                try:
                    self._reply(th, 0)
                except OSError:
                    pass
                return
            if ret is _EXECED:
                # the record now fronts the REPLACEMENT process; the old
                # image (this channel) is gone. The new main's first turn
                # grant is queued and drains when we return.
                self._trace(nr, args, "<execed>")
                return
            if ret is _REPLIED:
                # service sent its own (ancillary-carrying) reply inline
                self._trace(nr, args, "<inline>")
                self.host.counters.add("syscalls", 1)
                continue
            if ret is _EXITGROUP:
                self._trace(nr, args, 0)
                try:
                    self._reply(th, 0)
                except OSError:
                    pass
                self._kill_now()  # before any reap: the pid is still ours
                self._exited()
                return
            self._trace(nr, args, ret)
            if ret == RETRY_NATIVE and nr not in self.native_vfs:
                # reality boundary, default-on (VERDICT r3 item #7): the
                # worker declined this path/syscall and the shim re-issues
                # it against the host kernel — record the number even
                # without audit mode (audit mode additionally observes
                # the never-trapped numbers via the gadget-IP filter)
                self.native_vfs.add(nr)
                self.host.counters.add("native_passthrough_syscalls", 1)
            if self._syscall_latency == 0:
                # livelock detector: a guest spinning on nonblocking
                # syscalls at a frozen sim instant (e.g. sloppy epoll
                # usage) would hang the simulation silently
                if self.host.now != self._spin_t:
                    self._spin_t, self._spin_n = self.host.now, 0
                self._spin_n += 1
                if self._spin_n == 200_000:
                    import sys as _sys

                    print(
                        f"shadow_tpu_torch: {self.host.name}/{self.name} has made "
                        f"200000 syscalls without sim time advancing — guest "
                        f"busy-loop? Set general."
                        f"model_unblocked_syscall_latency: true to break it",
                        file=_sys.stderr)
            if self._syscall_latency:
                # model_unblocked_syscall_latency: each serviced syscall
                # advances this host's clock slightly, so busy-loops spin
                # forward in sim time instead of livelocking the round
                self._unapplied += self._syscall_latency
                if self._unapplied > self._max_unapplied:
                    self.host._now += self._unapplied
                    self._unapplied = 0
            try:
                self._reply(th, ret)
            except OSError:
                self._exited()
                return
            self.host.counters.add("syscalls", 1)

    def _ring_progress(self):
        """Shim-side SockRing cursor snapshot for the watchdog: RX read
        positions and TX write positions are the two cursors ONLY the shim
        advances (in-shim reads/writes, oplogged for later replay), so a
        change between two timeout windows proves the guest is alive in
        the fast plane. None when no live rings exist — then a silent
        guest has no syscall-free way to make progress and the watchdog
        fires on the first timeout, exactly as before the fast plane."""
        snap = None
        for fd, sr in self._sock_rings.items():
            if sr.dead:
                continue
            rx_r = struct.unpack_from("<Q", sr.rx, 8)[0]
            tx_w = struct.unpack_from("<Q", sr.tx, 16)[0]
            if snap is None:
                snap = []
            snap.append((fd, rx_r, tx_w))
        return None if snap is None else tuple(snap)

    def _watchdog_fire(self, th: GuestThread) -> None:
        """The guest held its turn past experimental.guest_turn_timeout
        wall seconds without making a syscall — a userspace spin-wait
        livelock (the README's declared turn-taking limitation). Kill the
        guest and convert the stall into the same host_down teardown the
        fault injector uses, so the simulation keeps its round loop (and
        its determinism for every OTHER host) instead of hanging forever.
        A stalled guest stalls every run, so the conversion is observed
        reproducibly; only the wall instant of detection varies."""
        host = self.host
        ctl = host.controller
        if getattr(ctl, "_supervised", False):
            # supervised run (supervise.py): escalate instead of
            # degrading in-sim. Kill the guest to unblock the pump, park
            # the named reason on the controller — it raises GuestStallError
            # at the next round boundary, and the supervisor restarts the
            # whole run from its re-execution snapshot (or scratch), which
            # regenerates every stream byte-identically. No in-sim
            # accounting (counters, host.crash) may record the stall: the
            # restarted run never saw it.
            msg = (f"guest watchdog: {host.name}/{self.name} held its turn "
                   f"for more than {self._turn_timeout:g}s wall without a "
                   f"syscall or fast-plane ring progress (wedged guest) — "
                   f"escalating to the supervisor")
            ctl.log.error(msg)
            ctl._stall_escalate = msg
            self._kill_now()
            self._exited()
            return
        msg = (f"guest watchdog: {host.name}/{self.name} held its turn for "
               f"more than {self._turn_timeout:g}s wall without a syscall "
               f"or fast-plane ring progress (spin-wait livelock?) — "
               f"killing the guest and downing the host (host_down)")
        host.controller.log.error(msg)
        host.log(msg, level="error")
        host.counters.add("guest_watchdog_kills", 1)
        self._signal_hint = -9  # killed by the watchdog
        self._kill_now()
        self._exited()
        # the host is going down: reap sibling MANAGED guests first, with
        # exit accounting — the stall killed the whole host, and a
        # sibling's live OS process must not outlive it (Host.crash's
        # .kill sweep would leave them respawnable, but a watchdog-downed
        # host records its guests as dead, not power-cycled)
        for p in host.processes:
            if p is not self:
                reap = getattr(p, "reap", None)
                if reap is not None:
                    reap()
        host.crash(host.now)

    def _resume(self, th: GuestThread, ret: int) -> None:
        """A continuation fired for a parked thread: queue its turn grant,
        and drain the grant queue unless a thread is already being pumped
        (then the drain happens when the active thread yields)."""
        if not self.running or th.dead:
            return
        th.waiting = None
        self._ready.append((th, ret))
        if not self._pumping:
            self._drain_ready()

    def _drain_ready(self) -> None:
        self._pumping = True
        try:
            while self._ready and self.running:
                th, ret = self._ready.pop(0)
                if th.dead:
                    continue
                self._cur = th
                if ret is _EMBRYO:
                    # first grant of a freshly spawned thread: read its
                    # THREAD_HELLO (blocks in real time only, bounded —
                    # the guest's real pthread_create may have FAILED
                    # after the slot was minted, and then nobody ever
                    # speaks on this channel)
                    th.sock.settimeout(HANDSHAKE_TIMEOUT_S)
                    try:
                        req = self._read_req(th)
                    finally:
                        if th.sock is not None:
                            th.sock.settimeout(None)
                    if req is None or req[0] != THREAD_HELLO:
                        self._thread_gone(th)
                        continue
                    th.waiting = None
                    ret = 0
                self._trace(-1, (), f"<resumed> = {ret}")
                try:
                    self._reply(th, ret)
                except OSError:
                    self._exited()
                    return
                self.host.counters.add("syscalls", 1)
                self._pump(th)
        finally:
            self._pumping = False

    def _close_vs(self, vs: VSocket) -> None:
        """Drop one fd-table reference; tear down the backing object only
        when the last reference (across forked processes) goes away."""
        vs.refs -= 1
        if vs.refs > 0:
            return
        if vs.kind in ("file", "dir"):
            self.vfs.close(vs)
            return
        if vs.listening:
            self.host.unlisten(vs.bound_port)
        if vs.sockring is not None:
            # every fd-table reference closed -> every shim mapping was
            # dropped before its close trap forwarded; safe to unmap
            vs.sockring.retire()
            vs.sockring = None
        if vs.endpoint is not None:
            vs.endpoint.close()
        if vs.pipe is not None:
            vs.pipe.wake()  # refs hit 0: EOF readers / EPIPE writers
        if vs.pipe_out is not None:
            vs.pipe_out.wake()

    def _thread_gone(self, th: GuestThread) -> None:
        """A non-main thread announced exit (or its channel died)."""
        th.dead = True
        for q in list(self.futexes.values()):
            q[:] = [(t, m) for (t, m) in q if t is not th]
        if th.joiners:
            th.joined = True
        for j in th.joiners:
            self._resume(j, th.retval)
        th.joiners = []

    # -- guest threads (reference analog: Process/ManagedThread ------------
    #    per SURVEY.md §2; strict one-runnable-thread turn-taking) ---------
    def _spawn_thread(self):
        slot = None
        # recycle a dead, fully-joined slot first (its worker-side socket
        # closes here; the guest's dup2 onto the reserved fd replaces the
        # stale guest end) — the 31-slot window caps CONCURRENT threads,
        # not threads-over-a-lifetime
        for s in sorted(self.threads):
            t = self.threads[s]
            if s != 0 and t.dead and t.joined and not t.joiners:
                if t.sock is not None:
                    t.sock.close()
                slot = s
                break
        if slot is None:
            if self._next_slot >= MAX_THREADS:
                return -EAGAIN
            slot = self._next_slot
            self._next_slot += 1
        parent, child = socket.socketpair(socket.AF_UNIX, socket.SOCK_STREAM)
        nt = GuestThread(slot, parent)
        nt.waiting = ("embryo",)  # until its THREAD_HELLO is read
        self.threads[slot] = nt
        # reply carries the slot in-band plus the new channel's guest end
        # as SCM_RIGHTS ancillary data (the shim recvmsg's this one reply)
        self._time_map[:8] = struct.pack("<q", emulated(self.host.now))
        socket.send_fds(self._cur.sock, [struct.pack("<q", slot)],
                        [child.fileno()])
        child.close()
        # grant the embryo its first turn once the spawner yields
        self._ready.append((nt, _EMBRYO))
        return _REPLIED

    def _mmap_vfd(self, args):
        """mmap over a virtualized file (the arg4-conditional trap): reply
        with a real kernel fd as SCM_RIGHTS — the host-tree backing fd, or
        a memfd snapshot for synthesized content — and the shim re-issues
        the map with it through the gadget, then closes the temporary fd.
        Deterministic: only this simulation writes the backing files, and
        synthesized snapshots are pure functions of the config."""
        fd = _sfd(args[4])
        vs = self.fds.get(fd)
        if vs is None:
            return -EBADF
        if vs.kind != "file" or vs.vfile is None:
            return -19  # ENODEV: directories/sockets are not mappable
        vf = vs.vfile
        if vf.fd is not None:
            send = vf.fd
            tmp = None
        else:
            tmp = os.memfd_create("shadow-synth")
            os.write(tmp, vf.data)
            send = tmp
        self._time_map[:8] = struct.pack("<q", emulated(self.host.now))
        try:
            socket.send_fds(self._cur.sock, [struct.pack("<q", 0)], [send])
        finally:
            if tmp is not None:
                os.close(tmp)
        return _REPLIED

    def _join_thread(self, slot: int):
        target = self.threads.get(slot)
        if target is None or target is self._cur:
            return -EINVAL
        if target.dead:
            target.joined = True
            return target.retval
        target.joiners.append(self._cur)
        self._waiting = ("join", target)
        return _BLOCK

    # -- fork (reference analog: Process::spawn's sibling path — a managed
    #    guest forking a managed child, SURVEY.md §3.2; the real fork runs
    #    SHIM-side, the worker mints the child's channel and adopts it) ----
    def _fork_intent(self):
        eid = len(self._embryos)
        parent_sock, child_sock = socket.socketpair(
            socket.AF_UNIX, socket.SOCK_STREAM)
        self._embryos[eid] = parent_sock
        self._time_map[:8] = struct.pack("<q", emulated(self.host.now))
        socket.send_fds(self._cur.sock, [struct.pack("<q", eid)],
                        [child_sock.fileno()])
        child_sock.close()
        return _REPLIED

    def _fork_commit(self, eid: int, real_pid: int):
        sock = self._embryos.pop(eid, None)
        if sock is None:
            return -EINVAL
        child = ManagedProcess.adopt(self, sock, real_pid)
        self.children.append(child)
        # grant the child its first turn once the parent yields; the child
        # parks in THREAD_HELLO inside its (copied) SIGSYS frame
        child._ready.append((child.threads[0], _EMBRYO))
        self.host.schedule_in(0, child._kick)
        return child.vpid

    @classmethod
    def adopt(cls, parent: "ManagedProcess", sock, real_pid: int):
        """Register a forked guest as a managed process of the same host.

        Built on __init__ (which is side-effect-free) so new runtime fields
        never need mirroring here; only the fork-specific identity and the
        fd-table snapshot are overridden."""
        import copy
        from dataclasses import replace as dc_replace

        host = parent.host
        ctl = host.controller
        seq = getattr(ctl, "_fork_seq", 0)
        ctl._fork_seq = seq + 1
        opts = dc_replace(copy.copy(parent.opts), expected_final_state=None)
        self = cls(host, opts, 0)
        self.name = f"{Path(parent.opts.path).name}.f{seq}"
        seqv = getattr(ctl, "_vpid_seq", 40000)
        ctl._vpid_seq = seqv + 1
        self.vpid = seqv  # deterministic: fork order is deterministic
        self.proc = None  # not our OS child — the guest parent's
        self.real_pid = real_pid
        self.mem = ProcessMemory(real_pid)
        self.sock = sock
        self._time_map = parent._time_map  # same mapped clock page
        # fork semantics: the fd table is a snapshot sharing open file
        # descriptions (refcounted); per-process capture files stay fresh
        self.fds = dict(parent.fds)
        self.fd_cloexec = set(parent.fd_cloexec)
        if hasattr(parent, "_rlimits"):  # setrlimit overrides inherit
            self._rlimits = dict(parent._rlimits)
        for vs in self.fds.values():
            vs.refs += 1
            if vs.pipe is not None:
                vs.pipe.procs.add(self)
            if vs.pipe_out is not None:
                vs.pipe_out.procs.add(self)
        self._next_vfd = parent._next_vfd
        self.vfs.cwd = parent.vfs.cwd
        self.threads = {0: GuestThread(0, sock)}
        self._cur = self.threads[0]
        self.parent_proc = parent
        self.running = True
        self.spawned = True
        self._open_strace()
        jdir = getattr(ctl, "guest_journal_dir", None)
        if jdir is not None:
            self._journal = GuestJournal(
                jdir / f"{host.name}.{self.name}.guest_oplog.jsonl")
        host.processes.append(self)
        ctl.processes.append(self)
        host.counters.add("processes_spawned", 1)
        note = getattr(ctl, "note_guest_pid", None)
        if note is not None:
            note(self)
        return self

    def _kick(self) -> None:
        if self.running and not self._pumping:
            self._drain_ready()

    def _flush_cpu_lat(self) -> None:
        """Apply accumulated-but-unapplied modeled CPU latency. Reference
        semantics: unapplied latency flushes at blocking points so sleep/
        poll timeouts are computed against the true consumed-CPU clock."""
        if self._unapplied:
            self.host._now += self._unapplied
            self._unapplied = 0

    def _kill_now(self) -> None:
        """SIGKILL the guest synchronously (exit_group: sibling threads
        must die too). Safe against pid reuse: called before the pid is
        reaped, so it is at worst a zombie that still belongs to us."""
        pid = self.proc.pid if self.proc is not None else self.real_pid
        if pid is not None:
            try:
                os.kill(pid, 9)
            except ProcessLookupError:
                pass

    # -- round-5 syscall-family breadth (SURVEY §2 SyscallHandler) ---------
    #: deterministic resource limits, part of the virtual identity
    #: (res -> (cur, max)); RLIM_INFINITY for everything unlisted
    _RLIM_INF = (1 << 64) - 1
    _RLIMITS_DEFAULT = {
        3: (8 << 20, _RLIM_INF),   # RLIMIT_STACK
        4: (0, _RLIM_INF),         # RLIMIT_CORE
        6: (4096, 4096),           # RLIMIT_NPROC
        7: (1024, 1 << 20),        # RLIMIT_NOFILE
        12: (819200, 819200),      # RLIMIT_MSGQUEUE
    }

    def _rlimit_get(self, res: int):
        ovr = getattr(self, "_rlimits", None)
        if ovr and res in ovr:
            return ovr[res]
        return self._RLIMITS_DEFAULT.get(res, (self._RLIM_INF,
                                               self._RLIM_INF))

    def _rlimit(self, nr: int, args):
        """getrlimit/setrlimit/prlimit64: a deterministic limit table
        (virtual identity) with per-process overrides. prlimit64 serves
        self (pid 0 or own vpid) only."""
        if nr == SYS_prlimit64:
            pid, res, newp, oldp = args[0], args[1], args[2], args[3]
            pid &= 0xFFFFFFFF
            if pid not in (0, self.vpid):
                return -EPERM
        else:
            res, ptr = args[0], args[1]
            newp = ptr if nr == SYS_setrlimit else 0
            oldp = ptr if nr == SYS_getrlimit else 0
        if res > 15:
            return -EINVAL
        if oldp:
            cur, mx = self._rlimit_get(res)
            self.mem.write(oldp, struct.pack("<QQ", cur, mx))
        if newp:
            cur, mx = struct.unpack("<QQ", self.mem.read(newp, 16))
            if cur > mx:
                return -EINVAL
            if not hasattr(self, "_rlimits"):
                self._rlimits = {}
            self._rlimits[res] = (cur, mx)
        return 0

    def _sigaltstack(self, th: GuestThread, args):
        """Bookkeeping + native passthrough: the record keeps strace and
        determinism surfaces coherent, while the real kernel stack switch
        still happens (genuine faults — e.g. the TSC SIGSEGV service —
        must honor the guest's alternate stack)."""
        ss_ptr, old_ptr = args[0], args[1]
        if old_ptr:
            sp, fl, sz = th.altstack or (0, 2, 0)  # SS_DISABLE when unset
            self.mem.write(old_ptr, struct.pack("<QiiQ", sp, fl, 0, sz))
        if ss_ptr:
            sp, fl, _pad, sz = struct.unpack("<QiiQ",
                                             self.mem.read(ss_ptr, 24))
            if not (fl & 2) and sz < 2048:  # MINSIGSTKSZ
                return -12  # ENOMEM
            th.altstack = (sp, fl, sz)
        return RETRY_NATIVE

    def _sendfile(self, args, th: GuestThread = None):
        """sendfile(2): virtual file -> simulated socket or pipe. Reads
        at the explicit offset (or the file position), sends what the
        destination accepts NOW, and advances by exactly the returned
        count (POSIX); a blocking socket with no room parks and retries
        whole (see _on_drain). All-real-fd calls pass through native."""
        out_fd, in_fd, off_ptr, count = args[0], args[1], args[2], args[3]
        out_vs = self.fds.get(out_fd)
        in_vs = self.fds.get(in_fd)
        if in_vs is None and out_vs is None:
            return RETRY_NATIVE
        if in_vs is None or in_vs.kind != "file":
            return -EINVAL
        if out_vs is None:
            return -EBADF
        count = min(count, 1 << 20)
        off = None
        if off_ptr:
            off = struct.unpack("<q", self.mem.read(off_ptr, 8))[0]
            data = self.vfs.pread(in_vs, count, off)
        else:
            data = self.vfs.pread(in_vs, count, in_vs.vfile.off)
        if isinstance(data, int):
            return data
        if not data:
            return 0
        if out_vs.kind in ("pipe_w", "spair"):
            pb = self._wbuf(out_vs)
            if pb is None or pb.readers == 0:
                return -EPIPE
            k = min(len(data), pb.room())
            if k <= 0:
                if out_vs.nonblock:
                    return -EAGAIN
                tgt = th if th is not None else self._cur
                tgt.waiting = ("sendfile", out_vs, args)
                self._park_on(pb, tgt)
                return _BLOCK
            pb.append_bytes(data[:k])
            pb.wake()
        elif out_vs.endpoint is not None and out_vs.connected:
            if out_vs.peer_closed:
                return -EPIPE
            k = out_vs.endpoint.send(payload=data)
            if k <= 0:
                if out_vs.nonblock:
                    return -EAGAIN
                tgt = th if th is not None else self._cur
                tgt.waiting = ("sendfile", out_vs, args)
                return _BLOCK
        else:
            return -EINVAL
        if off_ptr:
            self.mem.write(off_ptr, struct.pack("<q", off + k))
        else:
            in_vs.vfile.off += k
        return k

    def _signalfd(self, args, four: bool):
        """signalfd(4): a virtual signal fd. Model: an emulated kill(2)
        whose signal is in a signalfd's mask is captured there (the
        blocked-signal semantics real callers set up; per-thread signal
        masks are not otherwise modeled — documented scope)."""
        fd, mask_ptr = _sfd(args[0]), args[1]
        mask = struct.unpack("<Q", self.mem.read(mask_ptr, 8))[0]
        flags = args[3] if four else 0
        if fd == -1:
            vs = VSocket(self._next_vfd, "sigfd")
            self._next_vfd += 1
            vs.sig_mask = mask
            if flags & 0o4000:  # SFD_NONBLOCK
                vs.nonblock = True
            if flags & O_CLOEXEC:
                self.fd_cloexec.add(vs.vfd)
            self.fds[vs.vfd] = vs
            return vs.vfd
        vs = self.fds.get(fd)
        if vs is None or vs.kind != "sigfd":
            return -EINVAL
        vs.sig_mask = mask
        return fd

    _SFD_SIZE = 128  # sizeof(struct signalfd_siginfo)

    def _sigfd_read(self, vs: VSocket, bufaddr: int, buflen: int):
        if buflen < self._SFD_SIZE:
            return -EINVAL
        if not vs.sig_q:
            if vs.nonblock:
                return -EAGAIN
            self._waiting = ("sigread", vs, bufaddr, buflen)
            return _BLOCK
        out = b""
        while vs.sig_q and len(out) + self._SFD_SIZE <= buflen:
            signo, spid = vs.sig_q.pop(0)
            rec = bytearray(self._SFD_SIZE)
            struct.pack_into("<IiiII", rec, 0, signo, 0, 0, spid, 0)
            out += bytes(rec)
        self.mem.write(bufaddr, out)
        return len(out)

    def _sigfd_deliver(self, sig: int, sender_vpid: int) -> bool:
        """Queue sig on the first signalfd whose mask has it; wake its
        reader/pollers. Returns True if captured."""
        for vs in self.fds.values():
            if vs.kind == "sigfd" and (vs.sig_mask >> (sig - 1)) & 1:
                vs.sig_q.append((sig, sender_vpid))
                th, w = self._find_waiter((("sigread",), vs))
                if th is not None:
                    self._resume(th, self._sigfd_read(vs, w[2], w[3]))
                else:
                    self._notify()
                return True
        return False

    def _splice(self, args, tee: bool, th: GuestThread = None):
        """splice/tee between virtual pipes (and file->pipe for splice).
        Progress-now semantics with parking on an empty blocking input;
        all-real-fd calls pass through native."""
        if tee:
            fd_in, fd_out, count = args[0], args[1], args[2]
            off_in = off_out = 0
        else:
            fd_in, off_in, fd_out, off_out, count = (
                args[0], args[1], args[2], args[3], args[4])
        in_vs = self.fds.get(fd_in)
        out_vs = self.fds.get(fd_out)
        if in_vs is None and out_vs is None:
            return RETRY_NATIVE
        count = min(count, 1 << 20)
        # destination must be a virtual pipe (or file for splice-out)
        if out_vs is not None and out_vs.kind == "pipe_w":
            pb_out = out_vs.pipe
        else:
            pb_out = None
        if in_vs is not None and in_vs.kind == "pipe_r":
            pb_in = in_vs.pipe
            if pb_in is None:
                return 0
            if off_in:
                return -ESPIPE
            avail = pb_in.avail()
            if avail == 0:
                if pb_in.writers == 0:
                    return 0
                if in_vs.nonblock:
                    return -EAGAIN
                tgt = th if th is not None else self._cur
                tgt.waiting = ("splice", in_vs, args, tee)
                self._park_on(pb_in, tgt)
                return _BLOCK
            if tee:
                if pb_out is None or pb_out.readers == 0:
                    return -EINVAL if pb_out is None else -EPIPE
                k = min(avail, count, pb_out.room())
                if k <= 0:  # output full: block like tee(2), never 0
                    if out_vs.nonblock:
                        return -EAGAIN
                    tgt = th if th is not None else self._cur
                    tgt.waiting = ("splice", out_vs, args, tee)
                    self._park_on(pb_out, tgt)
                    return _BLOCK
                pb_out.append_bytes(pb_in.peek(k))  # tee: no consume
                pb_out.wake()
                return k
            if pb_out is not None:
                if pb_out.readers == 0:
                    return -EPIPE
                k = min(avail, count, pb_out.room())
                if k <= 0:  # output full: block like splice(2)
                    if out_vs.nonblock:
                        return -EAGAIN
                    tgt = th if th is not None else self._cur
                    tgt.waiting = ("splice", out_vs, args, tee)
                    self._park_on(pb_out, tgt)
                    return _BLOCK
                pb_out.append_bytes(pb_in.take(k))
                pb_in.wake()
                pb_out.wake()
                return k
            if out_vs is not None and out_vs.kind == "file":
                # write FIRST, consume what was actually written (an
                # error or short write must not lose pipe bytes)
                k = min(avail, count)
                data = pb_in.peek(k)
                if off_out:
                    off = struct.unpack("<q",
                                        self.mem.read(off_out, 8))[0]
                    r = self.vfs.pwrite(out_vs, data, off)
                else:
                    r = self.vfs.write(out_vs, data)
                if r > 0:
                    pb_in.take(r)
                    pb_in.wake()
                    if off_out:
                        self.mem.write(off_out,
                                       struct.pack("<q", off + r))
                return r
            return -EINVAL
        if (not tee and in_vs is not None and in_vs.kind == "file"
                and pb_out is not None):
            if pb_out.readers == 0:
                return -EPIPE
            k = min(count, pb_out.room())
            if k <= 0:
                return -EAGAIN
            if off_in:
                off = struct.unpack("<q", self.mem.read(off_in, 8))[0]
                data = self.vfs.pread(in_vs, k, off)
            else:
                data = self.vfs.pread(in_vs, k, in_vs.vfile.off)
            if isinstance(data, int):
                return data
            if not data:
                return 0
            if off_in:
                self.mem.write(off_in,
                               struct.pack("<q", off + len(data)))
            else:
                in_vs.vfile.off += len(data)
            pb_out.append_bytes(data)
            pb_out.wake()
            return len(data)
        return -EINVAL

    # -- inotify (directory watches over the virtual file surface) ---------
    _INO_HDR = struct.Struct("<iIII")  # wd, mask, cookie, len

    def _inotify_init(self, flags: int):
        vs = VSocket(self._next_vfd, "inotify")
        self._next_vfd += 1
        if flags & 0o4000:  # IN_NONBLOCK
            vs.nonblock = True
        if flags & O_CLOEXEC:
            self.fd_cloexec.add(vs.vfd)
        self.fds[vs.vfd] = vs
        return vs.vfd

    def _inotify_add(self, args):
        """Watches on DIRECTORIES within the worker-served tree; events
        are generated for direct children at the vfs mutation points
        (create/delete/move/modify — the families real build tools and
        event loops watch for). Self-events and native-passthrough paths
        are out of scope (documented)."""
        vs = self.fds.get(args[0])
        if vs is None or vs.kind != "inotify":
            return -EINVAL
        path = self.vfs._path_arg(args[1])
        if path is None:
            return -EFAULT
        r = self.vfs.resolve(AT_FDCWD, path)
        if r is None or r[0] == "synth":
            return -EPERM  # only the worker-served tree is watchable
        real = r[1]
        if not os.path.isdir(real):
            return -20  # ENOTDIR (file watches: out of scope)
        real = real.rstrip("/")
        wmask = args[2] & 0xFFFFFFFF
        for wd, (p, _m) in vs.watches.items():
            if p == real:
                vs.watches[wd] = (real, wmask)
                return wd
        wd = vs.next_wd
        vs.next_wd += 1
        vs.watches[wd] = (real, wmask)
        return wd

    def _inotify_rm(self, args):
        vs = self.fds.get(args[0])
        if vs is None or vs.kind != "inotify":
            return -EINVAL
        if args[1] not in vs.watches:
            return -EINVAL
        del vs.watches[args[1]]
        return 0

    def _ino_read(self, vs: VSocket, bufaddr: int, buflen: int):
        if not vs.ino_q:
            if vs.nonblock:
                return -EAGAIN
            self._waiting = ("inoread", vs, bufaddr, buflen)
            return _BLOCK
        out = b""
        while vs.ino_q and len(out) + len(vs.ino_q[0]) <= buflen:
            out += vs.ino_q.pop(0)
        if not out:
            return -EINVAL  # buffer smaller than the next event
        self.mem.write(bufaddr, out)
        return len(out)

    def _ino_mutate(self, real_path: str, mask: int, cookie: int = 0):
        """A vfs mutation happened at ``real_path``: deliver an event to
        every inotify watch (ANY process on this host — the tree is
        shared) whose directory is the path's parent."""
        parent = os.path.dirname(real_path.rstrip("/"))
        name = os.path.basename(real_path.rstrip("/"))
        nb = name.encode()
        pad = (-(len(nb) + 1)) % 8 + 1  # NUL + align to 8
        seen: set = set()  # fork/dup share VSockets: queue + wake ONCE
        for proc in self.host.processes:
            for vs in getattr(proc, "fds", {}).values():
                if vs.kind != "inotify" or id(vs) in seen:
                    continue
                seen.add(id(vs))
                for wd, (wpath, wmask) in vs.watches.items():
                    if wpath != parent or not (wmask & mask & 0xFFF):
                        continue
                    rec = (self._INO_HDR.pack(wd, mask, cookie,
                                              len(nb) + pad)
                           + nb + b"\0" * pad)
                    # coalesce identical consecutive unread events
                    # (kernel behavior for e.g. repeated IN_MODIFY)
                    if vs.ino_q and vs.ino_q[-1] == rec:
                        continue
                    vs.ino_q.append(rec)
                    # the blocked reader may be ANY process sharing the
                    # fd (fork); wake the first match, notify the rest
                    for p2 in self.host.processes:
                        fw = getattr(p2, "_find_waiter", None)
                        if fw is None:
                            continue
                        th, w = fw((("inoread",), vs))
                        if th is not None:
                            p2._resume(th, p2._ino_read(vs, w[2], w[3]))
                            break
                    else:
                        for p2 in self.host.processes:
                            if getattr(p2, "running", False):
                                p2._notify()

    def _kill(self, args):
        """kill(2) between managed guests of one simulated host: vpid
        resolution + DEFAULT dispositions emulated worker-side (terminate /
        ignore). Real in-guest handler delivery is out of scope — the
        turn-taking protocol admits no out-of-turn syscalls (a handler
        firing inside a parked syscall would corrupt the channel)."""
        pid = args[0] & 0xFFFFFFFF
        if pid >= (1 << 31):
            pid -= 1 << 32
        sig = args[1] & 0xFFFFFFFF
        if sig > 64:
            return -EINVAL
        if pid <= 0:
            return -EPERM  # process groups: not modeled
        target = None
        for p in self.host.processes:
            if getattr(p, "vpid", None) == pid and p.running:
                target = p
                break
        if target is None:
            return -ESRCH
        if sig == 0:
            return 0  # existence probe
        if sig != 9 and target._sigfd_deliver(sig, self.vpid):
            return 0  # captured by a signalfd (blocked-signal semantics)
        if sig in _IGN_SIGS or sig not in _TERM_SIGS and sig != 9:
            return 0  # default-ignore, or dispositions we don't model
        target._signal_hint = -sig
        if target is self:
            # self-signal with a fatal default: terminate after the reply
            self._exit_hint = None
            return _EXITGROUP
        target._kill_now()
        # the victim's channel EOF is collected here so its death (and
        # any wait4 wakeup) lands at THIS sim instant, deterministically
        target._exited()
        return 0

    def _wait4(self, args):
        # pid is a C int: only the low 32 bits are defined (the ABI leaves
        # the upper half of the register unspecified for int args)
        pid = args[0] & 0xFFFFFFFF
        if pid >= (1 << 31):
            pid -= 1 << 32
        status_ptr, options = args[1], args[2]
        matches = [c for c in self.children
                   if not c.reaped and (pid in (-1, 0) or c.vpid == pid)]
        if not matches:
            return -ECHILD
        dead = [c for c in matches if not c.running]
        if dead:
            return self._reap_child(dead[0], status_ptr)
        if options & WNOHANG:
            return 0
        self._waiting = ("waitchild", pid, status_ptr)
        return _BLOCK

    def _reap_child(self, c: "ManagedProcess", status_ptr: int) -> int:
        c.reaped = True
        code = c.exit_code if c.exit_code is not None else 0
        status = (-code if code < 0 else (code & 0xFF) << 8)  # signal|exit
        if status_ptr:
            self.mem.write(status_ptr, struct.pack("<i", status))
        return c.vpid

    def _child_exited(self, c: "ManagedProcess") -> None:
        """A forked child died: wake a parked wait4 if it matches."""
        for slot in sorted(self.threads):
            th = self.threads[slot]
            w = th.waiting
            if (w and not th.dead and w[0] == "waitchild"
                    and (w[1] in (-1, 0) or w[1] == c.vpid)):
                self._resume(th, self._reap_child(c, w[2]))
                return

    def _fstat(self, fd: int, buf: int):
        """struct stat for a virtual descriptor: enough for stdio/io.open
        (st_mode by kind, st_blksize, zero size)."""
        vs = self.fds.get(fd)
        if vs is None:
            return -EBADF
        if vs.kind in ("file", "dir"):
            self.mem.write(buf, self.vfs.fstat_bytes(vs))
            return 0
        mode = {"pipe_r": 0o010600, "pipe_w": 0o010600,  # S_IFIFO
                "stream": 0o140777, "dgram": 0o140777,   # S_IFSOCK
                "spair": 0o140777,
                }.get(vs.kind, 0o0600)  # epoll/timer/event: anon inode
        st = bytearray(144)  # struct stat, x86-64 layout
        struct.pack_into("<QQQIII", st, 0, 0, fd, 1, mode, 0, 0)
        struct.pack_into("<qq", st, 48, 0, 4096)  # st_size, st_blksize
        sec = emulated(self.host.now) // NS_PER_SEC
        for off in (72, 88, 104):  # st_atime / st_mtime / st_ctime .tv_sec
            struct.pack_into("<q", st, off, sec)
        self.mem.write(buf, bytes(st))
        return 0

    # -- pipes + dup (descriptor-table breadth; pipes work across fork) ----
    def _ring_bufs(self, n: int) -> list:
        """``n`` guest-shared memory rings (native/shring.h — the shim
        serves non-blocking ops locally, zero worker round trips) when
        eligible; plain worker-side buffers under strace / modeled
        syscall latency, which must see every call."""
        if (_FASTPATH_ON and self._strace is None
                and self._syscall_latency == 0):
            reg = self.host.controller.__dict__.setdefault(
                "_ring_registry", {})
            return [RingPipeBuf(reg) for _ in range(n)]
        return [PipeBuf() for _ in range(n)]

    def _pipe(self, fds_ptr: int, flags: int):
        (pb,) = self._ring_bufs(1)
        pb.procs.add(self)
        r = VSocket(self._next_vfd, "pipe_r")
        w = VSocket(self._next_vfd + 1, "pipe_w")
        self._next_vfd += 2
        r.pipe = w.pipe = pb
        pb.r_end, pb.w_end = r, w
        pb.sync_refs()  # the shared header must see readers/writers NOW:
        # the shim's local-write gate checks readers == 0 (EPIPE path)
        if flags & 0o4000:  # O_NONBLOCK
            r.nonblock = w.nonblock = True
        if flags & O_CLOEXEC:
            self.fd_cloexec.update((r.vfd, w.vfd))
        self.fds[r.vfd] = r
        self.fds[w.vfd] = w
        self.mem.write(fds_ptr, struct.pack("<ii", r.vfd, w.vfd))
        return 0

    def _socketpair(self, args):
        """AF_UNIX socketpair(2): a duplex pair modeled as two cross-
        wired PipeBufs (bash process substitution, mux/IPC idioms; works
        across fork like pipes)."""
        if args[0] != 1:  # AF_UNIX only
            return -EAFNOSUPPORT
        if (args[1] & 0xFF) != 1:  # SOCK_STREAM only — datagram pairs
            return -93  # EPROTONOSUPPORT: fail loudly, not mis-frame
        a = VSocket(self._next_vfd, "spair")
        b = VSocket(self._next_vfd + 1, "spair")
        self._next_vfd += 2
        # each direction is one ring; an end maps its read ring (role 0)
        # and its write ring (role 1) via separate offers
        ab, ba = self._ring_bufs(2)
        ab.procs.add(self)
        ba.procs.add(self)
        ab.w_end, ab.r_end = a, b
        ba.w_end, ba.r_end = b, a
        a.pipe, a.pipe_out = ba, ab
        b.pipe, b.pipe_out = ab, ba
        ab.sync_refs()  # headers must see readers/writers NOW (shim gate)
        ba.sync_refs()
        if args[1] & 0o4000:  # SOCK_NONBLOCK
            a.nonblock = b.nonblock = True
        if args[1] & O_CLOEXEC:
            self.fd_cloexec.update((a.vfd, b.vfd))
        self.fds[a.vfd] = a
        self.fds[b.vfd] = b
        self.mem.write(args[3], struct.pack("<ii", a.vfd, b.vfd))
        return 0

    def _dup(self, oldfd: int, newfd):
        vs = self.fds.get(oldfd)
        if vs is None:
            return -EBADF
        if newfd == oldfd:
            return newfd  # dup2(x, x): POSIX no-op, closes nothing
        if newfd is None:
            newfd = self._next_vfd
            self._next_vfd += 1
        else:
            old = self.fds.pop(newfd, None)
            if old is not None:
                self._close_vs(old)
            self._ring_offered.discard((newfd, 0))  # rebound fd number
            self._ring_offered.discard((newfd, 1))
            self._drop_fast_fd(newfd)
        vs.refs += 1
        self.fds[newfd] = vs
        self.fd_cloexec.discard(newfd)  # dup/dup2 clear FD_CLOEXEC
        return newfd

    def _pipe_read(self, vs: VSocket, iovs, peek: bool = False):
        pb = vs.pipe
        if pb is None:  # SHUT_RD half of a shutdown socketpair
            return 0
        if pb.avail():
            k = min(pb.avail(), sum(ln for _, ln in iovs))
            if peek:  # MSG_PEEK: leave the data in place
                self._scatter(iovs, pb.peek(k))
                return k
            self._scatter(iovs, pb.take(k))
            pb.wake()  # writers may have room now
            return k
        if pb.writers == 0:
            return 0  # EOF
        if vs.nonblock:
            return -EAGAIN
        self._cur.waiting = ("pipe_r", vs, iovs, peek)
        self._park_on(pb)
        return _BLOCK

    PIPE_BUF = 4096  # POSIX atomicity bound for pipe writes

    def _wbuf(self, vs: VSocket):
        return vs.pipe_out if vs.kind == "spair" else vs.pipe

    def _park_on(self, pb: PipeBuf, th: GuestThread = None) -> None:
        """Park a thread (default: the current one) on a pipe; ring pipes
        flag the shared header so the shim marks local ops dirty for the
        wake scan."""
        pb.waiting.append((self, th if th is not None else self._cur))
        pb.set_waiters(True)

    def _pipe_write(self, vs: VSocket, data: bytes):
        pb = self._wbuf(vs)
        if pb is None:  # SHUT_WR half of a shutdown socketpair
            return -EPIPE
        if pb.readers == 0:
            return -EPIPE
        room = pb.room()
        atomic = len(data) <= self.PIPE_BUF  # never split small writes
        if room <= 0 or (atomic and room < len(data)):
            if vs.nonblock:
                return -EAGAIN
            self._cur.waiting = ("pipe_w", vs, data, 0)
            self._park_on(pb)
            return _BLOCK
        k = min(room, len(data))
        pb.append_bytes(data[:k])
        pb.wake()
        if k == len(data) or vs.nonblock:
            return k  # nonblocking large writes may be short, as on Linux
        # blocking write(2) returns only once ALL bytes are transferred
        self._cur.waiting = ("pipe_w", vs, data[k:], k)
        self._park_on(pb)
        return _BLOCK

    def _pipe_retry(self, th: GuestThread, w) -> None:
        """Re-attempt a parked pipe op (called from PipeBuf.wake)."""
        if w[0] == "sendfile":
            r = self._sendfile(w[2], th=th)
            if r is not _BLOCK:
                self._resume(th, r)
            return
        if w[0] == "splice":
            r = self._splice(w[2], w[3], th=th)
            if r is not _BLOCK:
                self._resume(th, r)
            return
        vs = w[1]
        pb = vs.pipe
        if w[0] == "pipe_r":
            if pb.avail():
                k = min(pb.avail(), sum(ln for _, ln in w[2]))
                if len(w) > 3 and w[3]:  # MSG_PEEK leaves the data
                    self._scatter(w[2], pb.peek(k))
                else:
                    self._scatter(w[2], pb.take(k))
                    pb.wake()
                self._resume(th, k)
            elif pb.writers == 0:
                self._resume(th, 0)
            else:
                self._park_on(pb, th)
            return
        data, done = w[2], w[3]
        pb = self._wbuf(vs)
        if pb.readers == 0:
            self._resume(th, done if done else -EPIPE)
            return
        room = pb.room()
        atomic = done == 0 and len(data) <= self.PIPE_BUF
        if room <= 0 or (atomic and room < len(data)):
            self._park_on(pb, th)
            return
        k = min(room, len(data))
        pb.append_bytes(data[:k])
        if k == len(data):
            self._resume(th, done + k)
        else:
            th.waiting = ("pipe_w", vs, data[k:], done + k)
            pb.waiting.append((self, th))
        pb.wake()

    # -- futex emulation (reference analog: syscall handler futex family;
    #    required so lock handoffs between parked threads cannot deadlock
    #    the strict turn-taking protocol) ----------------------------------
    def _futex(self, args):
        uaddr, val = args[0], args[2] & 0xFFFFFFFF
        op = args[1] & 0x7F
        abs_realtime = bool(args[1] & FUTEX_CLOCK_REALTIME)
        if op in (FUTEX_WAIT, FUTEX_WAIT_BITSET):
            cur = struct.unpack("<I", self.mem.read(uaddr, 4))[0]
            if cur != val:
                return -EAGAIN
            mask = (args[5] & 0xFFFFFFFF if op == FUTEX_WAIT_BITSET
                    else FUTEX_BITSET_ALL)
            if mask == 0:
                return -EINVAL
            th = self._cur
            token = object()
            if args[3]:  # timeout pointer
                sec, nsec = struct.unpack("<qq", self.mem.read(args[3], 16))
                t = sec * NS_PER_SEC + nsec
                # WAIT: relative. WAIT_BITSET: absolute against
                # CLOCK_MONOTONIC (origin = sim start) unless
                # FUTEX_CLOCK_REALTIME selects the epoch clock
                if op == FUTEX_WAIT_BITSET or abs_realtime:
                    base = (emulated(self.host.now) if abs_realtime
                            else self.host.now)
                    delay = max(0, t - base)
                else:
                    delay = max(0, t)

                def fire():
                    w = th.waiting
                    if w and w[0] == "futex" and w[1] is token:
                        # w[2], not the original uaddr: a REQUEUE may have
                        # moved this waiter to another queue since parking
                        self._futex_remove(w[2], th)
                        self._resume(th, -ETIMEDOUT)

                self.host.schedule_in(delay, fire)
            th.waiting = ("futex", token, uaddr)
            self.futexes.setdefault(uaddr, []).append((th, mask))
            return _BLOCK
        if op in (FUTEX_WAKE, FUTEX_WAKE_BITSET):
            mask = (args[5] & 0xFFFFFFFF if op == FUTEX_WAKE_BITSET
                    else FUTEX_BITSET_ALL)
            return self._futex_wake(uaddr, args[2], mask)
        if op in (FUTEX_REQUEUE, FUTEX_CMP_REQUEUE):
            if op == FUTEX_CMP_REQUEUE:
                cur = struct.unpack("<I", self.mem.read(uaddr, 4))[0]
                if cur != (args[5] & 0xFFFFFFFF):
                    return -EAGAIN
            woken = self._futex_wake(uaddr, args[2], FUTEX_BITSET_ALL)
            moved = 0
            q = self.futexes.get(uaddr, [])
            dst = self.futexes.setdefault(args[4], [])
            while q and moved < args[3]:  # timeout slot doubles as val2
                t, m = q.pop(0)
                if t.waiting and t.waiting[0] == "futex":
                    # retag so timeouts/removals target the new queue
                    t.waiting = ("futex", t.waiting[1], args[4])
                dst.append((t, m))
                moved += 1
            if not q:
                self.futexes.pop(uaddr, None)
            return woken + (moved if op == FUTEX_CMP_REQUEUE else 0)
        if op == FUTEX_WAKE_OP:
            enc, uaddr2 = args[5], args[4]
            o, cmp = (enc >> 28) & 0xF, (enc >> 24) & 0xF
            oparg, cmparg = (enc >> 12) & 0xFFF, enc & 0xFFF
            if o & 8:  # FUTEX_OP_OPARG_SHIFT
                oparg = 1 << (oparg & 31)
            o &= 7
            old = struct.unpack("<I", self.mem.read(uaddr2, 4))[0]
            new = {0: oparg, 1: old + oparg, 2: old | oparg,
                   3: old & ~oparg, 4: old ^ oparg}.get(o, old)
            self.mem.write(uaddr2, struct.pack("<I", new & 0xFFFFFFFF))
            woken = self._futex_wake(uaddr, args[2], FUTEX_BITSET_ALL)
            hit = {0: old == cmparg, 1: old != cmparg, 2: old < cmparg,
                   3: old <= cmparg, 4: old > cmparg,
                   5: old >= cmparg}.get(cmp, False)
            if hit:
                woken += self._futex_wake(uaddr2, args[3], FUTEX_BITSET_ALL)
            return woken
        return -ENOSYS  # PI / robust futexes: not modeled

    def _futex_wake(self, uaddr: int, nmax: int, mask: int) -> int:
        q = self.futexes.get(uaddr)
        if not q:
            return 0
        woken, i = 0, 0
        while i < len(q) and woken < nmax:
            th, m = q[i]
            if (m & mask) and not th.dead:
                q.pop(i)
                woken += 1
                self._resume(th, 0)
            else:
                i += 1
        if not q:
            self.futexes.pop(uaddr, None)
        return woken

    def _futex_remove(self, uaddr: int, th: GuestThread) -> None:
        q = self.futexes.get(uaddr)
        if q:
            q[:] = [(t, m) for (t, m) in q if t is not th]
            if not q:
                self.futexes.pop(uaddr, None)

    def _trace(self, nr: int, args, ret) -> None:
        if self._strace is None:
            return
        ts = f"{self.host.now} " if self._strace_times else ""
        if self._cur is not None and self._cur.slot:
            ts += f"[t{self._cur.slot}] "
        if nr < 0:
            self._strace.write(f"{ts}{ret}\n")
        else:
            # deterministic mode omits raw args: they carry ASLR'd guest
            # pointers that legitimately differ between runs
            a = ",".join(hex(x) for x in args) if self._strace_times else "..."
            self._strace.write(f"{ts}syscall_{nr}({a}) = {ret}\n")

    def _exited(self) -> None:
        if self.proc is None and self.real_pid is None:
            return
        if not self.running:
            return
        if self.proc is not None:
            code = self.proc.wait()
            if code < 0 and self._exit_hint is not None:
                # exit_group path: the shim raw-exits / worker SIGKILLs,
                # but the TRUE code was captured at the trap
                code = self._exit_hint
            if code < 0 and self._signal_hint is not None:
                code = self._signal_hint  # the signal the guest was sent
        else:
            # adopted (forked) guest: not our OS child, no waitpid — the
            # captured exit_group code is authoritative; EOF without it
            # means a signal death (attributed when an emulated kill sent it)
            if self._exit_hint is not None:
                code = self._exit_hint
            elif self._signal_hint is not None:
                code = self._signal_hint
            else:
                code = -9
        if self.audit_native:
            # the reality boundary, surfaced (VERDICT r2 item #5): which
            # syscalls this guest ran against the HOST kernel
            self.host.log(
                f"{self.name}: {len(self.audit_native)} unemulated "
                f"syscalls ran natively: {sorted(self.audit_native)}")
        if self.native_vfs:
            # default-on flavor (VERDICT r3 item #7): numbers the worker
            # explicitly re-issued natively (virtual-FS policy and
            # unemulated trapped calls), observed in EVERY run
            self.host.log(
                f"{self.name}: guest used {len(self.native_vfs)} "
                f"native-passthrough syscalls: {sorted(self.native_vfs)}")
        if self._strace is not None:
            if self.audit_native:
                self._strace.write(
                    f"+++ native passthrough: {sorted(self.audit_native)} "
                    "+++\n")
            self._strace.write(f"+++ exited with {code} +++\n")
        self._teardown()
        if self._journal is not None:
            # terminal: exit_code is about to be set, so this record can
            # never respawn (Host.reboot skips exited processes) — the
            # journal stream is complete
            self._journal.close()
        self.finish(code)
        if (self.parent_proc is not None and self.parent_proc.running):
            self.parent_proc._child_exited(self)

    def _teardown(self) -> None:
        """Release every worker-side runtime handle of the current guest
        life: capture files, strace stream, fd-table references, thread
        channels, embryo channels, the IPC socket. Shared by ``_exited``
        (process death — exit accounting follows) and ``kill`` (host
        crash — no exit status, the record stays respawnable)."""
        if self._strace is not None:
            self._strace.close()
            self._strace = None
        for f in self._files.values():
            f.close()
        self._files.clear()
        for vs in list(self.fds.values()):  # one ref per table entry
            self._close_vs(vs)
        self.fds.clear()
        for th in self.threads.values():
            th.dead = True
            if th.sock is not None and th.sock is not self.sock:
                th.sock.close()
                th.sock = None
        self._ready.clear()
        self.futexes.clear()
        for s in self._embryos.values():  # forks that never committed
            s.close()
        self._embryos.clear()
        if self.sock is not None:
            self.sock.close()
            self.sock = None

    def kill(self) -> None:
        """Host crash (faults.py host_down/churn, live
        ``host_down``): the guest dies with its host. SIGKILL + reap the
        real OS process, release every worker-side handle, and record NO
        exit status — in the simulated world the host lost power, the
        process neither exited nor was signaled (the same contract as
        PluginProcess.kill), so ``Host.reboot`` respawns a fresh instance
        via spawn(). Deterministic: crashes apply at round boundaries,
        where every guest is parked between turns, and ``Host.crash`` has
        already torn down the transport side before processes are killed
        (endpoint.close on a crashed endpoint is a no-op)."""
        if not self.running:
            return
        self._kill_now()
        if self.proc is not None:
            self.proc.wait()  # reap now: the zombie pid was ours until here
            self.proc = None
        if self._strace is not None:
            self._strace.write("+++ killed: host crash +++\n")
        self._teardown()
        self.running = False
        if self.parent_proc is not None:
            # a fork child dies for good with its host: the rebooted
            # PARENT re-forks deterministically, so this record must not
            # respawn as a fresh top-level guest — record the signal
            # death (exit_code set directly: nothing "exited" in the
            # simulated world, so no processes_exited accounting)
            self.exit_code = -9

    # -- syscall emulation -------------------------------------------------
    def _service(self, nr: int, args):
        h = self.host
        if nr == SYS_write:
            fd, addr, n = args[0], args[1], args[2]
            # a dup2'd vfd on 0/1/2 takes precedence over stdio capture
            if fd in (1, 2) and fd not in self.fds:
                data = self.mem.read(addr, min(n, 1 << 20))
                self._capture(fd).write(data)
                return len(data)
            vs = self.fds.get(fd)
            if vs is not None and vs.kind == "event":
                if n < 8:
                    return -EINVAL
                val = struct.unpack("<Q", self.mem.read(addr, 8))[0]
                vs.evt_counter += val
                th, w = self._find_waiter((("cread",), vs))
                if th is not None:
                    self._resume(th, self._counter_read(vs, w[2], w[3]))
                else:
                    self._notify()
                return 8
            if vs is not None and vs.kind in ("pipe_w", "spair"):
                ret = self._pipe_write(
                    vs, self.mem.read(addr, min(n, 1 << 20)))
                return self._maybe_offer_ring(fd, vs, 1, ret)
            if vs is not None and vs.kind == "pipe_r":
                return -EBADF  # write on the read end
            if vs is not None and vs.kind in ("file", "dir"):
                return self.vfs.write(vs, self.mem.read(addr, min(n, 1 << 20)))
            return self._maybe_offer_sock(fd, self._vfd_send(fd, addr, n))
        if nr == SYS_read:
            if args[0] == 0 and 0 not in self.fds:
                return 0  # stdin: EOF (unless a vfd was dup2'd onto it)
            vs = self.fds.get(args[0])
            if vs is not None and vs.kind in ("file", "dir"):
                data = self.vfs.read(vs, min(args[2], 1 << 20))
                if isinstance(data, int):
                    return data
                self.mem.write(args[1], data)
                return len(data)
            if vs is not None and vs.kind in ("timer", "event"):
                return self._counter_read(vs, args[1], args[2])
            if vs is not None and vs.kind == "sigfd":
                return self._sigfd_read(vs, args[1], args[2])
            if vs is not None and vs.kind == "inotify":
                return self._ino_read(vs, args[1], args[2])
            if vs is not None and vs.kind in ("pipe_r", "spair"):
                ret = self._pipe_read(vs, [(args[1], args[2])])
                return self._maybe_offer_ring(args[0], vs, 0, ret)
            if vs is not None and vs.kind == "pipe_w":
                return -EBADF  # read on the write end
            return self._maybe_offer_sock(
                args[0], self._vfd_recv(args[0], args[1], args[2]))
        if nr == SYS_close:
            if IPC_LOW <= args[0] <= SHIM_IPC_FD:
                # a guest sweeping "all fds" (subprocess close_fds) must
                # not sever its own management channels; pretend success
                return 0
            vs = self.fds.pop(args[0], None)
            if vs is None:
                return -EBADF
            self.fd_cloexec.discard(args[0])
            self._ring_offered.discard((args[0], 0))  # fd may be reused
            self._ring_offered.discard((args[0], 1))
            self._drop_fast_fd(args[0])
            self._close_vs(vs)
            return 0
        if nr == SYS_clock_gettime:
            if args[0] == 2**64 - 1:  # shim slow-path sentinel: raw ns
                return emulated(h.now)
            # monotonic/cputime-family clock ids originate at boot == sim
            # start; realtime family stays epoch-based — matching the
            # shim's libc interposition and sysinfo's uptime
            ns = h.now if args[0] in MONO_CLOCKS else emulated(h.now)
            self.mem.write(args[1], struct.pack(
                "<qq", ns // NS_PER_SEC, ns % NS_PER_SEC))
            return 0
        if nr == SYS_gettimeofday:
            if args[0]:
                ns = emulated(h.now)
                self.mem.write(args[0], struct.pack(
                    "<qq", ns // NS_PER_SEC, (ns % NS_PER_SEC) // 1000))
            return 0
        if nr == SYS_time:
            secs = emulated(h.now) // NS_PER_SEC
            if args[0]:
                self.mem.write(args[0], struct.pack("<q", secs))
            return secs
        if nr in (SYS_nanosleep, SYS_clock_nanosleep):
            ts_addr = args[0] if nr == SYS_nanosleep else args[2]
            sec, nsec = struct.unpack("<qq", self.mem.read(ts_addr, 16))
            dur = sec * NS_PER_SEC + nsec
            if nr == SYS_clock_nanosleep and args[1] & TIMER_ABSTIME:
                # absolute deadline in the REQUESTED clock's base:
                # monotonic family originates at sim start
                base = h.now if args[0] in MONO_CLOCKS else emulated(h.now)
                dur = max(0, sec * NS_PER_SEC + nsec - base)
            self._waiting = ("sleep",)
            th = self._cur
            h.schedule_in(max(dur, 0), lambda: self._resume(th, 0))
            return _BLOCK
        if nr == SYS_getrandom:
            n = min(args[1], 1 << 16)
            self.mem.write(args[0], h.rng.bytes(n))
            return n
        if nr == SYS_socket:
            domain, typ = args[0], args[1] & 0xFF
            if domain != socket.AF_INET or typ not in (socket.SOCK_STREAM,
                                                       socket.SOCK_DGRAM):
                return -EAFNOSUPPORT
            vfd = self._next_vfd
            self._next_vfd += 1
            kind = "stream" if typ == socket.SOCK_STREAM else "dgram"
            vs = VSocket(vfd, kind)
            if args[1] & 0o4000:  # SOCK_NONBLOCK
                vs.nonblock = True
            if args[1] & O_CLOEXEC:  # SOCK_CLOEXEC
                self.fd_cloexec.add(vfd)
            self.fds[vfd] = vs
            return vfd
        if nr == SYS_connect:
            return self._connect(args[0], args[1], args[2])
        if nr == SYS_sendto:
            vs = self.fds.get(args[0])
            if vs is not None and vs.kind == "dgram":
                return self._dgram_sendto(vs, args)
            return self._maybe_offer_sock(
                args[0], self._vfd_send(args[0], args[1], args[2]))
        if nr == SYS_recvfrom:
            vs = self.fds.get(args[0])
            if vs is not None and vs.kind == "dgram":
                return self._dgram_recvfrom(vs, args,
                                            peek=bool(args[3] & 2))
            return self._maybe_offer_sock(args[0], self._vfd_recv(
                args[0], args[1], args[2], peek=bool(args[3] & 2)))
        if nr == SYS_shutdown:
            vs = self.fds.get(args[0])
            if vs is None:
                return -EBADF
            if vs.kind == "spair":
                how = args[1]
                if how in (1, 2) and vs.pipe_out is not None:  # SHUT_WR
                    pb, vs.pipe_out = vs.pipe_out, None
                    pb.w_end = None  # writers -> 0: peer reads see EOF
                    pb.wake()
                if how in (0, 2) and vs.pipe is not None:  # SHUT_RD
                    pb, vs.pipe = vs.pipe, None
                    pb.r_end = None  # readers -> 0: peer writes see EPIPE
                    pb.wake()
                return 0
            if vs.endpoint is not None:
                if vs.sockring is not None:
                    # full close of the connection: every alias mapping
                    # (the shim only dropped THIS fd's) must stop serving
                    vs.sockring.kill()
                vs.endpoint.close()
            return 0
        if nr in (SYS_setsockopt,):
            return 0
        if nr == SYS_getsockopt:
            vs = self.fds.get(args[0])
            if vs is None:
                return -EBADF
            err = 0
            if args[1] == 1 and args[2] == 4:  # SOL_SOCKET, SO_ERROR
                err = vs.connect_err
                vs.connect_err = 0  # SO_ERROR reads clear the error
            if args[3] and args[4]:
                self.mem.write(args[3], struct.pack("<i", err))
                self.mem.write(args[4], struct.pack("<i", 4))
            return 0
        if nr in (SYS_getsockname, SYS_getpeername):
            vs = self.fds.get(args[0])
            if vs is None:
                return -EBADF
            vs = self.fds[args[0]]
            port = vs.endpoint.local_port if vs.endpoint is not None else 0
            sa = (struct.pack("<H", socket.AF_INET)
                  + struct.pack(">H", port)
                  + socket.inet_aton(h.ip) + b"\0" * 8)
            if args[1] and args[2]:
                self.mem.write(args[1], sa)
                self.mem.write(args[2], struct.pack("<i", len(sa)))
            return 0
        if nr == SYS_bind:
            vs = self.fds.get(args[0])
            if vs is None:
                return -EBADF
            raw = self.mem.read(args[1], min(max(args[2], 16), 128))
            vs.bound_port = struct.unpack_from(">H", raw, 2)[0]
            if vs.kind == "dgram":
                return self._dgram_bind(vs)
            return 0
        if nr == SYS_listen:
            return self._listen(args[0])
        if nr in (SYS_accept, SYS_accept4):
            flags = args[3] if nr == SYS_accept4 else 0
            return self._accept(args[0], args[1], args[2], flags)
        if nr in (SYS_poll, SYS_ppoll):
            return self._poll(args[0], args[1], args[2], nr == SYS_ppoll)
        if nr in (SYS_select, SYS_pselect6):
            return self._select(args, nr == SYS_pselect6)
        if nr in (SYS_epoll_create, SYS_epoll_create1):
            vfd = self._next_vfd
            self._next_vfd += 1
            self.fds[vfd] = VSocket(vfd, "epoll")
            if nr == SYS_epoll_create1 and args[0] & O_CLOEXEC:
                self.fd_cloexec.add(vfd)
            return vfd
        if nr == SYS_epoll_ctl:
            return self._epoll_ctl(args[0], args[1], args[2], args[3])
        if nr in (SYS_epoll_wait, SYS_epoll_pwait):
            return self._epoll_wait(args[0], args[1], args[2], args[3])
        if nr == SYS_fcntl:
            vs = self.fds.get(args[0])
            if vs is None:
                return -EBADF
            cmd = args[1]
            if cmd == F_GETFL:
                return 0o2 | (O_NONBLOCK if vs.nonblock else 0)  # O_RDWR
            if cmd == F_SETFL:
                vs.nonblock = bool(args[2] & O_NONBLOCK)
                return 0
            if cmd == F_GETFD:
                return 1 if args[0] in self.fd_cloexec else 0
            if cmd == F_SETFD:
                if args[2] & 1:  # FD_CLOEXEC
                    self.fd_cloexec.add(args[0])
                else:
                    self.fd_cloexec.discard(args[0])
                return 0
            if cmd in (0, 1030):  # F_DUPFD / F_DUPFD_CLOEXEC
                newfd = self._dup(args[0], None)
                if newfd >= 0 and cmd == 1030:
                    self.fd_cloexec.add(newfd)
                return newfd
            return 0  # other fcntl cmds: benign
        if nr == SYS_ioctl:
            vs = self.fds.get(args[0])
            if vs is None:
                return -EBADF
            if args[1] == FIONBIO:
                flag = struct.unpack("<i", self.mem.read(args[2], 4))[0]
                vs.nonblock = bool(flag)
                return 0
            if args[1] == FIONREAD:
                if vs.kind in ("pipe_r", "spair"):
                    avail = vs.pipe.avail() if vs.pipe is not None else 0
                elif vs.kind == "stream":
                    avail = len(vs.rxbuf)
                else:
                    avail = vs.dgram_q[0][1] if vs.dgram_q else 0
                self.mem.write(args[2], struct.pack("<i", avail))
                return 0
            return 0
        if nr == SYS_getpid:
            return self.vpid
        if nr == SYS_gettid:
            return self.vpid
        if nr == SYS_getppid:
            return 1  # the "init" of the simulated world
        if nr == SYS_timerfd_create:
            vfd = self._next_vfd
            self._next_vfd += 1
            vs = VSocket(vfd, "timer")
            vs.timer_clock = args[0] & 0xFFFFFFFF  # clockid: deadline base
            self.fds[vfd] = vs
            if args[1] & 0o2000000:  # TFD_CLOEXEC
                self.fd_cloexec.add(vfd)
            return vfd
        if nr == SYS_timerfd_settime:
            return self._timerfd_settime(args[0], args[1], args[2], args[3])
        if nr == SYS_timerfd_gettime:
            vs = self.fds.get(args[0])
            if vs is None or vs.kind != "timer":
                return -EBADF
            tnow = (h.now if vs.timer_clock in MONO_CLOCKS
                    else emulated(h.now))
            left = max(vs.deadline - tnow, 0) if vs.timer_handle else 0
            self.mem.write(args[1], struct.pack(
                "<qqqq", vs.interval_ns // NS_PER_SEC,
                vs.interval_ns % NS_PER_SEC,
                left // NS_PER_SEC, left % NS_PER_SEC))
            return 0
        if nr in (SYS_eventfd, SYS_eventfd2):
            vfd = self._next_vfd
            self._next_vfd += 1
            vs = VSocket(vfd, "event")
            vs.evt_counter = args[0]
            if nr == SYS_eventfd2 and args[1] & 0o4000:  # EFD_NONBLOCK
                vs.nonblock = True
            if nr == SYS_eventfd2 and args[1] & O_CLOEXEC:  # EFD_CLOEXEC
                self.fd_cloexec.add(vfd)
            self.fds[vfd] = vs
            return vfd
        if nr == SYS_sendmsg:
            return self._sendmsg(args[0], args[1])
        if nr == SYS_recvmsg:
            return self._recvmsg(args[0], args[1],
                                 peek=bool(args[2] & 2))  # MSG_PEEK
        if nr == SYS_writev:
            return self._writev(args[0], args[1], args[2])
        if nr == SYS_readv:
            return self._readv(args[0], args[1], args[2])
        if nr == HELLO:
            # mid-life HELLO == the guest execve'd a new image: same process
            # record and channel, fresh shim. The kernel killed any sibling
            # threads at exec; reap their records. vfds survive (exec keeps
            # fds), as do stdout/stderr captures and the strace stream.
            cur = self._cur
            for t in list(self.threads.values()):
                if t is not cur and not t.dead:
                    t.retval = 0
                    self._thread_gone(t)
                if t is not cur:
                    t.joined = True  # kernel-reaped at exec: recyclable
            for fd in sorted(self.fd_cloexec):  # FD_CLOEXEC semantics
                vs = self.fds.pop(fd, None)
                if vs is not None:
                    self._close_vs(vs)
            self.fd_cloexec.clear()
            self.host.counters.add("execs", 1)
            return 0  # the reply is the new image's first turn grant
        if nr == SPAWN_THREAD:
            return self._spawn_thread()
        if nr == THREAD_HELLO:
            return 0  # the reply itself is this thread's first turn grant
        if nr == THREAD_JOIN:
            return self._join_thread(args[0])
        if nr == THREAD_EXIT:
            th = self._cur
            # retval crosses the wire as int64 (negative-encoded pointers
            # like (void*)-1 are common); store it reply-ready
            th.retval = (args[0] - (1 << 64) if args[0] >= (1 << 63)
                         else args[0])
            self._thread_gone(th)
            return _DETACH
        if nr == SYS_futex:
            return self._futex(args)
        if nr == FORK_INTENT:
            return self._fork_intent()
        if nr == FORK_COMMIT:
            return self._fork_commit(args[0], args[1])
        if nr == AUDIT_NOTE:
            # reality boundary (experimental.native_audit): the shim passed
            # an unemulated syscall through to the host kernel; record the
            # number (once per number per process)
            self.audit_native.add(int(args[0]))
            self.host.counters.add("audit_native_syscalls", 1)
            if self._strace is not None:
                self._strace.write(
                    f"native-passthrough first use: syscall_{args[0]}\n")
            return 0
        if nr == RESOLVE:
            # simulated name resolution (shim-interposed getaddrinfo):
            # config host names map to their simulated IPv4
            name = self._read_cstr(args[0])
            if name is not None:
                ctl = self.host.controller
                hid = ctl._by_name.get(name)
                if hid is not None:
                    return int.from_bytes(
                        socket.inet_aton(ctl.hosts[hid].ip), "big")
            return -1  # unknown: the shim falls through to the real resolver
        if nr == SYS_wait4:
            return self._wait4(args)
        if nr == SYS_kill:
            return self._kill(args)
        if nr == SYS_sched_getaffinity:
            # deterministic virtual CPU count: guests sizing thread pools
            # by core count behave identically on every real machine (and
            # stay inside the 31-thread channel window)
            size = min(args[1], 128)
            if size < 8 or size % 8:  # kernel: multiple of sizeof(long)
                return -EINVAL
            mask = ((1 << SIM_CPUS) - 1).to_bytes(8, "little")
            self.mem.write(args[2], mask + b"\0" * (size - 8))
            return 8  # kernel returns the mask size it wrote
        if nr == SYS_sysinfo:
            # deterministic virtual machine: 2 GB RAM, sim uptime
            si = bytearray(112)  # sizeof(struct sysinfo) on x86-64
            struct.pack_into("<q", si, 0, emulated(h.now) // NS_PER_SEC)
            struct.pack_into("<QQ", si, 32,
                             2 << 30, (2 << 30) - (256 << 20))
            struct.pack_into("<H", si, 80, 1)  # procs
            struct.pack_into("<I", si, 104, 1)  # mem_unit = 1 byte
            self.mem.write(args[0], bytes(si))
            return 0
        if nr == SYS_getrusage:
            # sim-time resource usage: utime = simulated elapsed, the rest
            # zero (per-process CPU accounting is not modeled)
            ru = bytearray(144)  # struct rusage
            ns = emulated(h.now)
            struct.pack_into("<qq", ru, 0, ns // NS_PER_SEC,
                             (ns % NS_PER_SEC) // 1000)
            self.mem.write(args[1], bytes(ru))
            return 0
        if nr == SYS_times:
            # clock ticks (100/s) of SIM time; per-process CPU split is
            # not modeled — report elapsed in utime, zeros elsewhere
            ticks = emulated(h.now) * 100 // NS_PER_SEC
            if args[0]:
                self.mem.write(args[0], struct.pack("<qqqq", ticks, 0, 0, 0))
            return ticks & 0x7FFFFFFFFFFFFFFF
        if nr == SYS_clock_getres:
            if args[1]:
                self.mem.write(args[1], struct.pack("<qq", 0, 1))  # 1 ns
            return 0
        if nr == SYS_uname:
            # identity virtualization: nodename is the SIMULATED host name
            # (gethostname() routes through uname in glibc)
            u = os.uname()
            buf = b"".join(
                s.encode()[:64].ljust(65, b"\0")
                for s in ("Linux", self.host.name, u.release, u.version,
                          u.machine, ""))
            self.mem.write(args[0], buf)
            return 0
        if nr == SYS_exit_group:
            # record the true exit code; _pump then replies, SIGKILLs the
            # process synchronously (sibling threads must not outlive an
            # exit_group, and the pid is still ours — unreaped), and reaps
            self._exit_hint = args[0] & 0xFF
            return _EXITGROUP
        if nr in (SYS_pipe, SYS_pipe2):
            return self._pipe(args[0], args[1] if nr == SYS_pipe2 else 0)
        if nr == SYS_socketpair:
            return self._socketpair(args)
        if nr == SYS_sendfile:
            return self._sendfile(args)
        if nr == SYS_sigaltstack:
            return self._sigaltstack(self._cur, args)
        if nr in (SYS_getrlimit, SYS_setrlimit, SYS_prlimit64):
            return self._rlimit(nr, args)
        if nr in (SYS_signalfd, SYS_signalfd4):
            return self._signalfd(args, nr == SYS_signalfd4)
        if nr in (SYS_splice, SYS_tee):
            return self._splice(args, nr == SYS_tee)
        if nr in (SYS_inotify_init, SYS_inotify_init1):
            return self._inotify_init(args[0] if nr == SYS_inotify_init1
                                      else 0)
        if nr == SYS_inotify_add_watch:
            return self._inotify_add(args)
        if nr == SYS_inotify_rm_watch:
            return self._inotify_rm(args)
        if nr == SYS_close_range:
            # close the range's VFDS only; real fds — including the shim's
            # reserved IPC window — survive (the guest can't be allowed to
            # sever its own management channel; leaked real fds are benign
            # under the sim). CLOSE_RANGE_CLOEXEC degrades to close.
            lo, hi = args[0], min(args[1], 1 << 62)
            if args[2] & 4:  # CLOSE_RANGE_CLOEXEC: mark, don't close
                self.fd_cloexec.update(
                    f for f in self.fds if lo <= f <= hi)
                return 0
            for fd in [f for f in self.fds if lo <= f <= hi]:
                self.fd_cloexec.discard(fd)
                self._ring_offered.discard((fd, 0))
                self._ring_offered.discard((fd, 1))
                self._close_vs(self.fds.pop(fd))
            return 0
        if nr == SYS_mmap:
            return self._mmap_vfd(args)
        if nr == SYS_fstat:
            return self._fstat(args[0], args[1])
        if nr == SYS_newfstatat:
            return self.vfs.statat(_sfd(args[0]), args[1], args[2],
                                   args[3])
        if nr == SYS_lseek:
            vs = self.fds.get(args[0])
            if vs is not None and vs.kind in ("file", "dir"):
                return self.vfs.lseek(vs, args[1], args[2])
            return -29 if args[0] in self.fds else -EBADF  # ESPIPE
        if nr == SYS_pread64:
            vs = self.fds.get(args[0])
            if vs is None:
                return -EBADF
            if vs.kind not in ("file", "dir"):
                return -29  # ESPIPE
            data = self.vfs.pread(vs, min(args[2], 1 << 20), _sfd(args[3]))
            if isinstance(data, int):
                return data
            self.mem.write(args[1], data)
            return len(data)
        if nr == SYS_pwrite64:
            vs = self.fds.get(args[0])
            if vs is None:
                return -EBADF
            if vs.kind not in ("file", "dir"):
                return -29  # ESPIPE
            return self.vfs.pwrite(
                vs, self.mem.read(args[1], min(args[2], 1 << 20)),
                _sfd(args[3]))
        if nr in (SYS_open, SYS_creat):
            flags = (0o1101 if nr == SYS_creat  # O_WRONLY|O_CREAT|O_TRUNC
                     else args[1])
            return self.vfs.openat(AT_FDCWD, args[0], flags, args[2])
        if nr == SYS_openat:
            return self.vfs.openat(_sfd(args[0]), args[1], args[2], args[3])
        if nr in (SYS_stat, SYS_lstat):
            return self.vfs.statat(
                AT_FDCWD, args[0], args[1],
                AT_SYMLINK_NOFOLLOW if nr == SYS_lstat else 0)
        if nr == SYS_statx:
            return self.vfs.statx(_sfd(args[0]), args[1], args[2], args[4])
        if nr == SYS_access:
            return self.vfs.access(AT_FDCWD, args[0], args[1])
        if nr in (SYS_faccessat, SYS_faccessat2):
            return self.vfs.access(_sfd(args[0]), args[1], args[2])
        if nr == SYS_unlink:
            return self.vfs.unlinkat(AT_FDCWD, args[0], 0)
        if nr == SYS_rmdir:
            return self.vfs.unlinkat(AT_FDCWD, args[0], AT_REMOVEDIR)
        if nr == SYS_unlinkat:
            return self.vfs.unlinkat(_sfd(args[0]), args[1], args[2])
        if nr == SYS_mkdir:
            return self.vfs.mkdirat(AT_FDCWD, args[0], args[1])
        if nr == SYS_mkdirat:
            return self.vfs.mkdirat(_sfd(args[0]), args[1], args[2])
        if nr == SYS_rename:
            return self.vfs.renameat(AT_FDCWD, args[0], AT_FDCWD, args[1])
        if nr in (SYS_renameat, SYS_renameat2):
            if nr == SYS_renameat2 and args[4]:
                return -EINVAL  # RENAME_* flags not modeled
            return self.vfs.renameat(_sfd(args[0]), args[1],
                                     _sfd(args[2]), args[3])
        if nr == SYS_readlink:
            return self.vfs.readlinkat(AT_FDCWD, args[0], args[1], args[2])
        if nr == SYS_readlinkat:
            return self.vfs.readlinkat(_sfd(args[0]), args[1], args[2],
                                       args[3])
        if nr == SYS_chdir:
            return self.vfs.chdir(args[0])
        if nr == SYS_fchdir:
            vs = self.fds.get(args[0])
            if vs is None:
                return -EBADF
            return self.vfs.fchdir(vs)
        if nr == SYS_getcwd:
            return self.vfs.getcwd(args[0], args[1])
        if nr == SYS_truncate:
            return self.vfs.truncate(args[0], args[1])
        if nr == SYS_ftruncate:
            vs = self.fds.get(args[0])
            if vs is None:
                return -EBADF
            return self.vfs.ftruncate(vs, args[1])
        if nr in (SYS_fsync, SYS_fdatasync):
            return 0 if args[0] in self.fds else -EBADF
        if nr == SYS_getdents64:
            vs = self.fds.get(args[0])
            if vs is None:
                return -EBADF
            if vs.kind != "dir":
                return -20  # ENOTDIR
            data = self.vfs.getdents64(vs, min(args[2], 1 << 16))
            if isinstance(data, int):
                return data
            self.mem.write(args[1], data)
            return len(data)
        if nr == SYS_dup:
            return self._dup(args[0], None)
        if nr in (SYS_dup2, SYS_dup3):
            if args[0] not in self.fds:
                # REAL source fd: the kernel will do the dup — but a dup2
                # onto a number we map virtually (a shell restoring its
                # saved stdout) must drop our mapping first, or writes to
                # that number keep landing in the old virtual file
                vs = self.fds.pop(args[1], None)
                if vs is not None:
                    self.fd_cloexec.discard(args[1])
                    self._close_vs(vs)
                return RETRY_NATIVE
            if args[0] == args[1]:
                # dup2(x, x): POSIX no-op; dup3 must fail (Linux EINVAL)
                return -EINVAL if nr == SYS_dup3 else args[1]
            r = self._dup(args[0], args[1])
            if r >= 0 and nr == SYS_dup3 and args[2] & O_CLOEXEC:
                self.fd_cloexec.add(r)
            return r
        if nr == SYS_execve:
            return self._do_exec(args)
        if nr in (SYS_clone, SYS_fork, SYS_vfork, SYS_clone3):
            # CLONE_THREAD clones run natively; fork-style clones are
            # executed SHIM-side (FORK_INTENT/COMMIT protocol) and never
            # reach here; vfork (shared-VM) stays rejected
            return -ENOSYS
        return -ENOSYS

    # -- readiness (poll/epoll) --------------------------------------------
    def _readable(self, vs: VSocket) -> bool:
        if vs.kind == "timer":
            return vs.expirations > 0
        if vs.kind == "event":
            return vs.evt_counter > 0
        if vs.kind == "sigfd":
            return bool(vs.sig_q)
        if vs.kind == "inotify":
            return bool(vs.ino_q)
        if vs.kind in ("pipe_r", "spair"):
            if vs.pipe is None:
                return True  # SHUT_RD: reads return EOF immediately
            return vs.pipe.avail() > 0 or vs.pipe.writers == 0
        if vs.kind == "pipe_w":
            return False
        if vs.kind == "dgram":
            return bool(vs.dgram_q)
        if vs.listening:
            return bool(vs.accept_q)
        return bool(vs.rxbuf) or vs.peer_closed

    def _writable(self, vs: VSocket) -> bool:
        if vs.kind in ("dgram", "event"):
            return True
        if vs.kind == "pipe_w":
            return vs.pipe.room() > 0 or vs.pipe.readers == 0
        if vs.kind == "spair":
            pb = vs.pipe_out
            if pb is None:
                return True  # SHUT_WR: writes fail fast with EPIPE
            return pb.room() > 0 or pb.readers == 0
        if vs.kind == "pipe_r":
            return False
        ep = vs.endpoint
        if ep is None or not vs.connected or vs.peer_closed:
            return bool(vs.connect_err)  # error state is "writable" (POLLERR)
        return ep.sender.buffered < ep.sender.send_buffer

    def _revents(self, vs: VSocket, want: int) -> int:
        r = 0
        if want & POLLIN and self._readable(vs):
            r |= POLLIN
        if want & POLLOUT and self._writable(vs):
            r |= POLLOUT
        if vs.peer_closed:
            r |= POLLHUP
        if vs.connect_err:
            r |= POLLERR
        return r

    def _notify(self) -> None:
        """Some vfd's state changed: re-evaluate every parked poll/epoll."""
        for slot in sorted(self.threads):
            th = self.threads[slot]
            w = th.waiting
            if not w or th.dead:
                continue
            if w[0] == "poll":
                n = self._poll_scan(w[2], w[3])
                if n:
                    self._resume(th, n)
            elif w[0] == "epoll":
                n = self._epoll_scan(w[2], w[3], w[4])
                if n:
                    self._resume(th, n)
            elif w[0] == "select":
                n = self._select_scan(w[2], w[3], w[4], w[5])
                if n:
                    self._select_timeleft(w)
                    self._resume(th, n)

    def _poll_scan(self, entries, fds_ptr) -> int:
        """Write revents for ready entries; returns the ready count."""
        n = 0
        for i, (fd, want) in enumerate(entries):
            if fd < 0:  # poll(2): negative fds are ignored, revents = 0
                r = 0
            else:
                vs = self.fds.get(fd)
                r = (self._revents(vs, want) if vs is not None
                     else 0x20)  # POLLNVAL
            if r:
                n += 1
            self.mem.write(fds_ptr + 8 * i + 6, struct.pack("<h", r))
        return n

    def _epoll_scan(self, ep_vs: VSocket, events_ptr: int, maxev: int) -> int:
        n = 0
        for fd, (want, data) in list(ep_vs.interest.items()):
            vs = self.fds.get(fd)
            if vs is None:
                continue
            r = self._revents(vs, want)
            if r and n < maxev:
                self.mem.write(events_ptr + 12 * n,
                               struct.pack("<I", r) + struct.pack("<Q", data))
                n += 1
        return n

    def _arm_wait_timeout(self, timeout_ns: int):
        token = object()
        if timeout_ns >= 0:
            def fire():
                th, w = self._find_waiter((("poll", "epoll", "select"),
                                           token))
                if th is not None:
                    if w[0] == "select":  # Linux zeroes the sets on timeout
                        self._select_write(w[3], _zeroed_sets(w[4], w[5]),
                                           w[5])
                        self._select_timeleft(w)
                    self._resume(th, 0)

            self.host.schedule_in(timeout_ns, fire)
        return token

    # -- socket bridge -----------------------------------------------------
    def _wire_endpoint(self, vs: VSocket, ep) -> None:
        vs.endpoint = ep
        ep.on_data = lambda n, payload, now: self._on_net_data(vs, n, payload)
        ep.on_close = lambda now: self._on_net_close(vs)
        ep.on_error = lambda msg: self._on_net_error(vs)
        ep.on_drain = lambda room: self._on_drain(vs)
        # flow control sees the guest's unread backlog: a guest that never
        # reads closes the advertised window instead of growing rxbuf
        # without bound (transport.StreamReceiver.window)
        ep.receiver.app_unread = lambda: len(vs.rxbuf)

    def _on_drain(self, vs: VSocket) -> None:
        th, w = self._find_waiter((("send", "smsg", "sendfile"), vs))
        if th is not None:
            if w[0] == "sendfile":
                r = self._sendfile(w[2], th=th)
                if r is not _BLOCK:
                    self._resume(th, r)
                return
            if w[0] == "send":
                data = self.mem.read(w[2], min(w[3], 1 << 20))
            else:
                data = w[2]
            accepted = vs.endpoint.send(payload=data)
            if accepted > 0:
                self._resume(th, accepted)
            return
        self._notify()

    def _listen(self, fd: int):
        vs = self.fds.get(fd)
        if vs is None:
            return -EBADF
        if not vs.bound_port:
            return -EINVAL
        if vs.listening:
            return 0

        def on_accept(ep, now):
            # wire rx buffering IMMEDIATELY: the peer's first data can land
            # before the app calls accept() (SYNACK already went out)
            conn = VSocket(-1)
            conn.connected = True
            self._wire_endpoint(conn, ep)
            th, w = self._find_waiter((("accept",), vs))
            if th is not None:
                self._finish_accept(th, vs, conn, w[2], w[3],
                                    w[4] if len(w) > 4 else 0)
            else:
                vs.accept_q.append(conn)
                self._notify()

        try:
            self.host.listen(vs.bound_port, on_accept)
        except ValueError:
            return -98  # EADDRINUSE
        vs.listening = True
        return 0

    def _accept(self, fd: int, addr: int, addrlen: int, flags: int = 0):
        vs = self.fds.get(fd)
        if vs is None:
            return -EBADF
        if not vs.listening:
            return -EINVAL
        if vs.accept_q:
            return self._do_accept(vs, vs.accept_q.pop(0), addr, addrlen,
                                   flags)
        if vs.nonblock:
            return -EAGAIN
        self._waiting = ("accept", vs, addr, addrlen, flags)
        return _BLOCK

    def _do_accept(self, vs: VSocket, conn: VSocket, addr: int,
                   addrlen: int, flags: int = 0):
        conn.vfd = self._next_vfd
        self._next_vfd += 1
        self.fds[conn.vfd] = conn
        if flags & 0o4000:  # SOCK_NONBLOCK
            conn.nonblock = True
        if flags & O_CLOEXEC:  # SOCK_CLOEXEC
            self.fd_cloexec.add(conn.vfd)
        if addr and addrlen:
            peer = self.host.controller.hosts[conn.endpoint.remote_host]
            sa = (struct.pack("<H", socket.AF_INET)
                  + struct.pack(">H", conn.endpoint.remote_port)
                  + socket.inet_aton(peer.ip) + b"\0" * 8)
            self.mem.write(addr, sa)
            self.mem.write(addrlen, struct.pack("<i", len(sa)))
        return conn.vfd

    def _finish_accept(self, th: GuestThread, vs: VSocket, conn: VSocket,
                       addr: int, addrlen: int, flags: int = 0) -> None:
        self._resume(th, self._do_accept(vs, conn, addr, addrlen, flags))

    def _connect(self, fd: int, addr: int, addrlen: int):
        vs = self.fds.get(fd)
        if vs is None:
            return -EBADF
        if vs.endpoint is not None:  # the re-connect completion idiom
            if vs.connect_err:
                return -vs.connect_err
            return -106 if vs.connected else -114  # EISCONN / EALREADY
        raw = self.mem.read(addr, min(max(addrlen, 16), 128))
        family = struct.unpack_from("<H", raw, 0)[0]
        if vs.kind == "dgram":
            # connected UDP (DNS/stub-resolver idiom): record the default
            # peer, filter inbound to it, and return instantly — Linux
            # performs no handshake for SOCK_DGRAM connect(2)
            if family == socket.AF_UNSPEC:  # dissolve the association
                vs.dgram_peer = None
                vs.connected = False
                return 0
            if family != socket.AF_INET:
                return -EAFNOSUPPORT
            port = struct.unpack_from(">H", raw, 2)[0]
            ip = socket.inet_ntoa(raw[4:8])
            try:
                peer = self.host.controller.resolve(ip)
            except KeyError:
                return -ENETUNREACH
            if vs.udp is None:
                r = self._dgram_bind(vs)  # connect auto-binds, like the kernel
                if r != 0:
                    return r
            vs.dgram_peer = (peer, port)
            vs.connected = True
            return 0
        if family != socket.AF_INET:
            return -EAFNOSUPPORT
        port = struct.unpack_from(">H", raw, 2)[0]
        ip = socket.inet_ntoa(raw[4:8])
        try:
            peer = self.host.controller.resolve(ip)
        except KeyError:
            return -ENETUNREACH
        ep = self.host.connect(peer, port)
        self._wire_endpoint(vs, ep)
        ep.on_connected = lambda now: self._on_connected(vs)
        if vs.nonblock:
            ep.connect()
            return -115  # EINPROGRESS; completion via POLLOUT + SO_ERROR
        self._waiting = ("connect", vs)
        ep.connect()
        return _BLOCK

    def _on_connected(self, vs: VSocket) -> None:
        vs.connected = True
        th, _ = self._find_waiter((("connect",), vs))
        if th is not None:
            self._resume(th, 0)
            return
        self._notify()

    def _on_net_data(self, vs: VSocket, n: int, payload) -> None:
        data = payload if payload is not None else b"\0" * n
        vs.rxbuf += data
        sr = vs.sockring
        if sr is not None and not sr.dead:
            if len(data) <= sr.rx_room():
                sr.rx_append(data)  # mirror: RX unread == len(rxbuf)
            else:
                # mirror overflow (rxbuf grew past the ring's slack over
                # recv_buffer): permanent slow path; rxbuf stays
                # authoritative, so nothing is lost
                sr.kill()
        # wake every satisfiable waiter: a fulfilled MSG_PEEK leaves the
        # data in place, so another thread's recv may also be servable
        while vs.rxbuf:
            th, w = self._find_waiter((("recv", "rmsg"), vs))
            if th is None:
                break
            if w[0] == "recv":
                self._fulfill_recv(th, vs, w[2], w[3], w[4])
            else:  # rmsg: a parked MSG_PEEK must not consume on wakeup
                peek = len(w) > 3 and w[3]
                self._resume(th, self._scatter_rx(vs, w[2],
                                                  consume=not peek))
        self._notify()

    def _on_net_close(self, vs: VSocket) -> None:
        vs.peer_closed = True
        if vs.sockring is not None:
            # HUP now: the shim serves EOF-once-drained locally and
            # forwards writes (the worker twin returns -EPIPE)
            vs.sockring.sync_flags(vs)
        woke = False
        while not vs.rxbuf:  # terminal event: EVERY reader gets EOF
            th, _ = self._find_waiter((("recv", "rmsg"), vs))
            if th is None:
                break
            self._resume(th, 0)
            woke = True
        if not woke:
            self._notify()

    def _on_net_error(self, vs: VSocket) -> None:
        vs.connect_err = ETIMEDOUT if not vs.connected else ECONNRESET
        if vs.sockring is not None:
            # error delivery ordering is worker business: flag + kill so
            # the shim forwards everything on this connection from now on
            vs.sockring.sync_flags(vs)
            vs.sockring.kill()
        woke = False
        while True:  # terminal event: EVERY waiter on this socket errors
            th, w = self._find_waiter((("connect",), vs))
            if th is not None:
                self._resume(th, -ETIMEDOUT)
                woke = True
                continue
            th, w = self._find_waiter(
                (("recv", "send", "rmsg", "smsg", "dmsg"), vs))
            if th is not None:
                self._resume(th, -ECONNRESET)
                woke = True
                continue
            break
        if not woke:
            self._notify()

    def _vfd_send(self, fd: int, addr: int, n: int):
        vs = self.fds.get(fd)
        if vs is None:
            return -EBADF
        if vs.kind == "spair":
            return self._pipe_write(vs, self.mem.read(addr, min(n, 1 << 20)))
        if vs.kind == "dgram":  # send/write(2) on a connected-UDP socket
            return self._dgram_sendto(vs, (fd, addr, n, 0, 0, 0))
        if vs.endpoint is None or not vs.connected:
            return -ENOTCONN
        if vs.peer_closed:
            return -EPIPE
        data = self.mem.read(addr, min(n, 1 << 20))
        accepted = vs.endpoint.send(payload=data)
        if accepted > 0:
            return accepted
        if vs.nonblock:
            return -EAGAIN
        # send buffer full: park until acks drain it (_on_drain resumes)
        self._waiting = ("send", vs, addr, n)
        return _BLOCK

    def _vfd_recv(self, fd: int, bufaddr: int, buflen: int,
                  peek: bool = False):
        vs = self.fds.get(fd)
        if vs is None:
            return -EBADF
        if vs.kind == "spair":
            return self._pipe_read(vs, [(bufaddr, buflen)], peek=peek)
        if vs.kind == "dgram":  # recv/read(2) on a (connected-)UDP socket
            return self._dgram_recvfrom(vs, (fd, bufaddr, buflen, 0, 0, 0),
                                        peek=peek)
        if vs.endpoint is None:
            return -ENOTCONN
        if vs.rxbuf:
            return self._take_rx(vs, bufaddr, buflen, consume=not peek)
        if vs.peer_closed:
            return 0
        if vs.nonblock:
            return -EAGAIN
        self._waiting = ("recv", vs, bufaddr, buflen, peek)
        return _BLOCK

    def _fulfill_recv(self, th: GuestThread, vs: VSocket, bufaddr: int,
                      buflen: int, peek: bool = False) -> None:
        # a parked MSG_PEEK must not consume on wakeup
        self._resume(th, self._take_rx(vs, bufaddr, buflen,
                                       consume=not peek))

    def _take_rx(self, vs: VSocket, bufaddr: int, buflen: int,
                 consume: bool = True) -> int:
        k = min(len(vs.rxbuf), buflen)
        self.mem.write(bufaddr, bytes(vs.rxbuf[:k]))
        if consume:
            del vs.rxbuf[:k]
            sr = vs.sockring
            if sr is not None and not sr.dead and k:
                sr.rx_advance(k)  # keep the mirror invariant
            self._rx_consumed(vs)
        return k

    def _rx_consumed(self, vs: VSocket) -> None:
        """The guest read from rxbuf: let the receiver send a window-update
        ack if the sender was throttled by our advertised window."""
        if vs.endpoint is not None:
            vs.endpoint.receiver.on_app_read()

    # -- select -------------------------------------------------------------
    def _select(self, args, is_pselect: bool):
        """select/pselect6 over fd_set bitmaps. Only reachable for fds the
        guest can legally FD_SET (< FD_SETSIZE): vfds land there via dup2
        (shell redirections, inetd-style servers). Real fds in the sets
        count as always-ready, like regular files."""
        nfds = min(args[0] & 0xFFFFFFFF, 1024)
        nbytes = (nfds + 7) // 8
        sets = []
        for ptr in (args[1], args[2], args[3]):
            if ptr:
                sets.append(bytearray(self.mem.read(ptr, nbytes)))
            else:
                sets.append(None)
        want_of = (POLLIN, POLLOUT, 0)  # exceptfds: never signaled here
        entries = []  # (fd, set_index, want_mask)
        for si, bits in enumerate(sets):
            if bits is None:
                continue
            for fd in range(nfds):
                if bits[fd >> 3] & (1 << (fd & 7)):
                    entries.append((fd, si, want_of[si]))
        n = self._select_scan(entries, args, sets, nbytes)
        if n:
            return n
        if args[4] == 0:  # NULL timeout pointer = infinite
            timeout_ns = -1
        else:
            # timespec (pselect) and timeval (select) are both two int64s
            sec, frac = struct.unpack("<qq", self.mem.read(args[4], 16))
            timeout_ns = sec * NS_PER_SEC + (frac if is_pselect
                                             else frac * 1000)
            if sec < 0 or frac < 0:
                return -EINVAL  # Linux rejects negative timeouts
        if timeout_ns == 0:
            # nothing ready and a zero timeout: clear every set and return
            self._select_write(args, _zeroed_sets(sets, nbytes), nbytes)
            return 0
        token = self._arm_wait_timeout(timeout_ns)
        # select (not pselect) updates the guest's timeval with the time
        # remaining; remember the deadline for the writeback
        deadline = (None if is_pselect or timeout_ns < 0
                    else emulated(self.host.now) + timeout_ns)
        self._waiting = ("select", token, entries, args, sets, nbytes,
                        deadline)
        return _BLOCK

    def _select_timeleft(self, w) -> None:
        """Linux select(2) semantics: write the unslept remainder back
        into the guest's timeval on every blocking return."""
        deadline = w[6] if len(w) > 6 else None
        if deadline is None:
            return
        left = max(0, deadline - emulated(self.host.now))
        self.mem.write(w[3][4], struct.pack(
            "<qq", left // NS_PER_SEC, (left % NS_PER_SEC) // 1000))

    def _select_scan(self, entries, args, sets, nbytes: int) -> int:
        out = _zeroed_sets(sets, nbytes)
        n = 0
        for fd, si, want in entries:
            vs = self.fds.get(fd)
            if vs is None:
                ready = si != 2  # real fd (file-like): always read/write-ready
            elif si == 2:
                ready = False
            else:
                ready = bool(self._revents(vs, want) & want)
            if ready:
                out[si][fd >> 3] |= 1 << (fd & 7)
                n += 1
        if n:
            self._select_write(args, out, nbytes)
        return n

    def _select_write(self, args, out, nbytes: int) -> None:
        for ptr, bits in zip((args[1], args[2], args[3]), out):
            if ptr and bits is not None:
                self.mem.write(ptr, bytes(bits))

    # -- poll / epoll -------------------------------------------------------
    def _poll(self, fds_ptr: int, nfds: int, timeout, is_ppoll: bool):
        nfds = min(nfds, 1024)
        raw = self.mem.read(fds_ptr, 8 * nfds)
        entries = []
        for i in range(nfds):
            fd = struct.unpack_from("<i", raw, 8 * i)[0]
            want = struct.unpack_from("<h", raw, 8 * i + 4)[0]
            entries.append((fd, want))
        if self._fast_plane and self.parent_proc is None:
            # this poll reached the worker: publish readiness bytes for
            # its fds from the next reply on, so repeats complete in-shim
            for fd, _w in entries:
                if 0 <= fd - VFD_BASE < SHIM_READY_LEN:
                    self._ready_watch.add(fd)
        n = self._poll_scan(entries, fds_ptr)
        if n:
            return n
        if is_ppoll:  # timeout is a timespec pointer (NULL = infinite)
            if timeout == 0:
                timeout_ns = -1
            else:
                sec, nsec = struct.unpack("<qq", self.mem.read(timeout, 16))
                timeout_ns = sec * NS_PER_SEC + nsec
        else:  # poll: signed ms (negative = infinite)
            tmo = timeout if timeout < (1 << 63) else timeout - (1 << 64)
            timeout_ns = -1 if tmo < 0 else int(tmo) * 1_000_000
        if timeout_ns == 0:
            return 0
        token = self._arm_wait_timeout(timeout_ns)
        self._waiting = ("poll", token, entries, fds_ptr)
        return _BLOCK

    def _epoll_ctl(self, epfd: int, op: int, fd: int, event_ptr: int):
        ep_vs = self.fds.get(epfd)
        if ep_vs is None or ep_vs.kind != "epoll":
            return -EBADF
        if op == EPOLL_CTL_DEL:
            ep_vs.interest.pop(fd, None)
            return 0
        if fd not in self.fds:
            # real (non-virtual) fds can't be multiplexed by the simulated
            # epoll — fail loudly instead of silently never firing
            return -EPERM
        raw = self.mem.read(event_ptr, 12)
        events = struct.unpack_from("<I", raw, 0)[0]
        data = struct.unpack_from("<Q", raw, 4)[0]
        ep_vs.interest[fd] = (events, data)
        return 0

    def _epoll_wait(self, epfd: int, events_ptr: int, maxev: int, timeout):
        ep_vs = self.fds.get(epfd)
        if ep_vs is None or ep_vs.kind != "epoll":
            return -EBADF
        n = self._epoll_scan(ep_vs, events_ptr, maxev)
        if n:
            return n
        tmo = timeout if timeout < (1 << 63) else timeout - (1 << 64)
        if tmo == 0:
            return 0
        timeout_ns = -1 if tmo < 0 else int(tmo) * 1_000_000
        token = self._arm_wait_timeout(timeout_ns)
        self._waiting = ("epoll", token, ep_vs, events_ptr, maxev)
        return _BLOCK

    # -- scatter-gather (msghdr/iovec walking via guest memory) --------------
    def _read_cstr(self, ptr: int, limit: int = 256):
        try:
            return self.mem.read_cstr(ptr, limit).decode()
        except (OSError, UnicodeDecodeError):
            return None

    def _read_iovec(self, iov_ptr: int, iovcnt: int):
        """Reads a struct iovec[] from guest memory → [(base, len)]."""
        iovs = []
        n = min(iovcnt, 1024)  # IOV_MAX
        if iov_ptr and n:
            raw = self.mem.read(iov_ptr, 16 * n)
            for i in range(n):
                iovs.append(struct.unpack_from("<QQ", raw, 16 * i))
        return iovs

    def _read_msghdr(self, msg_ptr: int):
        """Returns (name_ptr, namelen, iov list[(base, len)])."""
        raw = self.mem.read(msg_ptr, 56)  # struct msghdr on x86-64
        # msg_namelen is a 4-byte socklen_t at offset 8 (then 4 pad bytes)
        name, namelen, iov, iovlen = struct.unpack_from("<QIxxxxQQ", raw, 0)
        return name, namelen, self._read_iovec(iov, iovlen)

    def _stream_send(self, vs: VSocket, data: bytes):
        """Send gathered bytes on a stream socket; park replaying the same
        staged buffer if the send buffer is full (sendmsg/writev path)."""
        if vs.kind != "stream" or vs.endpoint is None or not vs.connected:
            return -ENOTCONN
        if vs.peer_closed:
            return -EPIPE
        accepted = vs.endpoint.send(payload=data)
        if accepted > 0:
            return accepted
        if vs.nonblock:
            return -EAGAIN
        self._waiting = ("smsg", vs, data)
        return _BLOCK

    def _scatter_rx(self, vs: VSocket, iovs, consume: bool = True) -> int:
        """Move bytes from vs.rxbuf into the guest's iovecs (MSG_PEEK:
        copy without consuming)."""
        k = min(len(vs.rxbuf), sum(ln for _, ln in iovs))
        self._scatter(iovs, bytes(vs.rxbuf[:k]))
        if consume:
            del vs.rxbuf[:k]
            sr = vs.sockring
            if sr is not None and not sr.dead and k:
                sr.rx_advance(k)  # keep the mirror invariant
            self._rx_consumed(vs)
        return k

    def _sendmsg(self, fd: int, msg_ptr: int):
        vs = self.fds.get(fd)
        if vs is None:
            return -EBADF
        name, namelen, iovs = self._read_msghdr(msg_ptr)
        data = b"".join(self.mem.read(b, min(ln, 1 << 20))
                        for b, ln in iovs if ln)
        if vs.kind == "dgram":
            # NULL name falls back to the connected-UDP default peer
            return self._dgram_sendto(vs, (fd, 0, len(data), 0, name, namelen),
                                      staged=data)
        if vs.kind == "spair":
            return self._pipe_write(vs, data)
        return self._stream_send(vs, data)

    def _recvmsg(self, fd: int, msg_ptr: int, peek: bool = False):
        vs = self.fds.get(fd)
        if vs is None:
            return -EBADF
        name, namelen, iovs = self._read_msghdr(msg_ptr)
        if vs.kind == "spair":
            return self._pipe_read(vs, iovs, peek=peek)
        if vs.kind == "dgram":
            if not vs.dgram_q:
                if vs.nonblock:
                    return -EAGAIN
                self._waiting = ("dmsg", vs, iovs, (msg_ptr, name, namelen),
                                 peek)
                return _BLOCK
            return self._recvmsg_take(vs, iovs, (msg_ptr, name, namelen),
                                      consume=not peek)
        if vs.rxbuf:
            return self._scatter_rx(vs, iovs, consume=not peek)
        if vs.peer_closed:
            return 0
        if vs.nonblock:
            return -EAGAIN
        self._waiting = ("rmsg", vs, iovs, peek)
        return _BLOCK

    def _recvmsg_take(self, vs: VSocket, iovs, where,
                      consume: bool = True) -> int:
        # MSG_PEEK (consume=False) copies the head datagram without
        # dequeuing it, matching the recvfrom path (_dgram_take)
        if consume:
            payload, nbytes, src, sport = vs.dgram_q.pop(0)
        else:
            payload, nbytes, src, sport = vs.dgram_q[0]
        data = payload if payload is not None else b"\0" * nbytes
        msg_ptr, name_ptr, namelen = where if where else (0, 0, 0)
        if name_ptr and namelen:
            ip = self.host.controller.hosts[src].ip
            sa = (struct.pack("<H", socket.AF_INET) + struct.pack(">H", sport)
                  + socket.inet_aton(ip) + b"\0" * 8)
            # kernel semantics: truncate to the caller's buffer, then
            # write the un-truncated length back into msg_namelen
            self.mem.write(name_ptr, sa[:namelen])
            self.mem.write(msg_ptr + 8, struct.pack("<I", len(sa)))
        return self._scatter(iovs, data)

    def _writev(self, fd: int, iov_ptr: int, iovcnt: int):
        iovs = self._read_iovec(iov_ptr, iovcnt)
        data = b"".join(self.mem.read(b, min(ln, 1 << 20))
                        for b, ln in iovs if ln)
        if fd in (1, 2) and fd not in self.fds:
            self._capture(fd).write(data)
            return len(data)
        vs = self.fds.get(fd)
        if vs is None:
            return -EBADF
        if vs.kind == "event":
            if len(data) < 8:
                return -EINVAL
            vs.evt_counter += struct.unpack("<Q", data[:8])[0]
            self._notify()
            return 8
        if vs.kind in ("pipe_w", "spair"):
            return self._pipe_write(vs, data)
        if vs.kind in ("file", "dir"):
            return self.vfs.write(vs, data)
        return self._stream_send(vs, data)

    def _readv(self, fd: int, iov_ptr: int, iovcnt: int):
        if fd == 0 and 0 not in self.fds:
            return 0  # stdin: EOF, matching the read path
        vs = self.fds.get(fd)
        if vs is None:
            return -EBADF
        iovs = self._read_iovec(iov_ptr, iovcnt)
        if vs.kind in ("timer", "event"):
            if not iovs:
                return -EINVAL
            return self._counter_read(vs, iovs[0][0], iovs[0][1])
        if vs.kind in ("file", "dir"):
            data = self.vfs.read(vs, sum(ln for _, ln in iovs))
            if isinstance(data, int):
                return data
            return self._scatter(iovs, data)
        if vs.kind in ("pipe_r", "spair"):
            return self._pipe_read(vs, iovs)
        if vs.kind == "dgram":
            if not vs.dgram_q:
                if vs.nonblock:
                    return -EAGAIN
                self._waiting = ("dmsg", vs, iovs, None)
                return _BLOCK
            return self._recvmsg_take(vs, iovs, None)
        if vs.rxbuf:
            return self._scatter_rx(vs, iovs)
        if vs.peer_closed:
            return 0
        if vs.nonblock:
            return -EAGAIN
        self._waiting = ("rmsg", vs, iovs)
        return _BLOCK

    def _scatter(self, iovs, data: bytes) -> int:
        off = 0
        for base, ln in iovs:
            if off >= len(data):
                break
            k = min(ln, len(data) - off)
            self.mem.write(base, data[off:off + k])
            off += k
        return off

    # -- timerfd / eventfd ---------------------------------------------------
    def _counter_read(self, vs: VSocket, buf: int, buflen: int):
        if buflen < 8:
            return -EINVAL
        val = vs.expirations if vs.kind == "timer" else vs.evt_counter
        if val > 0:
            if vs.kind == "timer":
                vs.expirations = 0
            else:
                vs.evt_counter = 0
            self.mem.write(buf, struct.pack("<Q", val))
            return 8
        if vs.nonblock:
            return -EAGAIN
        self._waiting = ("cread", vs, buf, buflen)
        return _BLOCK

    def _timerfd_settime(self, fd: int, flags: int, new_ptr: int, old_ptr: int):
        vs = self.fds.get(fd)
        if vs is None or vs.kind != "timer":
            return -EBADF
        isec, insec, vsec, vnsec = struct.unpack(
            "<qqqq", self.mem.read(new_ptr, 32))
        # deadlines live in the timerfd's OWN clock base (timerfd_create
        # clockid): monotonic family counts from sim start
        now = (self.host.now if vs.timer_clock in MONO_CLOCKS
               else emulated(self.host.now))
        if old_ptr:
            left = max(vs.deadline - now, 0) if vs.timer_handle else 0
            self.mem.write(old_ptr, struct.pack(
                "<qqqq", vs.interval_ns // NS_PER_SEC,
                vs.interval_ns % NS_PER_SEC,
                left // NS_PER_SEC, left % NS_PER_SEC))
        if vs.timer_handle is not None:
            self.host.cancel(vs.timer_handle)
            vs.timer_handle = None
        vs.interval_ns = isec * NS_PER_SEC + insec
        first = vsec * NS_PER_SEC + vnsec
        if first == 0:
            return 0  # disarm
        if flags & TFD_TIMER_ABSTIME:
            delay = max(first - now, 0)
            vs.deadline = first
        else:
            delay = first
            vs.deadline = now + first
        vs.timer_handle = self.host.schedule_in(delay, lambda: self._timer_fire(vs))
        return 0

    def _timer_fire(self, vs: VSocket) -> None:
        if vs.vfd not in self.fds or not self.running:
            return
        vs.expirations += 1
        if vs.interval_ns > 0:
            vs.deadline += vs.interval_ns
            vs.timer_handle = self.host.schedule_in(
                vs.interval_ns, lambda: self._timer_fire(vs))
        else:
            vs.timer_handle = None
        th, w = self._find_waiter((("cread",), vs))
        if th is not None:
            self._resume(th, self._counter_read(vs, w[2], w[3]))
        else:
            self._notify()

    # -- datagram bridge ----------------------------------------------------
    def _dgram_bind(self, vs: VSocket):
        try:
            sock = self.host.udp_socket(vs.bound_port or None)
        except ValueError:
            return -98  # EADDRINUSE
        vs.udp = sock
        vs.bound_port = sock.local_port

        def on_datagram(nbytes, payload, src_addr, now):
            if vs.dgram_peer is not None and src_addr != vs.dgram_peer:
                return  # connected UDP filters inbound to the peer
            vs.dgram_q.append((payload, nbytes, src_addr[0], src_addr[1]))
            # wake every satisfiable waiter: a fulfilled MSG_PEEK leaves
            # the datagram queued for the next reader
            while vs.dgram_q:
                th, w = self._find_waiter((("drecv", "dmsg"), vs))
                if th is None:
                    break
                if w[0] == "drecv":
                    self._resume(
                        th, self._dgram_take(vs, w[2], w[3], w[4], w[5],
                                             consume=not (len(w) > 6
                                                          and w[6])))
                else:
                    self._resume(th, self._recvmsg_take(
                        vs, w[2], w[3],
                        consume=not (len(w) > 4 and w[4])))
            self._notify()

        sock.on_datagram = on_datagram
        return 0

    def _dgram_sendto(self, vs: VSocket, args, staged: bytes = None):
        if not args[4] and vs.dgram_peer is None:
            # NULL addr needs a connected socket; error BEFORE the
            # auto-bind so the failed send leaves the socket unbound,
            # like the kernel
            return -89  # EDESTADDRREQ
        if vs.udp is None:
            r = self._dgram_bind(vs)  # auto-bind an ephemeral port
            if r != 0:
                return r
        if not args[4]:
            peer, port = vs.dgram_peer
        else:
            raw = self.mem.read(args[4], min(max(args[5], 16), 128))
            port = struct.unpack_from(">H", raw, 2)[0]
            ip = socket.inet_ntoa(raw[4:8])
            try:
                peer = self.host.controller.resolve(ip)
            except KeyError:
                return -ENETUNREACH
        if staged is not None:
            data = staged
        else:
            data = self.mem.read(args[1], min(args[2], 1 << 16))
        vs.udp.sendto(peer, port, payload=data)
        return len(data)

    def _dgram_recvfrom(self, vs: VSocket, args, peek: bool = False):
        if vs.udp is None:
            return -ENOTCONN
        if vs.dgram_q:
            return self._dgram_take(vs, args[1], args[2], args[4], args[5],
                                    consume=not peek)
        if vs.nonblock:
            return -EAGAIN
        self._waiting = ("drecv", vs, args[1], args[2], args[4], args[5],
                         peek)
        return _BLOCK

    def _dgram_take(self, vs: VSocket, buf: int, buflen: int,
                    src_ptr: int, srclen_ptr: int,
                    consume: bool = True) -> int:
        if consume:
            payload, nbytes, src, sport = vs.dgram_q.pop(0)
        else:  # MSG_PEEK: inspect without dequeuing
            payload, nbytes, src, sport = vs.dgram_q[0]
        data = payload if payload is not None else b"\0" * nbytes
        k = min(len(data), buflen)
        self.mem.write(buf, data[:k])
        if src_ptr and srclen_ptr:
            ip = self.host.controller.hosts[src].ip
            sa = (struct.pack("<H", socket.AF_INET) + struct.pack(">H", sport)
                  + socket.inet_aton(ip) + b"\0" * 8)
            self.mem.write(src_ptr, sa)
            self.mem.write(srclen_ptr, struct.pack("<i", len(sa)))
        return k

    # -- stdio capture -----------------------------------------------------
    def _capture(self, fd: int):
        f = self._files.get(fd)
        if f is None:
            ddir = Path(self.host.controller.data_dir) / "hosts" / self.host.name
            ddir.mkdir(parents=True, exist_ok=True)
            suffix = "stdout" if fd == 1 else "stderr"
            f = open(ddir / f"{self.name}.{suffix}", "wb")  # fresh per run
            self._files[fd] = f
        return f
