"""Managed-process memory access — the MemoryManager equivalent.

Reference analog: SURVEY.md §2 "MemoryManager" (reads/writes managed-process
memory for syscall arguments). The reference maps guest memory; we use the
kernel's cross-address-space copy syscalls (process_vm_readv/writev) via
ctypes — no /proc parsing, one syscall per access, and the shim stays
completely ignorant of argument semantics.
"""

from __future__ import annotations

import ctypes
import ctypes.util

_libc = ctypes.CDLL(ctypes.util.find_library("c") or "libc.so.6", use_errno=True)


class _IoVec(ctypes.Structure):
    _fields_ = [("iov_base", ctypes.c_void_p), ("iov_len", ctypes.c_size_t)]


def _vm_call(fn, pid: int, local_buf, remote_addr: int, n: int) -> int:
    local = _IoVec(ctypes.cast(local_buf, ctypes.c_void_p), n)
    remote = _IoVec(ctypes.c_void_p(remote_addr), n)
    got = fn(pid, ctypes.byref(local), 1, ctypes.byref(remote), 1, 0)
    if got < 0:
        raise OSError(ctypes.get_errno(), f"process_vm op failed (pid {pid})")
    return got


class ProcessMemory:
    """Read/write one managed process's address space."""

    def __init__(self, pid: int) -> None:
        self.pid = pid

    def read(self, addr: int, n: int) -> bytes:
        if n <= 0:
            return b""
        buf = ctypes.create_string_buffer(n)
        got = _vm_call(_libc.process_vm_readv, self.pid, buf, addr, n)
        return buf.raw[:got]

    def write(self, addr: int, data: bytes) -> int:
        if not data:
            return 0
        buf = ctypes.create_string_buffer(data, len(data))
        return _vm_call(_libc.process_vm_writev, self.pid, buf, addr, len(data))

    def read_cstr(self, addr: int, limit: int = 4096) -> bytes:
        """NUL-terminated guest string, read page-by-page: process_vm_readv
        fails wholesale if any page is unmapped, so never read past the
        page holding the terminator."""
        out = b""
        while len(out) < limit:
            avail = min(4096 - ((addr + len(out)) & 4095), limit - len(out))
            chunk = self.read(addr + len(out), avail)
            if b"\0" in chunk:
                return out + chunk.split(b"\0", 1)[0]
            out += chunk
        return out
