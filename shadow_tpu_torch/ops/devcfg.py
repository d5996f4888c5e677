"""Device selection and the CUDA kernel build for shadow_tpu_torch.

Replaces shadow_tpu/ops/jaxcfg.py. Two jobs:

- ``select_device(name)``: turn ``--device cuda|cpu`` into a
  ``torch.device``. Asking for ``cuda`` where PyTorch sees no card is an
  error, never a silent CPU run.
- ``kernel_lib(stem)``: the ctypes handle of ``csrc/<stem>.cu`` built for
  Hopper (``sm_90a``) into a shared library with a plain C interface;
  ``device_pointer(t, stem)`` the card's address of a page-locked buffer
  that such a kernel reads or writes in place.
  Builds happen at first use into ``shadow_tpu_torch/_build/`` (listed in
  .gitignore), named by a hash of the sources and flags, so an edited
  source rebuilds and an unchanged one loads at once. A failed build
  raises with nvcc's output. Nothing here is imported from outside the
  repository.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD = PKG / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-lineinfo")

#: C signatures of every entry point, per source (pointers and the stream
#: are c_void_p: ctypes would pass a bare int as 32 bits and cut it)
_DEVICE_POINTER = (ctypes.c_int, [ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_void_p)])
_SIGNATURES = {
    "draw": {
        "shadow_draw_flags": (ctypes.c_int, [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_uint32,
            ctypes.c_uint32, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p]),
        "shadow_min_draw": (ctypes.c_int, [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_uint32,
            ctypes.c_uint32, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p]),
        "shadow_threefry": (ctypes.c_int, [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_uint32,
            ctypes.c_void_p, ctypes.c_void_p]),
        "shadow_device_pointer": _DEVICE_POINTER,
        "shadow_cuda_error_string": (ctypes.c_char_p, [ctypes.c_int]),
    },
    "mesh": {
        "shadow_mesh_exchange": (ctypes.c_int, [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]),
        "shadow_mesh_rounds": (ctypes.c_int, [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p]),
        "shadow_device_pointer": _DEVICE_POINTER,
        "shadow_cuda_error_string": (ctypes.c_char_p, [ctypes.c_int]),
    },
    "transport": {
        "shadow_ack_advance": (ctypes.c_int, [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p]),
        "shadow_device_pointer": _DEVICE_POINTER,
        "shadow_cuda_error_string": (ctypes.c_char_p, [ctypes.c_int]),
    },
    "apsp": {
        "shadow_apsp_square": (ctypes.c_int, [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p]),
        "shadow_cuda_error_string": (ctypes.c_char_p, [ctypes.c_int]),
    },
}

#: one lock per source, so two sources build at once in two threads
_locks = {stem: threading.Lock() for stem in _SIGNATURES}
_libs: dict = {}


class DeviceUnavailable(ValueError):
    """The caller asked for a device this process cannot use."""


class DrawServiceError(RuntimeError):
    """The fleet's shared draw service (ops/propagate.py ``DrawServer``)
    failed a member: its attach or a launch failed, or the member could
    not reach it or lost its connection. The member raises it and its
    seed fails; it never draws on the host in the card's place."""


def require_device(name: str = "cuda") -> None:
    """Raise DeviceUnavailable unless this process can use ``name``
    (``cuda`` or ``cpu``), without initialising CUDA: the cards are
    counted through NVML (``torch.cuda.device_count``), which unlike
    ``torch.cuda.is_available`` does not call cuInit. A controller checks
    its device this way at construction; a shard worker or a served fleet
    member, which launches nothing, never touches the card; and the fleet
    parent can still fork its workers afterwards."""
    import torch

    if name == "cpu":
        return
    if name != "cuda":
        raise DeviceUnavailable(
            f"unknown device {name!r} (want cuda or cpu)")
    if torch.cuda.device_count() == 0:
        raise DeviceUnavailable(
            "device cuda requested but torch.cuda.is_available() is false; "
            "pass --device cpu to run the plain PyTorch kernels on the CPU")


def select_device(name: str = "cuda"):
    """``torch.device`` for ``name`` (``cuda`` or ``cpu``). Raises
    DeviceUnavailable for ``cuda`` when no card is visible."""
    import torch

    require_device(name)
    if name == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", torch.cuda.current_device())


def visible_devices(device) -> int:
    """How many devices of ``device``'s type this process can use: the
    CUDA cards PyTorch sees, or 1 for the CPU."""
    import torch

    if torch.device(device).type == "cuda":
        return torch.cuda.device_count()
    return 1


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, nvcc on PATH, or
    /usr/local/cuda/bin/nvcc."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH, /usr/local/cuda/bin);"
        " the CUDA kernels of shadow_tpu_torch/csrc cannot be built")


def _included(src: Path) -> list:
    """``src`` and every csrc header it includes (``#include "x.cuh"``,
    followed transitively), sorted by name."""
    seen = {src.name: src}
    todo = [src]
    while todo:
        for m in re.finditer(r'^\s*#include\s+"([^"]+)"',
                             todo.pop().read_text(), re.M):
            dep = CSRC / m.group(1)
            if m.group(1) not in seen and dep.exists():
                seen[m.group(1)] = dep
                todo.append(dep)
    return [seen[k] for k in sorted(seen)]


def _lib_path(src: Path) -> Path:
    """Library name: a hash of the source, the headers it includes and the
    flags, so editing any of them rebuilds."""
    h = hashlib.sha256()
    for f in _included(src):
        h.update(f.name.encode() + b"\0" + f.read_bytes() + b"\0")
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return BUILD / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def _build(src: Path) -> Path:
    """Build ``src`` with nvcc unless the library for these exact sources
    exists; returns the library path. Raises with nvcc's output."""
    out = _lib_path(src)
    if out.exists():
        return out
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [nvcc_path(), *ARCH_FLAGS, *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}) building {out.name}:\n"
            f"$ {' '.join(cmd)}\n{proc.stdout}")
    os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    return out


def kernel_lib(stem: str):
    """ctypes handle of ``csrc/<stem>.cu``, built on first use, with the
    argument and result types of its entry points set."""
    lib = _libs.get(stem)
    if lib is not None:
        return lib
    src = CSRC / f"{stem}.cu"
    if not src.exists():
        raise RuntimeError(f"kernel source {src} is missing")
    with _locks[stem]:
        lib = _libs.get(stem)
        if lib is not None:
            return lib
        lib = ctypes.CDLL(str(_build(src)))
        for name, (res, args) in _SIGNATURES[stem].items():
            fn = getattr(lib, name)
            fn.restype = res
            fn.argtypes = args
        _libs[stem] = lib
    return lib


def device_pointer(t, stem: str) -> int:
    """The card's address of the page-locked host tensor ``t``, for a
    kernel of ``csrc/<stem>.cu`` that reads or writes it in place, or an
    exception."""
    lib = kernel_lib(stem)
    out = ctypes.c_void_p()
    code = lib.shadow_device_pointer(t.data_ptr(), ctypes.byref(out))
    check_launch(lib, code, f"device address of a page-locked {stem} buffer")
    return int(out.value or 0)


def check_launch(lib, code: int, what: str) -> None:
    """Raise if a C entry point reported a launch error."""
    if code != 0:
        msg = lib.shadow_cuda_error_string(code)
        raise RuntimeError(
            f"{what}: CUDA launch failed with error {code} "
            f"({msg.decode() if msg else 'unknown'})")
