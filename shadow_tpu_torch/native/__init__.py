"""Native pieces: the C engine of the columnar plane and the managed
processes' preload shim, both built from the port's own sources.

The counterpart of shadow_tpu/native/__init__.py's loader. The engine is
shadow_tpu_torch/csrc/colcore.c, a copy of native/colcore/colcore.c that
differs only where tests/test_torch_colcore.py allows (the module it
fetches ``StoreBatch`` from). ``colcore()`` returns the extension module,
building it at first use with the C compiler and the reference's flags
(native/Makefile: ``cc -O2 -Wall -Wextra -fPIC -shared`` with Python's and
numpy's include directories) into ``shadow_tpu_torch/_build/`` (listed in
.gitignore), named by a hash of the source, the flags, both include
directories and the Python and numpy versions, and renamed into place
atomically, so processes that build
at once each see a whole library. A failed build raises with the
compiler's output: the engine is never silently replaced by the Python
plane; ``experimental.native_colcore: false`` is the way to run without it.

The shim (``shim_lib()``) is csrc/shim/shim.c, a byte-for-byte copy of
native/shim/shim.c (with csrc/shring.h, native/shring.h's copy, beside it),
built the same way with native/Makefile's flags (``cc -O2 -Wall -Wextra
-shared -fPIC ... -ldl``) into ``_build/libshadow_shim-<hash>.so``;
``SHADOW_SHIM_LIB`` names another library instead, as in the reference.
``ManagedProcess`` (native/managed.py) preloads it into every guest.
"""

from __future__ import annotations

import hashlib
import importlib.util
import os
import shutil
import subprocess
import sys
import sysconfig
import threading
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]
SOURCE = PKG / "csrc" / "colcore.c"
BUILD = PKG / "_build"
CFLAGS = ("-O2", "-Wall", "-Wextra", "-fPIC", "-shared")
SHIM_SOURCE = PKG / "csrc" / "shim" / "shim.c"
SHIM_HEADER = PKG / "csrc" / "shring.h"
SHIM_CFLAGS = ("-O2", "-Wall", "-Wextra", "-shared", "-fPIC")
SHIM_LIBS = ("-ldl",)
MODULE = "shadow_tpu_torch.native._colcore"

_lock = threading.Lock()
_mod = None
_shim = None

_ENGINE_HINT = ("set experimental.native_colcore: false to run the Python "
                "columnar plane instead")


def _compiler(what: str = f"the C engine {SOURCE}",
              hint: str = _ENGINE_HINT) -> str:
    cc = os.environ.get("CC") or shutil.which("cc") or shutil.which("gcc")
    if not cc:
        raise RuntimeError(
            f"no C compiler (looked at $CC, cc, gcc) to build {what}; "
            f"{hint}")
    return cc


def _compile(out: Path, cmd_of, what: str, hint: str) -> Path:
    """Run the compiler into a private temporary name and rename it onto
    ``out`` (atomic: a concurrent build sees all or nothing). Raises with
    the compiler's output."""
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = cmd_of(str(tmp))
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"building {what} failed (exit {proc.returncode}):\n"
            f"$ {' '.join(cmd)}\n{proc.stdout}\n{hint}")
    os.replace(tmp, out)
    return out


def _includes() -> list:
    import numpy as np

    return ["-I" + sysconfig.get_paths()["include"], "-I" + np.get_include()]


def lib_path() -> Path:
    """Library name: a hash of the source, flags, include directories and
    the versions of the interpreter and numpy it is built against."""
    import numpy as np

    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CFLAGS + tuple(_includes())).encode())
    h.update(f"{sys.version}|{np.__version__}".encode())
    return BUILD / f"_colcore-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Build the engine unless the library for this exact source exists;
    returns its path. Raises with the compiler's output."""
    out = lib_path()
    if out.exists():
        return out
    return _compile(
        out, lambda tmp: [_compiler(), *CFLAGS, *_includes(), "-o", tmp,
                          str(SOURCE)], "the C engine", _ENGINE_HINT)


def colcore():
    """The engine's extension module, built and loaded on first use."""
    global _mod
    if _mod is not None:
        return _mod
    with _lock:
        if _mod is None:
            path = build()
            spec = importlib.util.spec_from_file_location(MODULE, path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            sys.modules[MODULE] = mod
            _mod = mod
    return _mod


_SHIM_HINT = "managed processes need the preload shim"


def shim_path() -> Path:
    """The shim's library name: a hash of its source, the header it
    includes and the flags."""
    h = hashlib.sha256(SHIM_SOURCE.read_bytes())
    h.update(SHIM_HEADER.read_bytes())
    h.update(" ".join(SHIM_CFLAGS + SHIM_LIBS).encode())
    return BUILD / f"libshadow_shim-{h.hexdigest()[:16]}.so"


def build_shim() -> Path:
    """Build the shim unless the library for this exact source exists;
    returns its path. Raises with the compiler's output."""
    out = shim_path()
    if out.exists():
        return out
    return _compile(
        out, lambda tmp: [
            _compiler(f"the preload shim {SHIM_SOURCE}", _SHIM_HINT),
            *SHIM_CFLAGS, "-o", tmp, str(SHIM_SOURCE), *SHIM_LIBS],
        "the preload shim", _SHIM_HINT)


def shim_lib() -> Path:
    """The preload shim every managed guest loads: ``SHADOW_SHIM_LIB``
    when set, else the port's build, made at first use."""
    override = os.environ.get("SHADOW_SHIM_LIB")
    if override:
        return Path(override)
    global _shim
    if _shim is None:
        with _lock:
            if _shim is None:
                _shim = build_shim()
    return _shim


from shadow_tpu_torch.native.managed import ManagedProcess  # noqa: E402,F401
