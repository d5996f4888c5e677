"""The C engine of the columnar plane, built from the port's own source.

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
MODULE = "shadow_tpu_torch.native._colcore"

_lock = threading.Lock()
_mod = None


def _compiler() -> str:
    cc = os.environ.get("CC") or shutil.which("cc") or shutil.which("gcc")
    if not cc:
        raise RuntimeError(
            "no C compiler (looked at $CC, cc, gcc) to build the C engine "
            f"{SOURCE}; set experimental.native_colcore: false to run the "
            "Python columnar plane instead")
    return cc


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
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [_compiler(), *CFLAGS, *_includes(), "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"building the C engine failed (exit {proc.returncode}):\n"
            f"$ {' '.join(cmd)}\n{proc.stdout}\n"
            "set experimental.native_colcore: false to run the Python "
            "columnar plane instead")
    os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    return out


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
