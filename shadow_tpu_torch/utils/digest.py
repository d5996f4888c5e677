"""Output-tree digest: one hash over a run's ``hosts/`` tree.

A copy of shadow_tpu/fleet.py::output_tree_digest (the fleet itself is not
ported), so the port computes the same identity on its own.
"""

from __future__ import annotations

import hashlib
import os


def output_tree_digest(data_dir) -> str:
    """One sha256 over the per-host output tree (path + content, sorted)
    — the identity the port is held to: the same config and seed give the
    same digest under shadow_tpu and shadow_tpu_torch. A raw os.scandir
    walk, as the reference's."""
    base = str(data_dir)
    hosts = os.path.join(base, "hosts")
    files = []
    stack = [hosts]
    while stack:
        d = stack.pop()
        try:
            # detlint: ok(unordered-iter): list is .sort()ed before hashing
            with os.scandir(d) as it:
                for e in it:
                    if e.is_dir(follow_symlinks=False):
                        stack.append(e.path)
                    elif e.is_file(follow_symlinks=False):
                        files.append(e.path)
        except FileNotFoundError:
            pass
    files.sort()
    h = hashlib.sha256()
    pfx = len(base) + 1
    for p in files:
        h.update(p[pfx:].encode())
        h.update(b"\0")
        with open(p, "rb") as f:
            h.update(hashlib.sha256(f.read()).digest())
    return h.hexdigest()
