"""Simulator logging: a main shadow.log plus per-host logs.

Mirrors the reference's logger + output-tree layout (SURVEY.md §2 "Logger",
§5.5): main log to ``<data_dir>/shadow.log`` (and mirrored to stderr),
per-host lines to ``<data_dir>/hosts/<name>/``. Log content that feeds
determinism tests contains sim time only — wall-clock appears only in
heartbeat lines, which determinism tests exclude.
"""

from __future__ import annotations

import sys
from pathlib import Path
from typing import Optional

LEVELS = {"error": 40, "warning": 30, "info": 20, "debug": 10, "trace": 5}


class SimLogger:
    def __init__(self, level: str = "info", path: Optional[Path] = None,
                 mirror_stderr: bool = True) -> None:
        self.level = LEVELS[level]
        self.lines: list[str] = []
        self.path = path
        self.mirror = mirror_stderr

    def log(self, level: str, msg: str) -> None:
        if LEVELS[level] < self.level:
            return
        line = f"[{level}] {msg}"
        self.lines.append(line)
        if self.mirror:
            print(line, file=sys.stderr)

    def error(self, msg: str) -> None:
        self.log("error", msg)

    def warning(self, msg: str) -> None:
        self.log("warning", msg)

    def info(self, msg: str) -> None:
        self.log("info", msg)

    def debug(self, msg: str) -> None:
        self.log("debug", msg)

    def flush(self) -> None:
        if self.path is not None:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            with open(self.path, "w") as f:
                f.write("\n".join(self.lines) + ("\n" if self.lines else ""))
