"""What a simulation's clients must have finished by the config's stop
time, read from the log lines its hosts/ tree holds.

The config's YAML says which host runs which application with which
arguments (``quantity: N`` stamps out hosts ``<name>0`` .. ``<name>N-1``).
For each application class that has a rule, ``portbench/outcomes/<class>.py``,
the rule's ``expected(args)`` is the number of completions that the
arguments ask for and ``found(args, lines, apps)`` the number that the
host's log shows done as asked (``apps``: host name -> the classes it
runs). A simulation's shortfall sums ``|expected - found|`` over every
host with a rule. Plain: the YAML and the log text, nothing of the program.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import yaml

HERE = Path(__file__).resolve().parent


def _rule(cls: str):
    path = HERE / "outcomes" / f"{cls}.py"
    if not path.is_file():
        return None
    spec = importlib.util.spec_from_file_location(
        f"portbench.outcomes.{cls}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Plan:
    """The clients of one config whose completions a rule can read."""

    def __init__(self, config_file: Path) -> None:
        with open(config_file) as f:
            doc = yaml.safe_load(f)
        self.apps = {}
        procs = []
        for name, h in doc["hosts"].items():
            qty = int(h.get("quantity", 1))
            names = [str(name)] if qty == 1 else [f"{name}{i}"
                                                  for i in range(qty)]
            for host in names:
                for p in h["processes"]:
                    cls = str(p["path"]).rsplit(":", 1)[-1]
                    self.apps.setdefault(host, set()).add(cls)
                    procs.append((host, cls, [str(a) for a in
                                              p.get("args", [])]))
        rules = {cls: _rule(cls) for _, cls, _ in procs}
        self.clients = [(host, rules[cls], args) for host, cls, args in procs
                        if rules[cls] is not None]

    def shortfall(self, hosts_dir: Path) -> int:
        bad = 0
        for host, rule, args in self.clients:
            log = Path(hosts_dir) / host / f"{host}.log"
            lines = log.read_text().splitlines() if log.is_file() else []
            bad += abs(rule.expected(args) - rule.found(args, lines,
                                                         self.apps))
        return bad
