"""Command-line entry point.

The port of shadow_tpu/cli.py: the same flags, exit codes and config
files, with the reference's paths for checkpointed runs
(``--checkpoint-every``, ``--resume-from``), multi-process sharding
(``--shards``), supervision (``--supervise``), the live operations plane
(``--live-endpoint``, ``--replay-commands``: live.py) and the ``fork``
verb (forks.py). A process path that is not ``pyapp:`` runs a real binary
as a managed process (native/managed.py); a managed run checkpoints as a
re-execution snapshot, and ``--shards`` above 1 refuses it by name, as the
reference does. Every config the reference runs, the port runs.
``--device`` (default cuda) says where the data-plane kernels run: ``cuda``
(every visible card), ``cpu``, or a comma list of device entries
(ops/devcfg.py ``select_devices``); a resume reattaches them on the
resuming invocation's entries. A card that is not visible is an error,
never a silent CPU run.

Usage:
    python -m shadow_tpu_torch [flags] config.yaml
"""

from __future__ import annotations

import argparse
import json
import sys

from shadow_tpu_torch.config.schema import SCHEDULER_POLICIES


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="shadow_tpu_torch",
        description="discrete-event network simulator, PyTorch/CUDA port "
        "of shadow_tpu",
    )
    p.add_argument("config", help="simulation YAML config file")
    p.add_argument("--stop-time", help="override general.stop_time")
    p.add_argument("--seed", type=int, help="override general.seed")
    p.add_argument("--parallelism", type=int, help="override general.parallelism")
    p.add_argument("--log-level", help="override general.log_level")
    p.add_argument("--data-directory", help="override general.data_directory")
    p.add_argument(
        "--scheduler-policy",
        choices=list(SCHEDULER_POLICIES),
        help="override experimental.scheduler_policy",
    )
    p.add_argument(
        "--shards", type=int, metavar="N",
        help="partition the host set across N worker processes "
        "(general.sim_shards): static id-modulo placement, conservative "
        "cross-shard windows, byte-identical results at any shard count",
    )
    p.add_argument(
        "--checkpoint-every", metavar="SIMTIME",
        help="write a full-state checkpoint every SIMTIME of simulated "
        "time (general.checkpoint_every); resumed runs are byte-identical "
        "to uninterrupted ones",
    )
    p.add_argument(
        "--checkpoint-dir",
        help="checkpoint directory (general.checkpoint_dir; default "
        "<data-directory>/checkpoints)",
    )
    p.add_argument(
        "--resume-from", metavar="CKPT",
        help="resume from a checkpoint file written by --checkpoint-every "
        "(the config must match the original run)",
    )
    p.add_argument(
        "--sample-every", metavar="SIMTIME",
        help="enable the telemetry subsystem and snapshot per-host/per-NIC "
        "state every SIMTIME of simulated time (telemetry.sample_every); "
        "metrics.jsonl + flows.jsonl land in the metrics directory and are "
        "byte-identical across scheduler policies and data planes",
    )
    p.add_argument(
        "--metrics-dir",
        help="enable telemetry and write metrics.jsonl/flows.jsonl here "
        "(telemetry.metrics_dir; default <data-directory>)",
    )
    p.add_argument(
        "--state-digest-every", type=int, metavar="N",
        help="determinism sentinel: emit a canonical state digest every N "
        "rounds to <data-directory>/state_digests.jsonl "
        "(general.state_digest_every); diff two streams with "
        "tools/bisect_divergence.py",
    )
    p.add_argument(
        "--live-endpoint", metavar="PATH",
        help="bind an AF_UNIX live-operations endpoint "
        "(general.live_endpoint): stream heartbeats/metrics/flow "
        "snapshots and accept runtime fault commands, applied at the "
        "next round boundary and logged to commands.jsonl; 'auto' = "
        "<data-directory>/live.sock",
    )
    p.add_argument(
        "--replay-commands", metavar="FILE",
        help="replay a recorded commands.jsonl (general.replay_commands): "
        "re-applies each command at its original round boundary, "
        "reproducing an interactively driven run byte-identically",
    )
    p.add_argument(
        "--supervise", action="store_true",
        help="run under the self-healing supervisor (general.supervise): "
        "liveness watchdogs name dead/wedged workers, the run auto-resumes "
        "from the newest complete checkpoint with a bounded restart budget, "
        "and an unrecoverable crash writes crash_report.json; tune with "
        "--set general.supervise.max_restarts / .backoff",
    )
    p.add_argument(
        "--device", default="cuda", metavar="DEVICE",
        help="where the data-plane kernels run (default cuda): the "
        "loss-draw kernels under tpu_batch, the mesh kernels under "
        "tpu_mesh. cuda is every visible card, cpu runs the plain PyTorch "
        "versions, and a comma list names the device entries in shard "
        "order, an entry repeated at will (cuda:0,cuda:1; "
        "cuda:0,cuda:0,cuda:0,cuda:0; cpu,cpu,cpu,cpu): tpu_mesh puts "
        "shard i on entry i, tpu_batch splits each draw batch over "
        "experimental.tpu_mesh_shards entries (0: all). Single-device "
        "work runs on entry 0. The thread policies (thread_per_core, the "
        "default, and thread_per_host) are the reference's CPU baseline "
        "and launch no kernel",
    )
    p.add_argument(
        "--set",
        action="append",
        default=[],
        metavar="KEY=VALUE",
        help="override any config option by dotted path "
        "(e.g. --set experimental.runahead=5ms); repeatable",
    )
    p.add_argument(
        "--show-config", action="store_true",
        help="print the resolved configuration and exit",
    )
    p.add_argument(
        "--json-summary", action="store_true",
        help="print the end-of-run summary as one JSON line on stdout",
    )
    p.add_argument("--quiet", action="store_true", help="no log mirroring to stderr")
    return p


def overrides_from_args(args: argparse.Namespace) -> dict:
    ov: dict = {}
    flag_map = {
        "stop_time": "general.stop_time",
        "seed": "general.seed",
        "parallelism": "general.parallelism",
        "log_level": "general.log_level",
        "data_directory": "general.data_directory",
        "scheduler_policy": "experimental.scheduler_policy",
        "shards": "general.sim_shards",
        "checkpoint_every": "general.checkpoint_every",
        "checkpoint_dir": "general.checkpoint_dir",
        "state_digest_every": "general.state_digest_every",
        "sample_every": "telemetry.sample_every",
        "metrics_dir": "telemetry.metrics_dir",
        "live_endpoint": "general.live_endpoint",
        "replay_commands": "general.replay_commands",
    }
    for attr, key in flag_map.items():
        val = getattr(args, attr)
        if val is not None:
            ov[key] = val
    if args.supervise:
        # boolean flag: schema normalizes True -> defaults
        ov["general.supervise"] = True
    for item in args.set:
        if "=" not in item:
            print(f"shadow_tpu_torch: --set expects KEY=VALUE, got {item!r}",
                  file=sys.stderr)
            raise SystemExit(2)
        k, v = item.split("=", 1)
        import yaml as _yaml

        ov[k] = _yaml.safe_load(v)
    return ov


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] == "fork":
        # the fork verb: `python -m shadow_tpu_torch fork cfg.yaml --from
        # CKPT --branches branches.yaml` — checkpoint-forked what-if trees
        # (forks.py; also `python -m shadow_tpu_torch.fleet sweep
        # --fork-from`)
        from shadow_tpu_torch.forks import main as _fork_main

        return _fork_main(argv[1:])
    args = build_parser().parse_args(argv)
    from shadow_tpu_torch.checkpoint import CheckpointError
    from shadow_tpu_torch.config import load_config
    from shadow_tpu_torch.core.controller import Controller

    try:
        cfg = load_config(args.config, overrides_from_args(args))
    except FileNotFoundError:
        print(f"shadow_tpu_torch: config file not found: {args.config}",
              file=sys.stderr)
        return 2
    except ValueError as exc:
        print(f"shadow_tpu_torch: {exc}", file=sys.stderr)
        return 2
    if args.show_config:
        import dataclasses

        def enc(o):
            if dataclasses.is_dataclass(o):
                return dataclasses.asdict(o)
            return str(o)

        print(json.dumps(
            {
                "general": dataclasses.asdict(cfg.general),
                "network": cfg.network,
                "experimental": dataclasses.asdict(cfg.experimental),
                "hosts": [dataclasses.asdict(h) for h in cfg.hosts],
                **({"faults": dataclasses.asdict(cfg.faults)}
                   if cfg.faults is not None else {}),
                **({"telemetry": dataclasses.asdict(cfg.telemetry)}
                   if cfg.telemetry is not None else {}),
            },
            indent=2, default=enc,
        ))
        return 0
    mirror = not args.quiet
    if cfg.general.supervise is not None:
        # self-healing path (supervise.py): wraps the sharded or
        # single-process run in restart-on-failure with checkpoint resume;
        # the recovered result is byte-identical to an uninterrupted run
        from shadow_tpu_torch.supervise import SupervisorGaveUp, run_supervised

        try:
            result = run_supervised(cfg, mirror_log=mirror,
                                    resume_from=args.resume_from or None,
                                    device=args.device)
        except FileNotFoundError as exc:
            print(f"shadow_tpu_torch: checkpoint not found: {exc}",
                  file=sys.stderr)
            return 2
        except (ValueError, CheckpointError) as exc:
            print(f"shadow_tpu_torch: {exc}", file=sys.stderr)
            return 2
        except SupervisorGaveUp as exc:
            # restart budget exhausted or unrecoverable failure class; the
            # structured post-mortem is in <data_dir>/crash_report.json
            print(f"shadow_tpu_torch: {exc}", file=sys.stderr)
            return 1
    elif cfg.general.sim_shards > 1:
        # multi-process host partitioning (parallel/shards.py): the parent
        # coordinator replaces the single-process controller; results are
        # byte-identical at any shard count
        from shadow_tpu_torch.parallel.shards import run_sharded

        try:
            result = run_sharded(cfg, mirror_log=mirror,
                                 resume_from=args.resume_from or None,
                                 device=args.device)
        except FileNotFoundError as exc:
            print(f"shadow_tpu_torch: checkpoint not found: {exc}",
                  file=sys.stderr)
            return 2
        except (ValueError, CheckpointError) as exc:
            print(f"shadow_tpu_torch: {exc}", file=sys.stderr)
            return 2
    elif args.resume_from:
        from shadow_tpu_torch.checkpoint import load_checkpoint

        try:
            controller, resume_at = load_checkpoint(
                args.resume_from, cfg, mirror_log=mirror, device=args.device)
        except FileNotFoundError:
            print(f"shadow_tpu_torch: checkpoint not found: "
                  f"{args.resume_from}", file=sys.stderr)
            return 2
        except (ValueError, CheckpointError) as exc:
            # CheckpointError, and a device this process cannot use
            print(f"shadow_tpu_torch: {exc}", file=sys.stderr)
            return 2
        result = controller.run(resume_at=resume_at)
    else:
        try:
            controller = Controller(cfg, mirror_log=mirror,
                                    device=args.device)
        except ValueError as exc:
            # build-time refusals (no card for --device cuda, bad host
            # placement, unknown fault targets, checkpoint-unsupported
            # configs, missing executables) keep the clean one-line error
            # contract
            print(f"shadow_tpu_torch: {exc}", file=sys.stderr)
            return 2
        result = controller.run()
    if args.json_summary:
        print(json.dumps(result))
    if result.get("exit_reason") == "interrupted":
        # conventional signal exit status; the JSON summary above is still
        # a valid (partial) artifact
        import signal as _signal

        sig = result.get("interrupt_signal", "SIGINT")
        return 128 + int(getattr(_signal.Signals, sig, _signal.SIGINT))
    return 1 if result["process_errors"] else 0


if __name__ == "__main__":
    sys.exit(main())
