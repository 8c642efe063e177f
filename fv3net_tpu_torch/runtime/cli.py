"""`runfv3` CLI: create / append / run-native / parse-logs (the JAX
package's ``runtime/cli.py``).

Mirrors the reference's segmented-run entry point
(workflows/prognostic_c48_run/runtime/segmented_run/cli.py:31-80) over
this framework's segmented-run API, dependency-free (argparse instead
of click):

    python -m fv3net_tpu_torch.runtime.cli create URL FV3CONFIG_YML
    python -m fv3net_tpu_torch.runtime.cli append URL [--n-steps N]
        [--device DEVICE]
    python -m fv3net_tpu_torch.runtime.cli run-native FV3CONFIG_YML RUNDIR
        [--n-steps N] [--device DEVICE]
    python -m fv3net_tpu_torch.runtime.cli parse-logs [PATHS...]

The model runs on the CUDA device unless --device names another
(``--device cpu``); without a CUDA device the default raises.
"""

from __future__ import annotations

import argparse
import json
import sys

import yaml


def create_cmd(url: str, fv3config_path: str) -> int:
    from .segmented_run import create

    with open(fv3config_path) as f:
        config = yaml.safe_load(f)
    create(url, config)
    return 0


def _device(device, command: str):
    """The device a model command runs on: the one named, else the CUDA
    device (raises without one, before anything is written)."""
    from ..device import default_device

    return device if device is not None else default_device(
        f"runfv3 {command}"
    )


def append_cmd(url: str, n_steps=None, device=None) -> int:
    from .segmented_run import append

    return append(url, n_steps=n_steps, device=_device(device, "append"))


def run_native_cmd(fv3config_path: str, rundir: str,
                   n_steps=None, device=None) -> int:
    """Set up a run directory and run one segment in it (the
    reference's run-native debugging entry, cli.py:56-63)."""
    from .segmented_run import append, create

    device = _device(device, "run-native")
    with open(fv3config_path) as f:
        config = yaml.safe_load(f)
    create(rundir, config)
    return append(rundir, n_steps=n_steps, device=device)


def parse_logs_cmd(paths) -> int:
    """Model-log text (the statistics blocks fv3logs understands) or a
    segment's scalars.jsonl -> one JSON document on stdout
    (cli.py:66-80 `runfv3 parse-logs`)."""
    from ..utils.fv3logs import loads
    from .timing import read_scalars

    out = []
    texts = []
    if paths:
        for p in paths:
            if p.endswith(".jsonl"):
                out.append(
                    {
                        name: [r["value"] for r in recs]
                        for name, recs in read_scalars(p).items()
                    }
                )
            else:
                with open(p) as f:
                    texts.append(f.read())
    else:
        texts.append(sys.stdin.read())
    for text in texts:
        log = loads(text)
        out.append(
            {
                "dates": [str(d) for d in log.dates],
                "totals": {
                    k: list(map(float, v))
                    for k, v in log.totals.items()
                },
            }
        )
    json.dump(out if len(out) > 1 else out[0], sys.stdout,
              default=str)
    print()
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="runfv3")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser(
        "create", help="initialize a segmented run at URL"
    )
    p.add_argument("url")
    p.add_argument("fv3config_path")

    device_help = "torch device of the model (default: the CUDA device)"
    p = sub.add_parser("append", help="run one more segment")
    p.add_argument("url")
    p.add_argument("--n-steps", type=int, default=None)
    p.add_argument("--device", default=None, help=device_help)

    p = sub.add_parser(
        "run-native",
        help="set up a run directory and run the model in it",
    )
    p.add_argument("fv3config_path")
    p.add_argument("rundir")
    p.add_argument("--n-steps", type=int, default=None)
    p.add_argument("--device", default=None, help=device_help)

    p = sub.add_parser(
        "parse-logs",
        help="model logs / scalars.jsonl -> JSON on stdout",
    )
    p.add_argument("paths", nargs="*")

    args = parser.parse_args(argv)
    if args.command == "create":
        return create_cmd(args.url, args.fv3config_path)
    if args.command == "append":
        return append_cmd(args.url, n_steps=args.n_steps,
                          device=args.device)
    if args.command == "run-native":
        return run_native_cmd(
            args.fv3config_path, args.rundir, n_steps=args.n_steps,
            device=args.device,
        )
    if args.command == "parse-logs":
        return parse_logs_cmd(args.paths)
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
