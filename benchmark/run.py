"""Run one cell of the benchmark once, on the card of the machine it starts on.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up (weights, inputs, warm-up) from ``--seed``, then a measured window of
``--seconds``, then the comparison with the plain reference. The last line of
standard output is the result, one JSON object; the last lines of standard error
are the compared numbers beside their limits. With no CUDA card, fewer cards than
the cell asks for, the port absent from the checkout, or JAX or the JAX package
loaded in the process, it prints no result and exits with another code than 0.
"""

from __future__ import annotations

import time

T0 = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parents[1]
BUILD = CHECKOUT / "build"
_STARTED = "PERFBENCH_T0"


def reexec() -> None:
    """Start over in this process with the caches fixed inside the checkout:
    bytecode (an installation that writes none beside torch's sources makes every
    interpreter compile them), Triton's and torch's extension caches."""
    env = dict(os.environ)
    env[_STARTED] = repr(T0)
    env["PYTHONPYCACHEPREFIX"] = str(BUILD / "pycache")
    env["TRITON_CACHE_DIR"] = str(BUILD / "triton")
    env["TORCH_EXTENSIONS_DIR"] = str(BUILD / "torch_extensions")
    env.pop("PYTHONDONTWRITEBYTECODE", None)
    os.execve(sys.executable, sys.orig_argv, env)


def main(argv=None) -> int:
    if _STARTED not in os.environ:
        reexec()
    t0 = float(os.environ[_STARTED])
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    from benchmark import harness

    cell = harness.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA card(s), found {have}",
              file=sys.stderr)
        return 2
    import tpu_resiliency_torch

    if Path(tpu_resiliency_torch.__file__).resolve().parents[1] != CHECKOUT:
        print("benchmark: the port package does not lie in this checkout", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), device, t0)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"benchmark: the run loaded {loaded}", file=sys.stderr)
        return 3
    sys.stdout.flush()
    for name, c in result["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
