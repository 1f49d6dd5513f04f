"""Runs one cell of the benchmark once and prints its result line.

    python3 nsbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout on a machine with an NVIDIA GPU.  The last
line of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics with ``--trace 0``,
its per-layer metrics with ``--trace 1``), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each number that decided ``correct``
beside its limit; the checks are also the last lines of standard error.
Without a CUDA device, or with fewer than the cell asks for, it exits
with code 2 and prints no result.
"""

import time

T0 = time.perf_counter()   # set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the port must not load."""
    from nsbench.harness import FORBIDDEN
    return sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # every build and kernel cache of the program inside the checkout
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build"
                                             / "torch_extensions")
    sys.path.insert(0, str(ROOT))
    import torch

    import treensearch_tpu_torch  # noqa: F401  (the program under test)
    from nsbench import cells, harness
    cell = cells.Cell(args.workload, ROOT)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              ": no result", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), torch.device("cuda"), T0,
                              log=lambda s: print(s, flush=True))
    bad = forbidden_modules()
    if bad:
        print(f"modules loaded that the port must not load: {bad}; no "
              "result", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['rule']} "
              f"{c['limit']})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
