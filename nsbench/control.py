"""The readings that the limits of ``correct`` are set from, on the card:
for each seed, the program's numbers (a short window of the cell's own
loop at its own size, judged as a run judges it) and the control's (the
reference in bfloat16 put in the program's place on the same inputs).

    python3 nsbench/control.py --workload <name> --seconds <s> \
        --seeds <n> [<n> ...]

prints one JSON line per seed and side.  The benchmark's own runs do not
run it.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
WARM_STEPS = 3     # steps before the short window


def readings(cell, seed: int, seconds: float, device) -> list:
    """The program's and the control's checks on one seed."""
    import torch

    from nsbench import harness, judge
    from nsbench.generate import Inputs
    t0 = time.perf_counter()
    inputs = Inputs(cell.config, cell.traffic, seed, device)
    start = inputs.snapshot()
    loop = harness.Loop(cell, inputs, device)
    for _ in range(WARM_STEPS):
        loop.run_step()
    win = harness.window(loop, seconds)
    failed = int(loop.failed)
    outputs = judge.program_outputs(loop)
    moves, zsort_moves = loop.moves, loop.zsort_moves
    loop.free()
    del loop
    t1 = time.perf_counter()
    program = judge.judge(cell, inputs, start, outputs, moves, zsort_moves)
    t2 = time.perf_counter()
    del outputs
    control = judge.judge(cell, inputs, start,
                          judge.control_outputs(cell, inputs, start, moves,
                                                zsort_moves),
                          moves, zsort_moves)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    common = {"workload": cell.name, "seed": seed, "steps": win["steps"],
              "failed": failed, "run_s": t1 - t0, "check_s": t2 - t1}
    return [dict(common, side=side, correct=v["correct"],
                 checks={k: c["value"] for k, c in v["checks"].items()})
            for side, v in (("program", program), ("control", control))]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from nsbench import cells
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = cells.Cell(args.workload, ROOT)
    for seed in args.seeds:
        for line in readings(cell, seed, args.seconds, torch.device("cuda")):
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
