"""The readings the limits of `correct` are set from: the program's runs
and the control's, several seeds in one process, on the chip.

    python3 portbench/control.py --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...] [--program] [--control]

--program runs the cell as the benchmark does; --control runs it with
the control in the program's place: for a denoising cell the program's
own int8 paths (W8A8 linears in the DiT and int8 p.v in the flash
forward), for the decode the plain reference computed with fp8 operands. Each run
prints one JSON line with its compared numbers. The benchmark's own runs
never run the control.
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench.core import harness  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("control.py: needs a CUDA device", file=sys.stderr)
        return 2
    cell, config, traffic, bench = harness.cell_files(args.workload)
    limits = harness.limits_of(cell["name"])
    sides = [s for s, on in (("program", args.program),
                             ("control", args.control)) if on]
    for seed in args.seeds:
        for side in sides:
            t0 = time.perf_counter()
            res, numbers = harness.run_cell(
                cell, config, traffic, bench, seed, args.seconds, False,
                "cuda", t0, control=side == "control", limits=limits)
            print(json.dumps({"side": side, "seed": seed,
                              "units": res["attempted"],
                              "seconds": time.perf_counter() - t0,
                              "numbers": {n: v for n, v, _ in numbers}}),
                  flush=True)
            del res
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
