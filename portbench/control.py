"""Readings the comparison's limits are set from, for one cell, in one
process: the program's numbers over many seeds (the lower readings) and
the control's, the reference in the precision below the configuration's
put in the program's place (the upper readings).

    python3 portbench/control.py --workload <cell> --seconds 4 \
        --seeds 1 2 3 ... --control-seeds 101 102 103

Each run drives a short window at the cell's own size and load, as many
requests compared as in a benchmark run. One JSON line a run, then the
largest program reading and the smallest control reading of each number.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(cell, devices, seeds, seconds, control, log=print):
    from portbench import harness
    out = []
    for seed in seeds:
        r = harness.run(cell, devices, seed, seconds, False,
                        time.perf_counter(),
                        system=harness.Control if control else None)
        row = {"seed": seed, "control": control, "correct": r["correct"],
               "completed": r["attempted"] - r["failed"],
               **{k: c["value"] for k, c in r["checks"].items()}}
        log(json.dumps(row), flush=True)
        out.append(row)
    return out


def summary(rows, names):
    prog = [r for r in rows if not r["control"]]
    ctrl = [r for r in rows if r["control"]]
    return {k: {"lower": max((r[k] for r in prog), default=None),
                "upper": min((r[k] for r in ctrl), default=None)}
            for k in names}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    from portbench import harness
    cell = harness.Cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s)",
              file=sys.stderr)
        return 2
    devices = harness.Devices([torch.device("cuda", i)
                               for i in range(cell.chips)])
    rows = readings(cell, devices, args.seeds, args.seconds, False)
    rows += readings(cell, devices, args.control_seeds, args.seconds, True)
    print(json.dumps({"workload": args.workload,
                      "readings": summary(rows, list(cell.limits))}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
