"""Readings for the limits of a cell's numbers, many seeds in one process,
each judged by the harness's own comparison (``result``).

    python3 perfbench/calibrate.py --workload <name> --seeds 11,12,13 \
        [--control-seeds 11,12] [--fault half_batch --fault-seeds 21,22] \
        [--seconds 20]

For each seed a run of the cell, as ``run.py`` makes it (the window lasts
``--seconds``; 0 takes one step), and one JSON line: the program's result
line and all its readings. On the control seeds a second line: the result
line with the control's readings in the program's place (the plain
reference computed in fp8, against the same float32 reference), which has
to read ``"correct": false``. On the fault seeds, a run with the named
fault planted under the timed path (``faults.py``), which has to read
false too. The limits in limits/<workload>.json are set from these
readings: above the largest of the program's, below the smallest of the
control's (and, in a training cell, of each fault's).
"""

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent / "src")]

import torch  # noqa: E402

import faults  # noqa: E402
from harness.run import Run, execute, free_device, result  # noqa: E402
from harness.spec import load_cell  # noqa: E402


def _ints(s: str):
    return [int(x) for x in s.split(",") if x]


def line(run: Run, side: str, readings, t0: float) -> str:
    judged = dataclasses.replace(run, readings=readings)
    return json.dumps({
        "workload": run.cell.name, "seed": run.seed, "side": side,
        "result": result(judged), "readings": readings, "units": run.units,
        "seconds": time.perf_counter() - t0})


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_ints, default=[])
    ap.add_argument("--control-seeds", type=_ints, default=[])
    ap.add_argument("--fault", action="append", default=[],
                    choices=sorted(faults.FAULTS))
    ap.add_argument("--fault-seeds", type=_ints, default=[])
    ap.add_argument("--seconds", type=float, default=0.0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3
    cell = load_cell(args.workload)
    plan = [(s, None) for s in sorted(set(args.seeds)
                                      | set(args.control_seeds))]
    plan += [(s, args.fault) for s in args.fault_seeds]
    for seed, fault in plan:
        t0 = time.perf_counter()
        run = Run(cell, seed, args.seconds, False, torch.device("cuda", 0))
        if fault:
            readings = execute(run, t0, plant=faults.plant(*fault))
            print(line(run, "fault:" + "+".join(fault), run.readings, t0),
                  flush=True)
        else:
            sides = ("program", "control") if seed in args.control_seeds \
                else ("program",)
            readings = execute(run, t0, sides=sides)
            for side in sides:
                print(line(run, side, readings[side], t0), flush=True)
        del run, readings
        free_device()
    return 0


if __name__ == "__main__":
    sys.exit(main())
