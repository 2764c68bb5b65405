"""Read a cell's compared numbers on sound runs and on the control.

    python3 provbench/control.py --workload <cell> --seconds 3 --seeds <n> <n> ...

For each seed, one run of the cell (a short window at the cell's own
sizes and load, judged on as many answers as a full run) in one process,
and the control on the same sample: the plain reference computed in
bfloat16, the precision below the configurations' float32, put in the
port's place.  Prints one JSON line a seed: the sound readings and the
control's.  A cell's limits are set between the largest sound reading and
the smallest control reading (PERF.md gives both); the benchmark's own
runs never run the control.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)

    from provbench import harness

    for seed in args.seeds:
        r = harness.run_cell(args.workload, seed, args.seconds, False, args.device,
                             control=True)
        print(json.dumps({"seed": seed, "correct": r["correct"],
                          "sound": {k: v["value"] for k, v in r["checks"].items()},
                          "limits": {k: v["limit"] for k, v in r["checks"].items()},
                          "control": r["control"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
