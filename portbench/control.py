"""Read the controls of a cell at its own size: the comparison's numbers
when the reference, in the precision below the configuration's, stands in
the program's place (``yardstick/control.py``, driven by the ``control``
of the mix's kind, ``kinds/<kind>.py``). Each has to come out not correct.
Prints one JSON line per seed.

    python3 portbench/control.py --workload wt10g.build --seeds 1,2,3
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from yardstick import cells, judge  # noqa: E402


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args()
    cell = cells.load_cell(args.workload)
    for s in args.seeds.split(","):
        nums = cells.kind_module(cell.mix["kind"]).control(cell, int(s))
        print(json.dumps({"workload": args.workload, "seed": int(s),
                          "correct": judge.verdict(nums), "numbers": nums}), flush=True)
