"""The control: the reference put in the program's place and pricing the
latency in float32, the precision below the float64 the configuration
states.  The check has to reject it.  Not run by the benchmark's own runs:

    python3 bench/control.py --workload <cell> --seconds <s> --seeds <n> ...

runs a window per seed with the control as the program and prints each
run's numbers compared.
"""
from __future__ import annotations

import argparse
import json
import sys
import time


class Control:
    def __init__(self, network: dict, device: str):
        from reference import Reference

        self.ref = Reference(network, device, "float32")

    def prepare(self, hw_fields: dict, opts: dict):
        return hw_fields, opts

    def compile(self, args):
        from harness.cell import reference_plan

        return reference_plan(self.ref, *args)


def main(argv) -> int:
    from harness.cell import run_cell

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    for seed in args.seeds:
        started = time.perf_counter()
        r = run_cell(args.workload, seed, args.seconds, False, started,
                     program=Control)
        print(json.dumps({"control": args.workload, "seed": seed,
                          "correct": r["correct"],
                          "attempted": r["attempted"],
                          "failed": r["failed"], "checks": r["checks"]}),
              flush=True)
        if r["correct"]:
            print(f"the control passed the check on seed {seed}",
                  file=sys.stderr)
            return 1
    return 0
