"""The readings that a cell's limits are set from, on the card.

    python3 -m rtbench.calibrate --workload cornell600.final --seconds 4 \\
        --seeds 11 12 13 --control-seeds 11 12 13

For each of ``--seeds`` a whole run of the cell (set-up, a window of
``--seconds``, the check) prints the numbers its check compares; for each
of ``--control-seeds`` also the control's: the reference computed in
bfloat16 and put in the program's place for the same answers, and where the
mode plants them (``faults``), each fault's. One JSON line per seed; nothing
here is held to a limit.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="limit readings of one cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = p.parse_args(argv)
    from rtbench import harness

    for seed in args.seeds:
        run = harness.make_run(args.workload, seed, args.seconds, False)
        t0 = time.perf_counter()
        result, _ = harness.execute(run, t0, limits={})
        line = {"seed": seed, "numbers": run.numbers, "metrics": result["metrics"],
                "units": result["attempted"]}
        if seed in args.control_seeds:
            t1 = time.perf_counter()
            line["control"] = harness.mode_module(run.traffic["mode"]).control(run)
            line["control_s"] = time.perf_counter() - t1
            mode = harness.mode_module(run.traffic["mode"])
            if hasattr(mode, "faults"):
                line["faults"] = mode.faults(run)
        line["total_s"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
