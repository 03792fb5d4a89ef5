"""One run of one benchmark cell on the card.

    python3 -m rtbench.run --workload cornell600.final --seed 7 --seconds 10 --trace 0

Prints one JSON line as the last line of standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device`` (and with ``--trace
1`` ``breakdown``), then ``checks``, each compared number with its limit;
the same numbers end standard error. Exits non-zero, printing no result,
without a card, or where JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# Build and kernel caches at fixed paths inside the checkout.
CACHE = ROOT / "rtbench" / "_cache"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="run one benchmark cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")

    import torch

    from rtbench import harness

    # One process with one host thread: the card's work is launched from
    # Python, and idle intra-op threads only add jitter.
    torch.set_num_threads(1)
    try:
        run = harness.make_run(args.workload, args.seed, args.seconds, bool(args.trace))
        harness.require_cards(int(run.cell.get("chips", 1)))
        result, lines = harness.execute(run, T_START)
    except harness.CellError as e:
        print(f"rtbench: {e}", file=sys.stderr)
        return 2
    bad = harness.forbidden_modules()
    if bad:
        print(f"rtbench: loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 3
    print(json.dumps(result))
    print("\n".join(lines), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
