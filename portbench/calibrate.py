"""Readings from which a cell's correctness limits are set (not run by
the benchmark's own runs).

    python3 portbench/calibrate.py --workload <cell> --seeds 1 2 3 \\
        --seconds 1 [--control fp8|tf32] [--fault <name>] \\
        [--out readings.jsonl]

For each seed, in one process: the cell's set-up, a short window, the
program's compared numbers against the float32 reference and, with
``--control``, the same numbers for the reference computed in the
control's arithmetic in the program's place. With ``--fault``, the
program runs with that fault of ``harness/faults.py`` planted. One JSON
line per seed.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(name: str, seeds, seconds: float, control: str | None,
             fault: str | None = None, device: str = "cuda",
             overrides: dict | None = None):
    """Yield one dict per seed: ``seed``, ``program`` (the numbers) and,
    with ``control``, ``control``; with ``fault``, the program's run has
    that fault planted."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from portbench import run
    from portbench.harness import faults

    for seed in seeds:
        with run.open_cell(name, seed, device, overrides) as (cell, drv):
            with (faults.planted(fault) if fault
                  else contextlib.nullcontext()):
                state = drv.setup(cell)
                drv.window(cell, state, seconds)
                drv.release(cell, state)
            row = {"seed": int(seed), "program": drv.check(cell, state)}
            if fault:
                row["fault"] = fault
            if control:
                row["control"] = drv.check(cell, state, control=control)
            yield row


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--control", default=None)
    p.add_argument("--fault", default=None)
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    sink = open(a.out, "a") if a.out else None
    try:
        for row in readings(a.workload, a.seeds, a.seconds, a.control,
                            a.fault):
            line = json.dumps(row)
            print(line, flush=True)
            if sink:
                sink.write(line + "\n")
                sink.flush()
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
