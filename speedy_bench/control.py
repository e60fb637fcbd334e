"""The readings that a cell's limits are set from (``limits/<cell>.json``),
on the card at the cell's own size:

- the program's numbers (check.py) on each seed given: sound runs, whose
  largest reading is the lower end of a limit;
- the control's on the first `--controls` seeds: the reference put in the
  program's place, computed in TF32 (float32 with TensorFloat-32 products
  on the card: the precision below the configuration's float32 with TF32
  off), its start and its segments, from the same states, held against
  the float64 reference by the same numbers: its smallest reading is the
  upper end;
- beside them, for information, the reference in plain float32;
- with ``--fault <name>``, the numbers of a broken program of
  ``faults.py`` in the program's place instead (no control then).

    python3 -m speedy_bench.control --workload <cell> --seeds 1,2,3 --seconds 5 [--controls 3] [--fault <name>]

Each seed is one run of the cell's window (run.run_cell) in this process;
the lines it prints are JSON, one a seed."""

from __future__ import annotations

import argparse
import json
import sys

from .faults import FAULTS

__all__ = ["main", "control_numbers"]


def control_numbers(ref64, samples, want, init_fields, host_bc, cell,
                    tf32: bool) -> dict:
    """check.numbers of the reference in float32 (TF32 products when
    `tf32`) against the float64 reference, from the same states."""
    import torch

    from . import check
    from .reference.runner import Reference

    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        low = Reference(ref64.params, host_bc, cell.start,
                        ref64.consts.device, dtype=torch.float32)
        got = check.reference_outputs(low, samples)
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = old
    init_low = {k: low.state[k] for k in init_fields}
    return check.numbers(init_low, {k: ref64.state[k] for k in init_fields},
                         got, want, ref64.consts.sp.el2)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--fault", choices=sorted(FAULTS))
    a = ap.parse_args(argv)
    import torch

    from .cell import load_cell
    from .run import run_cell

    if not torch.cuda.is_available():
        print("control: no card", file=sys.stderr)
        return 2
    cell = load_cell(a.workload)
    for i, seed in enumerate(int(s) for s in a.seeds.split(",")):
        held = {}

        def on_check(ref, samples, want, init_fields, host_bc, i=i):
            if i < a.controls and not a.fault:
                for name, tf32 in (("tf32", True), ("f32", False)):
                    held[name] = control_numbers(ref, samples, want,
                                                 init_fields, host_bc, cell,
                                                 tf32)

        r = run_cell(cell, seed, a.seconds, False, "cuda",
                     program_cls=FAULTS.get(a.fault), on_check=on_check)
        line = {"workload": cell.name, "seed": seed, "fault": a.fault,
                "program": {k: v["value"] for k, v in r["checks"].items()},
                "attempted": r["attempted"], "failed": r["failed"],
                "metrics": {k: v["value"] for k, v in r["metrics"].items()},
                **held}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
