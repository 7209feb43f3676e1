"""The readings that a cell's limits are set from (PERF.md, "How correct
is decided").

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--seconds 3] [--fault <name>] [--out calibrate.jsonl]

For each seed, in one process: one run of the cell, the program's
compared number; and the control's: the configuration's reference
computed in its `control` precision (one step below the configuration's)
in the program's place, judged by the same `harness.judge` at the same
blocks.  With --fault, a fault of faults.py is planted under the timed
path first, and the program's number is the fault's reading.  One JSON
line a seed.  Needs the card, as a run does.
"""

import argparse
import json
import sys
import time

import faults
import harness


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="portbench-calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--fault", choices=sorted(faults.FAULTS), default=None)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    cell = harness.load_cell(harness.ROOT, args.workload)
    if args.fault:
        faults.plant(args.fault)
    ref = harness.reference_module(cell.config["name"])
    out = open(args.out, "a") if args.out else None
    for seed in (int(s) for s in args.seeds.split(",")):
        res = harness.run_cell(cell, seed, args.seconds, False,
                               time.perf_counter())
        chk = res["checks"]
        run = res["run"]
        line = {"workload": cell.name, "seed": seed, "fault": args.fault,
                "program": chk["mix_err"], "correct": chk["correct"],
                "blocks": chk["blocks"], "starts": chk["starts"],
                "window_blocks": run.blocks, "setup_s": run.setup_s}
        if not args.fault:
            low = ref.mix_blocks(res["voices"], chk["starts"],
                                 run.block_size, run.sample_rate,
                                 precision=cell.config["control"],
                                 device="cuda")
            ctl = harness.judge(cell, res["voices"], chk["starts"], low,
                                run.block_size, run.sample_rate, "cuda",
                                reference=chk["reference"])
            line.update(control=ctl["mix_err"],
                        control_correct=ctl["correct"])
        print(json.dumps(line), flush=True)
        if out:
            out.write(json.dumps(line) + "\n")
            out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
