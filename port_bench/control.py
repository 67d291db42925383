"""The control of the comparison that decides ``correct``, and the
readings its limits are set from.

For each seed, one process runs the cell as the benchmark does (the
program as its configuration states it) and then with the program's
own TF32 path switched on (``set_matmul_precision('tensorfloat32')``,
the nearest precision below float32), each with a short window of the
cell's own load, and prints every number the reference gives for both:

    python3 -m port_bench.control --workload <cell> --seeds 1,2,3 \\
        [--seconds 1] [--sound-only | --fault <name>]

``--fault`` runs the program with a fault of the cell's
``port_bench/proofs/<cell>.json`` planted in its calls or set-up
(:mod:`port_bench.faults`), for the readings of a number the control
does not move.

The benchmark's own runs never run it.
"""

import argparse
import json
import sys
import time


def main(argv=None):
    from port_bench import harness
    p = argparse.ArgumentParser(prog="python3 -m port_bench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--sound-only", action="store_true")
    p.add_argument("--fault", help="plant this fault of the cell's proofs"
                   " file instead of running the control")
    args = p.parse_args(argv)
    harness.env_defaults()
    sides = (False,) if args.sound_only or args.fault else (False, True)
    hook = None
    if args.fault:
        from port_bench.faults import hook_for
        hook, _ = hook_for(args.workload, args.fault)
    for seed in [int(s) for s in args.seeds.split(",")]:
        for control in sides:
            t0 = time.perf_counter()
            result, rec, numbers, _ = harness.run_cell(
                args.workload, seed, args.seconds, 0, t_start=t0,
                control=control, entry_hook=hook)
            print(json.dumps({
                "workload": args.workload, "seed": seed,
                "side": ("fault_" + args.fault if args.fault else
                         "control_tf32" if control else "program"),
                "correct": result["correct"], "calls": len(rec["calls"]),
                "metrics": {k: v["value"] for k, v in
                            result["metrics"].items()},
                "setup_parts": rec["setup_parts"],
                "check_s": rec["check_s"],
                "counts": [[c.get("k1_launches"), c.get("restart_iters")]
                           for c in rec["calls"][:8]],
                "numbers": numbers}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
