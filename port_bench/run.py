"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 -m port_bench.run --workload <cell> --seed <n> \\
        --seconds <s> --trace <0|1>

With ``--trace 0`` the line carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, the device's busy time and a
breakdown.  The compared numbers and their limits are the last lines on
standard error and the last key of the line.  Exits with 2, printing no
result, where there is no card or too few, and with 3 where JAX or the
JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def parse(argv):
    p = argparse.ArgumentParser(prog="python3 -m port_bench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None):
    from port_bench import harness
    args = parse(sys.argv[1:] if argv is None else argv)
    harness.env_defaults()
    chips = int(harness.find(harness.benchmark()["workloads"],
                             args.workload, "workload")["chips"])
    try:
        if chips == 1:
            result, rec, _, lines = harness.run_cell(
                args.workload, args.seed, args.seconds, args.trace,
                t_start=T_START)
        else:
            harness.check_cards(chips)
            result, rec, _, lines = harness.launch(
                args.workload, args.seed, args.seconds, args.trace,
                t_start=T_START, chips=chips, timeout=340)
    except harness.Refused as err:
        print("port_bench: %s" % err, file=sys.stderr)
        return 3 if "forbidden" in str(err) else 2
    print("set-up: %s" % ", ".join(
        "%s %.3f" % kv for kv in rec["setup_parts"].items()),
        file=sys.stderr)
    if "calls" in rec:
        print("window %.3f s, %d calls; reference %.3f s"
              % (rec["window_s"], len(rec["calls"]), rec["check_s"]),
              file=sys.stderr)
    if rec.get("k1") is not None:
        k1 = rec["k1"]
        print("K1 at %s: %.3f mean iterations, %d bytes, %.4g operations, "
              "bound %.4g s by %s, device %.4g s, %.2f%% of the bound, "
              "card %s" % (k1["shape"], k1["mean_iterations"], k1["bytes"],
                           k1["operations"], k1["bound_s"], k1["bound_by"],
                           k1["device_s"], k1["share_pct"],
                           harness.power_limit()), file=sys.stderr)
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
