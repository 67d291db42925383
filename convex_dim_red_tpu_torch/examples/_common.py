"""What the case-study examples share: their command line, and running
the port's own command-line modules (generators, anomalies, drivers) in
child processes."""

import argparse
import os
import subprocess
import sys

#: The directory that holds the package, put first on the children's
#: ``PYTHONPATH`` so that a checkout runs without being installed.
_PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def parse_args(description, argv):
    """``OUT_DIR [--quick] [--platform cuda|cpu]``; the output directory
    is made, and the card is checked for when asked for (there is no
    fallback to the CPU)."""
    from ..cli.common import apply_platform
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument('out_dir', help='directory for every output')
    parser.add_argument('--platform', default='cuda', choices=['cuda', 'cpu'],
                        help='the device of every fit (default: cuda; '
                             'there is no fallback to the CPU)')
    parser.add_argument('--quick', action='store_true',
                        help='small grids and few restarts, trials and '
                             'iterations: the same steps and artifacts')
    args = parser.parse_args(argv)
    args.device = apply_platform(args)
    args.out_dir = os.path.abspath(args.out_dir)
    os.makedirs(args.out_dir, exist_ok=True)
    return args


def run_module(module, *args):
    """``python -m convex_dim_red_tpu_torch.<module> args...`` in a child
    process; raises ``CalledProcessError`` when it fails."""
    cmd = [sys.executable, "-m", "convex_dim_red_tpu_torch." + module]
    cmd += [str(a) for a in args]
    print("+", " ".join(cmd), flush=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_PACKAGE_ROOT, env.get("PYTHONPATH")) if p)
    subprocess.run(cmd, check=True, env=env)


def save_figure(fig, out_dir, name):
    import matplotlib.pyplot as plt
    path = os.path.join(out_dir, name)
    fig.savefig(path, dpi=110)
    plt.close(fig)
    print("wrote", path)


def read_model_selection(path):
    """``{k: {metric: value}}`` from a model-selection CSV."""
    import csv
    with open(path) as f:
        rows = list(csv.DictReader(f))
    return {int(r['k']): {m: float(r[m]) for m in r if m != 'k'}
            for r in rows}
