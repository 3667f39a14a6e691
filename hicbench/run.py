"""The benchmark of haphic_tpu_torch, one run of one cell.

    python3 hicbench/run.py --workload xtropicalis.cluster --seed 7 \\
        --seconds 51 --trace 0

Run from the root of a checkout that holds ``BENCHMARK.json``. Prints
the run's numbers to standard error, each compared number beside its
limit last, and one JSON line last on standard output. Exits non-zero,
printing no result, without as many CUDA cards as the cell asks for,
when the program cannot be imported, or when a module of JAX or of the
JAX package is loaded once the window has closed.
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every build and kernel cache inside the checkout, at fixed paths
CACHE = os.path.join(ROOT, 'build', 'hicbench')
os.environ['TORCH_EXTENSIONS_DIR'] = os.path.join(CACHE, 'torch_extensions')
os.environ['TRITON_CACHE_DIR'] = os.path.join(CACHE, 'triton')
os.environ['CUDA_CACHE_PATH'] = os.path.join(CACHE, 'nv')
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    with open(os.path.join(ROOT, 'BENCHMARK.json')) as f:
        bench = json.load(f)
    chips = {w['name']: w['chips'] for w in bench['workloads']}
    if args.workload not in chips:
        print('unknown workload {!r}; known: {}'.format(
            args.workload, sorted(chips)), file=sys.stderr)
        return 2

    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < chips[args.workload]:
        print('the cell needs {} CUDA card(s); found {}'.format(
            chips[args.workload], torch.cuda.device_count()
            if torch.cuda.is_available() else 0), file=sys.stderr)
        return 2
    from hicbench import harness
    rc, result = harness.run(bench, args.workload, args.seed, args.seconds,
                             bool(args.trace), T_START)
    if result is not None:
        print(json.dumps(result), flush=True)
    return rc


if __name__ == '__main__':
    sys.exit(main())
