#!/usr/bin/env python3
"""The dense smoke pipeline of two checkouts, in turns on one card.

    python3 tools/ab_pipeline.py A_DIR B_DIR

Runs the `pipeline` phase of each checkout's own chip_smoke.py (the
160 Mb / 2,000,000-pair simulated genome through the dense MCL sweep
and the GA on the card) in the order ABBAABBA, each run in a process of
its own that imports only that checkout and writes into a directory of
its own, so that no run deletes another's files. The host's speed
drifts over a machine's life; in that order both checkouts see the
same drift. Before each run a probe times the host alone: it writes
PROBE_FILES small files, as the cluster stage writes its group files,
with no code of either checkout. Each turn prints one JSON line: the
checkout, its turn, the probe's seconds, and the phase lines (`env`,
`pipeline`) its chip_smoke.py printed. Exits non-zero when a run fails.
"""

import json
import os
import subprocess
import sys
import time

ORDER = 'ABBAABBA'
PROBE_FILES = 20000

CHILD = '''
import sys
import torch
sys.path.insert(0, sys.argv[1])
import chip_smoke as cs
from haphic_tpu_torch import cli
from haphic_tpu_torch.kernels import build as kbuild
from haphic_tpu_torch.kernels import delta as kdelta
from haphic_tpu_torch.kernels import score as kscore
cs.WORK = sys.argv[2]
cs.phase_env(torch, kbuild)
cs.phase_pipeline(torch, cli, kscore, kdelta)
'''


def probe(d: str) -> float:
    """Seconds to write PROBE_FILES files of one 60-byte line each."""
    os.makedirs(d)
    line = 'ctg\t1\t20000\n' * 5
    t0 = time.time()
    for k in range(PROBE_FILES):
        with open(os.path.join(d, 'group{}.txt'.format(k)), 'w') as f:
            f.write(line)
    return time.time() - t0


def run(tree: str, work: str) -> list:
    out = subprocess.run([sys.executable, '-c', CHILD, tree, work],
                         cwd=tree, stdout=subprocess.PIPE, text=True)
    if out.returncode != 0:
        raise SystemExit('ab_pipeline: {} exited {}'.format(
            tree, out.returncode))
    return [json.loads(line) for line in out.stdout.splitlines()
            if line.startswith('{')]


def main(argv) -> int:
    if len(argv) != 2:
        sys.stderr.write(__doc__)
        return 2
    trees = dict(zip('AB', (os.path.abspath(t) for t in argv)))
    for turn, label in enumerate(ORDER):
        build = os.path.join(trees[label], 'build')
        probe_s = probe(os.path.join(build, 'ab_probe{}'.format(turn)))
        lines = run(trees[label], os.path.join(build, 'ab_run{}'.format(
            turn)))
        print(json.dumps({'checkout': label, 'dir': trees[label],
                          'turn': turn, 'probe_s': probe_s,
                          'lines': lines}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
