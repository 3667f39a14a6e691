"""One run of one cell: the configuration, the traffic mix, the limits
and the per-layer metrics found by name under ``hicbench/``, the genome
drawn from the seed, set-up, the measured window, the check against the
plain reference, and the result line.

Everything a cell needs is data in files of its own:

    configs/<config>.json     published sizes, what is assumed, Nx
    traffic/<traffic>.json    the stage it drives and its parameters
    stages/<stage>.py         the stage: set-up, a unit, the check
    limits/<workload>.json    each compared number's limit
    metrics/<metric>.py       a per-layer metric's reader
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import time
from typing import Optional

import torch

from hicbench import genome as gen
from hicbench import stages
from hicbench.probe import Probe, profile_unit

HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'haphic_tpu')


def load(kind: str, name: str) -> dict:
    with open(os.path.join(HERE, kind, name + '.json')) as f:
        return json.load(f)


def metric_reader(name: str):
    path = os.path.join(HERE, 'metrics', name + '.py')
    spec = importlib.util.spec_from_file_location(
        'hicbench_metric_' + name.replace('.', '_'), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def applies(metric: dict, workload: str) -> bool:
    return 'workloads' not in metric or workload in metric['workloads']


def forbidden_modules():
    return sorted({m.split('.')[0] for m in sys.modules} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                              '--format=csv,noheader'], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return 'nvidia-smi failed: {}'.format(e)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else \
        'nvidia-smi: ' + out.stderr.strip()


def log(*parts):
    print('[hicbench]', *parts, file=sys.stderr, flush=True)


def run(bench: dict, workload: str, seed: int, seconds: float, trace: bool,
        t_start: float, device='cuda', overrides: Optional[dict] = None):
    """One run; returns (exit code, result dict or None). ``overrides``
    (tests only) replaces the configuration, the mix or the limits."""
    overrides = overrides or {}
    wl = next(w for w in bench['workloads'] if w['name'] == workload)
    cfg = overrides.get('config') or load('configs', wl['config'])
    mix = overrides.get('traffic') or load('traffic', wl['traffic'])
    limits = overrides.get('limits') or load('limits', workload)['limits']
    dev = torch.device(device)
    if dev.type == 'cuda':
        torch.cuda.set_device(0)

    gn = gen.make(cfg, seed)
    stage = stages.load(mix['stage']).Stage(cfg, mix, gn, dev, seed)
    log('sizes', json.dumps(dict(vars(gn.sizes), **stage.sizes)))
    stage.warmup()
    sync(dev)

    e2e = [m for m in bench['end_to_end'] if applies(m, workload)]
    layer = [m for m in bench['per_layer'] if applies(m, workload)]
    probe, readers = Probe(), {}
    if trace:
        for m in layer:
            readers[m['name']] = metric_reader(m['name'])
            if hasattr(readers[m['name']], 'install'):
                readers[m['name']].install(probe)
    if dev.type == 'cuda':
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.monotonic() - t_start

    outputs, profiled, read_trace = [], None, None
    t0 = time.perf_counter()
    try:
        while True:
            i = len(outputs)
            probe.unit = i
            if trace and i == 0 and dev.type == 'cuda':
                out, read_trace = profile_unit(lambda: stage.unit(0))
            else:
                out = stage.unit(i)
            sync(dev)
            outputs.append(out)
            elapsed = time.perf_counter() - t0
            log('unit {} ended at {:.3f} s'.format(i, elapsed))
            if elapsed + elapsed / len(outputs) > seconds:
                break
    finally:
        probe.restore()
    probe.units = len(outputs)
    peak = (torch.cuda.max_memory_allocated() if dev.type == 'cuda'
            else 0)
    if read_trace is not None:
        profiled = read_trace()
    values = {'setup_s': setup_s, 'peak_gib': peak / 2 ** 30,
              mix['unit_metric']: elapsed / len(outputs)}
    layer_values = {}
    for m in layer if trace else []:
        v = readers[m['name']].read(probe, stage, outputs, profiled)
        if v is not None:
            layer_values[m['name']] = v

    # the check: the reference after the window, the program's state
    # freed, on the same inputs
    if dev.type == 'cuda':
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = stage.reference()
    per_unit = [stage.compare(o, ref) for o in outputs]
    log('reference and comparison took {:.1f} s'.format(
        time.perf_counter() - t_ref))
    numbers = {k: max(u[k] for u in per_unit) for k in limits}
    failed = sum(any(u[k] > limits[k] for k in limits) for u in per_unit)
    correct = failed == 0

    metrics = {}
    for m in (layer if trace else e2e):
        src = layer_values if trace else values
        if m['name'] in src:
            metrics[m['name']] = {'value': src[m['name']], 'unit': m['unit']}
    result = {'correct': correct, 'attempted': len(outputs),
              'failed': failed, 'metrics': metrics,
              'device': device_info(dev, peak, wl['chips'], profiled)}
    if profiled is not None:
        result['breakdown'] = {'device_ops': profiled['device_ops'],
                               'idle_gaps': profiled['idle_gaps']}
    result['card'] = power_limit() if dev.type == 'cuda' else 'cpu'
    result['checks'] = {k: {'value': numbers[k], 'limit': limits[k]}
                        for k in limits}
    found = forbidden_modules()
    if found:
        log('modules of JAX or the JAX package are loaded:', found)
        return 3, None
    for k in limits:
        log('check {} = {!r} (limit {!r})'.format(k, numbers[k], limits[k]))
    return 0, result


def sync(dev):
    if dev.type == 'cuda':
        torch.cuda.synchronize()


def device_info(dev, peak: int, chips: int, profiled) -> dict:
    info = {'platform': 'gpu' if dev.type == 'cuda' else 'cpu',
            'kind': (torch.cuda.get_device_name(0) if dev.type == 'cuda'
                     else 'cpu'),
            'count': chips, 'memory_peak_bytes': peak}
    if profiled is not None:
        info['busy_s'] = profiled['busy_s']
        info['window_s'] = profiled['window_s']
    return info
