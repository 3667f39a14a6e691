"""The kernels' measurement kit (tools/kernelkit.py) for the kernel
tests: their comparators, seeded iterates, step drivers and bounds.

It is loaded from its file and registered as ``kernelkit``, so that a
test session reaches it without putting tools/ on ``sys.path``."""

import importlib.util
import os
import sys

_PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), 'tools', 'kernelkit.py')


def _load():
    mod = sys.modules.get('kernelkit')
    if mod is None:
        spec = importlib.util.spec_from_file_location('kernelkit', _PATH)
        mod = importlib.util.module_from_spec(spec)
        sys.modules['kernelkit'] = mod
        spec.loader.exec_module(mod)
    return mod


kernelkit = _load()
