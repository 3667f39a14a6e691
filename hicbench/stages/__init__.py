"""The stages a traffic mix can drive, one module a stage, found by the
mix's ``stage`` key: ``stages/<stage>.py`` defines ``Stage``. To add a
stage, add its file.

A ``Stage(cfg, mix, genome, device, seed)`` takes the configuration,
the mix and the genome drawn from the seed, hands the program its inputs
through the program's public entry, and judges what the program
returned against the plain reference (``hicbench/reference``), which is
given the same inputs and nothing the program made. It has ``sizes``
(printed by each run), ``warmup()`` (every shape the units use, once),
``unit(i)`` (one unit of work: the program's output), ``reference()``,
``compare(output, ref)`` -> {number: value}, and ``control(outputs)``:
the reference put in the program's place at the precision below the
configuration's, in the program's output format.
"""

from __future__ import annotations

import importlib
import os

HERE = os.path.dirname(os.path.abspath(__file__))


def load(name: str):
    """The module of stage ``name`` (``stages/<name>.py``)."""
    if not os.path.isfile(os.path.join(HERE, name + '.py')):
        raise ValueError('no stage {!r}: add hicbench/stages/{}.py'.format(
            name, name))
    return importlib.import_module('{}.{}'.format(__name__, name))
