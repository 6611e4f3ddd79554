"""Tasks: what a configuration's task makes for a run.

A configuration names its task (``"task": "ndns"``); the harness loads
``benchmark/tasks/<task>.py`` by that name. A task module gives

- ``prepare(cell, seed, device, generator) -> Prepared``: the run's data,
  made by the mix's own generator (``benchmark/traffic/<generator>.py``,
  passed in), its weights, its calibration inputs and its shape, all from
  ``seed`` and the same on every rank;
- ``TINY``: small sizes laid over its configurations and mixes
  (``{"recipe": ..., "mix": ..., "config": ...}``) for runs on the CPU in
  the tests.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple


class Prepared(NamedTuple):
    #: the pool that the schedule's rows index, by name, rows first
    data: Dict[str, object]
    #: the weights both sides get, by the program's leaf names
    weights: Dict[str, object]
    #: inputs of the program's calibration, where it calibrates
    calibration_inputs: List[object]
    #: what metric readers get as ``ctx.shape``
    shape: object
