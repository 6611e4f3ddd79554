"""The benchmark's files, found by name: ``BENCHMARK.json`` at the root of
the checkout, ``benchmark/workloads/<cell>.json``, the configuration and
the traffic mix the cell names, the configuration's task module, the
mix's generator, the entry module the cell drives and the metric reader
of each metric name."""

from __future__ import annotations

import importlib.util
import json
import os
import re
from typing import List

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def set_cache_dirs() -> None:
    """Build and kernel caches at fixed paths inside the checkout, set
    before torch is imported: PyTorch's own CUDA kernel cache, and the
    extension and Triton caches should the program ever use them. The
    program builds its kernels into its ``ops/cuda/_build/``."""
    cache = os.path.join(ROOT, "benchmark", "_cache")
    for var, sub in (("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(cache, sub)
        os.makedirs(os.environ[var], exist_ok=True)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def _load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _named(kind: str, name: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"{kind} name {name!r} is not a benchmark name")
    return name


def manifest(root: str = ROOT) -> dict:
    return _load(os.path.join(root, "BENCHMARK.json"))


def cell(name: str, bench_dir: str = HERE) -> dict:
    """The cell file with its configuration and traffic mix loaded under
    ``config_data`` and ``mix``."""
    c = _load(os.path.join(bench_dir, "workloads", _named("cell", name)
                           + ".json"))
    c["name"] = name
    c["config_data"] = _load(os.path.join(
        bench_dir, "configs", _named("config", c["config"]) + ".json"))
    c["mix"] = _load(os.path.join(bench_dir, "traffic",
                                  _named("traffic", c["traffic"]) + ".json"))
    return c


def entry(name: str, bench_dir: str = HERE):
    """The module ``benchmark/entries/<name>.py`` of the checkout at
    ``bench_dir``."""
    return _module("entries", name, bench_dir)


def task(name: str, bench_dir: str = HERE):
    """The module ``benchmark/tasks/<name>.py``: a configuration's
    ``task``."""
    return _module("tasks", name, bench_dir)


def generator(name: str, bench_dir: str = HERE):
    """The module ``benchmark/traffic/<name>.py``: a mix's ``generator``
    (``make_pool``, ``schedule``)."""
    return _module("traffic", name, bench_dir)


def _module(sub: str, name: str, bench_dir: str):
    path = os.path.join(bench_dir, sub, _named(sub, name) + ".py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark.{sub}." + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str, bench_dir: str = HERE):
    """The ``read(ctx)`` of ``benchmark/metrics/<metric>.py``."""
    return _module("metrics", metric, bench_dir).read


def reported(bench: dict, cell_name: str, section: str) -> List[dict]:
    """The metrics of ``section`` that cell ``cell_name`` reports: an
    end-to-end metric where its ``workloads`` list the cell or where it
    has no such list (``setup_s``); a per-layer metric where its
    ``workloads``, which every per-layer metric has, list the cell."""
    if section == "end_to_end":
        return [m for m in bench["end_to_end"]
                if "workloads" not in m or cell_name in m["workloads"]]
    return [m for m in bench["per_layer"] if cell_name in m["workloads"]]
