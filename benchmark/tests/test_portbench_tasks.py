"""Configurations of more than one task: a configuration of another task
added as files only (its generator, task module, entry, metric reader,
configuration, mix and cell, from ``benchmark/tests/toy/``) runs through
the harness unchanged; and the NDNS cells read, through their task, the
very pool, schedule, weights, calibration inputs and shape that they read
before the harness took tasks (digests of the parent tree's run)."""

import hashlib
import json
import os
import shutil

import pytest
import torch

from benchmark.harness import core, spec
from benchmark.harness.faults import Faults
from benchmark.tests.tiny import tiny_cell, tiny_run

ROOT = spec.ROOT
TOY = os.path.join(spec.HERE, "tests", "toy")
TOY_CELL = "toy_classify_b4"


def _file_digests(root):
    out = {}
    for d, dirs, files in os.walk(root):
        dirs[:] = [x for x in dirs if x != "__pycache__"]
        for f in files:
            path = os.path.join(d, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def test_a_configuration_of_another_task_is_added_as_files_only(tmp_path):
    """A later change adds a task with its own data (sequences (B, L, 1) and
    integer labels, no audio), leaves, shape and small sizes, and the
    entries in BENCHMARK.json; it edits no file of the harness, and the
    cell runs untraced and traced."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    before = _file_digests(root)
    added = []
    for d, _, files in os.walk(TOY):
        for f in files:
            rel = os.path.relpath(os.path.join(d, f), TOY)
            dst = root / "benchmark" / rel
            assert not dst.exists(), rel
            shutil.copy(os.path.join(d, f), dst)
            added.append(rel)
    assert len(added) == 7
    bench = json.loads((root / "BENCHMARK.json").read_text())
    conf = json.loads((root / "benchmark/configs/toy_linear.json")
                      .read_text())
    cell = json.loads((root / f"benchmark/workloads/{TOY_CELL}.json")
                      .read_text())
    bench["configs"].append({"name": "toy_linear", "source": conf["source"],
                             "file": "benchmark/configs/toy_linear.json",
                             "reduced": [], "why": conf["why"]})
    bench["workloads"].append({"name": TOY_CELL, "config": "toy_linear",
                               "traffic": "toy_b4", "chips": 1,
                               "why": cell["why"]})
    next(m for m in bench["end_to_end"]
         if m["name"] == "train_clips_per_s")["workloads"].append(TOY_CELL)
    bench["per_layer"].append({
        "name": "toy_rows_per_s", "unit": "rows/s", "better": "higher",
        "source": "host_clock", "layer": "model step",
        "moves": "train_clips_per_s", "workloads": [TOY_CELL]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=2))

    out = tiny_run(TOY_CELL, root=str(root))
    assert out["correct"], out["checks"]
    assert set(out["checks"]) == {"logit_gap", "loss_gap"}
    assert set(out["metrics"]) == {"train_clips_per_s", "setup_s"}
    traced = tiny_run(TOY_CELL, root=str(root), trace=True, seconds=0.0)
    assert traced["correct"], traced["checks"]
    assert set(traced["metrics"]) == {"toy_rows_per_s"}
    # the timed stretch runs the checked steps, the traced one three
    assert traced["attempted"] == 2 + 3
    after = _file_digests(root)
    del before["BENCHMARK.json"]
    assert {k: after[k] for k in before} == before


def _tensor(h, t):
    a = t.detach().cpu().contiguous()
    h.update(f"{a.dtype}{tuple(a.shape)}".encode())
    h.update(a.numpy().tobytes())


def _digests(ctx) -> dict:
    """SHA-256 of the pool (noisy, then clean), the schedule, every weight
    leaf (by sorted name: the name, then the tensor), the calibration
    inputs in order and the shape's numbers; each tensor as its dtype,
    shape and bytes."""
    out = {}
    for key, tensors in (("pool", [ctx.data["noisy"], ctx.data["clean"]]),
                         ("schedule", [ctx.schedule]),
                         ("calibration", ctx.calibration_inputs)):
        h = hashlib.sha256()
        for t in tensors:
            _tensor(h, t)
        out[key] = h.hexdigest()
    h = hashlib.sha256()
    for k in sorted(ctx.weights):
        h.update(k.encode())
        _tensor(h, ctx.weights[k])
    out["weights"] = h.hexdigest()
    out["shape"] = hashlib.sha256(
        repr(tuple(int(x) for x in ctx.shape)).encode()).hexdigest()
    out["n_weights"] = len(ctx.weights)
    return out


# computed on the tree before tasks (commit 7a4bb4c), by the same
# digests of its ``core.prepare`` at the NDNS small sizes on the CPU
PARENT = {
    "float_train_b32": {
        "pool": "a2d57a262ce19da1b6879840c32e0622"
                "f3af70ad0f38f8f2ac800c16c93d47b0",
        "schedule": "ca53d62dfb4443fbe5671e9750b9dd33"
                    "7b6b79b917d5f244f2df386bb83abe53",
        "weights": "778944e13f9773f26273612b3223b894"
                   "699359fa87313ebba76fb9372d9e4797",
        "calibration": "601f9f06f5c116ea012430beaf88b518"
                       "6ff4972182dc29c6725613b69fefc172",
        "shape": "2b78063de2f85c88f4cee7615f9d29ab"
                 "5ec0ac47c9e479af3ed4997e0f737e8d",
        "n_weights": 28},
    "w8a16_denoise_b32": {
        "pool": "389b8400efdadb89270a8a4523e75cf7"
                "d4eabce051f463e549249ec25f80a2cc",
        "schedule": "e1077edb62300b805e735dc6c07a4a4b"
                    "8a68088a44cf4043c8372c356bab699d",
        "weights": "3e586be3b40df6d2a0f1d4b8c5ffa346"
                   "83fa76ba9a4d53693911049cddab3b7e",
        "calibration": "aec4ab7b66ef965287302c21d83d5168"
                       "54570bb03ca07cbc3ffa0fbc264c44be",
        "shape": "2b78063de2f85c88f4cee7615f9d29ab"
                 "5ec0ac47c9e479af3ed4997e0f737e8d",
        "n_weights": 28},
}


@pytest.mark.parametrize("cell,seed", [("float_train_b32", 20260101),
                                       ("w8a16_denoise_b32", 2147483653)])
def test_the_ndns_cells_read_what_they_read_before(cell, seed):
    ctx = core.prepare(tiny_cell(cell), seed, torch.device("cpu"), 0, 1,
                       Faults())
    assert _digests(ctx) == PARENT[cell]
