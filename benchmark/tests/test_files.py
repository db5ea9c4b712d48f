"""The benchmark's files: every one parses, names what exists, and keeps to
BENCHMARK.json's limits; a new cell is a new file, found with no code edit;
the frozen bounds equal the port's; the reference imports nothing of the
program and the import guard compares whole top-level names."""

from __future__ import annotations

import ast
import glob
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from benchmark import bounds, harness

ROOT = harness.ROOT
BENCH = harness.BENCH_DIR
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def spec():
    return harness.benchmark_spec(ROOT)


def test_benchmark_json_keeps_its_limits(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert spec["paths"] == ["benchmark"] and spec["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= spec["run_seconds"] <= 51
    names = [c["name"] for c in spec["configs"]] + [w["name"] for w in spec["workloads"]]
    names += [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e["setup_s"]
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in spec["workloads"]}
    for m in spec["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", [w])


def test_every_file_parses_and_is_found_by_name(spec):
    configs = {c["name"] for c in spec["configs"]}
    for c in spec["configs"]:
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        cfg = harness.config(c["name"])
        assert c["reduced"] == cfg["reduced"] == []
    for w in spec["workloads"]:
        wl = harness.workload(w["name"])
        assert (wl["config"], wl["traffic"]) == (w["config"], w["traffic"]) and w["config"] in configs
        assert w["chips"] == 1
        assert hasattr(harness.traffic(wl["kind"]), "run")
    fns = harness.readers([m["name"] for m in spec["per_layer"]])
    assert set(fns) == {m["name"] for m in spec["per_layer"]}
    for path in glob.glob(os.path.join(BENCH, "kernels", "*.json")):
        k = json.load(open(path))
        assert harness.kernel_files(k["kernel"])
    used = {w["config"] for w in spec["workloads"]}
    assert used == configs


def test_a_new_cell_is_a_new_file(tmp_path, spec):
    """A copy of the benchmark gains a cell by a workload file and an entry:
    run.py finds it (and, with no card here, refuses to run it)."""
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    wl = harness.workload("generate-single-g1")
    wl.pop("name")
    wl["traffic"] = "single-g1-50"
    wl["requests"] = dict(wl["requests"], steps=50)
    (tmp_path / "benchmark" / "workloads" / "generate-single-g1-50.json").write_text(json.dumps(wl))
    spec = dict(spec, workloads=spec["workloads"] + [
        {"name": "generate-single-g1-50", "config": wl["config"], "traffic": "single-g1-50", "chips": 1,
         "why": "50 steps"}])
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    found = harness.workload("generate-single-g1-50", str(tmp_path / "benchmark"))
    assert found["requests"]["steps"] == 50
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    run = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "generate-single-g1-50", "--seed", "1",
                          "--seconds", "1"], cwd=tmp_path, capture_output=True, text=True, env=env, timeout=120)
    assert run.returncode == 2 and "needs 1 CUDA device" in run.stderr and not run.stdout.strip()
    run = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "no-such-cell", "--seed", "1",
                          "--seconds", "1"], cwd=tmp_path, capture_output=True, text=True, env=env, timeout=120)
    assert run.returncode == 2 and "no cell" in run.stderr


def test_without_the_program_the_run_fails(tmp_path):
    """A directory that holds only BENCHMARK.json and benchmark/ prints no
    result and exits non-zero."""
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    run = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "generate-single-g1", "--seed", "1",
                          "--seconds", "1"], cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert run.returncode != 0 and not run.stdout.strip()


def test_frozen_bounds_equal_the_ports():
    from photoverse_tpu_torch.ops import bounds as port

    for args in [(2, 4096, 4096, 8, 40), (8, 1024, 1024, 8, 80), (2, 4096, 4096, 1, 512)]:
        assert bounds.flash_fwd(*args) == port.flash_fwd(*args)
        assert bounds.flash_fwd(*args, with_lse=True) == port.flash_fwd(*args, with_lse=True)
    for args in [(8, 4096, 8, 40), (8, 1024, 8, 80)]:
        assert bounds.flash_bwd(*args) == port.flash_bwd(*args)
    assert bounds.fused_cross_ff(16, 4096, 320, 8, 77, 1, 1280) == port.fused_cross_ff(16, 4096, 320, 8, 77, 1, 1280)
    assert (bounds.PEAK_FLOPS, bounds.PEAK_BYTES) == (port.PEAK_FLOPS, port.PEAK_BYTES)
    assert bounds.bound_ms(1e12, 1e9) == port.bound_ms(1e12, 1e9)


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_the_reference_imports_nothing_of_the_program():
    for path in glob.glob(os.path.join(BENCH, "reference", "*.py")):
        for name in _imports(path):
            top = name.split(".", 1)[0]
            assert top in ("torch", "numpy", "PIL", "math", "contextlib", "typing", "hashlib", "json", "os", "re",
                           "__future__", "benchmark"), (path, name)
            if top == "benchmark":
                assert name.startswith("benchmark.reference"), (path, name)


def test_nothing_of_the_benchmark_imports_jax():
    for path in glob.glob(os.path.join(BENCH, "**", "*.py"), recursive=True):
        for name in _imports(path):
            assert name.split(".", 1)[0] not in harness.FORBIDDEN, (path, name)


def test_the_import_guard_compares_whole_top_level_names(monkeypatch):
    import types

    monkeypatch.setitem(sys.modules, "photoverse_tpu_torch_x", types.ModuleType("photoverse_tpu_torch_x"))
    assert "photoverse_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "photoverse_tpu.models", types.ModuleType("photoverse_tpu.models"))
    assert "photoverse_tpu" in harness.forbidden_modules()
    monkeypatch.delitem(sys.modules, "photoverse_tpu.models")
    monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("jaxlib"))
    assert "jaxlib" in harness.forbidden_modules()
