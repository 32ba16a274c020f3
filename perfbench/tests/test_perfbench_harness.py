"""The harness on the CPU: files found by name, the result's keys, the
contract's shape of ``BENCHMARK.json``, and the imports it may not make.

    python -m pytest perfbench/tests -q -p no:cacheprovider
"""
import ast
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from perfbench import run

ROOT = Path(__file__).resolve().parents[2]
PB = ROOT / "perfbench"
BANNED = {"jax", "jaxlib", "flax", "universal_differential_equations_tpu"}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TINY = {"lv_study.adam": {"cfg": {"runs_per_level": 1},
                          "traffic": {"iters_per_request": 1, "trace_iters": 1}},
        "hjb100d.m131072": {"traffic": {"trajectories": 8, "iters_per_request": 2,
                                        "trace_iters": 1}}}


def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def imported(path):
    """Top-level names of every module that ``path`` imports."""
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_nothing_under_perfbench_imports_jax():
    for path in PB.rglob("*.py"):
        assert not imported(path) & BANNED, path


def test_reference_imports_nothing_of_the_program():
    for path in (PB / "reference").rglob("*.py"):
        assert imported(path) <= {"__future__", "math", "numpy", "torch"}, path


def test_benchmark_json_keeps_the_contract_shape():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert b["paths"] == ["perfbench"] and 1 <= b["run_seconds"] <= 51
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    names = [c["name"] for c in b["configs"]] + [w["name"] for w in b["workloads"]]
    names += list(e2e) + [m["name"] for m in b["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/") and (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
    cells = {w["name"] for w in b["workloads"]}
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200
        assert (PB / "traffic" / f"{w['traffic']}.json").is_file()
        assert (PB / "checks" / f"{w['name']}.json").is_file()
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert (PB / "metrics" / f"{m['name']}.py").is_file()
        assert set(m.get("workloads", cells)) <= cells
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    for cell in cells:
        assert [m for m in b["per_layer"] if cell in m.get("workloads", [cell])]
        assert [m for m in b["end_to_end"] if cell in m.get("workloads", [cell])
                and m["name"] != "setup_s"]


def test_without_a_card_the_run_exits_with_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert run.main(["--workload", "lv_study.adam", "--seed", str(2**32 + 3),
                     "--seconds", "1", "--trace", "0"]) == 2
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("trace", [0, 1])
def test_result_line_has_the_contract_keys_and_checks_last(trace):
    res, checks = run.run_cell("hjb100d.m131072", 2**33 + 1, 0.05, trace,
                               torch.device("cpu"), overrides=TINY["hjb100d.m131072"])
    keys = list(res)
    want = ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[:5] == want and keys[-1] == "checks"
    assert set(keys) <= set(want) | {"breakdown", "checks"}
    assert ("breakdown" in keys) == bool(trace)
    assert res["correct"] is True and res["failed"] == 0
    assert set(res["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    e2e = {"train_iters_per_s", "iter_p95_ms", "setup_s"}
    assert (set(res["metrics"]) <= e2e) != bool(trace)
    for c in checks.values():
        assert c["value"] <= c["limit"]
    json.loads(json.dumps(res))


def test_a_cell_config_and_metric_added_as_files_alone(tmp_path):
    """A new configuration, traffic mix, cell and per-layer metric need new
    files and entries only: the harness finds them by name."""
    shutil.copytree(PB, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = bench()
    cfg = json.loads((PB / "configs" / "hjb100d_deepbsde.json").read_text())
    cfg["name"] = "hjb100d_copy"
    (tmp_path / "perfbench" / "configs" / "hjb100d_copy.json").write_text(json.dumps(cfg))
    (tmp_path / "perfbench" / "traffic" / "m16.json").write_text(json.dumps(
        {"driver": "bsde_adam", "trajectories": 16, "iters_per_request": 1, "trace_iters": 1}))
    (tmp_path / "perfbench" / "checks" / "hjb100d.m16.json").write_text(
        (PB / "checks" / "hjb100d.m131072.json").read_text())
    (tmp_path / "perfbench" / "metrics" / "paths_per_iter.hjb.py").write_text(
        "def read(run):\n    return run.traffic['trajectories']\n")
    b["configs"].append({"name": "hjb100d_copy", "source": "https://example.org/x",
                         "file": "perfbench/configs/hjb100d_copy.json", "reduced": [],
                         "why": "a test"})
    b["workloads"].append({"name": "hjb100d.m16", "config": "hjb100d_copy",
                           "traffic": "m16", "chips": 1, "why": "a test"})
    b["per_layer"].append({"name": "paths_per_iter.hjb", "unit": "paths", "better": "higher",
                           "source": "program_counter", "layer": "Kernels",
                           "moves": "train_iters_per_s", "workloads": ["hjb100d.m16"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    res, _ = run.run_cell("hjb100d.m16", 5, 0.01, 1, torch.device("cpu"), root=tmp_path)
    assert res["metrics"]["paths_per_iter.hjb"]["value"] == 16
    assert "mfu.train" not in res["metrics"]


def test_a_run_loads_no_module_of_jax():
    code = ("import sys, torch; from perfbench import run; "
            "run.run_cell('hjb100d.m131072', 7, 0.01, 0, torch.device('cpu'), "
            f"overrides={TINY['hjb100d.m131072']!r}); print(run.banned_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
