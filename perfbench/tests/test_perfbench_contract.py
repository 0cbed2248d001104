"""The benchmark's files: what ``BENCHMARK.json`` names exists under
``perfbench/``, and nothing in the folder imports JAX, the JAX package or
the JAX-era benchmarks (compared by whole top-level module name: the port's
name begins with the JAX package's)."""
import ast
import json
import re
from pathlib import Path

import pytest

from perfbench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
FORBIDDEN = {"jax", "jaxlib", "flax", "gcm_filters_tpu", "bench", "benchmarks"}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def imported_top_names(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted((ROOT / "perfbench").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    found = set(imported_top_names(path)) & FORBIDDEN
    assert not found, f"{path} imports {found}"


def test_the_check_reads_whole_top_level_names():
    names = {"gcm_filters_tpu_torch", "gcm_filters_tpu_torch.ops.cuda"}
    assert not {n.split(".")[0] for n in names} & FORBIDDEN
    assert {"gcm_filters_tpu.filter".split(".")[0]} & FORBIDDEN


def test_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


def test_every_cell_reports_its_metrics():
    """setup_s, another end-to-end metric and a per-layer metric in each
    cell; each per-layer metric moves an end-to-end metric its cells report."""
    for w in BENCH["workloads"]:
        cell = harness.load_cell(w["name"])
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
        assert all(m["moves"] in e2e for m in cell.per_layer)


def test_every_name_finds_its_files():
    cells = {w["name"]: w for w in BENCH["workloads"]}
    configs = {c["name"]: c for c in BENCH["configs"]}
    for w in cells.values():
        assert w["config"] in configs and w["chips"] == 1
        assert (ROOT / "perfbench" / "traffic" / f"{w['traffic']}.json").is_file()
    for c in configs.values():
        path = ROOT / c["file"]
        assert path.is_file() and path.with_suffix(".py").is_file()
        cfg = json.loads(path.read_text())
        assert cfg["name"] == c["name"] and c["reduced"] == []
        assert (ROOT / "perfbench" / "reference" / f"{cfg['grid_type'].lower()}.py").is_file()
        assert set(cfg["checks"]) == {"max_rel_err", "nan_mismatch"}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert harness.reader_path(m["name"]).is_file()
        assert m["moves"] in e2e
        for w in m.get("workloads", cells):
            assert w in cells
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
