"""On the card: one short run of every cell through `perfbench/run.py`, and
the keys and values its result line must have. Skips without a CUDA card:
``python -m pytest perfbench/tests -m card`` on the chip."""
import json
import subprocess
import sys

import pytest
import torch

from perfbench import harness

CELLS = [w["name"] for w in json.loads((harness.ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell_name", CELLS)
def test_run_on_the_card(cell_name, trace):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload", cell_name, "--seed",
                        str(2**31 + 3), "--seconds", "3", "--trace", str(trace)],
                       cwd=harness.ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"] is True, p.stderr[-3000:]
    assert r["device"]["platform"] == "gpu" and r["device"]["count"] == 1
    assert r["device"]["kind"] == torch.cuda.get_device_name(0)
    assert list(r)[-1] == "checks"
    if trace:
        assert r["device"]["busy_s"] > 0 and "breakdown" in r
        for name, m in r["metrics"].items():
            if name.split(".")[0] in ("filter_roofline", "device_idle_pct"):
                assert 0 < m["value"] <= 100
    else:
        assert "setup_s" in r["metrics"] and len(r["metrics"]) >= 2


def test_without_a_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("this card's machine has a card")
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload", CELLS[0], "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       cwd=harness.ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode == 2 and p.stdout.strip() == ""
