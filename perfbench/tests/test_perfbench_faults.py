"""The check fails what it must: the control (the reference computed in
bfloat16 in the program's place) and the faults a cell can have, each
planted under a whole run at a tiny size on the CPU (the look for a card is
skipped; the port runs its plain path). The sound program passes."""
import json

import pytest
import torch

from perfbench import harness

ROOT = harness.ROOT
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
SHAPE = (48, 72)


def batched(out):
    return [o if o.ndim == 3 else o[None] for o in out]


class Unchanged(harness.Program):
    """A filter that returns its state unchanged: the input."""

    def __call__(self, idx):
        out = super().__call__(idx)
        if self.traffic["entry"] == "streamed":
            return tuple(h.copy() for h in self.host)
        sel = idx.start if len(idx) == 1 else slice(idx.start, idx.stop)
        return tuple(f[sel].clone() for f in self.fields) if out else out


class DroppedStep(harness.Program):
    """The last Chebyshev step's term left out of the sum."""

    def __init__(self, cell, inputs, device):
        super().__init__(cell, inputs, device)
        spec = self.filter.filter_spec
        p = list(spec.p)
        p[-1] = 0.0
        self.filter.filter_spec = spec._replace(p=p)


class HalfBatch(harness.Program):
    """Half of each batch left out: its results are those of the other half."""

    def __call__(self, idx):
        out = super().__call__(idx)
        for o in batched(out):
            n = o.shape[0]
            o[n - n // 2:] = o[: n // 2]
        return out


class Altered(harness.Program):
    """One value of every result altered where it is produced, by a
    thousandth of the result's largest magnitude."""

    def __call__(self, idx):
        out = super().__call__(idx)
        o = batched(out)[0]
        o[0, o.shape[1] // 2, o.shape[2] // 2] += 1e-3 * float(abs(o[0][o[0] == o[0]]).max())
        return out


def control(cell, inputs, device):
    return harness.ReferenceProgram(cell, inputs, device, torch.bfloat16)


def run(cell_name, make):
    return harness.run(cell_name, 2**32 + 17, 0.2, False, "cpu", shape=SHAPE, make_program=make)


@pytest.mark.parametrize("cell_name", CELLS)
def test_the_sound_program_passes(cell_name):
    assert run(cell_name, None)["correct"] is True


@pytest.mark.parametrize("cell_name", CELLS)
@pytest.mark.parametrize("fault", [control, Unchanged, DroppedStep, Altered],
                         ids=["control_bfloat16", "state_unchanged", "dropped_step", "answer_altered"])
def test_a_fault_is_not_correct(cell_name, fault):
    r = run(cell_name, fault)
    assert r["correct"] is False
    assert r["checks"]["max_rel_err"]["value"] > r["checks"]["max_rel_err"]["limit"]


@pytest.mark.parametrize("cell_name", [c for c in CELLS if "resident8" in c or "streamed" in c])
def test_half_the_batch_left_out_is_not_correct(cell_name):
    assert run(cell_name, HalfBatch)["correct"] is False
