"""The host side of a launch (ops/cuda/launch.py), on the CPU.

Every pass wrapper routes its calls through :func:`launch.route`: a CUDA
device launches the kernel, the CPU runs the plain version, any other device
raises, each under one ``gft.launch`` span. A launch goes through
:class:`launch.Kernel` (the entry of the dtype, the current stream, the
error code) and is counted in the one table of :func:`launch.launch_counts`;
its buffers are checked by :func:`launch.pointer` and its grid by
:func:`launch.check_grid`. The kernels run only on the card, so the calls
here go to a stand-in library.
"""
import contextlib
import types

import pytest
import torch

import gcm_filters_tpu_torch as gt
from gcm_filters_tpu_torch.ops.cuda import cheb_pass as cp
from gcm_filters_tpu_torch.ops.cuda import launch
from gcm_filters_tpu_torch.ops.cuda import local_pass as lp
from gcm_filters_tpu_torch.ops.cuda import ring_pass as rp
from gcm_filters_tpu_torch.ops.cuda import vec_local_pass as vlp
from gcm_filters_tpu_torch.ops.cuda import vec_pass as vp
from gcm_filters_tpu_torch.ops.cuda.dispatch import make_cuda_scalar_apply
from gcm_filters_tpu_torch.utils.telemetry import recording, reset_spans, spans

META = torch.device("meta")


def _scalar_operands():
    filt = gt.Filter(filter_scale=4.0, dx_min=1.0, device="cpu")
    return make_cuda_scalar_apply(filt.operator, filt.filter_spec).operands(
        torch.float32, torch.device("cpu"))


def _vector_operands(shape=(8, 16)):
    return vp.VecPassOperands(vp.BGRID, torch.zeros((vp.N_COEF[vp.BGRID],) + shape), True)


def _on_meta(state):
    state.device = META
    return state


def _call(name):
    """A call of the wrapper ``name`` on the meta device."""
    ops, p = _scalar_operands()
    vops = _vector_operands()
    m3, m4 = torch.empty((1, 4, 4), device=META), torch.empty((1, 2, 4, 4), device=META)
    calls = {
        "cheb_pass": lambda: cp.cheb_pass(ops, cp.MIDDLE, p[2], t=m3, t_prev=m3, t_next=m3,
                                          acc=m3),
        "cheb_fused_pass": lambda: cp.cheb_fused_pass(ops, p, 0, 2, tile=(16, 32), field=m3,
                                                      t_out=m3, t_prev_out=m3, acc=m3),
        "local_pass": lambda: lp.local_pass(ops, cp.MIDDLE, p[2], cells=1, shrink=1, t=m3,
                                            t_prev=m3, t_next=m3, acc=m3),
        "local_strip_pass": lambda: lp.local_strip_pass(ops, p, 0, 2, cells=2, tile=(16, 32),
                                                        field=m3, t_out=m3, t_prev_out=m3,
                                                        acc=m3, strips=None),
        "vec_pass": lambda: vp.vec_pass(vops, cp.MIDDLE, p[2], t=m4, t_prev=m4, t_next=m4,
                                        acc=m4),
        "vec_fused_pass": lambda: vp.vec_fused_pass(vops, p, 0, 2, tile=(16, 32), w=m4,
                                                    t_out=m4, t_prev_out=m4, acc=m4),
        "vec_local_pass": lambda: vlp.vec_local_pass(vops, cp.MIDDLE, p[2], cells=1, shrink=1,
                                                     t=m4, t_prev=m4, t_next=m4, acc=m4),
        "vec_local_fused_pass": lambda: vlp.vec_local_fused_pass(
            vops, p, 3, 2, cells=2, tile=(8, 32), t=m4, t_prev=m4, t_out=m4, t_prev_out=m4,
            acc=m4),
        "ring_pass": lambda: rp.ring_pass(_on_meta(rp.RingState(
            rp.RingOperands.cut(ops, 2), 4, 16, torch.float32, "cpu")), cp.FIRST, p[0], p[1]),
        "vec_ring_pass": lambda: rp.vec_ring_pass(_on_meta(rp.RingState(
            rp.VecRingOperands.cut(vops, 2), 4, 16, torch.float32, "cpu")), cp.FIRST, p[0],
            p[1]),
        "ring_fused_pass": lambda: rp.ring_fused_pass(_on_meta(rp.RingFusedState(
            rp.RingFusedOperands.cut(ops, 2, 3), 4, 16, torch.float32, "cpu")), p, 0, 2,
            tile=(8, 16), out=0),
        "vec_ring_fused_pass": lambda: rp.vec_ring_fused_pass(_on_meta(rp.VecRingFusedState(
            rp.VecRingFusedOperands.cut(vops, 2, 3), 4, 16, torch.float32, "cpu")), p, 0, 2,
            tile=(8, 16), out=0),
    }
    return calls[name]


WRAPPERS = ("cheb_pass", "cheb_fused_pass", "local_pass", "local_strip_pass", "vec_pass",
            "vec_fused_pass", "vec_local_pass", "vec_local_fused_pass", "ring_pass",
            "vec_ring_pass", "ring_fused_pass", "vec_ring_fused_pass")


@pytest.mark.parametrize("name", WRAPPERS)
def test_wrappers_refuse_other_devices(name):
    """Every wrapper raises for a device that is neither CUDA nor the CPU,
    naming itself, and launches nothing."""
    call = _call(name)
    before = launch.launch_counts()
    with pytest.raises(RuntimeError, match=f"^{name} has no kernel for device meta$"):
        call()
    assert launch.launch_counts() == before


POINTER_CASES = {
    "dtype": (torch.zeros((2, 3), dtype=torch.float64),
              r"^acc: torch.float64 on cpu, expected torch.float32 on cpu$"),
    "device": (torch.zeros((2, 3), device=META),
               r"^acc: torch.float32 on meta, expected torch.float32 on cpu$"),
    "shape": (torch.zeros((3, 2)), r"^acc: shape \(3, 2\), expected \(2, 3\)$"),
    "contiguity": (torch.zeros((3, 2)).t(), r"^acc must be contiguous$"),
}


@pytest.mark.parametrize("case", list(POINTER_CASES))
def test_pointer_checks_a_buffer(case):
    x, message = POINTER_CASES[case]
    cpu = torch.device("cpu")
    with pytest.raises(ValueError, match=message):
        launch.pointer("acc", x, (2, 3), cpu, torch.float32)
    good = torch.zeros((2, 3))
    assert launch.pointer("acc", good, (2, 3), cpu, torch.float32) == good.data_ptr()
    assert launch.pointer("acc", None, (2, 3), cpu, torch.float32) is None


def _grid_calls():
    """Launches of a batch of 65536, each refused before it reaches a library."""
    ops, p = _scalar_operands()
    vops = _vector_operands((1, 1))
    s3 = torch.zeros((65536, 1, 1))
    s4 = torch.zeros((65536, 2, 1, 1))
    bufs3 = dict(field=s3, t=None, t_prev=None, t_out=s3.clone(), t_prev_out=s3.clone(), acc=s3)
    bufs4 = dict(w=s4, t=None, t_prev=None, t_out=s4.clone(), t_prev_out=s4.clone(), acc=s4)
    return {
        "check_grid": lambda: launch.check_grid(65536, 1, 8, "shape", (65536, 1, 1)),
        "cheb_fused_pass": lambda: cp._fused_launch(ops, p, 0, 2, (8, 8), bufs3, "shared"),
        "vec_fused_pass": lambda: vp._fused_launch(vops, p, 0, 2, (8, 32), bufs4),
    }


@pytest.mark.parametrize("case", ["check_grid", "cheb_fused_pass", "vec_fused_pass"])
def test_a_batch_above_the_grid_limit_raises(case):
    """gridDim.z holds a batch of 65535 at most: 65536 raises, with no card."""
    call = _grid_calls()[case]
    with pytest.raises(ValueError, match=r"\(65536, .*exceeds the kernel's launch grid"):
        call()


def test_the_grid_limit_counts_blocks_of_rows():
    launch.check_grid(65535, 8 * 65535, 8, "shape", (65535, 8 * 65535, 1))
    with pytest.raises(ValueError, match=r"^block \(1, 524281, 3\) exceeds"):
        launch.check_grid(1, 8 * 65535 + 1, 8, "block", (1, 524281, 3))


@pytest.fixture
def fake_card(monkeypatch):
    """A stand-in library for a kernel: ``(kernel, calls, codes)``; the entry
    returns the next code of ``codes`` (0 once they run out)."""
    calls, codes = [], []

    def entry(*args):
        calls.append(args)
        return codes.pop(0) if codes else 0

    lib = types.SimpleNamespace(fake_pass_f32=entry, fake_pass_f64=lambda *a: 0,
                                fake_error_string=lambda err: b"an invalid argument")
    kernel = launch.Kernel("fake", "fake_pass", [])
    kernel.bind(lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=1234))
    monkeypatch.setattr(torch.cuda, "device", lambda device=None: contextlib.nullcontext())
    return kernel, calls, codes


def test_launch_counts_are_read_and_reset_through_one_function(fake_card):
    kernel, calls, _ = fake_card
    dev = torch.device("cpu")
    launch.launch_counts(reset=True)
    kernel(dev, torch.float32, 7, 8)
    kernel(dev, torch.float32, 9, detail="shared")
    kernel(dev, torch.float32, 10, detail="shared")
    assert calls == [(7, 8, 1234), (9, 1234), (10, 1234)]  # the stream last
    counts = launch.launch_counts()
    assert counts == {("fake_pass", None): 1, ("fake_pass", "shared"): 2}
    counts[("fake_pass", None)] = 99  # a copy: the table is not changed
    assert launch.launch_counts(reset=True) == {("fake_pass", None): 1,
                                                ("fake_pass", "shared"): 2}
    assert launch.launch_counts() == {}


def test_a_failed_launch_raises_and_counts_nothing(fake_card):
    kernel, _, codes = fake_card
    dev = torch.device("cpu")
    before = launch.launch_counts()
    codes.append(1)
    with pytest.raises(RuntimeError, match=r"^fake_pass kernel launch failed: an invalid "
                                           r"argument \(cudaError 1\)$"):
        kernel(dev, torch.float32)
    with pytest.raises(TypeError, match="fake_pass kernel takes float32 or float64"):
        kernel(dev, torch.float16)
    assert launch.launch_counts() == before


def test_a_cpu_call_runs_the_plain_version_counts_no_launch_and_opens_one_span():
    ops, p = _scalar_operands()
    x = torch.rand((1, 16, 24))
    outs = [torch.empty_like(x) for _ in range(6)]
    before = launch.launch_counts()
    reset_spans()
    with recording():
        cp.cheb_fused_pass(ops, p, 0, 2, tile=(8, 8), field=x, t_out=outs[0],
                           t_prev_out=outs[1], acc=outs[2])
    found = [s for s in spans() if s.name == "gft.launch"]
    assert len(found) == 1 and found[0].counts == {"steps": 2}
    assert launch.launch_counts() == before
    cp.cheb_fused_pass_reference(ops, p, 0, 2, field=x, t_out=outs[3], t_prev_out=outs[4],
                                 acc=outs[5])
    for got, want in zip(outs[:3], outs[3:]):
        assert torch.equal(got, want)


def test_a_route_to_the_card_carries_its_path():
    """On a CUDA device the route says "launch" and its span carries the
    path and the steps; while spans are off, a route is one shared object
    per side."""
    cuda = torch.device("cuda", 0)
    assert launch.route("x", cuda, "shared") is launch.route("y", cuda)
    with launch.route("x", torch.device("cpu"), "shared") as card:
        assert card is False
    reset_spans()
    with recording():
        with launch.route("cheb_fused_pass", cuda, "registers") as card:
            assert card is True
        with launch.route("vec_fused_pass", cuda) as card:
            assert card is True
        with launch.route("ring_fused_pass", cuda, "shared", 9) as card:
            assert card is True
    assert [s.counts for s in spans() if s.name == "gft.launch"] == [
        {"path": "registers"}, {}, {"path": "shared", "steps": 9}]
