"""The readers of the program's own spans and counters
(``portbench/metrics/_program.py``): on a hand-made traced segment with
the program's registry in place, on a run without device activity, on
a program without ``pinn_torch.utils.trace`` (as before it had spans),
and in a traced run of the L-BFGS cell on a CUDA card (``-m cuda``)."""

import sys
from types import SimpleNamespace

import pytest

from portbench import harness, tracing

READERS = ("lbfgs_host_reads_per_iter", "direction_host_ms", "ic_bc_host_us")
CELL = "schrodinger.lbfgs.nf1m"


def _read(ctx):
    return {n: harness.find_module("metrics", n).read(ctx) for n in READERS}


def _ctx(busy_s=0.9):
    return SimpleNamespace(trace=tracing.Trace(window_s=1.5, busy_s=busy_s))


@pytest.fixture
def registry(monkeypatch):
    """The program's counters and span totals, as a run left them."""
    from pinn_torch.utils import trace
    monkeypatch.setattr(trace, "counters", lambda: {
        "lbfgs.host_reads": 6301, "lbfgs.iters": 875, "launch.x": 3})
    monkeypatch.setattr(trace, "span_totals", lambda: {
        "lbfgs.direction": (20, 0.1), "loss.ic_bc": (22, 0.055)})


def test_readers_read_the_registry(registry):
    got = _read(_ctx())
    assert got["lbfgs_host_reads_per_iter"] == pytest.approx(6301 / 875)
    assert got["direction_host_ms"] == pytest.approx(5.0)
    assert got["ic_bc_host_us"] == pytest.approx(2500.0)


def test_every_reader_is_listed_for_the_lbfgs_cell():
    names = {m["name"].split(".")[0]
             for m in harness.metrics_of(harness.load_benchmark(), CELL)[1]}
    assert set(READERS) <= names


@pytest.mark.parametrize("ctx", [
    SimpleNamespace(trace=None),   # an untraced run
    _ctx(busy_s=0.0),              # no device activity: the CPU rehearsal
])
def test_nothing_to_read(registry, ctx):
    assert all(v is None for v in _read(ctx).values())


def test_a_span_never_entered_reads_nothing(monkeypatch):
    from pinn_torch.utils import trace
    monkeypatch.setattr(trace, "counters", lambda: {})
    monkeypatch.setattr(trace, "span_totals", lambda: {})
    assert all(v is None for v in _read(_ctx()).values())


def test_a_program_without_spans_reads_nothing(monkeypatch):
    import pinn_torch.utils
    monkeypatch.delattr(pinn_torch.utils, "trace")
    monkeypatch.setitem(sys.modules, "pinn_torch.utils.trace", None)
    assert all(v is None for v in _read(_ctx()).values())


@pytest.mark.cuda
def test_traced_lbfgs_run_on_the_card(cuda_card):
    """A short traced run of the cell at a tenth of its N_f on the card:
    the three readings are on the line, host reads between 6 and 12 an
    iteration."""
    result, _ = harness.run_cell(CELL, 2 ** 31 + 77, 2.0, True,
                                 device=cuda_card, n_f=100000,
                                 log=lambda m: None)
    metrics = result["metrics"]
    assert {"lbfgs_host_reads_per_iter", "direction_host_ms.lbfgs",
            "ic_bc_host_us.lbfgs"} <= set(metrics)
    assert 6.0 <= metrics["lbfgs_host_reads_per_iter"]["value"] <= 12.0
    assert metrics["direction_host_ms.lbfgs"]["value"] > 0
    assert metrics["ic_bc_host_us.lbfgs"]["value"] > 0
