"""The harness: ``BENCHMARK.json`` against the shape its runner checks, every
name found by the harness and an unknown one refused, the work counts
at the cells' shapes, the generator's streams, the trace arithmetic,
the metric readers and the window's marks they read between, and whole
runs of every cell on the CPU at a small N_f (the fused losses take
their plain versions there)."""

import json
import re
from types import SimpleNamespace

import pytest
import torch

from portbench import generate, harness, judge, tracing
from portbench.peaks import bound_s
from portbench.work import fused_mlp

BENCH = harness.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
H100 = "NVIDIA H100 80GB HBM3"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_benchmark_json_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used and c["file"].startswith("portbench/")
        assert json.load(open(harness.ROOT / c["file"]))["name"] == c["name"]
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", CELLS))
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for cell in CELLS:   # every cell reports setup_s, a rate and a per-layer metric
        e, layer = harness.metrics_of(BENCH, cell)
        assert "setup_s" in {m["name"] for m in e} and len(e) >= 2 and layer


@pytest.mark.parametrize("cell", CELLS)
def test_every_name_is_found(cell):
    spec = harness.resolve(cell)
    assert set(spec.limits) == set(spec.driver.NUMBERS) <= set(judge.NUMBERS)
    rates = {m["name"] for m in harness.metrics_of(BENCH, cell)[0]} - {"setup_s"}
    assert rates and rates <= set(spec.driver.RATES)
    for m in harness.metrics_of(BENCH, cell)[1]:
        assert callable(harness.find_module("metrics", m["name"].split(".")[0]).read)
    harness.find_module("reference", spec.config["problem"])
    harness.find_module("reference", spec.driver.REFERENCE)


@pytest.mark.parametrize("cell", CELLS)
def test_per_layer_metrics_move_what_their_cells_report(cell):
    e2e, layer = harness.metrics_of(BENCH, cell)
    assert {m["moves"] for m in layer} <= {m["name"] for m in e2e}


@pytest.mark.parametrize("find", [
    lambda: harness.cell_entry(BENCH, "schrodinger.adam.nf0"),
    lambda: harness.find_json("configs", "no_such_config"),
    lambda: harness.find_json("traffic", "no.such.mix"),
    lambda: harness.find_module("drivers", "sgd"),
    lambda: harness.find_module("metrics", "no_such_metric"),
    lambda: harness.find_module("drivers", "../harness"),
])
def test_unknown_names_are_refused(find):
    with pytest.raises(harness.UnknownName):
        find()


def _config(name):
    return harness.find_json("configs", name)


@pytest.mark.parametrize("config, n_f, grads, ms", [
    ("schrodinger_inf_cont", 200000, True, 2.228),
    ("schrodinger_inf_cont", 1000000, True, 11.140),
    ("schrodinger_inf_cont", 1000000, False, 3.6836),
])
def test_work_bounds(config, n_f, grads, ms):
    cfg = _config(config)
    work = harness.find_module("work", cfg["problem"])
    ops, n_bytes = work.cost(cfg, n_f, grads)
    assert 1e3 * bound_s(H100, ops, n_bytes) == pytest.approx(ms, rel=2e-4)
    assert bound_s("a card without peaks", ops, n_bytes) is None


def test_work_per_point():
    s = _config("schrodinger_inf_cont")
    assert harness.find_module("work", "schrodinger").cost(s, 200000, True)[0] == 746400 * 200000
    # the fused count at the narrow [2, 20x8, 1] net (N_u = 100 data rows
    # and 200,000 collocation points, three aux rows a point)
    ops, n_bytes = fused_mlp.cost([2] + [20] * 8 + [1], 200100, True, 3)
    assert ops == 76160 * 200100
    assert 1e3 * bound_s(H100, ops, n_bytes) == pytest.approx(0.2275, rel=2e-4)


def test_program_loss_meets_the_reference_on_the_cpu():
    """The inputs the configuration draws, the program's loss over them
    (its plain version on the CPU) and the reference's, at a small N_f."""
    from pinn_torch.params import leaves
    from portbench.reference import precision

    cfg = _config("schrodinger_inf_cont")
    problem = harness.find_module("problems", cfg["problem"])
    batch, const = problem.make(cfg, 300, 2 ** 31 + 9, "cpu")
    params = generate.glorot_weights(cfg["layers"], 2 ** 31 + 9, "cpu")
    p = [(w.requires_grad_(True), b.requires_grad_(True)) for w, b in params]
    loss = problem.program_loss(cfg, const)(p, batch)
    grads = torch.autograd.grad(loss, leaves(p))
    ref = harness.find_module("reference", cfg["problem"])
    want, want_g = ref.loss_and_grad([a.detach() for a in leaves(p)], batch, const,
                                     precision.FLOAT64)
    assert float(loss) == pytest.approx(float(want), rel=2e-6)
    for g, w in zip(grads, want_g):
        assert float(torch.linalg.vector_norm(g.double() - w)) <= 1e-5 * float(
            torch.linalg.vector_norm(w)) + 1e-9


@pytest.mark.parametrize("k, head", [(0, 0), (3, 3), (5, 2), (5, 0)])
def test_ring_direction_meets_the_program(k, head):
    """The reference's direction from a history ring, filled or wrapped
    round, against the program's two-loop over the same ring."""
    from pinn_torch.optim import lbfgs as program
    from portbench.reference import lbfgs

    g = torch.Generator().manual_seed(k * 10 + head)
    m, n = 5, 9
    S = torch.randn(m, n, generator=g, dtype=torch.float64)
    Y = S + 0.3 * torch.randn(m, n, generator=g, dtype=torch.float64)
    grad = torch.randn(n, generator=g, dtype=torch.float64)
    want = program._two_loop(grad, S, Y, k, head, torch.tensor(0.7, dtype=torch.float64), m)
    got = lbfgs.direction_from_ring(grad, S, Y, k, head, 0.7, m)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-14)
    rolled = lbfgs.direction_from_ring(grad, S, Y, k, (head + 1) % m, 0.7, m)
    assert k < m or not torch.allclose(rolled, want)


def test_streams_follow_the_seed():
    big = 2 ** 31 + 977
    assert generate.stream_seed(big, "a") == generate.stream_seed(big, "a")
    assert generate.stream_seed(big, "a") != generate.stream_seed(big + 1, "a")
    assert generate.stream_seed(big, "collocation", 0) != generate.stream_seed(big, "collocation", 1)
    x1 = generate.collocation([-1, 0], [1, 1], 1000, big, 0, "cpu")
    x2 = generate.collocation([-1, 0], [1, 1], 1000, big, 0, "cpu")
    assert torch.equal(x1, x2) and x1.dtype == torch.float32
    # one point in each of the 1000 strata along each axis
    for j, (lo, hi) in enumerate(((-1, 1), (0, 1))):
        strata = torch.floor((x1[:, j].double() - lo) / (hi - lo) * 1000).long()
        assert torch.equal(torch.sort(strata.clamp(max=999)).values, torch.arange(1000))
    w = generate.glorot_weights([2, 20, 20, 1], big, "cpu")
    assert [tuple(a.shape) for p in w for a in p] == [(2, 20), (20,), (20, 20), (20,), (20, 1), (1,)]
    std = (2.0 / 40) ** 0.5
    assert w[1][0].abs().max() <= 2 * std / 0.8796 * 1.0001
    assert w[1][0].std() == pytest.approx(std, rel=0.15)


def test_trace_summary():
    ev = [{"ph": "X", "cat": "kernel", "name": "k1", "ts": 0, "dur": 10},
          {"ph": "X", "cat": "kernel", "name": "k2", "ts": 5, "dur": 10},
          {"ph": "X", "cat": "gpu_memset", "name": "m", "ts": 40, "dur": 5},
          {"ph": "X", "cat": "cpu_op", "name": "aten::mul", "ts": 10, "dur": 40},
          {"ph": "X", "cat": "user_annotation", "name": "pinn_torch.loss", "ts": 20, "dur": 15},
          {"ph": "X", "cat": "kernel", "name": "k1", "ts": 100, "dur": 1}]
    t = tracing.summarise(ev, 1e-4)
    assert t.busy_s == pytest.approx(21e-6) and t.kernel_s == pytest.approx(21e-6)
    assert t.n_kernels == 3
    assert dict(t.device_ops) == pytest.approx({"k1": 11e-6, "k2": 10e-6, "m": 5e-6})
    assert dict(t.idle_gaps) == pytest.approx({"pinn_torch.loss": 25e-6,
                                               "(no host event)": 55e-6})


def _ctx(**kw):
    base = dict(kind=H100, config=_config("schrodinger_inf_cont"), n_f=200000,
                work=harness.find_module("work", "schrodinger"),
                window_s=1.0, units=300, counts={"loss_grad": 300},
                count_from=harness.Mark(0.0, 0, (3, 4), {}),
                count_to=harness.Mark(1.0, 300, (303, 304), {}),
                trace=tracing.Trace(window_s=0.5, busy_s=0.4,
                                    kernel_s=0.45, n_kernels=7000),
                traced_units=100, traced_counts={"loss_grad": 100})
    base.update(kw)
    return SimpleNamespace(**base)


def test_metric_readers():
    read = {n: harness.find_module("metrics", n).read for n in
            ("loss_roofline", "step_mfu", "launches_per_step",
             "lbfgs_evals_per_iter", "device_idle")}
    c = _ctx()
    assert read["loss_roofline"](c) == pytest.approx(100 * 100 * 746400 * 200000 / 67e12 / 0.45)
    assert read["step_mfu"](c) == pytest.approx(100 * 300 * 746400 * 200000 / 67e12)
    assert read["launches_per_step"](c) == 70
    assert read["lbfgs_evals_per_iter"](c) == 1.0
    assert read["device_idle"](c) == pytest.approx(20.0)
    iters_per_s = harness.find_module("metrics", "lbfgs_iters_per_s").read
    assert iters_per_s(_ctx(window_s=2.0)) == 150.0
    assert iters_per_s(_ctx(units=0)) is None
    blank = _ctx(kind="cpu", trace=None, count_to=harness.Mark(0.0, 0, (3, 4), {}),
                 traced_units=0, counts={})
    assert all(r(blank) is None for r in read.values())


COUNTER_READERS = ("lbfgs_evals_per_iter", "lbfgs_host_reads_per_iter",
                   "wolfe_retrials_per_iter", "wolfe_bisects_per_iter",
                   "two_loop_launches_per_iter")


class _Phase:
    """``chunks`` chunks of 10 iterations whose evaluations and counters
    grow with the chunk's index n (1, 2, ...), so that a ratio tells over
    which chunks it was read: 10 + n evaluations, 90 + n host reads, n
    expansions, 2n bisections and 10 two-loop launches."""

    def __init__(self, chunks):
        self.chunks, self.n, self.evals = chunks, 0, 0

    def chunk(self):
        from pinn_torch.utils import trace
        if self.n == self.chunks:
            return 0, None
        self.n += 1
        self.evals += 10 + self.n
        for name, k in (("lbfgs.iters", 10), ("lbfgs.host_reads", 90 + self.n),
                        ("lbfgs.wolfe.expand", self.n),
                        ("lbfgs.wolfe.bisect", 2 * self.n),
                        ("launch.lbfgs_two_loop", 10)):
            trace.count(name, k)
        return 10, None

    def totals(self):
        return 10 * self.n, self.evals


@pytest.mark.parametrize("count_units, counted", [
    (30, 3),     # the first chunk boundary at or past 30 iterations
    (35, 4),
    (400, 8),    # the window closed first: read over all of it
    (None, 8),   # a traffic without count_units (Adam's)
])
def test_counter_readers_read_between_the_marks(monkeypatch, count_units, counted):
    """The harness's window on a made-up phase: the five counter readers
    read between its two marks, not the process's counters before the
    window (a run's checked steps) or after it (its traced segment)."""
    from pinn_torch.utils import trace
    monkeypatch.setattr(trace, "_counts", {})
    trace.count("lbfgs.iters", 3)
    trace.count("lbfgs.host_reads", 1000)
    phase = _Phase(8)
    units, _, _, (start, to) = harness.window(phase, 60.0, "cpu", count_units)
    trace.count("lbfgs.host_reads", 10 ** 6)
    assert units == 80 and start.units == 0 and to.units == 10 * counted
    c = counted
    tri = c * (c + 1) // 2
    want = {"lbfgs_evals_per_iter": (10 * c + tri) / (10 * c),
            "lbfgs_host_reads_per_iter": (90 * c + tri) / (10 * c),
            "wolfe_retrials_per_iter": 3 * tri / (10 * c),
            "wolfe_bisects_per_iter": 2 * tri / (10 * c),
            "two_loop_launches_per_iter": 1.0}
    ctx = SimpleNamespace(trace=tracing.Trace(window_s=1.0, busy_s=0.5),
                          count_from=start, count_to=to)
    got = {n: harness.find_module("metrics", n).read(ctx) for n in COUNTER_READERS}
    assert got == pytest.approx(want)


def test_judge():
    leaves = [torch.ones(3), 2 * torch.ones(2), torch.zeros(4)]
    rec = {"losses": [1.0, 0.5], "grad": leaves, "change": leaves}
    assert judge.readings(rec, rec) == {"loss_gap": 0.0, "grad_gap": 0.0,
                                        "change_gap": 0.0}
    frozen = {**rec, "change": [torch.zeros_like(a) for a in leaves]}
    assert judge.readings(frozen, rec)["change_gap"] == pytest.approx(1.0)
    nan = {**rec, "losses": [float("nan"), 0.5]}
    v = judge.readings(nan, rec)
    assert v["loss_gap"] == float("inf") and not judge.verdict(v, {k: 1 for k in v})
    assert judge.verdict(v, {"grad_gap": 1.0})
    assert not judge.verdict(v, {"grad_gap": 1.0, "direction_gap": 1.0})   # not read
    for bad in ({}, {"no_such_gap": 1.0}):
        with pytest.raises(ValueError):
            judge.verdict(v, bad)


def test_judge_late():
    d = [torch.ones(3), 2 * torch.ones(2), torch.zeros(4)]
    ref = {"direction": d, "loss": 0.25}
    assert judge.late_readings(ref, ref) == {"direction_gap": 0.0, "final_loss_gap": 0.0}
    turned = {"direction": [d[0].flip(0) * torch.tensor([1.0, 1.0, -1.0]), d[1], d[2]],
              "loss": 0.5}
    v = judge.late_readings(turned, ref)
    # the first leaf keeps its norm but turns: its difference counts
    assert v["direction_gap"] == pytest.approx(2 / 3 ** 0.5)
    assert v["final_loss_gap"] == pytest.approx(1.0)
    zero = {"direction": [torch.zeros_like(a) for a in d], "loss": 0.25}
    assert judge.late_readings(zero, ref)["direction_gap"] == pytest.approx(1.0)


# each cell's rate besides setup_s: Burgers L-BFGS's iterations take as
# many evaluations as a seed's line searches ask, so its rate is theirs
RATE_OF = {"schrodinger.adam.nf1m": "adam_steps_per_s",
           "burgers.adam.nf1m": "adam_steps_per_s",
           "schrodinger.lbfgs.nf1m": "lbfgs_iters_per_s",
           "burgers.lbfgs.nf1m": "lbfgs_evals_per_s"}


@pytest.mark.parametrize("cell", CELLS)
def test_run_on_the_cpu(cell):
    result, checks = harness.run_cell(cell, 2 ** 31 + 5, 0.2, False,
                                      device="cpu", n_f=256, log=lambda m: None)
    assert list(result)[-1] == "checks" and result["correct"] is True
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == {"setup_s", RATE_OF[cell]}
    assert all(c["value"] <= c["limit"] for c in checks.values())
    json.dumps(result)


@pytest.mark.parametrize("cell", ["schrodinger.lbfgs.nf1m", "burgers.lbfgs.nf1m"])
def test_rates_are_the_windows_work_over_its_seconds(monkeypatch, cell):
    """On a CPU run, each L-BFGS rate over the window it came from:
    iterations, and loss calls, which are the optimizer state's own
    evaluations (its ``n_evals`` over the window's draws)."""
    seen = {}
    window = harness.window

    def spy(phase, *a, **kw):
        out = window(phase, *a, **kw)
        seen.update(out=out, evals=phase.totals()[1])
        return out

    monkeypatch.setattr(harness, "window", spy)
    monkeypatch.setattr(harness, "metrics_of", lambda bench, c: (
        [{"name": n, "unit": "1/s"} for n in ("setup_s", "lbfgs_iters_per_s",
                                             "lbfgs_evals_per_s")], []))
    result, _ = harness.run_cell(cell, 2 ** 31 + 11, 0.3, False,
                                 device="cpu", n_f=256, log=lambda m: None)
    units, _, window_s, (start, _) = seen["out"]
    evals = seen["evals"] - start.totals[1]
    assert units > 0 and evals >= units
    got = {k: v["value"] for k, v in result["metrics"].items()}
    assert got["lbfgs_iters_per_s"] == pytest.approx(units / window_s, rel=1e-12)
    assert got["lbfgs_evals_per_s"] == pytest.approx(evals / window_s, rel=1e-12)


def test_traced_run_on_the_cpu():
    result, _ = harness.run_cell("schrodinger.lbfgs.nf1m", 7, 0.2, True,
                                 device="cpu", n_f=128, log=lambda m: None)
    assert result["correct"] is True
    # no device on the CPU: only the optimizer state's own counts read
    assert set(result["metrics"]) == {"lbfgs_evals_per_iter"}
    assert result["device"]["busy_s"] == 0.0 and result["breakdown"]["device_ops"] == []
