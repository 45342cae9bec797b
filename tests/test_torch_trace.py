"""hp["trace_dir"] on the port's Trainer (``torch.profiler`` in place of
``jax.profiler.trace``): a Chrome-trace JSON with ``traceEvents`` lands
under the directory, as tests/test_trace.py asks of the JAX Trainer,
and the parameters and logged losses are bitwise those of the same run
without it."""

import glob
import json
import os

import numpy as np
import pytest
import torch

from pinn_torch import params as pcodec
from pinn_torch.models import mlp
from pinn_torch.train import Trainer
from pinn_torch.utils import Logger, trace

torch.set_num_threads(1)


def _problem(dtype):
    params = mlp.init_mlp([2, 4, 1], torch.Generator().manual_seed(0), dtype,
                          "cpu")
    rng = np.random.RandomState(0)
    batch = {"X_u": torch.as_tensor(rng.rand(8, 2), dtype=dtype),
             "u": torch.as_tensor(rng.rand(8, 1), dtype=dtype)}
    lb, ub = torch.zeros(2, dtype=dtype), torch.ones(2, dtype=dtype)

    def loss_fn(p, b):
        return torch.mean((mlp.apply(p, b["X_u"], lb, ub) - b["u"]) ** 2)

    return params, batch, loss_fn


def _trace_files(trace_dir):
    return [f for f in glob.glob(os.path.join(trace_dir, "**", "*"),
                                 recursive=True) if os.path.isfile(f)]


def test_trace_dir_writes_profile(tmp_path):
    params, batch, loss_fn = _problem(torch.float32)
    trace_dir = str(tmp_path / "trace")
    hp = {"tf_epochs": 3, "tf_lr": 0.01, "tf_b1": 0.9, "tf_eps": None,
          "nt_epochs": 0, "log_frequency": 10, "trace_dir": trace_dir}
    Trainer(loss_fn, params, batch, hp, logger=None).fit()
    files = _trace_files(trace_dir)
    assert files, "no trace artifacts"
    path, = files
    assert path.endswith(".pt.trace.json")
    with open(path) as fh:
        trace = json.load(fh)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert any(str(n).startswith("aten::") for n in names)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_trace_dir_changes_no_number(tmp_path, dtype):
    """Adam then L-BFGS (Wolfe, resampling at the same draw), with and
    without the trace: every parameter and logged loss bitwise equal."""
    runs = []
    for trace in (False, True):
        params, batch, loss_fn = _problem(dtype)
        log_file = str(tmp_path / f"log{int(trace)}.jsonl")
        hp = {"tf_epochs": 6, "nt_epochs": 6, "tf_lr": 0.01,
              "log_frequency": 2, "nt_line_search": "wolfe",
              "log_file": log_file}
        if trace:
            hp["trace_dir"] = str(tmp_path / "trace")
        out = Trainer(loss_fn, params, batch, hp,
                      Logger(hp, print_fn=lambda s: None, device="cpu")).fit()
        with open(log_file) as fh:
            losses = [r["loss"] for r in map(json.loads, fh)
                      if r["event"] == "epoch"]
        runs.append((pcodec.ravel(out).numpy(), losses))
    (w0, l0), (w1, l1) = runs
    assert len(l0) == 6
    np.testing.assert_array_equal(w0, w1)
    assert l0 == l1
    assert len(_trace_files(str(tmp_path / "trace"))) == 1


def test_trace_dir_through_the_command_line(tmp_path, capsys):
    """``python -m pinn_torch run NAME --set trace_dir=...``."""
    from pinn_torch import cli
    trace_dir = str(tmp_path / "trace")
    rc = cli.main(["run", "inf_cont_burgers", "--set", "device=cpu",
                   "--set", "N_u=20", "--set", "N_f=100", "--set",
                   "layers=[2, 8, 1]", "--set", "tf_epochs=2", "--set",
                   "nt_epochs=2", "--set", f"trace_dir={trace_dir}"])
    assert rc == 0
    assert "error: " in capsys.readouterr().out
    path, = _trace_files(trace_dir)
    with open(path) as fh:
        assert json.load(fh)["traceEvents"]


# ---------------------------------------------------------------------------
# The port's own spans and counters (pinn_torch.utils.trace)
# ---------------------------------------------------------------------------

SLB, SUB = np.array([-5.0, 0.0]), np.array([5.0, np.pi / 2])


def _schrodinger(seed=0, n_f=64):
    """A small Schrödinger problem on the fused loss (its plain version
    on the CPU): parameters, batch and loss."""
    from pinn_torch.ops.fused_schrodinger import make_schrodinger_loss

    params = mlp.init_mlp([2, 8, 8, 2], torch.Generator().manual_seed(seed),
                          torch.float32, "cpu")
    rng = np.random.RandomState(seed)

    def pts(n, x=None):
        p = SLB + (SUB - SLB) * rng.rand(n, 2)
        if x is not None:
            p[:, 0] = x
        return torch.as_tensor(p, dtype=torch.float32)

    X_b = pts(5)
    batch = {"X0": pts(5, x=None), "H0": torch.as_tensor(
                 rng.randn(5, 2), dtype=torch.float32),
             "X_lb": torch.stack([torch.full((5,), SLB[0], dtype=torch.float32),
                                  X_b[:, 1]], 1),
             "X_ub": torch.stack([torch.full((5,), SUB[0], dtype=torch.float32),
                                  X_b[:, 1]], 1),
             "X_f": pts(n_f)}
    batch["X0"][:, 1] = 0.0
    return params, batch, make_schrodinger_loss(SLB, SUB)


def _lbfgs_funcs(loss_fn, params):
    """``(flat float64 iterate, opfunc, lossfunc)`` as the Trainer's
    L-BFGS phase builds them with hp["nt_vector_dtype"] = "float64"."""
    flat, unravel = pcodec.ravel_with_unravel(params)

    def opfunc(w, batch):
        w_ = w.detach().requires_grad_(True)
        loss = loss_fn(unravel(w_.to(torch.float32)), batch)
        g, = torch.autograd.grad(loss, w_)
        return loss.detach().double(), g

    def lossfunc(w, batch):
        with torch.no_grad():
            return loss_fn(unravel(w.to(torch.float32)), batch).double()

    return flat.detach().double(), opfunc, lossfunc


def _span_pairs(prof):
    """``{(span, parent span)}`` of the port's spans in a profile: the
    parent is the innermost enclosing ``pinn_torch.`` event, or None."""
    pairs = set()
    for e in prof.events():
        if not e.name.startswith(trace.PREFIX):
            continue
        up = e.cpu_parent
        while up is not None and not up.name.startswith(trace.PREFIX):
            up = up.cpu_parent
        pairs.add((e.name[len(trace.PREFIX):],
                   None if up is None else up.name[len(trace.PREFIX):]))
    return pairs


def _profiled(fn):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return prof


LOSS_SPANS = {("loss.ic_bc", "loss"), ("loss.prep", "loss"),
              ("loss.assemble", "loss")}


def test_span_is_the_shared_null_context_without_a_profiler():
    import contextlib
    assert trace.span("adam.step") is trace.span("lbfgs.direction")
    assert isinstance(trace.span("loss"), contextlib.nullcontext)
    before = trace.span_totals().get("a.test", (0, 0.0))[0]
    with trace.span("a.test"):
        pass
    assert trace.span_totals().get("a.test", (0, 0.0))[0] == before

    def traced():
        with trace.span("a.test"):
            pass

    assert ("a.test", None) in _span_pairs(_profiled(traced))
    assert trace.span_totals()["a.test"][0] == before + 1


def test_adam_step_spans_and_their_nesting():
    """One AdamRunner step on the fused Schrödinger loss: the step, the
    update inside it, the loss and its parts inside the step; no launch
    on the CPU (the plain version runs)."""
    from pinn_torch.optim.adam import AdamRunner

    params, batch, loss_fn = _schrodinger()
    runner = AdamRunner(loss_fn, {"tf_lr": 1e-3})
    state = runner.init(params)
    prof = _profiled(lambda: runner.run(params, state, batch, 1))
    assert _span_pairs(prof) == {("adam.step", None),
                                 ("adam.update", "adam.step"),
                                 ("loss", "adam.step")} | LOSS_SPANS


def test_lbfgs_step_spans_and_their_nesting():
    """lbfgs_init and two Armijo iterations (the second has a memory
    update and a direction) on the fused Schrödinger loss."""
    from pinn_torch.optim import lbfgs as lb

    params, batch, loss_fn = _schrodinger()
    x0, opfunc, lossfunc = _lbfgs_funcs(loss_fn, params)
    config = lb.LbfgsConfig(max_iter=10, line_search="armijo")

    def two_steps():
        state = lb.lbfgs_init(opfunc, x0, config, batch)
        lb.make_lbfgs_run(opfunc, config, lossfunc)(state, batch, 2)

    pairs = _span_pairs(_profiled(two_steps))
    assert pairs == {("lbfgs.init", None), ("loss", "lbfgs.init"),
                     ("lbfgs.step", None), ("lbfgs.memory", "lbfgs.step"),
                     ("lbfgs.direction", "lbfgs.step"),
                     ("lbfgs.search", "lbfgs.step"), ("loss", "lbfgs.search"),
                     ("lbfgs.checks", "lbfgs.step")} | LOSS_SPANS


def _rosenbrock(w, batch):
    """Rosenbrock's valley in float64 and its gradient: Armijo rejects
    some first trials on it."""
    w_ = w.detach().requires_grad_(True)
    f = torch.sum(100.0 * (w_[1:] - w_[:-1] ** 2) ** 2 + (1.0 - w_[:-1]) ** 2)
    g, = torch.autograd.grad(f, w_)
    return f.detach(), g


@pytest.mark.parametrize("line_search", ["none", "armijo", "wolfe"])
def test_host_reads_count_every_conversion(monkeypatch, line_search):
    """``lbfgs.host_reads`` equals the device values lbfgs.py turns into
    Python values (Tensor.__bool__, __float__ and item called from its
    own frames), over lbfgs_init and a run; ``lbfgs.iters`` the
    iterations.  With Armijo, an iteration reads 7, plus its
    evaluations when the first trial is rejected, and the first one
    fewer (no memory update)."""
    import sys
    from pinn_torch.optim import lbfgs as lb

    seen = []

    def counting(name):
        real = getattr(torch.Tensor, name)

        def conv(self, *a):
            if sys._getframe(1).f_code.co_filename == lb.__file__:
                seen.append(name)
            return real(self, *a)
        return conv

    for name in ("__bool__", "__float__", "item"):
        monkeypatch.setattr(torch.Tensor, name, counting(name))
    config = lb.LbfgsConfig(max_iter=40, line_search=line_search)
    x0 = torch.tensor([-1.2, 1.0, -0.5, 0.8], dtype=torch.float64)
    c0 = trace.counters()
    state = lb.lbfgs_init(_rosenbrock, x0, config)
    run = lb.make_lbfgs_run(_rosenbrock, config)
    per_iter = []
    for _ in range(30):
        if state.reason != lb.RUNNING:
            break
        c1, evals = trace.counters(), state.n_evals
        state, _ = run(state, None, 1)
        per_iter.append((trace.delta(c1, trace.counters()).get(
            "lbfgs.host_reads", 0), state.n_evals - evals))
    moved = trace.delta(c0, trace.counters())
    assert moved["lbfgs.host_reads"] == len(seen) > 0
    assert moved["lbfgs.iters"] == state.n_iter == len(per_iter) > 5
    if line_search == "armijo":
        assert max(e for _, e in per_iter) > 1     # a rejected first trial
        for i, (reads, evals) in enumerate(per_iter):
            want = 7 if evals == 1 else 7 + evals
            assert reads == want - (i == 0), (i, reads, evals)


def test_tracing_changes_no_number():
    """An Armijo run to its stop on the fused Schrödinger loss, and an
    Adam chunk, with and without a profiler: iterates, losses, counts
    and stop reason bitwise equal."""
    from pinn_torch.optim import lbfgs as lb
    from pinn_torch.optim.adam import AdamRunner

    runs = []
    for traced in (False, True):
        params, batch, loss_fn = _schrodinger(seed=3)
        x0, opfunc, lossfunc = _lbfgs_funcs(loss_fn, params)
        config = lb.LbfgsConfig(max_iter=25, line_search="armijo",
                                restart=True)
        out = {}

        def go():
            state = lb.lbfgs_init(opfunc, x0, config, batch)
            state, hist = lb.make_lbfgs_run(opfunc, config, lossfunc)(
                state, batch, 25)
            runner = AdamRunner(loss_fn, {"tf_lr": 1e-2})
            p, _, losses = runner.run(params, runner.init(params), batch, 3)
            out.update(x=state.x, hist=hist, reason=state.reason,
                       n=(state.n_iter, state.n_evals), adam=losses,
                       p=pcodec.ravel(p))

        _profiled(go) if traced else go()
        runs.append(out)
    a, b = runs
    for k in ("x", "hist", "adam", "p"):
        assert torch.equal(a[k], b[k]), k
    assert (a["reason"], a["n"]) == (b["reason"], b["n"])


def _quadratic(a, c):
    """f(w) = a (w - c)^2 / 2 in one dimension, float64, and its
    gradient."""
    def opfunc(w, batch):
        return 0.5 * a * torch.sum((w - c) ** 2), a * (w - c)
    return opfunc


@pytest.mark.parametrize("a,c,expand,bisect", [
    # |g| = 100: t0 = 0.01 stops far short of the minimum, so the
    # curvature test fails at t0, 0.02, 0.04, 0.08 and holds at 0.16.
    (1.0, 100.0, 4, 0),
    # |g| = 0.3: t0 = 1 overshoots threefold (f grows 4x), so hi = 1 and
    # the bisected t = 0.5 meets both conditions.
    (3.0, 0.1, 0, 1),
])
def test_wolfe_counters_count_each_bracket_move(a, c, expand, bisect):
    """The first weak-Wolfe iteration on a one-dimensional quadratic
    from 0, where t0 = min(1, 1/|g|): ``lbfgs.wolfe.expand`` counts the
    trials where t doubled, ``lbfgs.wolfe.bisect`` those where it halved
    the bracket, and their sum is the search's evaluations after the
    first."""
    from pinn_torch.optim import lbfgs as lb

    opfunc = _quadratic(a, c)
    config = lb.LbfgsConfig(max_iter=5, line_search="wolfe")
    state = lb.lbfgs_init(opfunc, torch.zeros(1, dtype=torch.float64), config)
    c0 = trace.counters()
    state, _ = lb.make_lbfgs_run(opfunc, config)(state, None, 1)
    moved = trace.delta(c0, trace.counters())
    assert moved.get("lbfgs.wolfe.expand", 0) == expand
    assert moved.get("lbfgs.wolfe.bisect", 0) == bisect
    assert state.n_evals - 1 == 1 + expand + bisect
    assert {"lbfgs.wolfe.expand",
            "lbfgs.wolfe.bisect"} <= set(trace.counters())
