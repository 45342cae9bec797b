"""The port's optimizers against the JAX package's: Adam against
optax.adam over 5 steps, ``AdamRunner`` against JAX's over 20 (and the
Trainer's Adam phase on it bit for bit), and L-BFGS on the quadratic
and Rosenbrock cases of tests/test_lbfgs.py plus an iterate-by-iterate float64 trace
against pinn.optim.lbfgs for every line search and direction form
(rtol 1e-9)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pinn.optim import adam as jax_adam
from pinn.optim import lbfgs as jax_lb
from pinn_torch.optim import lbfgs as lb
from pinn_torch.optim.adam import adam_from_hp

torch.set_num_threads(1)


def _quad(dim=20, seed=0):
    rng = np.random.RandomState(seed)
    A = rng.randn(dim, dim)
    A = A @ A.T + dim * np.eye(dim)
    b = rng.randn(dim)
    return A, b


def _torch_quad(A, b):
    At, bt = torch.as_tensor(A), torch.as_tensor(b)

    def opfunc(x, batch=None):
        return 0.5 * x @ At @ x - bt @ x, At @ x - bt

    return opfunc, torch.linalg.solve(At, bt)


def _rosen_np(x, xp):
    return xp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1 - x[:-1]) ** 2)


def _torch_rosen(x, batch=None):
    x_ = x.detach().requires_grad_(True)
    f = _rosen_np(x_, torch)
    g, = torch.autograd.grad(f, x_)
    return f.detach(), g


def _jax_rosen(x, batch=None):
    return jax.value_and_grad(lambda z: _rosen_np(z, jnp))(x)


# ---------------------------------------------------------------------------
# Adam
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tf_eps", [None, 1e-4])
def test_adam_matches_optax(tf_eps):
    hp = {"tf_lr": 0.03, "tf_b1": 0.9, "tf_eps": tf_eps}
    A, b = _quad(dim=6, seed=1)
    x0 = np.random.RandomState(1).randn(6)

    opt = jax_adam.adam_from_hp(hp)
    xj = jnp.asarray(x0)
    state = opt.init(xj)
    grad = jax.grad(lambda x: 0.5 * x @ A @ x - b @ x + jnp.sum(x ** 4))

    xt = torch.tensor(x0, requires_grad=True)
    topt = adam_from_hp([xt], hp)
    At, bt = torch.as_tensor(A), torch.as_tensor(b)
    for _ in range(5):
        upd, state = opt.update(grad(xj), state, xj)
        xj = optax.apply_updates(xj, upd)
        topt.zero_grad()
        (0.5 * xt @ At @ xt - bt @ xt + torch.sum(xt ** 4)).backward()
        topt.step()
        np.testing.assert_allclose(xt.detach().numpy(), np.asarray(xj),
                                   rtol=1e-9, atol=1e-12)


def test_adam_keras_epsilon_default():
    opt = adam_from_hp([torch.zeros(2, requires_grad=True)], {"tf_lr": 0.1})
    group = opt.param_groups[0]
    assert group["eps"] == 1e-7 and group["betas"] == (0.9, 0.999)


# ---------------------------------------------------------------------------
# L-BFGS convergence (the cases of tests/test_lbfgs.py)
# ---------------------------------------------------------------------------

def test_quadratic_convergence():
    opfunc, x_star = _torch_quad(*_quad())
    config = lb.LbfgsConfig(learning_rate=1.0, max_iter=100, n_correction=10)
    state = lb.minimize(opfunc, torch.zeros_like(x_star), config)
    np.testing.assert_allclose(state.x.numpy(), x_star.numpy(), rtol=1e-6,
                               atol=1e-8)


def test_rosenbrock_descends():
    x0 = torch.tensor([-1.2, 1.0], dtype=torch.float64)
    config = lb.LbfgsConfig(learning_rate=0.3, max_iter=400, n_correction=20)
    state = lb.minimize(_torch_rosen, x0, config)
    assert float(state.f) < 1e-2 * float(_torch_rosen(x0)[0])


def test_history_depth_exceeded():
    opfunc, x_star = _torch_quad(*_quad(dim=30, seed=1))
    config = lb.LbfgsConfig(learning_rate=1.0, max_iter=60, n_correction=3)
    state = lb.minimize(opfunc, torch.zeros_like(x_star), config)
    assert np.isfinite(float(state.f))
    np.testing.assert_allclose(state.x.numpy(), x_star.numpy(), rtol=1e-4,
                               atol=1e-6)


def test_first_step_size_rule():
    opfunc, _ = _torch_quad(*_quad(dim=5, seed=2))
    x0 = torch.zeros(5, dtype=torch.float64)
    config = lb.LbfgsConfig(learning_rate=0.5, max_iter=3, n_correction=5)
    state = lb.lbfgs_init(opfunc, x0, config)
    run = lb.make_lbfgs_run(opfunc, config)
    g0_sum = float(state.g.abs().sum())
    state, _ = run(state, None, 1)
    np.testing.assert_allclose(float(state.t), min(1.0, 1.0 / g0_sum),
                               rtol=1e-12)
    state, _ = run(state, None, 1)
    np.testing.assert_allclose(float(state.t), 0.5, rtol=1e-12)


def test_early_stop_on_converged_start():
    opfunc, x_star = _torch_quad(*_quad(dim=5, seed=3))
    config = lb.LbfgsConfig(max_iter=10, n_correction=5, tol_fun=1e-8)
    state = lb.minimize(opfunc, x_star, config)
    assert state.reason == lb.GRAD_TOL and state.n_iter == 0


@pytest.mark.parametrize("line_search", ["armijo", "wolfe"])
def test_rejected_step_keeps_its_direction(line_search):
    """A search that finds no sufficient decrease stops the run
    (NO_PROGRESS) at the old iterate with t = 0, and the state holds the
    direction it tried with the gradient and history it came from: the
    two-loop from (g_old, S, Y) gives d again.  The loss is an
    ill-conditioned quadratic for three evaluations and then reads 1e6
    higher everywhere, so every trial of the third search fails."""
    a = torch.tensor([1.0, 10.0, 100.0, 3.0], dtype=torch.float64)
    calls = []

    def opfunc(x, batch=None):
        calls.append(1)
        f = 0.5 * torch.dot(a * x, x) + (1e6 if len(calls) > 3 else 0.0)
        return f, a * x

    config = lb.LbfgsConfig(max_iter=10, n_correction=5,
                            line_search=line_search)
    x0 = torch.tensor([1.0, -2.0, 0.5, 3.0], dtype=torch.float64)
    state = lb.lbfgs_init(opfunc, x0, config)
    run = lb.make_lbfgs_run(opfunc, config)
    state, _ = run(state, None, 2)
    assert state.reason == lb.RUNNING and len(calls) == 3
    x, g = state.x.clone(), state.g.clone()
    state, _ = run(state, None, 1)
    assert state.reason == lb.NO_PROGRESS and len(calls) > 4
    assert torch.equal(state.x, x) and torch.equal(state.g, g)
    assert float(state.t) == 0.0 and torch.equal(state.g_old, g)
    want = lb._two_loop(state.g_old, state.S, state.Y, state.k, state.head,
                        state.hdiag, config.n_correction)
    assert float(torch.dot(want, want)) > 0.0
    torch.testing.assert_close(state.d, want, rtol=1e-12, atol=0.0)


def test_armijo_trials_use_lossfunc():
    """Rejected Armijo trials evaluate the loss alone."""
    calls = []

    def lossfunc(w, batch):
        calls.append(torch.is_grad_enabled())
        with torch.no_grad():
            return _rosen_np(w, torch)

    config = lb.LbfgsConfig(max_iter=30, n_correction=5, line_search="armijo")
    run = lb.make_lbfgs_run(_torch_rosen, config, lossfunc)
    x0 = torch.tensor([-1.2, 1.0, -0.5, 0.8], dtype=torch.float64)
    state, _ = run(lb.lbfgs_init(_torch_rosen, x0, config), None, 30)
    assert calls, "no Armijo trial was rejected on this path"
    assert float(state.f) < float(_torch_rosen(x0)[0])


# ---------------------------------------------------------------------------
# Iterate-by-iterate trace against the JAX L-BFGS
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("line_search", ["none", "armijo", "wolfe"])
@pytest.mark.parametrize("dir_impl", ["scan", "matrix"])
def test_trace_matches_jax(line_search, dir_impl):
    kw = dict(learning_rate=0.3, max_iter=10, n_correction=4,
              line_search=line_search, dir_impl=dir_impl,
              restart=line_search != "none")
    x0 = np.array([-1.2, 1.0, -0.5, 0.8, 1.1, -0.3])
    jconf, tconf = jax_lb.LbfgsConfig(**kw), lb.LbfgsConfig(**kw)
    jstate = jax_lb.lbfgs_init(_jax_rosen, jnp.asarray(x0), jconf)
    tstate = lb.lbfgs_init(_torch_rosen, torch.as_tensor(x0), tconf)
    jrun = jax_lb.make_lbfgs_run(_jax_rosen, jconf)
    trun = lb.make_lbfgs_run(_torch_rosen, tconf)
    for it in range(10):
        jstate, _ = jrun(jstate, None, 1)
        tstate, _ = trun(tstate, None, 1)
        msg = f"iteration {it + 1}"
        np.testing.assert_allclose(tstate.x.numpy(), np.asarray(jstate.x),
                                   rtol=1e-9, atol=1e-12, err_msg=msg)
        np.testing.assert_allclose(float(tstate.f), float(jstate.f),
                                   rtol=1e-9, err_msg=msg)
        np.testing.assert_allclose(float(tstate.t), float(jstate.t),
                                   rtol=1e-9, err_msg=msg)
        assert tstate.n_evals == int(jstate.n_evals), msg
        assert tstate.k == int(jstate.k), msg
        assert tstate.reason == int(jstate.reason), msg


_DIAG = np.array([1.0, 10.0, 100.0, 3.0])


def _trap(xp, where, case):
    """A diagonal quadratic that changes inside the ball |x|^2 < 0.05,
    which the iterates from [1, -2, 0.5, 3] enter at iteration 7.
    ``rejected``: the gradient there points uphill, so the next search
    finds no decrease.  ``soft_restart``: the loss drops by 1 there and
    the gradient is 1e-12 a component, so the next direction is no
    descent (g.d > -tol_x) with a full history."""
    a = xp.asarray(_DIAG) if xp is jnp else torch.as_tensor(_DIAG)

    def opfunc(x, batch=None):
        f, g = 0.5 * xp.sum(a * x * x), a * x
        inside = xp.sum(x * x) < 0.05
        if case == "rejected":
            return f, where(inside, -g, g)
        return (where(inside, f - 1.0, f),
                where(inside, 1e-12 * xp.ones_like(x), g))

    return opfunc


@pytest.mark.parametrize("case", ["rejected", "soft_restart"])
@pytest.mark.parametrize("line_search", ["armijo", "wolfe"])
def test_rejected_and_restarted_steps_match_jax(case, line_search):
    """A rejected step (NO_PROGRESS after a failed search) and a soft
    restart (non-descent with a history: cleared, still RUNNING) against
    pinn.optim.lbfgs on x, f, g, n_iter, n_evals, k and reason at every
    iteration.  The port's d stays the two-loop direction of its g_old
    and history after every iteration, these two included, where the
    JAX package's d is zero."""
    kw = dict(max_iter=20, n_correction=5, line_search=line_search,
              restart=True, tol_fun=1e-30)
    x0 = np.array([1.0, -2.0, 0.5, 3.0])
    jconf, tconf = jax_lb.LbfgsConfig(**kw), lb.LbfgsConfig(**kw)
    jop, top = _trap(jnp, jnp.where, case), _trap(torch, torch.where, case)
    jstate = jax_lb.lbfgs_init(jop, jnp.asarray(x0), jconf)
    tstate = lb.lbfgs_init(top, torch.as_tensor(x0), tconf)
    jrun = jax_lb.make_lbfgs_run(jop, jconf)
    trun = lb.make_lbfgs_run(top, tconf)
    events = []
    while tstate.reason == lb.RUNNING and tstate.n_iter < 20:
        k, n_evals = tstate.k, tstate.n_evals
        jstate, _ = jrun(jstate, None, 1)
        tstate, _ = trun(tstate, None, 1)
        msg = f"iteration {tstate.n_iter}"
        for got, want in ((tstate.x, jstate.x), (tstate.g, jstate.g)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-9, atol=1e-12, err_msg=msg)
        np.testing.assert_allclose(float(tstate.f), float(jstate.f),
                                   rtol=1e-9, err_msg=msg)
        assert tstate.n_iter == int(jstate.n_iter), msg
        assert tstate.n_evals == int(jstate.n_evals), msg
        assert tstate.k == int(jstate.k), msg
        assert tstate.reason == int(jstate.reason), msg
        want = lb._two_loop(tstate.g_old, tstate.S, tstate.Y, tstate.k,
                            tstate.head, tstate.hdiag, tconf.n_correction)
        torch.testing.assert_close(tstate.d, want, rtol=1e-12, atol=0.0,
                                   msg=msg)
        rejected = tstate.reason == lb.NO_PROGRESS and tstate.n_evals > n_evals
        restarted = tstate.reason == lb.RUNNING and k > 0 and tstate.k == 0
        if rejected or restarted:
            events.append("rejected" if rejected else "soft_restart")
            assert float(jnp.abs(jstate.d).max()) == 0.0, msg
            assert float(tstate.d.abs().max()) > 0.0, msg
    assert events == [case]


# ---------------------------------------------------------------------------
# AdamRunner
# ---------------------------------------------------------------------------

def _runner_case(tmp_path, jdt):
    """The Burgers continuous loss on [2, 10, 10, 1], both sides from one
    JAX-saved npz: (JAX params, batch, loss; the port's)."""
    from pinn.models import mlp as jax_mlp
    from pinn.problems import burgers as jax_burgers
    from pinn.utils import checkpoint as jax_checkpoint
    from pinn_torch.problems import burgers
    from pinn_torch.utils import checkpoint
    from pinn_torch.utils.checkpoint import params_from_numpy

    path = str(tmp_path / "init.npz")
    init = jax_mlp.init_mlp(jax.random.PRNGKey(3), [2, 10, 10, 1], jdt)
    jax_checkpoint.save_npz(path, init)
    jparams, _ = jax_checkpoint.load_npz(path, like=init)
    tdt = torch.float64 if jdt == jnp.float64 else torch.float32
    tparams, _ = checkpoint.load_npz(path, like=params_from_numpy(
        [(np.asarray(w), np.asarray(b)) for w, b in init], "cpu", tdt))
    rng = np.random.RandomState(4)
    lb, ub = np.array([-1.0, 0.0]), np.array([1.0, 1.0])
    batch = {"X_u": lb + (ub - lb) * rng.rand(32, 2), "u": rng.rand(32, 1),
             "X_f": lb + (ub - lb) * rng.rand(128, 2)}
    npdt = np.float64 if tdt == torch.float64 else np.float32
    batch = {k: v.astype(npdt) for k, v in batch.items()}
    nu = 0.01 / np.pi

    def jloss(p, b):
        return jax_burgers.loss_cont_inference(
            p, b["X_u"], b["u"], b["X_f"], jnp.asarray(lb, jdt),
            jnp.asarray(ub, jdt), nu)

    lb_t, ub_t = torch.tensor(lb, dtype=tdt), torch.tensor(ub, dtype=tdt)

    def tloss(p, b):
        return burgers.loss_cont_inference(p, b["X_u"], b["u"], b["X_f"],
                                           lb_t, ub_t, nu)
    return ((jparams, {k: jnp.asarray(v) for k, v in batch.items()}, jloss),
            (tparams, {k: torch.as_tensor(v) for k, v in batch.items()},
             tloss))


# (JAX dtype, hp extra, rtol of the losses, rtol and atol of the params).
# With tf_net_dtype each product's gradient is rounded to bf16 on both
# sides; the two sums of those roundings differ by an ulp here and there,
# which 20 normalised Adam steps carry into the parameters: measured at
# 2.6e-3 relative in the losses and 3.7e-4 absolute in the parameters
# on this case (float32: 2.8e-7 and 6.0e-8; float64: 5.6e-16 and
# 1.7e-16).
RUNNER_CASES = {
    "float32": (jnp.float32, {}, 1e-6, 1e-5, 1e-7),
    "float64": (jnp.float64, {}, 1e-10, 1e-10, 1e-13),
    "bf16_net": (jnp.float32, {"tf_net_dtype": "bfloat16"}, 5e-3, 0, 1e-3),
}


@pytest.mark.parametrize("case", list(RUNNER_CASES))
def test_adam_runner_matches_jax(case, tmp_path):
    """20 steps of ``AdamRunner.run`` against JAX's, and the same 20 as
    runs of 7 + 13 bitwise equal to one of 20."""
    from pinn.optim.adam import AdamRunner as JaxAdamRunner
    from pinn_torch import params as pcodec
    from pinn_torch.optim import AdamRunner

    jdt, extra, rtol_l, rtol_p, atol_p = RUNNER_CASES[case]
    (jp, jb, jloss), (tp, tb, tloss) = _runner_case(tmp_path, jdt)
    hp = {"tf_lr": 1e-2, "tf_b1": 0.9, "tf_eps": None, **extra}
    jr = JaxAdamRunner(jloss, hp)
    want_p, _, want_l = jr.run(jp, jr.init(jp), jb, 20)

    runner = AdamRunner(tloss, hp)
    assert (runner.loss_fn is tloss) == (not extra)
    got_p, _, got_l = runner.run(tp, runner.init(tp), tb, 20)
    assert got_l.shape == (20,)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), rtol=rtol_l)
    for g, w in zip(pcodec.leaves(got_p), jax.tree_util.tree_leaves(want_p)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=rtol_p,
                                   atol=atol_p)

    state = runner.init(tp)
    p7, state, l7 = runner.run(tp, state, tb, 7)
    p20, _, l13 = runner.run(p7, state, tb, 13)
    assert torch.equal(torch.cat([l7, l13]), got_l)
    assert torch.equal(pcodec.ravel(p20), pcodec.ravel(got_p))
    assert not torch.equal(pcodec.ravel(p7), pcodec.ravel(p20))


def test_trainer_adam_losses_are_adam_runner_losses(tmp_path):
    """The Trainer's logged Adam losses and its Adam-phase result are
    ``AdamRunner.run``'s bit for bit (log_frequency 1: every step)."""
    from pinn_torch import params as pcodec
    from pinn_torch.optim import AdamRunner
    from pinn_torch.train import Trainer

    _, (tp, tb, tloss) = _runner_case(tmp_path, jnp.float32)
    hp = {"tf_epochs": 23, "tf_lr": 1e-2, "nt_epochs": 0, "log_frequency": 1}
    logged = []

    class Log:
        def __getattr__(self, name):
            if name == "log_train_epoch":
                return lambda epoch, loss, *a: logged.append((epoch, loss))
            return lambda *a, **k: None

    got = Trainer(tloss, tp, tb, hp, logger=Log()).fit()
    runner = AdamRunner(tloss, hp)
    want, _, losses = runner.run(tp, runner.init(tp), tb, 23)
    assert logged == [(i, float(l)) for i, l in enumerate(losses)]
    assert torch.equal(pcodec.ravel(got), pcodec.ravel(want))
