"""The L-BFGS two-loop kernel (``pinn_torch.ops.lbfgs_direction``,
``pinn_torch/csrc/lbfgs_direction.cu``) against the eager recursion
``pinn_torch.optim.lbfgs._two_loop`` on the same ring, on the card.
Skips without a CUDA device (a CUDA kernel has no CPU mode; the CPU
side of the dispatch is tested in test_torch_lbfgs_direction.py).  No
JAX here: on a machine with a card and no JAX, run

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_lbfgs.py

The rings are what L-BFGS fills on a quadratic with a diagonal Hessian
in [0.5, 2] (y = H s), the rows outside the k filled ones noise.  Bars,
on the largest difference over the largest entry of the eager
direction: float64 1e-12 and float32 1e-5 (the same recursion with the
same roundings, only the order of each dot product's sum differs:
cuBLAS's against the kernel's), bfloat16 5e-2 (one bf16 ulp, 2^-8, of
a dot's total moves a step's coefficient, and the k steps compound).
Two launches are bitwise equal.  A 30-iteration Armijo run of the
fused Schrödinger loss at N_f = 20,000 on the kernel tracks the eager
direction's run to 1e-6 relative over its first 5 losses.
"""

import numpy as np
import pytest
import torch

from pinn_torch.ops import lbfgs_direction as ld
from pinn_torch.optim import lbfgs as lb
from pinn_torch.utils import trace

pytestmark = pytest.mark.cuda

RTOL = {torch.float64: 1e-12, torch.float32: 1e-5, torch.bfloat16: 5e-2}


@pytest.fixture(autouse=True)
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a CUDA kernel has no CPU mode)")


def _ring(p, m, k, head, dtype, seed=0, device="cuda"):
    rng = np.random.RandomState(seed)
    h = rng.uniform(0.5, 2.0, p)
    S, Y = rng.randn(m, p), rng.randn(m, p)
    for j in range(k):
        row = (head - k + j) % m
        Y[row] = h * S[row]
    newest = (head - 1) % m
    hdiag = S[newest] @ Y[newest] / (Y[newest] @ Y[newest]) if k else 1.0
    g, S, Y, hdiag = (torch.as_tensor(a, dtype=dtype, device=device)
                      for a in (rng.randn(p), S, Y, np.float64(hdiag)))
    return g, S, Y, k, head, hdiag, m


def _rel_err(got, want):
    return float((got.double() - want.double()).abs().max()
                 / want.double().abs().max())


def _heads(m, k):
    """head at 0 (the filled rows end the ring), mid-ring, and wrapped
    (the filled rows run over the ring's end)."""
    return {"head0": 0, "mid": m // 2, "wrapped": max(1, k // 2) % m}


CASES = [(p, m, k, where)
         for p in (3021, 30802, 30803)
         for m in (10, 50)
         for k in (0, 1, 2, 17, m) if k <= m
         for where in ("head0", "mid", "wrapped")]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("p,m,k,where", CASES)
def test_kernel_matches_eager(p, m, k, where, dtype):
    ring = _ring(p, m, k, _heads(m, k)[where], dtype, seed=p + m + k)
    want = lb._two_loop(*ring)
    got = ld.two_loop(*ring)
    assert got.dtype == dtype and got.shape == (p,)
    assert _rel_err(got, want) <= RTOL[dtype]


@pytest.mark.parametrize("p,dtype", [(600_000, torch.float64),
                                     (1_000_000, torch.float32)],
                         ids=["f64", "f32"])
def test_kernel_matches_eager_at_large_p(p, dtype):
    """Far beyond the nets of the recipes: q lives in the output buffer,
    so P has no bound of the kernel's own."""
    ring = _ring(p, 4, 4, 1, dtype, seed=3)
    assert _rel_err(ld.two_loop(*ring), lb._two_loop(*ring)) <= RTOL[dtype]


@pytest.mark.parametrize("p,k", [(3021, 2), (3021, 17), (30802, 17)])
def test_kernel_matches_eager_bf16(p, k):
    ring = _ring(p, 50, k, 20, torch.bfloat16, seed=k)
    assert _rel_err(ld.two_loop(*ring), lb._two_loop(*ring)) <= RTOL[torch.bfloat16]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                   torch.bfloat16], ids=["f64", "f32", "bf16"])
@pytest.mark.parametrize("p", [3021, 30802])
def test_two_launches_bitwise_equal(p, dtype):
    ring = _ring(p, 50, 50, 17, dtype)
    assert torch.equal(ld.two_loop(*ring), ld.two_loop(*ring))


def test_one_launch_a_direction_through_lbfgs():
    ring = _ring(30802, 50, 50, 17, torch.float64)
    config = lb.LbfgsConfig(dir_impl="scan")
    for _ in range(2):
        before = trace.counters()
        lb._direction(config, *ring)
        assert trace.delta(before, trace.counters()) == {
            "launch.lbfgs_two_loop": 1}


def _bad(kind):
    g, S, Y, k, head, hdiag, m = _ring(300, 10, 5, 3, torch.float64)
    if kind == "shape":
        S = S[:, :-1]
    elif kind == "dtype":
        g, S, Y, hdiag = (a.half() for a in (g, S, Y, hdiag))
    elif kind == "mixed_dtype":
        Y = Y.float()
    elif kind == "stride":
        S = torch.empty(300, 10, dtype=torch.float64, device="cuda").t()
        S.copy_(Y)
    elif kind == "g_stride":
        g = torch.empty(600, dtype=torch.float64, device="cuda")[::2]
    elif kind == "k":
        k = m + 1
    elif kind == "head":
        head = m
    return g, S, Y, k, head, hdiag, m


@pytest.mark.parametrize("kind", ["shape", "dtype", "mixed_dtype", "stride",
                                  "g_stride", "k", "head"])
def test_bad_cuda_arguments_raise(kind):
    ring = _bad(kind)
    with pytest.raises(ValueError):
        ld.two_loop(*ring)
    with pytest.raises(ValueError):
        lb._direction(lb.LbfgsConfig(dir_impl="scan"), *ring)


def _schrodinger_problem(n_f, seed, device="cuda"):
    from pinn_torch import params as pcodec
    from pinn_torch.ops import fused_schrodinger as fs
    from pinn_torch.utils.checkpoint import params_from_numpy

    rng = np.random.RandomState(seed)
    layers = [2, 100, 100, 100, 100, 2]
    pairs = [(rng.randn(a, b) * np.sqrt(2.0 / (a + b)), np.zeros(b))
             for a, b in zip(layers[:-1], layers[1:])]
    params = params_from_numpy(pairs, device, torch.float32)
    lb_, ub_ = np.array([-5.0, 0.0]), np.array([5.0, np.pi / 2])
    x0 = rng.uniform(-5.0, 5.0, (50, 1))
    tb = rng.uniform(0.0, np.pi / 2, (50, 1))
    batch = {"X0": np.hstack([x0, np.zeros_like(x0)]),
             "H0": np.hstack([2.0 / np.cosh(x0), np.zeros_like(x0)]),
             "X_lb": np.hstack([np.full_like(tb, -5.0), tb]),
             "X_ub": np.hstack([np.full_like(tb, 5.0), tb]),
             "X_f": lb_ + (ub_ - lb_) * rng.rand(n_f, 2)}
    batch = {key: torch.as_tensor(a, dtype=torch.float32, device=device)
             for key, a in batch.items()}
    loss_fn = fs.make_schrodinger_loss(lb_, ub_)
    flat, unravel = pcodec.ravel_with_unravel(params)

    def opfunc(w, b):
        w_ = w.detach().requires_grad_(True)
        loss = loss_fn(unravel(w_.float()), b)
        g, = torch.autograd.grad(loss, w_)
        return loss.detach().double(), g

    def lossfunc(w, b):
        with torch.no_grad():
            return loss_fn(unravel(w.float()), b).double()

    return opfunc, lossfunc, flat.detach().double(), batch


def test_armijo_run_tracks_the_eager_direction(monkeypatch):
    opfunc, lossfunc, x0, batch = _schrodinger_problem(20000, seed=5)
    config = lb.LbfgsConfig(max_iter=30, n_correction=50,
                            line_search="armijo", dir_impl="scan")

    def run():
        state = lb.lbfgs_init(opfunc, x0.clone(), config, batch)
        state, f_hist = lb.make_lbfgs_run(opfunc, config, lossfunc)(
            state, batch, 30)
        return state, f_hist.cpu().numpy()

    before = trace.counters()
    state, kernel = run()
    launches = trace.delta(before, trace.counters()).get(
        "launch.lbfgs_two_loop", 0)
    assert state.n_iter == 30 and launches == 29
    monkeypatch.setattr(lb, "two_loop", lb._two_loop)
    _, eager = run()
    np.testing.assert_allclose(kernel[:5], eager[:5], rtol=1e-6)
    assert np.all(np.isfinite(kernel)) and kernel[-1] < kernel[0]
