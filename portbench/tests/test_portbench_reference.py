"""The plain reference against independent derivations: the loss
and gradients against nested autograd of a plain net, Adam against
``torch.optim.Adam``, the L-BFGS direction against a dense BFGS
update, and the TF32 rounding at its ties."""

import math

import pytest
import torch

from portbench.reference import adam, lbfgs, schrodinger
from portbench.reference.precision import FLOAT64, TF32, round_tf32

D = torch.float64


def T(x):
    return torch.tensor(x, dtype=D)


def _net(layers, seed):
    g = torch.Generator().manual_seed(seed)
    leaves = []
    for a, b in zip(layers[:-1], layers[1:]):
        leaves += [torch.randn(a, b, generator=g, dtype=D) / math.sqrt(a),
                   0.1 * torch.randn(b, generator=g, dtype=D)]
    return leaves


def _plain(leaves, X, lb, ub):
    a = 2.0 * (X - lb) / (ub - lb) - 1.0
    for i in range(0, len(leaves) - 2, 2):
        a = torch.tanh(a @ leaves[i] + leaves[i + 1])
    return a @ leaves[-2] + leaves[-1]


def _derivs(leaves, X, lb, ub, k):
    """Output k and its x, xx, t derivatives by nested autograd."""
    X = X.clone().requires_grad_(True)
    u = _plain(leaves, X, lb, ub)[:, k]
    du, = torch.autograd.grad(u.sum(), X, create_graph=True)
    u_x, u_t = du[:, 0], du[:, 1]
    u_xx = torch.autograd.grad(u_x.sum(), X, create_graph=True)[0][:, 0]
    return u, u_x, u_xx, u_t


def _points(n, seed, lb, ub):
    g = torch.Generator().manual_seed(seed)
    return lb + (ub - lb) * torch.rand(n, 2, generator=g, dtype=D)


@pytest.mark.parametrize("block", [5, 1 << 17])
def test_schrodinger_loss_and_grad(block):
    lb, ub = T([-5.0, 0.0]), T([5.0, math.pi / 2])
    leaves = _net([2, 6, 6, 2], 7)
    x0 = lb[0] + (ub[0] - lb[0]) * torch.rand(8, generator=torch.Generator().manual_seed(8), dtype=D)
    X0 = torch.stack([x0, torch.zeros(8, dtype=D)], 1)
    H0 = torch.randn(8, 2, generator=torch.Generator().manual_seed(9), dtype=D)
    tb = ub[1] * torch.rand(6, generator=torch.Generator().manual_seed(10), dtype=D)
    X_lb = torch.stack([torch.full((6,), -5.0, dtype=D), tb], 1)
    X_ub = torch.stack([torch.full((6,), 5.0, dtype=D), tb], 1)
    X_f = _points(17, 11, lb, ub)
    want_leaves = [a.clone().requires_grad_(True) for a in leaves]
    H = _plain(want_leaves, X0, lb, ub)
    mse_0 = torch.mean((H[:, 0] - H0[:, 0]) ** 2) + torch.mean((H[:, 1] - H0[:, 1]) ** 2)
    mse_b = 0.0
    for k in (0, 1):
        lo, hi = _derivs(want_leaves, X_lb, lb, ub, k), _derivs(want_leaves, X_ub, lb, ub, k)
        mse_b = mse_b + torch.mean((lo[0] - hi[0]) ** 2) + torch.mean((lo[1] - hi[1]) ** 2)
    u, _, u_xx, u_t = _derivs(want_leaves, X_f, lb, ub, 0)
    v, _, v_xx, v_t = _derivs(want_leaves, X_f, lb, ub, 1)
    h2 = u * u + v * v
    f_u, f_v = u_t + 0.5 * v_xx + h2 * v, v_t - 0.5 * u_xx - h2 * u
    want = mse_0 + mse_b + torch.mean(f_u ** 2) + torch.mean(f_v ** 2)
    want_g = torch.autograd.grad(want, want_leaves)
    got, got_g = schrodinger.loss_and_grad(
        leaves, {"X0": X0, "H0": H0, "X_lb": X_lb, "X_ub": X_ub, "X_f": X_f},
        {"lb": lb, "ub": ub}, FLOAT64, block=block)
    assert float(got) == pytest.approx(float(want.detach()), rel=1e-12)
    for a, b in zip(got_g, want_g):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-12)


def test_loss_only_equals_loss_with_grads():
    lb, ub = T([-1.0, 0.0]), T([1.0, 1.0])
    X_b = _points(3, 3, lb, ub)
    inputs = {"X0": _points(5, 1, lb, ub), "H0": torch.ones(5, 2, dtype=D),
              "X_lb": X_b, "X_ub": X_b + T([2.0, 0.0]),
              "X_f": _points(11, 2, lb, ub)}
    const = {"lb": lb, "ub": ub}
    leaves = _net([2, 4, 2], 1)
    f, g = schrodinger.loss_and_grad(leaves, inputs, const, FLOAT64)
    f0, g0 = schrodinger.loss_and_grad(leaves, inputs, const, FLOAT64, grads=False)
    assert g0 is None and float(f0) == float(f)


def test_round_tf32_ties_and_grads():
    one = torch.tensor(1.0, dtype=torch.float32)
    e = 2.0 ** -10
    cases = {1 + e: 1 + e, 1 + e / 2: 1.0, 1 + 1.5 * e: 1 + 2 * e,
             1 + e / 2 + 2.0 ** -20: 1 + e, -(1 + e / 2 + 2.0 ** -20): -(1 + e)}
    for x, want in cases.items():
        got = round_tf32(torch.tensor(x, dtype=torch.float32))
        assert float(got) == want, (x, float(got), want)
    assert float(round_tf32(one)) == 1.0
    a = torch.randn(4, 3, dtype=torch.float32, requires_grad=True)
    w = torch.randn(3, 2, dtype=torch.float32, requires_grad=True)
    TF32.mm(a, w).sum().backward()
    torch.testing.assert_close(a.grad, round_tf32(torch.ones(4, 2, dtype=torch.float32)) @ round_tf32(w.detach()).t())


def test_adam_against_torch_optim():
    target = T([0.3, -1.2, 2.0])
    x0 = [T([1.0, 1e-9, -0.5])]

    def lg(leaves, grads):
        f = torch.sum((leaves[0] - target) ** 4)
        return f, [4 * (leaves[0] - target) ** 3]

    hp = {"tf_lr": 0.03, "tf_b1": 0.9, "tf_eps": None}
    got = adam.follow(lg, x0, hp, 3, torch.float64)
    p = x0[0].clone().requires_grad_(True)
    opt = torch.optim.Adam([p], lr=0.03, betas=(0.9, 0.999), eps=1e-7)
    losses = []
    for _ in range(3):
        opt.zero_grad()
        f = torch.sum((p - target) ** 4)
        f.backward()
        losses.append(float(f.detach()))
        opt.step()
    assert got["losses"] == pytest.approx(losses, rel=1e-14)
    torch.testing.assert_close(got["change"][0], (p - x0[0]).detach(), rtol=1e-12, atol=1e-15)
    torch.testing.assert_close(got["grad"][0], 4 * (x0[0] - target) ** 3)


def test_lbfgs_direction_is_the_dense_bfgs_update():
    g = torch.Generator().manual_seed(0)
    s, y, grad = (torch.randn(6, generator=g, dtype=D) for _ in range(3))
    y = y + 2 * s   # y.s > 0
    rho = 1 / torch.dot(y, s)
    h0 = torch.dot(y, s) / torch.dot(y, y)
    eye = torch.eye(6, dtype=D)
    H = (eye - rho * torch.outer(s, y)) @ (h0 * eye) @ (eye - rho * torch.outer(y, s)) \
        + rho * torch.outer(s, s)
    torch.testing.assert_close(lbfgs._direction(grad, [(s, y)], h0), -H @ grad)


@pytest.mark.parametrize("search", ["wolfe", "armijo", "none"])
def test_lbfgs_on_a_quadratic(search):
    g = torch.Generator().manual_seed(1)
    M = torch.randn(5, 5, generator=g, dtype=D)
    A = 0.2 * M @ M.t() + torch.eye(5, dtype=D)
    b = torch.randn(5, generator=g, dtype=D)

    def lg(leaves, grads):
        x = leaves[0]
        f = 0.5 * x @ A @ x - b @ x
        return f, ([A @ x - b] if grads else None)

    x0 = [torch.zeros(5, dtype=D)]
    hp = {"nt_ncorr": 50, "nt_line_search": search, "nt_lr": 0.8,
          "nt_vector_dtype": "float64"}
    out = lbfgs.follow(lg, x0, hp, 3, torch.float64)
    assert out["losses"][0] == 0.0
    assert out["losses"][1] < out["losses"][0]
    if search != "none":   # a search keeps every step a decrease
        assert out["losses"][3] <= out["losses"][2] <= out["losses"][1]
    # The first step is t0 = min(1, 1 / sum|g|) along -g or, with a
    # search, a step the search accepted along -g: the change after one
    # iteration is parallel to b.
    one = lbfgs.follow(lg, x0, hp, 1, torch.float64)
    c = one["change"][0]
    torch.testing.assert_close(c / c.norm(), b / b.norm())
    if search == "none":
        torch.testing.assert_close(c, min(1.0, 1.0 / float(b.abs().sum())) * b)
