"""The CUDA kernels of pinn_torch against their plain PyTorch versions,
on the card.  Skips without a CUDA device (there is no interpret mode
for a CUDA kernel).  No JAX here: on a machine with a card and no JAX,
run

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Bars as in tests/test_pallas_train.py: loss rtol 1e-5, gradients rtol
5e-4 with atol 5e-6 * max|g|, identification lambda adjoints rtol 1e-4;
two launches are bitwise equal; at [2, 100x4, 2] the Schrödinger
loss-only kernel's loss is the loss+grad kernel's bit for bit (f32 and
bf16: the same tiled forward, grid and order of sums), and so are the
Burgers inference, identification and v1 SSE pairs' at [2, 20x8, 1]
and at every edge of the narrow kernels, f32 and bf16 (the narrow
loss+grad kernel and the narrow loss-only kernel share one forward,
head and order of sums).  The bf16-stream
kernels against their plain bf16 versions (the same roundings, summed
in another order, which can move a rounding): loss rtol 2e-3, gradient
rel-L2 <= 1e-2 and cosine >= 0.9999 (the net gradients and the lambda
adjoints each).  The residual-evaluation kernels against theirs at the
bars of tests/test_pallas.py: Burgers rtol 2e-5 / atol 1e-6,
Schrödinger rtol 2e-4 / atol 2e-6; the two Burgers residual layouts
(one eval kernel, two input policies) bitwise equal on the same
inputs.  The eager Navier–Stokes loss and gradients on the card against
the CPU, float64 rtol 1e-10.
"""

import numpy as np
import pytest
import torch

from pinn_torch.ops import fused_schrodinger as fs
from pinn_torch.ops import fused_train as ft
from pinn_torch.ops import residual as rs
from pinn_torch.utils import trace
from pinn_torch.utils.checkpoint import params_from_numpy

pytestmark = [
    pytest.mark.cuda,
    pytest.mark.skipif(not torch.cuda.is_available(),
                       reason="needs a CUDA device (CUDA kernels have no "
                              "CPU mode; their plain versions are tested "
                              "in test_torch_fused_train.py)"),
]

NU = 0.01 / np.pi
LB = np.array([-1.0, 0.0], np.float32)
UB = np.array([1.0, 1.0], np.float32)
S_LB = np.array([-5.0, 0.0], np.float32)
S_UB = np.array([5.0, np.pi / 2], np.float32)


def _case(layers, n_u, n_f, seed, device):
    rng = np.random.RandomState(seed)
    pairs = [(rng.randn(a, b) * np.sqrt(2.0 / (a + b)), 0.1 * rng.randn(b))
             for a, b in zip(layers[:-1], layers[1:])]
    params = params_from_numpy(pairs, device, torch.float32)
    batch = {"X_u": LB + (UB - LB) * rng.rand(n_u, 2), "u": rng.rand(n_u, 1),
             "X_f": LB + (UB - LB) * rng.rand(n_f, 2)}
    batch = {k: torch.as_tensor(v, dtype=torch.float32, device=device)
             for k, v in batch.items()}
    return params, batch


def _kernel_args(params, batch, n=None):
    """The inference kernels' arguments; with ``n``, only the last ``n``
    points."""
    dev = batch["X_f"].device
    lb, ub = (torch.as_tensor(a, device=dev) for a in (LB, UB))
    a0, aux = ft._prep_points(batch, lb, ub)
    if n is not None:
        a0, aux = a0[:, -n:].contiguous(), aux[:, -n:].contiguous()
    scale = 2.0 / (ub - lb)
    zero = torch.zeros((), device=dev)
    vx, vt = torch.stack([scale[0], zero]), torch.stack([zero, scale[1]])
    return (a0, aux, *ft._prep(params, vx, vt))


FLAGSHIP = [2] + [20] * 8 + [1]
# The edges of the narrow loss+grad kernel (pt_narrow.cuh, a block a
# 32-point tile), as (layers, N_u, N_f, the last N points kept): one
# point, a tile less or more one point, the flagship's 316 tiles and 7
# points more, hidden widths that are not multiples of 4, the widest
# pack and the most layers.
NARROW_EDGES = [
    (FLAGSHIP, 1, 1, 1),
    (FLAGSHIP, 10, 22, 31),
    (FLAGSHIP, 11, 23, 33),
    (FLAGSHIP, 100, 316 * 32 + 7 - 100, None),
    ([2, 7, 33, 64, 1], 33, 300, None),
    ([2] + [64] * 14 + [1], 50, 500, None),
    ([2] + [20] * 15 + [1], 50, 500, None),
]


def _flat(out):
    loss, gwt, gz1, gz2 = out
    return [loss.reshape(1)] + [g.reshape(-1) for g in (*gwt, gz1, gz2)]


def _launched(before, *names):
    """Launches of each named kernel since ``before`` (a
    ``trace.counters()`` snapshot): the ``launch.<entry>`` counters."""
    moved = trace.delta(before, trace.counters())
    return tuple(moved.get("launch." + n, 0) for n in names)


@pytest.mark.parametrize("layers,n_u,n_f,n", [
    ([2, 20, 20, 20, 1], 32, 300, None),
    ([2] + [20] * 8 + [1], 100, 2048, None),
    ([2, 16, 1], 7, 1017, None),
    ([2, 40, 40, 1], 16, 256, None),
    ([2, 5, 1], 1, 1, None),
] + NARROW_EDGES)
def test_kernels_match_plain(layers, n_u, n_f, n):
    params, batch = _case(layers, n_u, n_f, seed=len(layers) + n_f, device="cuda")
    args = _kernel_args(params, batch, n)
    n0 = trace.counters()
    got = _flat(ft.burgers_loss_grad(*args, NU))
    again = _flat(ft.burgers_loss_grad(*args, NU))
    loss_only = ft.burgers_loss(*args, NU)
    want = _flat(ft.burgers_loss_grad_plain(*args, NU))
    torch.cuda.synchronize()
    assert _launched(n0, "burgers_loss_grad", "burgers_loss") == (2, 1)

    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=0.0)
    gmax = max(float(w.abs().max()) for w in want[1:])
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, w, rtol=5e-4, atol=5e-6 * gmax)
    torch.testing.assert_close(loss_only.reshape(1), got[0], rtol=1e-6,
                               atol=0.0)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("layers,n_u,n_f,n", [
    (FLAGSHIP, 100, 10000, None),
    (FLAGSHIP, 100, 1948, None),
] + NARROW_EDGES)
def test_inference_loss_only_is_the_loss_grad_loss_bitwise(layers, n_u, n_f,
                                                           n, bf16):
    """At [2, 20x8, 1] (N = 10,100 and 2,048) and at the narrow kernels'
    edges burgers_loss's loss is burgers_loss_grad's bit for bit: the
    L-BFGS line search compares loss-only trials with loss+grad
    values."""
    params, batch = _case(layers, n_u, n_f, seed=len(layers) + n_f + 3,
                          device="cuda")
    args = _kernel_args(params, batch, n)
    n0 = trace.counters()
    loss_only = ft.burgers_loss(*args, NU, bf16=bf16)
    loss = ft.burgers_loss_grad(*args, NU, bf16=bf16)[0]
    torch.cuda.synchronize()
    sfx = "_bf16" if bf16 else ""
    assert _launched(n0, "burgers_loss" + sfx,
                     "burgers_loss_grad" + sfx) == (1, 1)
    assert torch.equal(loss_only.reshape(1), loss.reshape(1))


def test_fused_loss_on_card_matches_cpu():
    """make_burgers_loss on CUDA (kernels) against the same call on the
    CPU (plain version), through prep and reassembly."""
    layers = [2, 20, 20, 20, 1]
    outs = {}
    for dev in ("cuda", "cpu"):
        params, batch = _case(layers, 20, 500, seed=5, device=dev)
        leaves = [a.requires_grad_(True) for wb in params for a in wb]
        loss = ft.make_burgers_loss(LB, UB, NU)
        val = loss(params, batch)
        grads = torch.autograd.grad(val, leaves)
        with torch.no_grad():
            val_only = loss(params, batch)
        outs[dev] = [val.detach().cpu(), val_only.cpu()] + [g.cpu() for g in grads]
    cuda, cpu = outs["cuda"], outs["cpu"]
    torch.testing.assert_close(cuda[0], cpu[0], rtol=1e-5, atol=0.0)
    torch.testing.assert_close(cuda[1], cpu[1], rtol=1e-5, atol=0.0)
    gmax = max(float(g.abs().max()) for g in cpu[2:])
    for a, b in zip(cuda[2:], cpu[2:]):
        torch.testing.assert_close(a, b, rtol=5e-4, atol=5e-6 * gmax)


def test_cuda_wrapper_raises_instead_of_falling_back():
    params, batch = _case([2, 8, 1], 3, 40, seed=6, device="cuda")
    a0, aux, z1row, z2row, wt_args = _kernel_args(params, batch)
    with pytest.raises(TypeError, match="float32"):
        ft.burgers_loss_grad(a0.double(), aux.double(), z1row.double(),
                             z2row.double(), [w.double() for w in wt_args], NU)
    with pytest.raises(ValueError, match="widths"):
        wide = [torch.zeros(65, 2, device="cuda"), torch.zeros(65, 1, device="cuda"),
                torch.zeros(1, 65, device="cuda"), torch.zeros(1, 1, device="cuda")]
        ft.burgers_loss(a0, aux, torch.zeros(65, 1, device="cuda"),
                        torch.zeros(65, 1, device="cuda"), wide, NU)


# The narrow kernel's edges for the identification head (layers, N):
# the flagship at one point, a tile less or more one point and its 63
# tiles and 7 points more, then the widths and depths of NARROW_EDGES.
IDE_EDGES = [(FLAGSHIP, 1), (FLAGSHIP, 31), (FLAGSHIP, 33),
             (FLAGSHIP, 63 * 32 + 7)] + [(e[0], 1000) for e in NARROW_EDGES[4:]]


def _check_against_plain(got, again, want, loss_only, n_lam=0):
    """Flat outputs [loss, *grads, (lam adjoints)] of the kernel, a second
    launch, and the plain version; the loss-only kernel's value."""
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=0.0)
    net = slice(1, len(want) - n_lam)
    gmax = max(float(w.abs().max()) for w in want[net])
    for g, w in zip(got[net], want[net]):
        torch.testing.assert_close(g, w, rtol=5e-4, atol=5e-6 * gmax)
    for g, w in zip(got[len(want) - n_lam:], want[len(want) - n_lam:]):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=0.0)
    torch.testing.assert_close(loss_only.reshape(1), got[0], rtol=1e-6,
                               atol=0.0)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def _ide_args(layers, n, l1, logl2, seed):
    """The identification kernels' arguments on the card, ``n`` data
    points."""
    params, batch = _case(layers, n, 1, seed=seed, device="cuda")
    lb, ub, vx, vt = ft._tangents(LB, UB, "cuda")
    a0, aux = ft._prep_ide_points(batch, lb, ub)
    lam = ft._lam(torch.tensor([l1], device="cuda"),
                  torch.tensor([logl2], device="cuda"))
    return (a0, aux, lam, *ft._prep(params, vx, vt))


def _ide_flat(out):
    loss, gwt, gz1, gz2, glam = out
    return [loss.reshape(1)] + [g.reshape(-1) for g in (*gwt, gz1, gz2)] + [glam]


@pytest.mark.parametrize("layers,n", [
    ([2] + [20] * 8 + [1], 2000),
    ([2, 20, 20, 20, 1], 300),
    ([2, 16, 1], 1017),
] + IDE_EDGES)
@pytest.mark.parametrize("l1,logl2", [(0.0, -6.0), (1.3, -4.0)])
def test_ide_kernels_match_plain(layers, n, l1, logl2):
    args = _ide_args(layers, n, l1, logl2, seed=n)
    n0 = trace.counters()
    got = _ide_flat(ft.burgers_ide_loss_grad(*args))
    again = _ide_flat(ft.burgers_ide_loss_grad(*args))
    loss_only = ft.burgers_ide_loss(*args)
    want = _ide_flat(ft.burgers_ide_loss_grad_plain(*args))
    torch.cuda.synchronize()
    assert _launched(n0, "burgers_ide_loss_grad", "burgers_ide_loss") == (2, 1)
    _check_against_plain(got, again, want, loss_only, n_lam=1)
    assert torch.equal(loss_only.reshape(1), got[0])


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("layers,n", [(FLAGSHIP, 2000)] + IDE_EDGES)
def test_ide_loss_only_is_the_loss_grad_loss_bitwise(layers, n, bf16):
    """At [2, 20x8, 1] (N = 2,000) and at the narrow kernels' edges
    burgers_ide_loss's loss is burgers_ide_loss_grad's bit for bit: both
    narrow kernels evaluate the identification head alike."""
    args = _ide_args(layers, n, 1.3, -4.0, seed=len(layers) + n + 3)
    n0 = trace.counters()
    loss_only = ft.burgers_ide_loss(*args, bf16=bf16)
    loss = ft.burgers_ide_loss_grad(*args, bf16=bf16)[0]
    torch.cuda.synchronize()
    sfx = "_bf16" if bf16 else ""
    assert _launched(n0, "burgers_ide_loss" + sfx,
                     "burgers_ide_loss_grad" + sfx) == (1, 1)
    assert torch.equal(loss_only.reshape(1), loss.reshape(1))


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("n", [33, 63 * 32 + 7])
def test_ide_launches_on_one_input_are_bitwise_equal(n, bf16):
    """Two launches on the same inputs, with a launch on other inputs
    between them, give the same outputs bit for bit: the partials are
    fresh torch.empty memory each call, so a slot that a block does not
    write (a wrong row stride with the two extra accumulators) would
    carry the other inputs' values into the second launch."""
    args = _ide_args(FLAGSHIP, n, 1.3, -4.0, seed=n + 5)
    other = _ide_args(FLAGSHIP, n, 0.0, -6.0, seed=n + 6)
    first = _ide_flat(ft.burgers_ide_loss_grad(*args, bf16=bf16))
    between = _ide_flat(ft.burgers_ide_loss_grad(*other, bf16=bf16))
    second = _ide_flat(ft.burgers_ide_loss_grad(*args, bf16=bf16))
    torch.cuda.synchronize()
    assert not torch.equal(first[-1], between[-1])
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def _loss_only_args(entry, n, seed):
    """Arguments of a loss-only entry at [2, 20x8, 1] on ``n`` points:
    the inference kernels' (a third data points) or the identification
    kernels'."""
    if entry == "burgers_loss":
        params, batch = _case(FLAGSHIP, max(1, n // 3), n - n // 3 + 1,
                              seed=seed, device="cuda")
        return _kernel_args(params, batch, n) + (NU,)
    return _ide_args(FLAGSHIP, n, 1.3, -4.0, seed=seed)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("entry,n", [
    ("burgers_loss", 33), ("burgers_loss", 316 * 32 + 7),
    ("burgers_ide_loss", 33), ("burgers_ide_loss", 63 * 32 + 7),
])
def test_loss_only_launches_on_one_input_are_bitwise_equal(entry, n, bf16):
    """Two launches of a loss-only entry on the same inputs, with a
    launch on other inputs between them, give the same loss bit for
    bit: the partials are fresh torch.empty memory each call, so a
    tile's slot that no block writes would carry the other inputs'
    value into the second launch."""
    fn = getattr(ft, entry)
    args = _loss_only_args(entry, n, seed=n + 5)
    other = _loss_only_args(entry, n, seed=n + 6)
    first = fn(*args, bf16=bf16)
    between = fn(*other, bf16=bf16)
    second = fn(*args, bf16=bf16)
    torch.cuda.synchronize()
    assert not torch.equal(first, between)
    assert torch.equal(first, second)


# The edges of the tiled loss+grad kernel (pt_tile.cuh, 32-point tiles):
# one point, a tile less or more one point, more tiles than one wave of
# blocks (132 SMs), the widest net and one hidden layer.
S_TILE_EDGES = [
    ([2, 100, 100, 100, 100, 2], 1),
    ([2, 100, 100, 100, 100, 2], 31),
    ([2, 100, 100, 100, 100, 2], 33),
    ([2, 100, 100, 100, 100, 2], 132 * 32 + 7),
    ([2, 128, 128, 2], 132 * 32 + 7),
    ([2, 100, 2], 1000),
]


def _schrodinger_args(layers, n, seed):
    """Seeded weights and points, prepared for the Schrödinger kernels
    on the card: (a0, z1row, z2row, wt_args)."""
    rng = np.random.RandomState(seed)
    pairs = [(rng.randn(a, b) * np.sqrt(2.0 / (a + b)), 0.1 * rng.randn(b))
             for a, b in zip(layers[:-1], layers[1:])]
    params = params_from_numpy(pairs, "cuda", torch.float32)
    lbs, ubs = np.array([-5.0, 0.0], np.float32), np.array([5.0, np.pi / 2], np.float32)
    X_f = torch.as_tensor(lbs + (ubs - lbs) * rng.rand(n, 2), dtype=torch.float32,
                          device="cuda")
    lb, ub, vx, vt = ft._tangents(lbs, ubs, "cuda")
    return (ft._normalise(X_f, lb, ub), *ft._prep(params, vx, vt))


@pytest.mark.parametrize("layers,n", [
    ([2, 100, 100, 100, 100, 2], 2048),
    ([2, 100, 100, 100, 100, 2], 300),
    ([2, 40, 40, 2], 300),
    ([2, 32, 2], 512),
] + S_TILE_EDGES)
def test_schrodinger_kernels_match_plain(layers, n):
    args = _schrodinger_args(layers, n, seed=n)
    n0 = trace.counters()
    got = _flat(fs.schrodinger_sse_grad(*args))
    again = _flat(fs.schrodinger_sse_grad(*args))
    loss_only = fs.schrodinger_sse(*args)
    want = _flat(fs.schrodinger_sse_grad_plain(*args))
    torch.cuda.synchronize()
    assert _launched(n0, "schrodinger_sse_grad", "schrodinger_sse") == (2, 1)
    _check_against_plain(got, again, want, loss_only)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("n", [20000, 132 * 32 + 7])
def test_schrodinger_loss_only_is_the_loss_grad_loss_bitwise(n, bf16):
    """At [2, 100x4, 2] both tiled kernels run one block an SM, so the
    same grid, tiles and order of sums: the loss-only kernel's loss is
    the loss+grad kernel's, bit for bit."""
    args = _schrodinger_args([2, 100, 100, 100, 100, 2], n, seed=n + 2)
    n0 = trace.counters()
    loss_only = fs.schrodinger_sse(*args, bf16=bf16)
    loss = fs.schrodinger_sse_grad(*args, bf16=bf16)[0]
    torch.cuda.synchronize()
    sfx = "_bf16" if bf16 else ""
    assert _launched(n0, "schrodinger_sse" + sfx,
                     "schrodinger_sse_grad" + sfx) == (1, 1)
    assert torch.equal(loss_only.reshape(1), loss.reshape(1))


def test_schrodinger_wrapper_refuses_wide_nets():
    a0 = torch.zeros(2, 40, device="cuda")
    wide = [torch.zeros(129, 2, device="cuda"), torch.zeros(129, 1, device="cuda"),
            torch.zeros(2, 129, device="cuda"), torch.zeros(2, 1, device="cuda")]
    z = torch.zeros(129, 1, device="cuda")
    with pytest.raises(ValueError, match="widths"):
        fs.schrodinger_sse(a0, z, z, wide)


# ---------------------------------------------------------------------------
# bf16 streams
# ---------------------------------------------------------------------------

def _check_bf16(got, again, want, loss_only, want_loss, n_lam=0):
    """Flat outputs of a bf16 kernel, a second launch and the plain bf16
    version; the bf16 loss-only kernel's value and its plain version's."""
    torch.testing.assert_close(got[0], want[0], rtol=2e-3, atol=0.0)
    torch.testing.assert_close(loss_only, want_loss, rtol=2e-3, atol=0.0)
    k = len(want) - n_lam
    for part in (slice(1, k), slice(k, len(want))):
        if not want[part]:
            continue
        g, w = torch.cat(got[part]), torch.cat(want[part])
        assert float(torch.linalg.norm(g - w)) <= 1e-2 * float(torch.linalg.norm(w))
        assert float(g @ w) >= 0.9999 * float(torch.linalg.norm(g) * torch.linalg.norm(w))
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("layers,n_u,n_f,n", [
    ([2] + [20] * 8 + [1], 100, 10000, None),
    ([2] + [40] * 8 + [1], 100, 1024, None),
    ([2, 16, 1], 7, 1017, None),
] + NARROW_EDGES)
def test_bf16_kernels_match_plain(layers, n_u, n_f, n):
    params, batch = _case(layers, n_u, n_f, seed=n_f, device="cuda")
    args = _kernel_args(params, batch, n)
    n0 = trace.counters()
    got = _flat(ft.burgers_loss_grad(*args, NU, bf16=True))
    again = _flat(ft.burgers_loss_grad(*args, NU, bf16=True))
    loss_only = ft.burgers_loss(*args, NU, bf16=True)
    want = _flat(ft.burgers_loss_grad_bf16_plain(*args, NU))
    want_loss = ft.burgers_loss_bf16_plain(*args, NU)
    torch.cuda.synchronize()
    assert _launched(n0, "burgers_loss_grad_bf16", "burgers_loss_bf16",
                     "burgers_loss_grad", "burgers_loss") == (2, 1, 0, 0)
    _check_bf16(got, again, want, loss_only, want_loss)


@pytest.mark.parametrize("layers,n", [([2] + [20] * 8 + [1], 2000),
                                      ([2, 16, 1], 1017)] + IDE_EDGES)
def test_bf16_ide_kernels_match_plain(layers, n):
    args = _ide_args(layers, n, 1.3, -4.0, seed=n + 1)
    n0 = trace.counters()
    got = _ide_flat(ft.burgers_ide_loss_grad(*args, bf16=True))
    again = _ide_flat(ft.burgers_ide_loss_grad(*args, bf16=True))
    loss_only = ft.burgers_ide_loss(*args, bf16=True)
    want = _ide_flat(ft.burgers_ide_loss_grad_bf16_plain(*args))
    want_loss = ft.burgers_ide_loss_bf16_plain(*args)
    torch.cuda.synchronize()
    assert _launched(n0, "burgers_ide_loss_grad_bf16",
                     "burgers_ide_loss_bf16") == (2, 1)
    _check_bf16(got, again, want, loss_only, want_loss, n_lam=1)
    assert torch.equal(loss_only.reshape(1), got[0])


@pytest.mark.parametrize("layers,n", [([2, 100, 100, 100, 100, 2], 20000),
                                      ([2, 32, 2], 512)] + S_TILE_EDGES)
def test_bf16_schrodinger_kernels_match_plain(layers, n):
    args = _schrodinger_args(layers, n, seed=n + 1)
    n0 = trace.counters()
    got = _flat(fs.schrodinger_sse_grad(*args, bf16=True))
    again = _flat(fs.schrodinger_sse_grad(*args, bf16=True))
    loss_only = fs.schrodinger_sse(*args, bf16=True)
    want = _flat(fs.schrodinger_sse_grad_bf16_plain(*args))
    want_loss = fs.schrodinger_sse_bf16_plain(*args)
    torch.cuda.synchronize()
    assert _launched(n0, "schrodinger_sse_grad_bf16",
                     "schrodinger_sse_bf16") == (2, 1)
    _check_bf16(got, again, want, loss_only, want_loss)


# ---------------------------------------------------------------------------
# The v1 SSE pair and the residual-evaluation kernels
# ---------------------------------------------------------------------------

# The narrow kernels' edges for the v1 SSE pair (layers, N): the
# flagship at one point, a tile less or more one point and its 316
# tiles and 7 points more, then the widths and depths of NARROW_EDGES.
SSE_EDGES = IDE_EDGES[:3] + [(FLAGSHIP, 316 * 32 + 7)] + IDE_EDGES[4:]


def _sse_args(layers, n, seed):
    """The v1 SSE kernels' arguments on the card: (a0, z1row, z2row,
    wt_args) for ``n`` seeded collocation points."""
    rng = np.random.RandomState(seed)
    pairs = [(rng.randn(a, b) * np.sqrt(2.0 / (a + b)), 0.1 * rng.randn(b))
             for a, b in zip(layers[:-1], layers[1:])]
    params = params_from_numpy(pairs, "cuda", torch.float32)
    X_f = torch.as_tensor(LB + (UB - LB) * rng.rand(n, 2), dtype=torch.float32,
                          device="cuda")
    lb, ub, vx, vt = ft._tangents(LB, UB, "cuda")
    return (ft._normalise(X_f, lb, ub), *ft._prep(params, vx, vt))


@pytest.mark.parametrize("layers,n", [
    ([2] + [20] * 8 + [1], 10000),
    ([2] + [40] * 8 + [1], 1124),    # ragged edge inside a 32-point tile
    ([2, 16, 1], 1024),
    ([2, 5, 1], 1),
] + SSE_EDGES)
def test_sse_kernels_match_plain(layers, n):
    args = _sse_args(layers, n, seed=n)
    n0 = trace.counters()
    got = _flat(ft.burgers_sse_grad(*args, NU))
    again = _flat(ft.burgers_sse_grad(*args, NU))
    loss_only = ft.burgers_sse(*args, NU)
    want = _flat(ft.burgers_sse_grad_plain(*args, NU))
    torch.cuda.synchronize()
    assert _launched(n0, "burgers_sse_grad", "burgers_sse",
                     "burgers_loss_grad", "burgers_loss") == (2, 1, 0, 0)
    _check_against_plain(got, again, want, loss_only)
    assert torch.equal(loss_only.reshape(1), got[0])


@pytest.mark.parametrize("n", [10000, 316 * 32 + 7])
def test_sse_loss_only_is_the_loss_grad_loss_bitwise(n):
    """At [2, 20x8, 1] (N = 10,000 and 10,119) burgers_sse's SSE is
    burgers_sse_grad's bit for bit: both narrow kernels run one forward
    and sum each tile and the tiles in one order."""
    args = _sse_args(FLAGSHIP, n, seed=n + 3)
    n0 = trace.counters()
    loss_only = ft.burgers_sse(*args, NU)
    loss = ft.burgers_sse_grad(*args, NU)[0]
    torch.cuda.synchronize()
    assert _launched(n0, "burgers_sse", "burgers_sse_grad") == (1, 1)
    assert torch.equal(loss_only.reshape(1), loss.reshape(1))


@pytest.mark.parametrize("n", [33, 316 * 32 + 7])
def test_sse_launches_on_one_input_are_bitwise_equal(n):
    """Two launches of each SSE kernel on the same inputs, with a launch
    on other inputs between them, give the same outputs bit for bit: a
    partials slot that a block does not write would carry the other
    inputs' values into the second launch."""
    args = _sse_args(FLAGSHIP, n, seed=n + 5)
    other = _sse_args(FLAGSHIP, n, seed=n + 6)
    first = _flat(ft.burgers_sse_grad(*args, NU))
    first_loss = ft.burgers_sse(*args, NU)
    between = _flat(ft.burgers_sse_grad(*other, NU))
    between_loss = ft.burgers_sse(*other, NU)
    second = _flat(ft.burgers_sse_grad(*args, NU))
    second_loss = ft.burgers_sse(*args, NU)
    torch.cuda.synchronize()
    assert not torch.equal(first[0], between[0])
    assert not torch.equal(first_loss, between_loss)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    assert torch.equal(first_loss, second_loss)


def test_fused_sse_on_card_matches_cpu():
    """make_burgers_sse on CUDA against the same call on the CPU: the
    forward launches burgers_sse, the backward burgers_sse_grad."""
    layers = [2, 20, 20, 20, 1]
    outs = {}
    for dev in ("cuda", "cpu"):
        rng = np.random.RandomState(9)
        pairs = [(rng.randn(a, b) * np.sqrt(2.0 / (a + b)), 0.1 * rng.randn(b))
                 for a, b in zip(layers[:-1], layers[1:])]
        params = params_from_numpy(pairs, dev, torch.float32)
        X_f = torch.as_tensor(LB + (UB - LB) * rng.rand(500, 2),
                              dtype=torch.float32, device=dev)
        leaves = [a.requires_grad_(True) for wb in params for a in wb]
        n0 = trace.counters()
        val = ft.make_burgers_sse(LB, UB, NU)(params, X_f)
        grads = torch.autograd.grad(val, leaves)
        if dev == "cuda":
            assert _launched(n0, "burgers_sse", "burgers_sse_grad") == (1, 1)
        outs[dev] = [val.detach().cpu()] + [g.cpu() for g in grads]
    torch.testing.assert_close(outs["cuda"][0], outs["cpu"][0], rtol=1e-5, atol=0.0)
    gmax = max(float(g.abs().max()) for g in outs["cpu"][1:])
    for a, b in zip(outs["cuda"][1:], outs["cpu"][1:]):
        torch.testing.assert_close(a, b, rtol=5e-4, atol=5e-6 * gmax)


def _residual_case(layers, n, lb, ub, seed):
    rng = np.random.RandomState(seed)
    pairs = [(rng.randn(a, b) * np.sqrt(2.0 / (a + b)), 0.1 * rng.randn(b))
             for a, b in zip(layers[:-1], layers[1:])]
    X = torch.as_tensor(lb + (ub - lb) * rng.rand(n, 2), dtype=torch.float32,
                        device="cuda")
    return params_from_numpy(pairs, "cuda", torch.float32), X


BURGERS_RESIDUAL_SHAPES = [
    ([2] + [20] * 8 + [1], 25600),
    ([2, 20, 20, 1], 700),
    ([2, 20, 1], 2048),
    ([2, 5, 1], 1),
    # the narrow kernel's edges: one point, a tile less or more one
    # point, widths not multiples of 4, the widest pack, the pool
    ([2] + [20] * 8 + [1], 1),
    ([2] + [20] * 8 + [1], 31),
    ([2] + [20] * 8 + [1], 33),
    ([2, 7, 33, 64, 1], 1000),
    ([2] + [64] * 14 + [1], 1000),
    ([2] + [20] * 8 + [1], 200000),
]
BURGERS_LAYOUTS = ["burgers_residual", "burgers_residual_fmajor"]


@pytest.mark.parametrize("layers,n", BURGERS_RESIDUAL_SHAPES)
@pytest.mark.parametrize("name", BURGERS_LAYOUTS)
def test_burgers_residual_kernels_match_plain(layers, n, name):
    params, X = _residual_case(layers, n, LB, UB, seed=n)
    n0 = trace.counters()
    got = getattr(rs, name)(params, X, LB, UB, NU)
    again = getattr(rs, name)(params, X, LB, UB, NU)
    want = getattr(rs, name + "_plain")(params, X, LB, UB, NU)
    torch.cuda.synchronize()
    assert _launched(n0, name) == (2,)
    assert tuple(got.shape) == (n, 1)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=1e-6)
    assert torch.equal(got, again)


def _check_burgers_layouts(params, X, lb, ub):
    """Both Burgers layouts at (lb, ub): each against its plain version
    and twice bitwise equal, launched twice each; the two bitwise equal
    (one eval kernel, the same sums in the same order, only the loads
    differ)."""
    n0 = trace.counters()
    outs = {}
    for name in BURGERS_LAYOUTS:
        got = getattr(rs, name)(params, X, lb, ub, NU)
        again = getattr(rs, name)(params, X, lb, ub, NU)
        want = getattr(rs, name + "_plain")(params, X, lb, ub, NU)
        torch.cuda.synchronize()
        assert tuple(got.shape) == (X.shape[0], 1)
        torch.testing.assert_close(got, want, rtol=2e-5, atol=1e-6)
        assert torch.equal(got, again)
        outs[name] = got
    assert _launched(n0, *BURGERS_LAYOUTS) == (2, 2)
    assert torch.equal(*outs.values())


@pytest.mark.parametrize("layers,n", BURGERS_RESIDUAL_SHAPES)
@pytest.mark.parametrize("box", ["unit", "schrodinger"])
def test_burgers_residual_layouts_bitwise_equal(layers, n, box):
    """Row 10 (features-major) is row 9 (points-major) bit for bit on the
    same weights and points, in the unit box and in a box whose tangent
    scales are neither 1 nor 2 (Schrödinger's, (-5, 0) to (5, pi/2))."""
    lb, ub = (LB, UB) if box == "unit" else (S_LB, S_UB)
    _check_burgers_layouts(*_residual_case(layers, n, lb, ub, seed=n), lb, ub)


@pytest.mark.parametrize("past", [0, 1])
@pytest.mark.parametrize("box", ["unit", "schrodinger"])
def test_burgers_residual_block_rule_edge(past, box):
    """The eval kernel's launch takes 640 threads a block while its
    ceil(N / 32) blocks fit the SMs one each, else 320: N = 32 x SMs
    (the last grid on 640; 4,224 on 132 SMs) and one point more (the
    first on 320)."""
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    n = 32 * n_sm + past
    lb, ub = (LB, UB) if box == "unit" else (S_LB, S_UB)
    _check_burgers_layouts(*_residual_case([2] + [20] * 8 + [1], n, lb, ub,
                                           seed=n), lb, ub)


@pytest.mark.parametrize("layers,n", [([2, 100, 100, 100, 100, 2], 51456),
                                      ([2, 32, 32, 2], 600),
                                      # the tiled kernel's edges
                                      ([2, 100, 100, 100, 100, 2], 1),
                                      ([2, 100, 100, 100, 100, 2], 33),
                                      ([2, 30, 30, 2], 1000),
                                      ([2, 100, 2], 1000),
                                      ([2, 128, 128, 2], 4231)])
def test_schrodinger_residual_kernel_matches_plain(layers, n):
    lbs, ubs = np.array([-5.0, 0.0], np.float32), np.array([5.0, np.pi / 2], np.float32)
    params, X = _residual_case(layers, n, lbs, ubs, seed=n)
    n0 = trace.counters()
    got = torch.cat(rs.schrodinger_residual(params, X, lbs, ubs), dim=1)
    again = torch.cat(rs.schrodinger_residual(params, X, lbs, ubs), dim=1)
    want = torch.cat(rs.schrodinger_residual_plain(params, X, lbs, ubs), dim=1)
    torch.cuda.synchronize()
    assert _launched(n0, "schrodinger_residual") == (2,)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-6)
    assert torch.equal(got, again)


def _residual_call(name, params, X):
    if name == "schrodinger_residual":
        return torch.cat(rs.schrodinger_residual(params, X, S_LB, S_UB), dim=1)
    return getattr(rs, name)(params, X, LB, UB, NU)


@pytest.mark.parametrize("n", [33, 6250 * 32 + 7, 1608 * 32 + 7])
@pytest.mark.parametrize("name", ["burgers_residual", "burgers_residual_fmajor",
                                  "schrodinger_residual"])
def test_residual_kernels_leave_nothing_stale(name, n):
    """Two launches on one input, with a launch on another N and net
    between them, are bitwise equal: nothing of one call (a cached
    launch shape, shared memory, a tile past N) leaks into the next.
    N = 33 and the flagships' tile counts plus 7 (the RAR pool's 6,250
    tiles, the Schrödinger grid's 1,608)."""
    schrodinger = name == "schrodinger_residual"
    lb, ub = (S_LB, S_UB) if schrodinger else (LB, UB)
    layers = [2, 100, 100, 100, 100, 2] if schrodinger else [2] + [20] * 8 + [1]
    other = [2, 30, 30, 2] if schrodinger else [2, 7, 33, 64, 1]
    params, X = _residual_case(layers, n, lb, ub, seed=n)
    params2, X2 = _residual_case(other, n // 3 + 5, lb, ub, seed=n + 1)
    first = _residual_call(name, params, X)
    _residual_call(name, params2, X2)
    again = _residual_call(name, params, X)
    torch.cuda.synchronize()
    assert torch.equal(first, again)


def test_residual_wrappers_raise_instead_of_falling_back():
    params, X = _residual_case([2, 8, 1], 40, LB, UB, seed=1)
    with pytest.raises(TypeError, match="float32"):
        rs.burgers_residual([(w.double(), b.double()) for w, b in params],
                            X.double(), LB, UB, NU)
    wide, Xw = _residual_case([2, 65, 1], 40, LB, UB, seed=2)
    with pytest.raises(ValueError, match="widths"):
        rs.burgers_residual_fmajor(wide, Xw, LB, UB, NU)
    with pytest.raises(ValueError, match="widths"):
        rs.burgers_residual(wide, Xw, LB, UB, NU)
    s_wide, Xs = _residual_case([2, 129, 2], 40, S_LB, S_UB, seed=3)
    with pytest.raises(ValueError, match="widths"):
        rs.schrodinger_residual(s_wide, Xs, S_LB, S_UB)


def test_navierstokes_loss_grad_on_card_matches_cpu():
    """The eager Navier–Stokes identification loss (13 streams through
    the campaign's [3, 40x8, 2] net, a separate collocation set) and its
    net and lambda gradients on the card against the same call on the
    CPU, float64 rtol 1e-10; the parameters and gradients stay on the
    card.  No kernel of ours: every launch count stays put."""
    from pinn_torch import params as pcodec
    from pinn_torch.problems import navierstokes as ns

    layers = [3] + [40] * 8 + [2]
    lb, ub = np.zeros(3), np.array([2 * np.pi, 2 * np.pi, 2.0])
    outs = {}
    for dev in ("cuda", "cpu"):
        rng = np.random.RandomState(15)
        pairs = [(rng.randn(a, b) * np.sqrt(2.0 / (a + b)), 0.1 * rng.randn(b))
                 for a, b in zip(layers[:-1], layers[1:])]

        def t(a):
            return torch.as_tensor(a, dtype=torch.float64, device=dev)

        params = ns.NSIdeParams(net=params_from_numpy(pairs, dev, torch.float64),
                                lambda1=t([0.9]), lambda2=t([0.012]))
        X, X_f = (lb + (ub - lb) * rng.rand(n, 3) for n in (2000, 3000))
        u, v = rng.randn(2000, 1), rng.randn(2000, 1)
        leaves = [a.requires_grad_(True) for a in pcodec.leaves(params)]
        n0 = trace.counters()
        loss = ns.loss_identification(params, t(X), t(u), t(v), t(lb), t(ub),
                                      X_f=t(X_f))
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        assert not [k for k in trace.delta(n0, trace.counters())
                    if k.startswith("launch.")]
        if dev == "cuda":
            assert loss.is_cuda and all(a.is_cuda for a in leaves + list(grads))
        outs[dev] = [loss.detach().cpu()] + [g.cpu() for g in grads]
    torch.testing.assert_close(outs["cuda"][0], outs["cpu"][0], rtol=1e-10, atol=0.0)
    gmax = max(float(g.abs().max()) for g in outs["cpu"][1:])
    for a, b in zip(outs["cuda"][1:], outs["cpu"][1:]):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-12 * gmax)
