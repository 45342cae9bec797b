"""The port's fused Burgers loss (pinn_torch.ops.fused_train) against the
JAX package's fused loss (pinn.ops.pallas_train, interpret mode).

On the CPU the port's wrapper takes the kernel's plain PyTorch version
through the same host-side prep and reassembly as the CUDA kernel, so
these tests check everything but the kernel body.  float32 bars are
those of tests/test_pallas_train.py: loss rtol 1e-5, gradients rtol
5e-4 with atol 5e-6 * max|g| (float32 summed in another order on each
side).  bf16-stream bars (both sides round at the same points, so only
the summation order differs, and it can move a rounding): against the
JAX bf16 kernel, loss rtol 2e-3, gradient rel-L2 <= 1e-2 and cosine >=
0.9999; against the float32 result, the reference's own bar
(tests/test_pallas_train.py:137-165): loss rtol 3e-2, cosine > 0.999,
norm ratio within 5%.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinn.models import mlp as jax_mlp
from pinn.ops import pallas_train
from pinn.utils import checkpoint as jax_checkpoint
from pinn_torch.data import burgers_cont_inference
from pinn_torch.models import mlp
from pinn_torch.ops import fused_schrodinger, fused_train
from pinn_torch.utils import checkpoint
from pinn_torch.utils.checkpoint import params_from_numpy

torch.set_num_threads(1)

NU = 0.01 / np.pi
LB = np.array([-1.0, 0.0], np.float32)
UB = np.array([1.0, 1.0], np.float32)


def _glorot(layers, rng):
    return [(rng.randn(a, b) * np.sqrt(2.0 / (a + b)), np.zeros(b))
            for a, b in zip(layers[:-1], layers[1:])]


def _case(layers, n_u, n_f, seed=0):
    rng = np.random.RandomState(seed)
    pairs = [(w.astype(np.float32), (0.1 * rng.randn(*b.shape)).astype(np.float32))
             for w, b in _glorot(layers, rng)]
    batch = {"X_u": LB + (UB - LB) * rng.rand(n_u, 2),
             "u": rng.rand(n_u, 1),
             "X_f": LB + (UB - LB) * rng.rand(n_f, 2)}
    batch = {k: v.astype(np.float32) for k, v in batch.items()}
    return pairs, batch


def _jax_value_and_grad(pairs, batch, stream_dtype=None):
    loss = pallas_train.make_burgers_loss(LB, UB, NU, interpret=True,
                                          stream_dtype=stream_dtype)
    params = tuple((jnp.asarray(w), jnp.asarray(b)) for w, b in pairs)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    val, grads = jax.value_and_grad(loss)(params, jb)
    return float(val), [np.asarray(a) for wb in grads for a in wb]


def _torch_batch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _torch_value_and_grad(pairs, batch, stream_dtype=None):
    params = params_from_numpy(pairs, "cpu", torch.float32)
    leaves = [a.requires_grad_(True) for wb in params for a in wb]
    val = fused_train.make_burgers_loss(LB, UB, NU, stream_dtype)(
        params, _torch_batch(batch))
    grads = torch.autograd.grad(val, leaves)
    return float(val.detach()), [g.numpy() for g in grads]


def assert_bf16_parity(val, grads, want_val, want_grads, val32, grads32):
    """The bf16 bars of the module docstring: (val, grads) against the
    JAX bf16 kernel's (want_*) and against the float32 result (*32)."""
    g, w, o = (np.concatenate([np.ravel(a) for a in x])
               for x in (grads, want_grads, grads32))
    np.testing.assert_allclose(val, want_val, rtol=2e-3)
    assert np.linalg.norm(g - w) <= 1e-2 * np.linalg.norm(w)
    assert g @ w >= 0.9999 * np.linalg.norm(g) * np.linalg.norm(w)
    np.testing.assert_allclose(val, val32, rtol=3e-2)
    assert g @ o > 0.999 * np.linalg.norm(g) * np.linalg.norm(o)
    assert abs(np.linalg.norm(g) / np.linalg.norm(o) - 1) < 0.05


CASES = [
    ([2, 20, 20, 20, 1], 32, 300),   # ragged edge
    ([2, 16, 1], 7, 1017),           # one hidden layer, data+collocation straddle a tile
    ([2, 40, 40, 1], 16, 256),       # width 40
]


@pytest.mark.parametrize("layers,n_u,n_f", CASES)
def test_fused_loss_and_grad_match_jax(layers, n_u, n_f):
    pairs, batch = _case(layers, n_u, n_f)
    want_val, want_grads = _jax_value_and_grad(pairs, batch)

    params = params_from_numpy(pairs, "cpu", torch.float32)
    for w, b in params:
        w.requires_grad_(True)
        b.requires_grad_(True)
    loss = fused_train.make_burgers_loss(LB, UB, NU)
    val = loss(params, _torch_batch(batch))
    grads = torch.autograd.grad(val, [a for wb in params for a in wb])

    np.testing.assert_allclose(float(val.detach()), want_val, rtol=1e-5)
    for g, want in zip(grads, want_grads):
        scale = max(1e-3, float(np.max(np.abs(want))))
        np.testing.assert_allclose(g.numpy(), want, rtol=5e-4,
                                   atol=5e-6 * scale)


# The shapes at which the narrow loss-only kernel cuts its work, as
# (layers, N_u, N_f, stream_dtype): a tile and one point; hidden widths
# that are not multiples of 4 and the widest layer; the most hidden
# layers; bf16 streams at N = 1,031, two JAX tiles (one fails on XLA's
# CPU backend).
LOSS_ONLY_EDGES = [
    ([2] + [20] * 8 + [1], 3, 30, None),
    ([2, 7, 33, 64, 1], 9, 100, None),
    ([2] + [20] * 15 + [1], 5, 60, None),
    ([2, 7, 33, 64, 1], 31, 1000, "bfloat16"),
]


@pytest.mark.parametrize("layers,n_u,n_f,stream_dtype",
                         [c + (None,) for c in CASES] + LOSS_ONLY_EDGES)
def test_loss_only_branch_matches(layers, n_u, n_f, stream_dtype):
    """Under no_grad the wrapper takes the loss-only path; its value
    equals the loss+grad path's and the JAX primal's (float32 rtol
    1e-5; bf16 streams the module's 2e-3)."""
    pairs, batch = _case(layers, n_u, n_f, seed=1)
    params = params_from_numpy(pairs, "cpu", torch.float32)
    tb = _torch_batch(batch)
    loss = fused_train.make_burgers_loss(LB, UB, NU, stream_dtype)
    with torch.no_grad():
        v_nograd = float(loss(params, tb))
    grad_params = [(w.clone().requires_grad_(True), b.clone().requires_grad_(True))
                   for w, b in params]
    v_grad = float(loss(grad_params, tb).detach())
    np.testing.assert_allclose(v_nograd, v_grad, rtol=1e-6)

    jloss = pallas_train.make_burgers_loss(LB, UB, NU, interpret=True,
                                           stream_dtype=stream_dtype)
    jp = tuple((jnp.asarray(w), jnp.asarray(b)) for w, b in pairs)
    want = float(jloss(jp, {k: jnp.asarray(v) for k, v in batch.items()}))
    np.testing.assert_allclose(v_nograd, want,
                               rtol=1e-5 if stream_dtype is None else 2e-3)


def test_backward_scales_by_grad_output():
    """backward is the stashed gradient times grad_output."""
    pairs, batch = _case([2, 8, 8, 1], 5, 40, seed=2)
    params = params_from_numpy(pairs, "cpu", torch.float32)
    for w, b in params:
        w.requires_grad_(True)
        b.requires_grad_(True)
    leaves = [a for wb in params for a in wb]
    loss = fused_train.make_burgers_loss(LB, UB, NU)
    tb = _torch_batch(batch)
    g1 = torch.autograd.grad(loss(params, tb), leaves)
    g3 = torch.autograd.grad(3.0 * loss(params, tb), leaves)
    for a, b in zip(g1, g3):
        torch.testing.assert_close(3.0 * a, b, rtol=1e-6, atol=0.0)


def test_plain_version_matches_eager_loss_in_float64():
    """The kernel's plain version, run through prep and reassembly in
    float64, is the eager loss_cont_inference and its autograd."""
    from pinn_torch.problems import burgers

    pairs, batch = _case([2, 12, 12, 1], 9, 70, seed=3)
    params = params_from_numpy(pairs, "cpu", torch.float64)
    tb = {k: torch.as_tensor(v, dtype=torch.float64) for k, v in batch.items()}
    lb, ub = (torch.as_tensor(a, dtype=torch.float64) for a in (LB, UB))
    a0, aux = fused_train._prep_points(tb, lb, ub)
    scale = 2.0 / (ub - lb)
    vx = torch.stack([scale[0], torch.zeros((), dtype=torch.float64)])
    vt = torch.stack([torch.zeros((), dtype=torch.float64), scale[1]])
    z1row, z2row, wt_args = fused_train._prep(params, vx, vt)
    val, gwt, gz1, gz2 = fused_train.burgers_loss_grad_plain(
        a0, aux, z1row, z2row, wt_args, NU)
    grads = fused_train._assemble_net_grads(params, gwt, gz1, gz2, vx, vt)

    leaves = [a.clone().requires_grad_(True) for wb in params for a in wb]
    pp = [(leaves[i], leaves[i + 1]) for i in range(0, len(leaves), 2)]
    want = burgers.loss_cont_inference(pp, tb["X_u"], tb["u"], tb["X_f"],
                                       lb, ub, NU)
    want_grads = torch.autograd.grad(want, leaves)
    torch.testing.assert_close(val, want.detach(), rtol=1e-12, atol=0.0)
    for g, w in zip(grads, want_grads):
        torch.testing.assert_close(g, w, rtol=1e-10, atol=1e-14)


def test_kernel_input_checks():
    """The checks the CUDA launch runs before it touches the card."""
    pairs, batch = _case([2, 8, 1], 3, 10, seed=4)
    params = params_from_numpy(pairs, "cpu", torch.float32)
    lb, ub = torch.as_tensor(LB), torch.as_tensor(UB)
    a0, aux = fused_train._prep_points(_torch_batch(batch), lb, ub)
    vx = torch.tensor([1.0, 0.0])
    vt = torch.tensor([0.0, 2.0])
    z1row, z2row, wt_args = fused_train._prep(params, vx, vt)
    fused_train._check_inputs(a0, aux, z1row, z2row, wt_args)
    with pytest.raises(TypeError, match="float32"):
        fused_train._check_inputs(a0.double(), aux, z1row, z2row, wt_args)
    with pytest.raises(ValueError, match="aux"):
        fused_train._check_inputs(a0, aux[:, 1:], z1row, z2row, wt_args)
    with pytest.raises(ValueError, match="contiguous"):
        fused_train._check_inputs(a0.t().contiguous().t(), aux, z1row,
                                  z2row, wt_args)
    # float32 and bf16 streams take the same float32 inputs; other
    # stream types are refused.
    assert [fused_train._check_stream_dtype(d) for d in
            (None, "float32", "bfloat16", "bf16")] == [False, False, True, True]
    with pytest.raises(ValueError, match="float16"):
        fused_train.make_burgers_loss(LB, UB, NU, stream_dtype="float16")


@pytest.mark.parametrize("n", [1, 33, 10100, 1000100])
@pytest.mark.parametrize("layers,bf16,want", [
    ([2] + [20] * 8 + [1], False, fused_train.RB_ENTRY),
    ([2, 20, 1], False, fused_train.RB_ENTRY),
    ([2] + [20] * 15 + [1], False, fused_train.RB_ENTRY),
    ([2] + [20] * 8 + [1], True, "burgers_loss_grad_bf16"),
    ([2, 20, 20, 32, 1], False, "burgers_loss_grad"),
    ([2, 16, 16, 1], False, "burgers_loss_grad"),
])
def test_loss_grad_entry_by_shape(layers, bf16, want, n):
    """The C entry that burgers_loss_grad launches: the register-blocked
    one for float32 streams where every hidden layer has width 20,
    whatever the point count; the narrow kernel's entry otherwise."""
    a0 = torch.empty((2, n))
    wt_args = [t for a, b in zip(layers[:-1], layers[1:])
               for t in (torch.empty(b, a), torch.empty(b, 1))]
    assert fused_train.loss_grad_entry(a0, wt_args, bf16) == want


@pytest.mark.parametrize("name,n_in,want", [
    ("burgers_loss_grad", 7, True),
    ("burgers_loss_grad_bf16", 7, True),
    (fused_train.RB_ENTRY, 7, False),
    ("burgers_ide_loss_grad", 7, True),
    ("burgers_sse_grad", 6, True),
    ("schrodinger_sse_grad", 5, True),
])
def test_workspace_from_signature(name, n_in, want):
    """launch gives an entry a workspace where its C signature has one
    more pointer than a0 to the scalars, partials, out and stream."""
    assert fused_train._takes_ws(name, n_in) is want


def test_bf16_streams_match_jax():
    """bf16 streams at the shape of tests/test_pallas_train.py's bf16
    test: the plain bf16 version (the explicit backward, rounded where
    the TPU kernel rounds) against the JAX kernel in interpret mode; the
    loss-only branch gives the loss+grad branch's value."""
    pairs, batch = _case([2, 20, 20, 20, 20, 1], 64, 1024, seed=5)
    want_val, want_grads = _jax_value_and_grad(pairs, batch, "bfloat16")
    val, grads = _torch_value_and_grad(pairs, batch, "bfloat16")
    val32, grads32 = _torch_value_and_grad(pairs, batch)
    assert_bf16_parity(val, grads, want_val, want_grads, val32, grads32)
    with torch.no_grad():
        v_only = fused_train.make_burgers_loss(LB, UB, NU, "bfloat16")(
            params_from_numpy(pairs, "cpu", torch.float32),
            _torch_batch(batch))
    np.testing.assert_allclose(float(v_only), val, rtol=1e-6)


@pytest.mark.parametrize("stream_dtype,n_u,n_f", [
    (None, 3, 30),          # N = 33: a tile and one point
    ("bfloat16", 31, 1000),  # N = 1,031: two TPU tiles (XLA CPU and bf16)
])
def test_edge_widths_match_jax(stream_dtype, n_u, n_f):
    """[2, 7, 33, 64, 1]: hidden widths that are not multiples of 4 and
    the widest the CUDA kernels take, as in their card tests.  The plain
    version (float32 autograd, or the explicit bf16 backward) against
    the JAX kernel in interpret mode, at the module's bars."""
    pairs, batch = _case([2, 7, 33, 64, 1], n_u, n_f, seed=7)
    want_val, want_grads = _jax_value_and_grad(pairs, batch, stream_dtype)
    val, grads = _torch_value_and_grad(pairs, batch, stream_dtype)
    if stream_dtype is None:
        np.testing.assert_allclose(val, want_val, rtol=1e-5)
        for g, want in zip(grads, want_grads):
            scale = max(1e-3, float(np.max(np.abs(want))))
            np.testing.assert_allclose(g, want, rtol=5e-4, atol=5e-6 * scale)
    else:
        val32, grads32 = _torch_value_and_grad(pairs, batch)
        assert_bf16_parity(val, grads, want_val, want_grads, val32, grads32)


def _explicit_case(head):
    """(autograd plain version, the explicit backward without rounding,
    their inputs) of one kernel head, float32 on the CPU."""
    rng = np.random.RandomState(6)
    lb, ub = torch.as_tensor(LB), torch.as_tensor(UB)
    if head == "schrodinger":
        pairs = [(rng.randn(a, b) * np.sqrt(2.0 / (a + b)), 0.1 * rng.randn(b))
                 for a, b in zip([2, 32, 32], [32, 32, 2])]
        X = torch.as_tensor(LB + (UB - LB) * rng.rand(300, 2), dtype=torch.float32)
        _, _, vx, vt = fused_train._tangents(LB, UB, "cpu")
        params = params_from_numpy(pairs, "cpu", torch.float32)
        args = (fused_train._normalise(X, lb, ub),
                *fused_train._prep(params, vx, vt))
        return (fused_schrodinger.schrodinger_sse_grad_plain,
                lambda *a: fused_train.explicit_loss_grad(
                    fused_schrodinger._head, *a, rounded_bias=False), args)
    pairs, batch = _case([2, 20, 20, 20, 1], 32, 300, seed=6)
    params = params_from_numpy(pairs, "cpu", torch.float32)
    _, _, vx, vt = fused_train._tangents(LB, UB, "cpu")
    rest = fused_train._prep(params, vx, vt)
    if head == "inference":
        a0, aux = fused_train._prep_points(_torch_batch(batch), lb, ub)
        return (lambda *a: fused_train.burgers_loss_grad_plain(a0, aux, *a, NU),
                lambda *a: fused_train.explicit_loss_grad(
                    fused_train._burgers_head(aux, NU), a0, *a),
                rest)
    a0, aux = fused_train._prep_ide_points(_torch_batch(batch), lb, ub)
    lam = fused_train._lam(torch.tensor([1.3]), torch.tensor([-4.0]))
    return (lambda *a: fused_train.burgers_ide_loss_grad_plain(a0, aux, lam, *a),
            lambda *a: fused_train.explicit_loss_grad(
                fused_train._burgers_ide_head(aux, lam), a0, *a),
            rest)


@pytest.mark.parametrize("head", ["inference", "identification", "schrodinger"])
def test_explicit_backward_matches_autograd(head):
    """The explicit backward that the bf16 plain versions run, with no
    rounding, is the autograd plain version (float32 bars)."""
    plain, explicit, args = _explicit_case(head)
    want, got = plain(*args), explicit(*args)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=0.0)
    flat_g = [g for part in got[1:] for g in (part if isinstance(part, list) else [part])]
    flat_w = [w for part in want[1:] for w in (part if isinstance(part, list) else [part])]
    assert len(flat_g) == len(flat_w)
    gmax = max(float(w.abs().max()) for w in flat_w)
    for g, w in zip(flat_g, flat_w):
        torch.testing.assert_close(g, w, rtol=5e-4, atol=5e-6 * gmax)


FLAGSHIP = [2] + [20] * 8 + [1]


@pytest.mark.parametrize("stream_dtype,step0_loss", [
    ("bfloat16", 3.8662e-1),
    (None, 3.8490e-1),
])
def test_flagship_step0_loss_fingerprint(stream_dtype, step0_loss, tmp_path):
    """The Burgers flagship's seed-1234 init and data, built as the JAX
    experiment builds them (experiments/inf_cont_burgers.py:49-72) and
    carried over through the npz codec: the fused loss at step 0 is the
    basin fingerprint recorded on the TPU for each stream type
    (experiments/df32_ab.py:50-52), within rtol 2e-4."""
    path = str(tmp_path / "init.npz")
    jax_checkpoint.save_npz(path, jax_mlp.init_mlp(jax.random.PRNGKey(1234),
                                                   FLAGSHIP, jnp.float32))
    params, _ = checkpoint.load_npz(path, like=mlp.init_mlp(
        FLAGSHIP, torch.Generator().manual_seed(0), torch.float32, "cpu"))
    np.random.seed(1234)
    data = burgers_cont_inference(100, 10000)
    batch = {"X_u": data.X_u_train, "u": data.u_train, "X_f": data.X_f}
    batch = {k: torch.as_tensor(v, dtype=torch.float32) for k, v in batch.items()}
    leaves = [a.requires_grad_(True) for wb in params for a in wb]
    loss = fused_train.make_burgers_loss(data.lb, data.ub, 0.01 / np.pi,
                                         stream_dtype)(params, batch)
    torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), step0_loss, rtol=2e-4)


# ---------------------------------------------------------------------------
# The v1 residual SSE (make_burgers_sse)
# ---------------------------------------------------------------------------

SSE_CASES = [
    ([2, 20, 20, 20, 1], 300),       # ragged: the TPU kernel's pad mask
    (FLAGSHIP, 2048),                # flagship depth
    ([2, 16, 1], 1024),              # single hidden layer
    # The edges of the narrow kernels (32-point tiles):
    (FLAGSHIP, 1),                   # one point, 31 masked
    (FLAGSHIP, 33),                  # a tile and one point
    ([2, 7, 33, 64, 1], 33),         # widths off 4, the widest layer
    ([2] + [20] * 15 + [1], 64),     # the most hidden layers
]


def _sse_case(layers, n, seed=0):
    rng = np.random.RandomState(seed)
    pairs = [(w.astype(np.float32), (0.1 * rng.randn(*b.shape)).astype(np.float32))
             for w, b in _glorot(layers, rng)]
    return pairs, (LB + (UB - LB) * rng.rand(n, 2)).astype(np.float32)


@pytest.mark.parametrize("layers,n", SSE_CASES)
def test_fused_sse_matches_jax(layers, n):
    """make_burgers_sse's value and gradients against the JAX v1 pair
    (tests/test_pallas_train.py:34-62 shapes and bars)."""
    pairs, X_f = _sse_case(layers, n, seed=n)
    jsse = pallas_train.make_burgers_sse(LB, UB, NU, interpret=True)
    jp = tuple((jnp.asarray(w), jnp.asarray(b)) for w, b in pairs)
    want_val, want_grads = jax.value_and_grad(lambda p: jsse(p, jnp.asarray(X_f)))(jp)

    params = params_from_numpy(pairs, "cpu", torch.float32)
    leaves = [a.requires_grad_(True) for wb in params for a in wb]
    val = fused_train.make_burgers_sse(LB, UB, NU)(params, torch.as_tensor(X_f))
    grads = torch.autograd.grad(val, leaves)

    np.testing.assert_allclose(float(val.detach()), float(want_val), rtol=1e-5)
    for g, want in zip(grads, [np.asarray(a) for wb in want_grads for a in wb]):
        scale = max(1e-3, float(np.max(np.abs(want))))
        np.testing.assert_allclose(g.numpy(), want, rtol=5e-4, atol=5e-6 * scale)


def test_fused_sse_is_the_eager_residual_sum_and_scales_by_grad_output():
    """In float64 the plain pair, through prep and reassembly, is the sum
    of the eager residual squared and its autograd; the backward is the
    pair's gradient times grad_output; the no-grad branch gives the same
    value; the points get no gradient."""
    from pinn_torch.problems import burgers

    pairs, X_f = _sse_case([2, 12, 12, 1], 70, seed=3)
    params = params_from_numpy(pairs, "cpu", torch.float64)
    X = torch.as_tensor(X_f, dtype=torch.float64)
    lb, ub = (torch.as_tensor(a, dtype=torch.float64) for a in (LB, UB))
    scale = 2.0 / (ub - lb)
    zero = torch.zeros((), dtype=torch.float64)
    vx, vt = torch.stack([scale[0], zero]), torch.stack([zero, scale[1]])
    z1row, z2row, wt_args = fused_train._prep(params, vx, vt)
    val, gwt, gz1, gz2 = fused_train.burgers_sse_grad_plain(
        fused_train._normalise(X, lb, ub), z1row, z2row, wt_args, NU)
    grads = fused_train._assemble_net_grads(params, gwt, gz1, gz2, vx, vt)
    leaves = [a.clone().requires_grad_(True) for wb in params for a in wb]
    pp = [(leaves[i], leaves[i + 1]) for i in range(0, len(leaves), 2)]
    want = torch.sum(burgers.residual_cont(pp, X, lb, ub, nu=NU) ** 2)
    want_grads = torch.autograd.grad(want, leaves)
    torch.testing.assert_close(val, want.detach(), rtol=1e-12, atol=0.0)
    for g, w in zip(grads, want_grads):
        torch.testing.assert_close(g, w, rtol=1e-10, atol=1e-12)

    p32 = params_from_numpy(pairs, "cpu", torch.float32)
    leaves32 = [a.requires_grad_(True) for wb in p32 for a in wb]
    X32 = torch.as_tensor(X_f).requires_grad_(True)
    sse = fused_train.make_burgers_sse(LB, UB, NU)
    g1 = torch.autograd.grad(sse(p32, X32), leaves32 + [X32], allow_unused=True)
    g3 = torch.autograd.grad(3.0 * sse(p32, X32), leaves32)
    assert g1[-1] is None
    for a, b in zip(g1[:-1], g3):
        torch.testing.assert_close(3.0 * a, b, rtol=1e-6, atol=0.0)
    with torch.no_grad():
        v_only = sse(p32, torch.as_tensor(X_f))
    np.testing.assert_allclose(float(v_only), float(sse(p32, X32).detach()),
                               rtol=1e-6)
