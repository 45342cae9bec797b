"""The port's structure-aware parameter codec and npz checkpoints on
identification parameters (IdeParams: the net's (W, b) pairs with
lambda1 and log_lambda2 at the tail) against the JAX package's, byte for
byte."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinn import params as jax_params
from pinn.models import mlp as jax_mlp
from pinn.problems import burgers as jax_burgers
from pinn.utils import checkpoint as jax_checkpoint
from pinn_torch import params as pcodec
from pinn_torch.problems import burgers
from pinn_torch.utils import checkpoint
from pinn_torch.utils.checkpoint import ide_params_from_numpy, params_from_numpy

torch.set_num_threads(1)

LAYERS = [2, 12, 12, 1]


def _jax_ide(dtype=jnp.float32, seed=0):
    net = jax_mlp.init_mlp(jax.random.PRNGKey(seed), LAYERS, dtype)
    return jax_burgers.IdeParams(net=net, lambda1=jnp.array([0.7], dtype),
                                 log_lambda2=jnp.array([-4.5], dtype))


def _to_torch(jp, dtype=torch.float32):
    return ide_params_from_numpy(
        [(np.asarray(w), np.asarray(b)) for w, b in jp.net],
        np.asarray(jp.lambda1), np.asarray(jp.log_lambda2), "cpu", dtype)


@pytest.mark.parametrize("jdt,tdt", [(jnp.float32, torch.float32),
                                     (jnp.float64, torch.float64)])
def test_ravel_matches_jax_bitwise(jdt, tdt):
    jp = _jax_ide(jdt)
    tp = _to_torch(jp, tdt)
    want = np.asarray(jax_params.ravel(jp))
    got = pcodec.ravel(tp).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert pcodec.num_params(tp) == jax_params.num_params(jp)
    # the coefficients are the last two entries
    np.testing.assert_array_equal(got[-2:], [jp.lambda1[0], jp.log_lambda2[0]])


def test_unravel_round_trips_and_keeps_views():
    tp = _to_torch(_jax_ide())
    flat, unravel = pcodec.ravel_with_unravel(tp)
    back = unravel(flat)
    assert isinstance(back, burgers.IdeParams)
    assert isinstance(back.net, list) and len(back.net) == len(LAYERS) - 1
    for a, b in zip(pcodec.leaves(back), pcodec.leaves(tp)):
        assert a.shape == b.shape
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    # the leaves are views: autograd reaches the flat vector
    x = flat.clone().requires_grad_(True)
    p = unravel(x)
    (p.lambda1.sum() * 3.0 + p.net[0][0].sum()).backward()
    assert float(x.grad[-2]) == 3.0 and float(x.grad[-1]) == 0.0
    n0 = LAYERS[0] * LAYERS[1]
    torch.testing.assert_close(x.grad[:n0], torch.ones(n0))


def test_pairs_layout_unchanged():
    """A (W, b) list keeps the flat order W0, b0, W1, b1, ..."""
    jp = jax_mlp.init_mlp(jax.random.PRNGKey(3), LAYERS, jnp.float64)
    tp = params_from_numpy([(np.asarray(w), np.asarray(b)) for w, b in jp],
                           "cpu", torch.float64)
    np.testing.assert_array_equal(pcodec.ravel(tp).numpy(),
                                  np.asarray(jax_params.ravel(jp)))
    back = pcodec.make_unravel(tp)(pcodec.ravel(tp))
    assert isinstance(back, list) and all(isinstance(p, tuple) for p in back)
    assert pcodec.paths(tp)[:2] == ["[0][0]", "[0][1]"]
    assert pcodec.paths(_to_torch(_jax_ide()))[-2:] == [".lambda1",
                                                       ".log_lambda2"]


def test_jax_saved_ide_checkpoint_loads_in_port(tmp_path):
    jp = _jax_ide(jnp.float32, seed=1)
    path = str(tmp_path / "jax.npz")
    jax_checkpoint.save_npz(path, jp, hp={"N_u": 5})
    like = burgers.init_ide_params(
        params_from_numpy([(np.zeros((a, b)), np.zeros(b))
                           for a, b in zip(LAYERS[:-1], LAYERS[1:])],
                          "cpu", torch.float64))
    got, meta = checkpoint.load_npz(path, like=like)
    assert isinstance(got, burgers.IdeParams) and meta["hp"] == {"N_u": 5}
    assert all(a.dtype == torch.float64 for a in pcodec.leaves(got))
    want = jax.tree_util.tree_leaves(jp)
    for a, b in zip(pcodec.leaves(got), want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b, np.float64))


def test_port_saved_ide_checkpoint_loads_in_jax(tmp_path):
    tp = _to_torch(_jax_ide(jnp.float32, seed=2))
    path = str(tmp_path / "port.npz")
    checkpoint.save_npz(path, tp)
    like = _jax_ide(jnp.float32, seed=9)
    got, _ = jax_checkpoint.load_npz(path, like=like)
    assert isinstance(got, jax_burgers.IdeParams)
    for a, b in zip(jax.tree_util.tree_leaves(got), pcodec.leaves(tp)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_load_rejects_wrong_size(tmp_path):
    path = str(tmp_path / "p.npz")
    checkpoint.save_npz(path, _to_torch(_jax_ide()).net)
    with pytest.raises(ValueError, match="parameters"):
        checkpoint.load_npz(path, like=_to_torch(_jax_ide()))
