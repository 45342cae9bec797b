"""The L-BFGS direction's dispatch and argument checks on the CPU
(``pinn_torch.optim.lbfgs._direction``, ``pinn_torch.ops.lbfgs_direction``).
The kernel itself runs only on a card: tests/test_torch_cuda_lbfgs.py.

- ``scan`` on CPU tensors is ``_two_loop``, bit for bit, and launches
  nothing;
- the kernel's cluster size is a function of P, 1 to 16, never smaller
  for a larger P;
- both paths refuse a ring whose layout they do not take
  (``ValueError``), and the kernel's wrapper refuses CPU tensors, types
  it has no instance for and strided vectors;
- the benchmark's reader of ``two_loop_launches_per_iter`` divides the
  program's two counters, and reads nothing where the program has no
  such counter.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pinn_torch.ops import lbfgs_direction as ld
from pinn_torch.optim import lbfgs as lb
from pinn_torch.utils import trace

P = 37


def _ring(m, k, head, dtype=torch.float64, seed=0):
    rng = np.random.RandomState(seed)
    h = rng.uniform(0.5, 2.0, P)
    S, Y = rng.randn(m, P), rng.randn(m, P)
    for j in range(k):
        row = (head - k + j) % m
        Y[row] = h * S[row]
    g, S, Y = (torch.as_tensor(a, dtype=dtype) for a in (rng.randn(P), S, Y))
    return g, S, Y, k, head, torch.tensor(0.7, dtype=dtype), m


CASES = [(m, k, head)
         for m in (10, 50)
         for k in (0, 1, 2, 17, m) if k <= m
         for head in sorted({0, m // 2, max(1, k // 2) % m})]


@pytest.mark.parametrize("m,k,head", CASES)
def test_cpu_scan_direction_is_two_loop(m, k, head):
    ring = _ring(m, k, head, seed=m + k + head)
    before = trace.counters()
    got = lb._direction(lb.LbfgsConfig(dir_impl="scan"), *ring)
    assert "launch.lbfgs_two_loop" not in trace.delta(before, trace.counters())
    assert torch.equal(got, lb._two_loop(*ring))


@pytest.mark.parametrize("ps", [range(1, 4097), range(1, 10**6, 997),
                                [1, 3021, 30802, 30803, 10**6, 10**8]],
                         ids=["small", "dense", "model_sizes"])
def test_cluster_size_rule(ps):
    """A function of P alone (the sweep found no effect of the type),
    within 1 to 16, never smaller for a larger P."""
    sizes = [ld.cluster_size(p) for p in ps]
    assert all(1 <= c <= ld.MAX_CLUSTER for c in sizes)
    assert sizes == sorted(sizes)
    assert ld.cluster_size(1) == 1 and ld.cluster_size(10**8) == ld.MAX_CLUSTER


def _bad(kind):
    g, S, Y, k, head, hdiag, m = _ring(10, 5, 3)
    if kind == "g_2d":
        g = g[None]
    elif kind == "S_shape":
        S = S[:, :-1]
    elif kind == "Y_rows":
        Y = Y[:-1]
    elif kind == "hdiag_shape":
        hdiag = hdiag.reshape(1)
    elif kind == "S_dtype":
        S = S.float()
    elif kind == "hdiag_dtype":
        hdiag = hdiag.float()
    elif kind == "k_over_m":
        k = m + 1
    elif kind == "k_negative":
        k = -1
    elif kind == "head_m":
        head = m
    elif kind == "head_negative":
        head = -1
    return g, S, Y, k, head, hdiag, m


BAD = ["g_2d", "S_shape", "Y_rows", "hdiag_shape", "S_dtype", "hdiag_dtype",
       "k_over_m", "k_negative", "head_m", "head_negative"]


@pytest.mark.parametrize("dir_impl", ["scan", "matrix"])
@pytest.mark.parametrize("kind", BAD)
def test_bad_ring_raises(kind, dir_impl):
    ring = _bad(kind)
    with pytest.raises(ValueError):
        ld.check_args(*ring)
    with pytest.raises(ValueError):
        lb._direction(lb.LbfgsConfig(dir_impl=dir_impl), *ring)


@pytest.mark.parametrize("kind", ["cpu", "float16", "strided_S", "strided_g"])
def test_kernel_wrapper_refuses(kind):
    g, S, Y, k, head, hdiag, m = _ring(10, 5, 3)
    if kind == "float16":
        g, S, Y, hdiag = (a.half() for a in (g, S, Y, hdiag))
    elif kind == "strided_S":
        S = S.t().contiguous().t()
    elif kind == "strided_g":
        g = torch.repeat_interleave(g, 2)[::2]
    before = trace.counters()
    with pytest.raises(ValueError):
        ld.two_loop(g, S, Y, k, head, hdiag, m)
    assert trace.delta(before, trace.counters()) == {}


def _reader_ctx(busy_s):
    return SimpleNamespace(trace=SimpleNamespace(busy_s=busy_s))


@pytest.mark.parametrize("counts,busy_s,want", [
    ({"launch.lbfgs_two_loop": 899, "lbfgs.iters": 900}, 1.0, 899 / 900),
    ({"lbfgs.iters": 900}, 1.0, None),        # a program without the kernel
    ({"launch.lbfgs_two_loop": 899, "lbfgs.iters": 900}, 0.0, None),
])
def test_two_loop_launches_reader(monkeypatch, counts, busy_s, want):
    from portbench.metrics import two_loop_launches_per_iter as reader
    monkeypatch.setattr(trace, "counters", lambda: dict(counts))
    assert reader.read(_reader_ctx(busy_s)) == want
