"""The L-BFGS phase: ``pinn_torch.optim.lbfgs`` (``lbfgs_init``,
``make_lbfgs_run``) on the flat parameters, with the configuration's
``lbfgs`` settings as ``pinn_torch.train.lbfgs_config_from_hp`` reads
them, composed as ``Trainer._lbfgs_phase`` composes it: the iterate in
``nt_vector_dtype`` around a net in its own dtype, gradients through
the loss's autograd, loss-only trials under ``torch.no_grad()``,
chunks of ``Trainer.CHUNK_CAP`` iterations that end on the
``nt_resample`` boundaries, a fresh collocation draw and a new L-BFGS
history at each of them, and a terminated run revived on a fresh draw
unless its draw began at that iteration.  A unit is an iteration."""

from __future__ import annotations

import torch

from pinn_torch import params as pcodec
from pinn_torch.optim import lbfgs as lb
from pinn_torch.train import Trainer, lbfgs_config_from_hp

from portbench import judge

RATES = {   # the end-to-end rates, each from the window's (units, evaluations)
    "lbfgs_iters_per_s": lambda units, evals: units,
    "lbfgs_evals_per_s": lambda units, evals: evals}
REFERENCE = "lbfgs"
NUMBERS = judge.NUMBERS      # the first steps and the state the window left


class Phase:
    def __init__(self, cell):
        self.cell = cell
        hp = cell.config["lbfgs"]
        self.config = lbfgs_config_from_hp(hp)
        flat, self.unravel = pcodec.ravel_with_unravel(cell.params)
        self.net_dtype = flat.dtype
        vec = hp.get("nt_vector_dtype")
        self.vec_dtype = getattr(torch, vec) if vec else flat.dtype
        self.every = int(hp.get("nt_resample") or 0)
        self.batch = cell.batch
        self.state = lb.lbfgs_init(self.opfunc, flat.detach().to(self.vec_dtype),
                                   self.config, self.batch)
        self.run = lb.make_lbfgs_run(self.opfunc, self.config, self.lossfunc)
        self.done = 0
        self.resampled_at = -1
        self.closed = (0, 0)   # iterations and evaluations of past draws

    def opfunc(self, w, batch):
        w_ = w.detach().requires_grad_(True)
        loss = self.cell.loss_fn(self.unravel(w_.to(self.net_dtype)), batch)
        g, = torch.autograd.grad(loss, w_)
        return loss.detach().to(self.vec_dtype), g

    def lossfunc(self, w, batch):
        with torch.no_grad():
            return self.cell.loss_fn(self.unravel(w.to(self.net_dtype)),
                                     batch).to(self.vec_dtype)

    def _leaves(self, flat):
        return [a.double() for a in pcodec.leaves(self.unravel(flat))]

    def check_steps(self, n: int) -> dict:
        x0 = self.state.x
        losses, grad = [float(self.state.f)], None
        for _ in range(n):
            self.state, _ = self.run(self.state, self.batch, 1)
            self.done += 1
            losses.append(float(self.state.f))
            if grad is None:   # the gradient the first iteration stepped on
                grad = self._leaves(self.state.g_old)
        return {"losses": losses, "grad": grad,
                "change": self._leaves(self.state.x - x0)}

    def final(self) -> dict:
        """Where the window left the program: its last iterate (as the
        net's leaves and as ``params``), the loss there and the batch it
        was taken over, and its last direction with the history and
        gradient the direction came from, copied to the host as the
        program's state holds them: the ring rows ``S``, ``Y`` of which
        ``k`` are filled, the oldest at ``(head - k) mod m``."""
        st = self.state

        def host(a):
            return a.detach().to("cpu", copy=True)

        params = self.unravel(st.x.to(self.net_dtype))
        return {"params": params,
                "leaves": [host(a) for a in pcodec.leaves(params)],
                "loss": float(st.f), "batch": self.batch,
                "direction": [host(a) for a in self._leaves(st.d)],
                "history": {"g": host(st.g_old), "S": host(st.S),
                            "Y": host(st.Y), "k": st.k, "head": st.head,
                            "hdiag": float(st.hdiag),
                            "m": self.config.n_correction}}

    def warm(self) -> None:
        self.lossfunc(self.state.x, self.batch)   # the loss-only kernel

    def _refresh(self) -> None:
        st = self.state
        self.closed = (self.closed[0] + st.n_iter, self.closed[1] + st.n_evals)
        self.batch = self.cell.resample(self.done)
        self.state = lb.lbfgs_init(self.opfunc, st.x, self.config, self.batch)
        self.resampled_at = self.done

    def chunk(self):
        if self.state.reason != lb.RUNNING:
            if not self.every or self.done == self.resampled_at:
                return 0, None
            self._refresh()
        elif (self.every and self.done and self.done % self.every == 0
              and self.done != self.resampled_at):
            self._refresh()
        size = Trainer.CHUNK_CAP
        if self.every:
            size = min(size, self.every - self.done % self.every)
        before = self.state.n_iter
        self.state, f_hist = self.run(self.state, self.batch, size)
        self.done += size
        return self.state.n_iter - before, f_hist

    def totals(self):
        return (self.closed[0] + self.state.n_iter,
                self.closed[1] + self.state.n_evals)
