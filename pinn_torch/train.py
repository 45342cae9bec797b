"""Trainer: Adam warmup then L-BFGS.

Counterpart of ``pinn/train.py``'s ``Trainer``: Adam for ``tf_epochs``
then the repo's L-BFGS for ``nt_epochs`` over the flat parameter
vector, logger lines every ``log_frequency`` epochs, collocation
resampling (``tf_resample``/``nt_resample``, which also resets the
L-BFGS history), best-iterate selection on a held-out metric
(``nt_val_every``), periodic atomic checkpoints (``save_every``) and
the mixed-precision mode ``nt_vector_dtype="float64"``: a float64
iterate and L-BFGS algebra around a network (and fused kernel) that
runs in float32.  Parameters may be any structure the codec takes
(``pinn_torch.params``): ``(W, b)`` pairs or ``IdeParams``.
``epoch_extra(params) -> str`` is appended to each epoch log line (the
logger's ``custom`` field) and to the end line.  ``adam_loss_fn``, when
given, is the loss the Adam phase optimises (a cheaper warmup loss,
such as the bf16-stream fused kernel); L-BFGS always refines on
``loss_fn``.  The Adam phase runs on ``pinn_torch.optim.AdamRunner``,
as the JAX Trainer's does, in chunks of at most ``CHUNK_CAP`` steps
that end on the log, resample and save boundaries; hp["tf_net_dtype"]
wraps its loss in ``pinn_torch.optim.adam.net_dtype_cast``.
``params_callback(params)``, when given, is called with the current
parameters right before every log line and at the end (the facade
keeps its ``params`` live with it).

PyTorch runs eagerly, so both phases step one iteration at a time.
Both keep the JAX Trainer's chunk boundaries (at most
``CHUNK_CAP`` iterations between host checks): they are where the loop
logs, resamples, probes and revives a stalled run, so keeping them
keeps the trajectory, and the resampling draws, equal to the JAX
package's.

hp["trace_dir"] wraps ``fit`` (the start log, both phases and the
L-BFGS stop line) in ``torch.profiler.profile``, as the JAX Trainer
wraps it in ``jax.profiler.trace``: the CPU always, and CUDA when the
parameters are on the card.  One Chrome-trace JSON lands in the
directory (``<host>_<pid>.<ns>.pt.trace.json``, which Perfetto and
TensorBoard's profile plugin open); the run's numbers are those without
it.  Beside PyTorch's own events the trace holds the port's spans
(``pinn_torch.utils.trace``; they exist only while a profiler runs), so
each idle gap of the device can be put down to a layer:

- ``pinn_torch.trainer.boundary``: the host work between two chunks of
  either phase (the log line and its loss read, resampling, saves, the
  validation probe, a revived L-BFGS run);
- ``pinn_torch.adam.step``: one Adam step (zero_grad, loss, backward,
  update), with ``pinn_torch.adam.update`` around ``torch.optim.Adam``'s
  per-leaf update;
- ``pinn_torch.lbfgs.init``: a history's first evaluation;
  ``pinn_torch.lbfgs.step``: one iteration, with
  ``pinn_torch.lbfgs.memory`` (the curvature guard and the ring write),
  ``pinn_torch.lbfgs.direction`` (the two-loop), ``pinn_torch.lbfgs.search``
  (the step rule and its loss calls) and ``pinn_torch.lbfgs.checks``
  (the convergence tests) inside;
- ``pinn_torch.loss``: one call of a fused loss (``pinn_torch.ops``),
  with ``pinn_torch.loss.ic_bc`` (Schrödinger's eager initial and
  boundary terms), ``pinn_torch.loss.prep`` (points, weights, checks,
  buffers), ``pinn_torch.loss.launch`` (the kernel's C call) and
  ``pinn_torch.loss.assemble`` (the gradients' reassembly) inside.

A loss's backward runs outside ``pinn_torch.loss``: under
``pinn_torch.adam.step`` in Adam, under ``pinn_torch.lbfgs.search`` or
``pinn_torch.lbfgs.init`` in L-BFGS.

``mesh`` (a ``pinn_torch.parallel`` mesh), as the JAX Trainer's: the
parameters and the batch are placed on the mesh's first device, and
again after every resampling.  The loss does the sharding itself
(``pinn_torch.parallel.data_parallel`` and the fused ``*_loss_dp``
wrappers), where GSPMD does it for the JAX Trainer.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from pinn_torch import params as pcodec
from pinn_torch.optim import lbfgs as lb
from pinn_torch.optim.adam import AdamRunner
from pinn_torch.utils import checkpoint, trace
from pinn_torch.utils.logger import Logger

def lbfgs_config_from_hp(hp: dict) -> lb.LbfgsConfig:
    return lb.LbfgsConfig(
        learning_rate=hp.get("nt_lr", 0.8),
        max_iter=hp.get("nt_epochs", 0),
        n_correction=hp.get("nt_ncorr", 50),
        tol_fun=float(np.finfo(np.float64).eps),
        line_search=hp.get("nt_line_search", "none"),
        dir_impl=hp.get("nt_dir_impl", "scan"),
        restart=hp.get("nt_restart",
                       hp.get("nt_line_search", "none") != "none"),
    )


def _detached(params):
    return pcodec.tree_map(torch.Tensor.detach, params)


class Trainer:
    """Drives ``loss_fn(params, batch) -> scalar`` through both phases.

    ``params0`` is a parameter structure (``(W, b)`` pairs,
    ``IdeParams``, dicts); ``batch`` a dict of tensors.
    ``epoch_extra(params) -> str``, ``resample_fn(round) -> batch``,
    ``val_fn(params) -> float``, ``adam_loss_fn(params, batch)`` and
    ``params_callback(params)`` are optional, as in the JAX Trainer.
    """

    CHUNK_CAP = 10  # iterations between host checks in each phase

    def __init__(self, loss_fn: Callable[[Any, Any], torch.Tensor], params0,
                 batch: Any, hp: dict, logger: Optional[Logger] = None,
                 epoch_extra: Optional[Callable[[Any], str]] = None,
                 resample_fn: Optional[Callable[[int], Any]] = None,
                 val_fn: Optional[Callable[[Any], float]] = None,
                 adam_loss_fn: Optional[Callable[[Any, Any],
                                                 torch.Tensor]] = None,
                 params_callback: Optional[Callable[[Any], None]] = None,
                 mesh=None):
        self.mesh = mesh
        if mesh is not None:
            params0 = pcodec.tree_map(lambda a: a.to(mesh.devices[0]), params0)
            batch = self._place(batch)
        self.loss_fn = loss_fn
        self.epoch_extra = epoch_extra
        self.params_callback = params_callback
        self.val_fn = val_fn
        self.resample_fn = resample_fn
        self.batch = batch
        self.params = _detached(params0)
        self.hp = hp
        self.logger = logger
        self.tf_epochs = hp.get("tf_epochs", 0)
        self.nt_config = lbfgs_config_from_hp(hp)
        self.frequency = hp.get("log_frequency", 10)
        self.save_every = int(hp.get("save_every", 0) or 0)
        self.save_path = hp.get("save_checkpoint")
        if self.save_every and not self.save_path:
            raise ValueError("hp['save_every'] requires hp['save_checkpoint'] "
                             "(the path periodic saves write to)")
        # Wall-clock seconds and step counts of each phase (host clock
        # around work that ends in a device synchronisation).
        # lbfgs_evals counts the loss evaluations of the L-BFGS phase,
        # with and without gradients (initial ones included).
        self.timing = {"adam_s": 0.0, "lbfgs_s": 0.0, "lbfgs_iters": 0,
                       "lbfgs_evals": 0}
        # The Adam phase (its loss_fn wraps hp["tf_net_dtype"]'s cast).
        self.adam = (AdamRunner(adam_loss_fn or loss_fn, hp)
                     if self.tf_epochs > 0 else None)

    # -- logging helpers ---------------------------------------------------
    def _log(self, method: str, *args, **kw):
        if self.params_callback is not None:
            self.params_callback(self.params)
        if self.logger is not None:
            getattr(self.logger, method)(*args, **kw)

    def _extra(self) -> str:
        return self.epoch_extra(self.params) if self.epoch_extra else ""

    def summary(self) -> str:
        """Parameter-shape report (hp["model_description"])."""
        lines = [f"  {name}: {tuple(a.shape)} "
                 f"{str(a.dtype).replace('torch.', '')}"
                 for name, a in zip(pcodec.paths(self.params),
                                    pcodec.leaves(self.params))]
        lines.append(f"  total parameters: {pcodec.num_params(self.params)}")
        return "\n".join(lines)

    def _maybe_save(self, phase: str, phase_done: int) -> None:
        if not (self.save_every and phase_done % self.save_every == 0
                and phase_done):
            return
        epoch = phase_done + (self.tf_epochs if phase == "lbfgs" else 0)
        checkpoint.save_npz_atomic(
            self.save_path, self.params,
            extra={"phase": phase, "epoch": int(epoch),
                   "phase_epoch": int(phase_done)})

    def _place(self, batch):
        """``batch`` on the mesh's first device (as it is without a mesh)."""
        if self.mesh is None:
            return batch
        return {k: v.to(self.mesh.devices[0]) for k, v in batch.items()}

    def _resample(self, round_idx: int) -> None:
        self.batch = self._place(self.resample_fn(round_idx))

    # -- phases ------------------------------------------------------------
    def _adam_phase(self):
        self._log("log_train_opt", "Adam")
        state = self.adam.init(self.params)
        device = state.leaves[0].device
        every = self.hp.get("tf_resample", 0) if self.resample_fn else 0
        done = 0
        t0 = _now(device)
        while done < self.tf_epochs:
            with trace.span("trainer.boundary"):
                if every and done and done % every == 0:
                    self._resample(done)
                # Chunks end on log, resample and save boundaries, as the
                # JAX Trainer's scan chunks do.
                chunk = min(self.CHUNK_CAP, self.tf_epochs - done,
                            self.frequency - (done % self.frequency))
                if every:
                    chunk = min(chunk, every - (done % every))
                if self.save_every:
                    chunk = min(chunk,
                                self.save_every - (done % self.save_every))
            self.params, state, losses = self.adam.run(
                self.params, state, self.batch, chunk)
            with trace.span("trainer.boundary"):
                # losses[0] is the loss at epoch `done`, before its update.
                if done % self.frequency == 0:
                    self._log("log_train_epoch", done, float(losses[0]),
                              self._extra(), False)
                done += chunk
                self._maybe_save("adam", done)
        self.timing["adam_s"] += _now(device) - t0

    def _lbfgs_phase(self):
        if self.nt_config.max_iter == 0:
            return
        self._log("log_train_opt", "LBFGS")
        flat, unravel = pcodec.ravel_with_unravel(self.params)
        net_dtype = flat.dtype
        device = flat.device

        # hp["nt_vector_dtype"]="float64": the iterate, gradients and
        # L-BFGS history in float64, the network and its loss in the
        # model dtype.
        vec = self.hp.get("nt_vector_dtype")
        vec_dtype = getattr(torch, vec) if vec is not None else net_dtype
        flat = flat.to(vec_dtype)

        def to_params(x):
            return unravel(x.to(net_dtype))

        def opfunc(w, batch):
            w_ = w.detach().requires_grad_(True)
            loss = self.loss_fn(to_params(w_), batch)
            g, = torch.autograd.grad(loss, w_)
            return loss.detach().to(vec_dtype), g

        def lossfunc(w, batch):
            with torch.no_grad():
                return self.loss_fn(to_params(w), batch).to(vec_dtype)

        t0 = _now(device)
        state = lb.lbfgs_init(opfunc, flat, self.nt_config, self.batch)
        run = lb.make_lbfgs_run(opfunc, self.nt_config, lossfunc)
        every = self.hp.get("nt_resample", 0) if self.resample_fn else 0
        done = 0
        resampled_at = -1
        n_iters = n_evals = 0

        val_every = (int(self.hp.get("nt_val_every", 0) or 0)
                     if self.val_fn is not None else 0)
        val_best = None  # (metric, flat iterate, nt_epoch)

        def val_probe(x, it):
            nonlocal val_best
            v = float(self.val_fn(to_params(x)))
            if val_best is None or v < val_best[0]:
                val_best = (v, x, it)

        if val_every:
            # The warm-start iterate is a candidate too.
            val_probe(state.x, 0)

        def refresh(i):
            # Fresh collocation draw: restart the quasi-Newton model.
            self._resample(i)
            return lb.lbfgs_init(opfunc, state.x, self.nt_config, self.batch)

        while done < self.nt_config.max_iter:
            with trace.span("trainer.boundary"):
                if state.reason != lb.RUNNING:
                    # Terminal on this draw: with resampling, revive on a
                    # fresh one unless this draw already started here.
                    if not every or done == resampled_at:
                        break
                    n_iters += state.n_iter
                    n_evals += state.n_evals
                    state, resampled_at = refresh(done), done
                elif (every and done and done % every == 0
                      and done != resampled_at):
                    n_iters += state.n_iter
                    n_evals += state.n_evals
                    state, resampled_at = refresh(done), done
                chunk = min(self.CHUNK_CAP, self.nt_config.max_iter - done,
                            self.frequency - (done % self.frequency))
                if every:
                    chunk = min(chunk, every - (done % every))
                if self.save_every:
                    chunk = min(chunk,
                                self.save_every - (done % self.save_every))
                if val_every:
                    chunk = min(chunk, val_every - (done % val_every))
            state, f_hist = run(state, self.batch, chunk)
            with trace.span("trainer.boundary"):
                done += chunk
                self.params = to_params(state.x)
                self._maybe_save("lbfgs", done)
                if val_every and done % val_every == 0:
                    val_probe(state.x, done)
                if done % self.frequency == 0:
                    self._log("log_train_epoch", done, float(f_hist[-1]),
                              self._extra(), True)
        self.timing["lbfgs_s"] += _now(device) - t0
        self.timing["lbfgs_iters"] += n_iters + state.n_iter
        self.timing["lbfgs_evals"] += n_evals + state.n_evals
        self.params = to_params(state.x)
        if val_every:
            val_probe(state.x, done)
            if val_best[1] is not state.x:
                self.params = to_params(val_best[1])
                if self.logger is not None:
                    self.logger._print(
                        f"-- val select: restored nt_epoch "
                        f"{val_best[2]} iterate (val {val_best[0]:.4e}) "
                        f"over final --")
        if state.reason != lb.RUNNING and self.logger is not None:
            self.logger._print(
                f"-- LBFGS stopped after {state.n_iter} iterations: "
                f"{lb.REASON_NAMES.get(state.reason, state.reason)} --")

    def _trace(self):
        """hp["trace_dir"]: a ``torch.profiler`` context that writes one
        Chrome-trace JSON there when it closes; else a null context."""
        trace_dir = self.hp.get("trace_dir")
        if not trace_dir:
            return contextlib.nullcontext()
        from torch.profiler import (ProfilerActivity, profile,
                                    tensorboard_trace_handler)
        activities = [ProfilerActivity.CPU]
        if any(a.is_cuda for a in pcodec.leaves(self.params)):
            activities.append(ProfilerActivity.CUDA)
        return profile(activities=activities,
                       on_trace_ready=tensorboard_trace_handler(trace_dir))

    def fit(self):
        """Run both phases; returns the trained params.  With
        hp["trace_dir"] the run is traced (see the module's docstring)."""
        with self._trace():
            self._log("log_train_start", self,
                      model_description=self.hp.get("model_description",
                                                    False))
            if self.tf_epochs > 0:
                self._adam_phase()
            self._lbfgs_phase()
        self._log("log_train_end", self.tf_epochs + self.nt_config.max_iter,
                  self._extra())
        return self.params


def _now(device) -> float:
    """Host clock after the device's queued work has finished."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()
