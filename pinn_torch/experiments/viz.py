"""Result figures of the experiments.

Counterpart of ``experiments/viz.py``, function for function: the
solution heatmap over (t, x) with the training points, exact against
predicted time slices, and the identified-PDE tables, on top of
``pinn_torch.utils.plotting``.  Each one takes numpy arrays, saves
under ``save_path`` (``graph.pdf``, ``graph.png``, ``hp.json``) and
returns that directory, or shows the figure when ``save_path`` is None.
matplotlib and scipy's ``griddata`` are imported inside them,
so importing an experiment never needs them.
"""

from __future__ import annotations

import numpy as np

from pinn_torch.utils.plotting import newfig, pyplot, save_result_dir


def _gridspec():
    from matplotlib import gridspec
    return gridspec


def _griddata(*args, **kw):
    from scipy.interpolate import griddata
    return griddata(*args, **kw)


def _heatmap(ax, fig, U, t, x, cmap="rainbow"):
    h = ax.imshow(U.T, interpolation="nearest", cmap=cmap,
                  extent=[t.min(), t.max(), x.min(), x.max()],
                  origin="lower", aspect="auto")
    fig.colorbar(h, ax=ax, fraction=0.046, pad=0.04)
    ax.set_xlabel("$t$")
    ax.set_ylabel("$x$")


def _slices(fig, gs_row, x, exact_rows, pred_rows, titles, ylim=(-1.1, 1.1)):
    axes = []
    for k, (ex, pr, ti) in enumerate(zip(exact_rows, pred_rows, titles)):
        ax = fig.add_subplot(gs_row[0, k])
        ax.plot(x, ex, "b-", linewidth=2, label="Exact")
        ax.plot(x, pr, "r--", linewidth=2, label="Prediction")
        ax.set_xlabel("$x$")
        ax.set_title(ti, fontsize=10)
        ax.set_ylim(ylim)
        axes.append(ax)
    axes[len(axes) // 2].legend(loc="upper center",
                                bbox_to_anchor=(0.5, -0.35),
                                ncol=2, frameon=False)
    return axes


def plot_inf_cont_results(X_star, u_pred, X_u_train, u_train, Exact_u,
                          X, T, x, t, save_path=None, save_hp=None):
    U_pred = _griddata(X_star, u_pred.flatten(), (X, T), method="cubic")
    gridspec = _gridspec()
    fig, ax = newfig(1.0, 1.1)
    ax.axis("off")

    gs0 = gridspec.GridSpec(1, 1)
    gs0.update(top=0.94, bottom=2 / 3 + 0.06, left=0.15, right=0.85)
    ax0 = fig.add_subplot(gs0[0, 0])
    _heatmap(ax0, fig, U_pred, t, x)
    ax0.plot(X_u_train[:, 1], X_u_train[:, 0], "kx",
             label=f"Data ({u_train.shape[0]} points)",
             markersize=4, clip_on=False)
    ax0.legend(frameon=False, loc="best")
    ax0.set_title("$u(t,x)$", fontsize=10)

    gs1 = gridspec.GridSpec(1, 3)
    gs1.update(top=2 / 3 - 0.05, bottom=0.1, left=0.1, right=0.9, wspace=0.5)
    idxs = [25, 50, 75]
    _slices(fig, gs1, x,
            [Exact_u[i, :] for i in idxs],
            [U_pred[i, :] for i in idxs],
            [f"$t = {t[i, 0]:.2f}$" for i in idxs])

    if save_path is not None:
        return save_result_dir(save_path, save_hp or {})
    pyplot().show()


def plot_inf_disc_results(x_star, idx_t_0, idx_t_1, x_0, u_0, ub, lb,
                          u_1_pred, Exact_u, x, t,
                          save_path=None, save_hp=None):
    gridspec = _gridspec()
    fig, ax = newfig(1.0, 1.2)
    ax.axis("off")

    gs0 = gridspec.GridSpec(1, 1)
    gs0.update(top=0.94, bottom=0.55, left=0.15, right=0.85)
    ax0 = fig.add_subplot(gs0[0, 0])
    _heatmap(ax0, fig, Exact_u, t, x_star)
    for idx in (idx_t_0, idx_t_1):
        ax0.axvline(float(np.ravel(t)[idx]), color="w", linewidth=1)
    ax0.set_title("$u(t,x)$", fontsize=10)

    gs1 = gridspec.GridSpec(1, 2)
    gs1.update(top=0.45, bottom=0.12, left=0.15, right=0.85, wspace=0.5)
    ax1 = fig.add_subplot(gs1[0, 0])
    ax1.plot(x, Exact_u[idx_t_0, :], "b-", linewidth=2)
    ax1.plot(x_0, u_0, "rx", linewidth=2, label="Data")
    ax1.set_xlabel("$x$")
    ax1.set_title(f"$t = {float(np.ravel(t)[idx_t_0]):.2f}$", fontsize=10)
    ax1.legend(frameon=False)

    ax2 = fig.add_subplot(gs1[0, 1])
    ax2.plot(x, Exact_u[idx_t_1, :], "b-", linewidth=2, label="Exact")
    ax2.plot(x_star, u_1_pred, "r--", linewidth=2, label="Prediction")
    ax2.set_xlabel("$x$")
    ax2.set_title(f"$t = {float(np.ravel(t)[idx_t_1]):.2f}$", fontsize=10)
    ax2.legend(frameon=False)

    if save_path is not None:
        return save_result_dir(save_path, save_hp or {})
    pyplot().show()


def _pde_table(ax, nu, l1, l2, l1_noisy, l2_noisy, sign="-",
               deriv="u_{xx}"):
    rows = [
        ("Correct PDE", f"$u_t + u u_x {sign} {nu:.7f} {deriv} = 0$"),
        ("Identified (clean)",
         f"$u_t + {l1:.5f} u u_x {sign} {l2:.7f} {deriv} = 0$"),
        ("Identified (1% noise)",
         f"$u_t + {l1_noisy:.5f} u u_x {sign} {l2_noisy:.7f} {deriv} = 0$"),
    ]
    ax.axis("off")
    for i, (name, eq) in enumerate(rows):
        ax.text(0.0, 0.8 - 0.35 * i, f"{name}:  {eq}", fontsize=9)


def plot_ide_cont_results(X_star, u_pred, X_u_train, u_train, Exact_u,
                          X, T, x, t, l1, l1_noisy, l2, l2_noisy,
                          save_path=None, save_hp=None):
    U_pred = _griddata(X_star, u_pred.flatten(), (X, T), method="cubic")
    gridspec = _gridspec()
    fig, ax = newfig(1.0, 1.4)
    ax.axis("off")

    gs0 = gridspec.GridSpec(1, 1)
    gs0.update(top=0.96, bottom=0.72, left=0.15, right=0.85)
    ax0 = fig.add_subplot(gs0[0, 0])
    _heatmap(ax0, fig, U_pred, t, x)
    ax0.plot(X_u_train[:, 1], X_u_train[:, 0], "kx", markersize=2,
             clip_on=False, label=f"Data ({u_train.shape[0]} points)")
    ax0.set_title("$u(t,x)$", fontsize=10)

    gs1 = gridspec.GridSpec(1, 3)
    gs1.update(top=0.62, bottom=0.35, left=0.1, right=0.9, wspace=0.5)
    idxs = [25, 50, 75]
    _slices(fig, gs1, x,
            [Exact_u[i, :] for i in idxs],
            [U_pred[i, :] for i in idxs],
            [f"$t = {t[i, 0]:.2f}$" for i in idxs])

    gs2 = gridspec.GridSpec(1, 1)
    gs2.update(top=0.2, bottom=0.0, left=0.1, right=0.9)
    _pde_table(fig.add_subplot(gs2[0, 0]), 0.0031831, l1, l2,
               l1_noisy, l2_noisy)

    if save_path is not None:
        return save_result_dir(save_path, save_hp or {})
    pyplot().show()


def plot_ide_disc_results(x_star, t_star, idx_t_0, idx_t_1, x_0, u_0,
                          x_1, u_1, ub, lb, Exact, l1, l1_noisy, l2, l2_noisy,
                          save_path=None, save_hp=None,
                          lambda2_star=0.0031831, deriv="u_{xx}"):
    gridspec = _gridspec()
    fig, ax = newfig(1.0, 1.5)
    ax.axis("off")

    gs0 = gridspec.GridSpec(1, 1)
    gs0.update(top=0.96, bottom=0.72, left=0.15, right=0.85)
    ax0 = fig.add_subplot(gs0[0, 0])
    _heatmap(ax0, fig, Exact.T, t_star, x_star)
    for idx in (idx_t_0, idx_t_1):
        ax0.axvline(float(np.ravel(t_star)[idx]), color="w", linewidth=1)
    ax0.set_title("$u(t,x)$", fontsize=10)

    gs1 = gridspec.GridSpec(1, 2)
    gs1.update(top=0.62, bottom=0.35, left=0.15, right=0.85, wspace=0.5)
    for k, (xi, ui, idx) in enumerate([(x_0, u_0, idx_t_0),
                                       (x_1, u_1, idx_t_1)]):
        axk = fig.add_subplot(gs1[0, k])
        axk.plot(x_star, Exact[:, idx], "b", linewidth=2, label="Exact")
        axk.plot(xi, ui, "rx", linewidth=2, label="Data")
        axk.set_xlabel("$x$")
        axk.set_title(f"$t = {float(np.ravel(t_star)[idx]):.2f}$"
                      f"\n{ui.shape[0]} training data", fontsize=9)

    gs2 = gridspec.GridSpec(1, 1)
    gs2.update(top=0.2, bottom=0.0, left=0.1, right=0.9)
    _pde_table(fig.add_subplot(gs2[0, 0]), lambda2_star, l1, l2,
               l1_noisy, l2_noisy, sign="+", deriv=deriv)

    if save_path is not None:
        return save_result_dir(save_path, save_hp or {})
    pyplot().show()


def plot_schrodinger_results(X_star, u_pred, v_pred, h_pred, Exact_h,
                             X, T, x, t, lb, ub, x0, tb,
                             save_path=None, save_hp=None):
    H_pred = _griddata(X_star, h_pred.flatten(), (X, T), method="cubic")
    gridspec = _gridspec()
    fig, ax = newfig(1.0, 0.9)
    ax.axis("off")

    gs0 = gridspec.GridSpec(1, 1)
    gs0.update(top=0.94, bottom=2 / 3 + 0.06, left=0.15, right=0.85)
    ax0 = fig.add_subplot(gs0[0, 0])
    _heatmap(ax0, fig, H_pred, t, x, cmap="YlGnBu")
    X0 = np.concatenate([x0, 0 * x0], axis=1)
    X_lb = np.concatenate([0 * tb + lb[0], tb], axis=1)
    X_ub = np.concatenate([0 * tb + ub[0], tb], axis=1)
    pts = np.vstack([X0, X_lb, X_ub])
    ax0.plot(pts[:, 1], pts[:, 0], "kx", markersize=4, clip_on=False,
             label=f"Data ({pts.shape[0]} points)")
    ax0.legend(frameon=False, loc="best")
    ax0.set_title("$|h(t,x)|$", fontsize=10)

    gs1 = gridspec.GridSpec(1, 3)
    gs1.update(top=2 / 3 - 0.05, bottom=0.12, left=0.1, right=0.9, wspace=0.5)
    idxs = [75, 100, 125]
    _slices(fig, gs1, x,
            [Exact_h[:, i] for i in idxs],
            [H_pred[i, :] for i in idxs],
            [f"$t = {t[i, 0]:.2f}$" for i in idxs],
            ylim=(-0.1, 5.1))

    if save_path is not None:
        return save_result_dir(save_path, save_hp or {})
    pyplot().show()


def plot_ide_navierstokes_results(data, u_pred, v_pred, p_pred,
                                  l1, l1_noisy, l2, l2_noisy,
                                  save_path=None, save_hp=None):
    """Navier–Stokes identification figure (beyond-reference family):
    predicted vs exact (u, v, p) snapshots at mid-time plus the
    identified-PDE table — the Raissi et al. 2019 Fig. 4 layout class,
    rendered with the same compact helpers as the Burgers figures."""
    nx, ny, nt = len(data.x), len(data.y), len(data.t)
    k = nt // 2

    def frame(flat):
        return np.asarray(flat).reshape(nx, ny, nt)[:, :, k]

    fields = [("u", frame(data.u_star), frame(u_pred)),
              ("v", frame(data.v_star), frame(v_pred)),
              ("p", frame(data.p_star), frame(p_pred))]

    gridspec = _gridspec()
    fig, ax = newfig(1.0, 1.6)
    ax.axis("off")
    gs = gridspec.GridSpec(3, 2)
    gs.update(top=0.96, bottom=0.22, left=0.1, right=0.9,
              hspace=0.55, wspace=0.35)
    for r, (name, exact, pred) in enumerate(fields):
        for c, (tag, F) in enumerate([("exact", exact), ("PINN", pred)]):
            axr = fig.add_subplot(gs[r, c])
            h = axr.imshow(F.T, interpolation="nearest", cmap="rainbow",
                           extent=[data.x.min(), data.x.max(),
                                   data.y.min(), data.y.max()],
                           origin="lower", aspect="auto")
            fig.colorbar(h, ax=axr, fraction=0.046, pad=0.04)
            axr.set_title(f"${name}$ ({tag}), $t={data.t[k]:.2f}$",
                          fontsize=9)
            axr.set_xlabel("$x$"); axr.set_ylabel("$y$")

    gs2 = gridspec.GridSpec(1, 1)
    gs2.update(top=0.14, bottom=0.0, left=0.08, right=0.95)
    axt = fig.add_subplot(gs2[0, 0])
    axt.axis("off")
    rows = [
        ("Correct PDE",
         f"$u_t + (u u_x + v u_y) = -p_x + {data.nu:.4f}(u_{{xx}}+u_{{yy}})$"),
        ("Identified (clean)",
         f"$u_t + {l1:.5f}(u u_x + v u_y) = -p_x + {l2:.6f}(u_{{xx}}+u_{{yy}})$"),
        ("Identified (1% noise)",
         f"$u_t + {l1_noisy:.5f}(u u_x + v u_y) = -p_x + "
         f"{l2_noisy:.6f}(u_{{xx}}+u_{{yy}})$"),
    ]
    for i, (name, eq) in enumerate(rows):
        axt.text(0.0, 0.8 - 0.35 * i, f"{name}:  {eq}", fontsize=8)

    if save_path is not None:
        return save_result_dir(save_path, save_hp or {})
    pyplot().show()
