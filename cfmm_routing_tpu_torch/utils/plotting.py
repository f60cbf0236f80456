"""Figures for sweep results: the reference's two figures.

Per-pool net-flow curves and the concave utility frontier u(t) of a
:class:`~cfmm_routing_tpu_torch.api.Sweep`:

* styling is a context manager over rcParams (no global mutation left
  behind);
* ``usetex`` is opt-in and only enabled when a TeX toolchain exists;
* each figure gets its own Figure object.

Matplotlib is imported inside the functions, so importing this module (and
the solver stack) never needs it.  The same figures as the JAX package's
``utils/plotting.py``.
"""
from __future__ import annotations

import contextlib
import shutil
from typing import Optional, Sequence

import numpy as np

__all__ = ["publication_style", "plot_sweep_flows", "plot_sweep_utility", "save_sweep_figures"]

GOLDEN = (np.sqrt(5.0) - 1.0) / 2.0


@contextlib.contextmanager
def publication_style(width: float = 3.4, height: Optional[float] = None,
                      font_size: int = 8, usetex: bool = False):
    """rcParams context for single-column figures (width in inches)."""
    import matplotlib

    height = width * GOLDEN if height is None else height
    params = {
        "figure.figsize": (width, height),
        "font.family": "serif",
        "font.size": font_size,
        "axes.labelsize": font_size,
        "axes.titlesize": font_size,
        "legend.fontsize": font_size - 1,
        "xtick.labelsize": font_size - 1,
        "ytick.labelsize": font_size - 1,
        "axes.spines.top": False,
        "axes.spines.right": False,
        "text.usetex": bool(usetex and shutil.which("latex")),
    }
    with matplotlib.rc_context(params):
        yield


def plot_sweep_flows(sweep, pool_labels: Optional[Sequence[str]] = None,
                     give_label: str = "input amount $t$"):
    """Per-pool net trade curves vs sweep amount (the reference's ``all_plot``).

    Each pool contributes one line per traded asset: the net amount
    (lambda - delta) that flows out of the pool at grid point t.
    """
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots()
    for pid, flows in enumerate(sweep.net_trades):
        label = pool_labels[pid] if pool_labels else f"pool {pid}"
        for j in range(flows.shape[0]):
            ax.plot(
                sweep.amounts, flows[j],
                label=f"{label}/a{j}" if flows.shape[0] > 1 else label,
                linewidth=1.0,
            )
    ax.set_xlabel(give_label)
    ax.set_ylabel(r"net flow $\Lambda_i - \Delta_i$")
    ax.legend(ncol=2, frameon=False)
    fig.tight_layout()
    return fig


def plot_sweep_utility(sweep, give_label: str = "input amount $t$",
                       utility_label: str = "utility $u(t)$"):
    """The concave price-impact frontier u(t) (the reference's ``u_plot``)."""
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots()
    ax.plot(sweep.amounts, sweep.utilities, linewidth=1.2)
    ax.set_xlabel(give_label)
    ax.set_ylabel(utility_label)
    fig.tight_layout()
    return fig


def save_sweep_figures(sweep, flows_path: str, utility_path: str,
                       pool_labels: Optional[Sequence[str]] = None,
                       **style_kw) -> None:
    """Render both reference figures to files (PDF/PNG by extension)."""
    with publication_style(**style_kw):
        fig1 = plot_sweep_flows(sweep, pool_labels)
        fig1.savefig(flows_path)
        fig2 = plot_sweep_utility(sweep)
        fig2.savefig(utility_path)
    import matplotlib.pyplot as plt

    plt.close(fig1)
    plt.close(fig2)
