"""Visualization / reporting.

Port of ``quantized_spectrum_cartography_tpu/utils/viz.py`` (numpy and
matplotlib, imported when a figure is drawn).  The reference's verification
story is visual: per-iteration matplotlib reconstruction panels
(`qmc/qmc.ipynb` cells 1/3/5/7), map-value histograms (`qmc/utils.py:92-112`
`plot_histogram_map_values`), and image grids
(`deep_prior/networks/utils/utils.py:115-181` `plot_multiple`).  These are
the equivalents as pure functions returning matplotlib figures (Agg-safe;
callers save with fig.savefig).  Kept out of the compute path: solvers
return tensors, plotting is host-side and optional, on numpy arrays
(``tensor.cpu().numpy()``).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def plot_recovery_panels(
    T_true: np.ndarray,
    T_hat: np.ndarray,
    bands: Sequence[int] = (0, 24, 48),
    log_offset: Optional[float] = None,
):
    """True-vs-recovered map panels at selected frequency bands
    (qmc.ipynb cell 3/5 layout: imshow pairs per band).  log_offset
    switches to the log-domain view the likelihood actually fits."""
    plt = _plt()
    T_true = np.asarray(T_true)
    T_hat = np.asarray(T_hat)
    if log_offset is not None:
        # negative estimates (free-factor solvers before projection) would
        # make log() emit invalid-value RuntimeWarnings; clamp to the
        # offset floor first — the log view's own minimum
        T_true = np.log(np.maximum(T_true, 0.0) + log_offset)
        T_hat = np.log(np.maximum(T_hat, 0.0) + log_offset)
    n = len(bands)
    fig, axes = plt.subplots(2, n, figsize=(3 * n, 6.2), squeeze=False)
    for j, k in enumerate(bands):
        vmin = min(T_true[k].min(), T_hat[k].min())
        vmax = max(T_true[k].max(), T_hat[k].max())
        axes[0][j].imshow(T_true[k], vmin=vmin, vmax=vmax)
        axes[0][j].set_title(f"true, band {k}")
        axes[1][j].imshow(T_hat[k], vmin=vmin, vmax=vmax)
        axes[1][j].set_title(f"recovered, band {k}")
        for ax in (axes[0][j], axes[1][j]):
            ax.set_xticks([])
            ax.set_yticks([])
    fig.tight_layout()
    return fig


def plot_factors(S: np.ndarray, C: np.ndarray,
                 S_true: Optional[np.ndarray] = None,
                 C_true: Optional[np.ndarray] = None):
    """Per-emitter SLF images + PSD line plots (the joint_opt_ae.m figure
    family: estimated vs true S_r and c_r)."""
    plt = _plt()
    S = np.asarray(S)
    C = np.asarray(C)
    R = S.shape[0]
    rows = 2 if S_true is None else 3
    fig, axes = plt.subplots(rows, R, figsize=(3 * R, 3 * rows),
                             squeeze=False)
    for r in range(R):
        axes[0][r].imshow(S[r])
        axes[0][r].set_title(f"S_hat[{r}]")
        axes[0][r].set_xticks([]); axes[0][r].set_yticks([])
        axes[1][r].plot(C[r], label="estimate")
        if C_true is not None:
            axes[1][r].plot(np.asarray(C_true)[r], "--", label="true")
            axes[1][r].legend(fontsize=7)
        axes[1][r].set_title(f"c_hat[{r}]")
        if S_true is not None:
            axes[2][r].imshow(np.asarray(S_true)[r])
            axes[2][r].set_title(f"S_true[{r}]")
            axes[2][r].set_xticks([]); axes[2][r].set_yticks([])
    fig.tight_layout()
    return fig


def plot_convergence(curves: Dict[str, np.ndarray], ylabel: str = "NMSE",
                     logy: bool = True):
    """Named per-iteration curves (the notebooks' `nmses`/`costs` traces)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(5, 3.5))
    for name, ys in curves.items():
        ax.plot(np.asarray(ys), label=name)
    if logy:
        ax.set_yscale("log")
    ax.set_xlabel("iteration")
    ax.set_ylabel(ylabel)
    ax.legend(fontsize=8)
    fig.tight_layout()
    return fig


def plot_map_value_histogram(samples: np.ndarray, bins: int = 200,
                             log_domain: bool = False,
                             log_offset: float = 1e-10,
                             boundaries: Optional[Sequence[float]] = None):
    """Histogram of map/SLF pixel values with optional quantizer boundary
    overlay (reference `plot_histogram_map_values`, qmc/utils.py:92-112 —
    the tool used to design the bin-boundary tables)."""
    plt = _plt()
    vals = np.asarray(samples).reshape(-1)
    if log_domain:
        vals = np.log(vals + log_offset)
    fig, ax = plt.subplots(figsize=(5, 3.5))
    ax.hist(vals, bins=bins)
    if boundaries is not None:
        for b in boundaries:
            ax.axvline(float(b), color="k", lw=0.6, ls="--")
    ax.set_xlabel("log value" if log_domain else "value")
    ax.set_ylabel("count")
    fig.tight_layout()
    return fig


def plot_multiple(images: np.ndarray, cols: int = 8,
                  titles: Optional[Sequence[str]] = None):
    """Grid of map images (reference `plot_multiple`,
    networks/utils/utils.py:115-181 — used to eyeball prior samples)."""
    plt = _plt()
    imgs = np.asarray(images)
    if imgs.ndim == 4:          # [B, H, W, 1]
        imgs = imgs[..., 0]
    n = imgs.shape[0]
    rows = (n + cols - 1) // cols
    fig, axes = plt.subplots(rows, cols, figsize=(1.6 * cols, 1.6 * rows),
                             squeeze=False)
    for i in range(rows * cols):
        ax = axes[i // cols][i % cols]
        ax.axis("off")
        if i < n:
            ax.imshow(imgs[i])
            if titles is not None and i < len(titles):
                ax.set_title(str(titles[i]), fontsize=6)
    fig.tight_layout()
    return fig
