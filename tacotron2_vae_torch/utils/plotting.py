"""Matplotlib-Agg plots as numpy RGB images (JAX ``utils/plotting.py``,
reference plotting_utils.py): alignment, spectrogram, gate targets against
predictions, and the latent scatter the logger writes to TensorBoard.

matplotlib is optional: it is imported by ``available()`` or the first
plot, never when this module is imported.
"""

from __future__ import annotations

import numpy as np


def available() -> bool:
    """Whether matplotlib can be imported (it is, when it can)."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True


def pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pylab as plt

    return plt


def _fig_to_numpy(fig) -> np.ndarray:
    fig.canvas.draw()
    data = np.asarray(fig.canvas.buffer_rgba())[..., :3]
    pyplot().close(fig)
    return data


def plot_alignment_to_numpy(alignment: np.ndarray, info: str | None = None):
    """alignment: (encoder_steps, decoder_steps)."""
    plt = pyplot()
    fig, ax = plt.subplots(figsize=(6, 4))
    im = ax.imshow(alignment, aspect="auto", origin="lower", interpolation="none")
    fig.colorbar(im, ax=ax)
    ax.set_xlabel("Decoder timestep" + (f"\n\n{info}" if info else ""))
    ax.set_ylabel("Encoder timestep")
    fig.tight_layout()
    return _fig_to_numpy(fig)


def plot_spectrogram_to_numpy(spectrogram: np.ndarray):
    plt = pyplot()
    fig, ax = plt.subplots(figsize=(12, 3))
    im = ax.imshow(spectrogram, aspect="auto", origin="lower", interpolation="none")
    fig.colorbar(im, ax=ax)
    ax.set_xlabel("Frames")
    ax.set_ylabel("Channels")
    fig.tight_layout()
    return _fig_to_numpy(fig)


def plot_gate_outputs_to_numpy(gate_targets, gate_outputs):
    """Per-step gate predictions (n_frames_per_step > 1) are repeated onto
    the per-frame target axis (ceil, then trimmed) so both share x."""
    if len(gate_outputs) != len(gate_targets):
        reps = -(-len(gate_targets) // len(gate_outputs))
        gate_outputs = np.repeat(np.asarray(gate_outputs), reps)[: len(gate_targets)]
    plt = pyplot()
    fig, ax = plt.subplots(figsize=(12, 3))
    ax.scatter(range(len(gate_targets)), gate_targets, alpha=0.5, color="green", marker="+",
               s=1, label="target")
    ax.scatter(range(len(gate_outputs)), gate_outputs, alpha=0.5, color="red", marker=".",
               s=1, label="predicted")
    ax.set_xlabel("Frames (Green target, Red predicted)")
    ax.set_ylabel("Gate State")
    fig.tight_layout()
    return _fig_to_numpy(fig)


def plot_scatter(mus: np.ndarray, labels: np.ndarray, names=("neu", "sad", "ang", "hap")):
    """2-D scatter of the first two latent dims colored by emotion label."""
    colors = "r", "b", "g", "y", "c", "m"
    plt = pyplot()
    fig, ax = plt.subplots(figsize=(6, 6))
    for i in range(min(len(names), int(labels.max(initial=0)) + 1)):
        sel = labels == i
        if sel.any():
            ax.scatter(mus[sel, 0], mus[sel, 1], alpha=0.6, color=colors[i % len(colors)],
                       label=names[i])
    ax.legend()
    fig.tight_layout()
    return _fig_to_numpy(fig)


def plot_tsne(zs: np.ndarray, labels: np.ndarray, names=("neu", "sad", "ang", "hap")):
    """t-SNE of latents colored by emotion (the reference's inference
    notebook); the first two dims when scikit-learn is absent or refuses
    the points (no more of them than its perplexity, 30), as the JAX
    package falls back."""
    try:
        from sklearn.manifold import TSNE

        pts = TSNE(n_components=2, random_state=0).fit_transform(zs)
    except (ImportError, ValueError):
        pts = zs[:, :2]
    return plot_scatter(pts, labels, names)
