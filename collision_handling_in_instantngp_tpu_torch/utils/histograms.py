"""Slot-usage histogram figures: a bar chart of the per-slot counts of each
level (the (L, T) counts of a counts epoch), with the reference's adaptive
x-tick step. matplotlib is imported only when a figure is asked for, and a
missing matplotlib raises an ImportError naming it.
"""

from __future__ import annotations

import numpy as np


def _tick_step(hash_table_size: int) -> int:
    """The adaptive x-tick step: a round tenth of T."""
    dec = hash_table_size * 0.1
    if dec < 100 or dec % 100 < 10:
        if dec % 10 < 5:
            step = dec // 5 * 5
        else:
            step = dec // 10 * 10
    else:
        step = dec // 100 * 100
    return max(int(step), 1)


def _pyplot(should_draw: bool):
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError(
            "histogram figures need matplotlib, which is not installed; log to a "
            "logger that stores no media (JsonlLogger(save_media=False)) instead"
        ) from e
    if not should_draw:
        matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    from matplotlib.ticker import MultipleLocator

    return plt, MultipleLocator


def counts_per_level_histograms(counts: np.ndarray, hash_table_size: int,
                                should_draw: bool = False, combined: bool = False):
    """Figures of (L, T) counts: one per level, or all levels in one
    multi-panel figure (``combined``). Returns the list of figures."""
    plt, MultipleLocator = _pyplot(should_draw)
    counts = np.asarray(counts)
    num_levels = counts.shape[0]
    step = _tick_step(hash_table_size)
    figures = []

    def _style(ax, level, level_counts):
        ax.set_xlim(-1, hash_table_size)
        ax.xaxis.set_major_locator(MultipleLocator(step))
        ax.xaxis.set_minor_locator(MultipleLocator(max(int(step * 0.1), 1)))
        y_max = max(int(level_counts.max()), 1)
        ax.set_ylim(bottom=0, top=y_max + y_max * 0.05)
        ax.set_title(f"Level {level} ({hash_table_size})")
        ax.set_xlabel("Hashed indices")
        ax.set_ylabel("Counts")

    def _bars(ax, level):
        ax.bar(range(hash_table_size), counts[level], width=1, align="center",
               edgecolor="grey")
        _style(ax, level, counts[level])

    if combined and num_levels > 1:
        rows = num_levels // 2 + num_levels % 2
        fig, axs = plt.subplots(rows, 2, figsize=(20, 10))
        axs = np.atleast_1d(axs).flatten()
        for level in range(num_levels):
            _bars(axs[level], level)
        figures.append(fig)
        if should_draw:
            plt.tight_layout()
            plt.show()
        plt.close(fig)
    else:
        for level in range(num_levels):
            fig, ax = plt.subplots(figsize=(15, 5))
            _bars(ax, level)
            figures.append(fig)
            if should_draw:
                plt.show()
            plt.close(fig)
    return figures
