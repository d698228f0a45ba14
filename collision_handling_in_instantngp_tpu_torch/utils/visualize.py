"""Side-by-side original / reconstruction figure: the reference's test-mode
display, a 1x2 panel of the original image and the reconstruction. Saved
to disk by default (a headless host); ``show=True`` displays it.
matplotlib is imported only here, with the Agg backend unless ``show``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def save_comparison(
    original: np.ndarray,
    reconstruction: np.ndarray,
    path: Optional[str] = None,
    show: bool = False,
):
    import matplotlib

    if not show:
        matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    bw = original.ndim == 2
    fig, axs = plt.subplots(1, 2, figsize=(12, 12))
    for (title, img), ax in zip([("og_image", original), ("output", reconstruction)], axs):
        ax.imshow(img, cmap="gray" if bw else None)
        ax.set_title(title)
    if path:
        fig.savefig(path, bbox_inches="tight", dpi=100)
    if show:
        plt.show()
    plt.close(fig)
    return fig
