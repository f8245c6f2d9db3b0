"""Visualization panels on the host.

The port's own copy of ``unseenobjectswithmeanshift_tpu.utils.visualize``
(ref: lib/fcn/test_common.py image / depth / feature-PCA / label panels and
lib/utils/mask.py visualize_segmentation). ``label_overlay`` and
``unnormalize_image`` need numpy only (``cli/dataset_statistics.py`` writes
their panels through ``utils/image_io.write_png``); the panel figure of
``vis_minibatch_segmentation`` imports matplotlib inside it.
"""

from __future__ import annotations

import numpy as np

from ..config import UCN_PIXEL_MEANS_BGR


def unnormalize_image(image_norm_bgr):
    """Invert the UCN normalization back to displayable RGB uint8."""
    im = (image_norm_bgr + np.asarray(UCN_PIXEL_MEANS_BGR, np.float32) / 255.0)
    im = np.clip(im * 255.0, 0, 255).astype(np.uint8)
    return im[..., ::-1]  # BGR -> RGB


def normalize_descriptor(res, stats=None):
    """Per-channel min / max normalization of an embedding map for display
    (ref: test_common.py normalize_descriptor)."""
    if stats is None:
        stats = {"min": res.min(axis=tuple(range(res.ndim - 1))),
                 "max": res.max(axis=tuple(range(res.ndim - 1)))}
    return (res - stats["min"]) / np.maximum(stats["max"] - stats["min"], 1e-12)


def features_pca(features_hwc, dim=3):
    """Project an embedding map to RGB by PCA for display."""
    h, w, c = features_hwc.shape
    x = features_hwc.reshape(-1, c).astype(np.float64)
    x = x - x.mean(0)
    _, _, vt = np.linalg.svd(x, full_matrices=False)
    proj = (x @ vt[:dim].T).reshape(h, w, dim)
    return normalize_descriptor(proj)


def label_overlay(image_rgb_u8, label, alpha=0.5, seed=5):
    """Colour-overlay a label image on an RGB image."""
    rng = np.random.RandomState(seed)
    colors = rng.randint(50, 255, size=(int(label.max()) + 1, 3), dtype=np.uint8)
    colors[0] = 0
    overlay = colors[label]
    blend = image_rgb_u8.astype(np.float32) * (1 - alpha) + overlay * alpha
    return np.where((label > 0)[..., None], blend, image_rgb_u8).astype(np.uint8)


def vis_minibatch_segmentation(image, xyz, label, out_label, out_label_refined=None,
                               features=None, save_path=None):
    """Panel plot mirroring _vis_minibatch_segmentation_final
    (ref: lib/fcn/test_common.py). image: [H, W, 3] normalized BGR."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rgb = unnormalize_image(image)
    panels = [("image", rgb)]
    if xyz is not None:
        panels.append(("depth z", xyz[..., 2]))
    if features is not None:
        panels.append(("features (PCA)", features_pca(features)))
    if label is not None:
        panels.append(("gt", label))
    panels.append(("initial labels", label_overlay(rgb, np.asarray(out_label))))
    if out_label_refined is not None:
        panels.append(("refined labels", label_overlay(rgb, np.asarray(out_label_refined))))

    n = len(panels)
    fig, axes = plt.subplots(1, n, figsize=(4 * n, 4))
    if n == 1:
        axes = [axes]
    for ax, (title, img) in zip(axes, panels):
        ax.imshow(img)
        ax.set_title(title)
        ax.axis("off")
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=80)
        plt.close(fig)
        return save_path
    return fig
