"""Visualization: potential-field rendering and streamline overlays.

A copy of ``epic_tpu.viz`` (NumPy, PIL, and cv2 for the window). Replaces
the reference's OpenCV interactive harness (its
libepic/python/epic/harmonic_map.py:103-176 — click a free cell, draw its
streamline). Two surfaces:

- :func:`render` / :func:`save_png` — headless rendering of (map, field,
  streamlines) to an RGB array / PNG, usable in CI and notebooks;
- :func:`interactive` — the click-to-streamline loop when an OpenCV build
  with GUI support is present (optional; guarded import).
"""

from __future__ import annotations

import numpy as np

from . import constants as C
from .errors import EpicError


def field_to_gray(u: np.ndarray, locked: np.ndarray) -> np.ndarray:
    """Log-potential -> uint8 grayscale: obstacles black, goals white, free
    cells shaded by relative log-potential (brighter = closer to a goal)."""
    u = np.asarray(u, dtype=np.float64)
    locked = np.asarray(locked).astype(bool)
    goal = locked & (u == 0.0)
    obstacle = locked & (u < 0.0)
    free = ~locked
    img = np.zeros(u.shape, dtype=np.uint8)
    if free.any():
        vals = u[free]
        finite = vals[vals > -9e5]
        lo = finite.min() if finite.size else -1.0
        scaled = np.clip((u - lo) / (0.0 - lo + 1e-12), 0.0, 1.0)
        img[free] = (40 + 175 * scaled[free]).astype(np.uint8)
    img[obstacle] = 0
    img[goal] = 255
    return img


def render(
    u: np.ndarray,
    locked: np.ndarray,
    paths: list[np.ndarray] | None = None,
    base_img: np.ndarray | None = None,
) -> np.ndarray:
    """RGB uint8 [H, W, 3]: field (or original map) with streamlines drawn in
    red, start points in green — the HarmonicMap overlay, headless."""
    gray = (
        np.asarray(base_img, dtype=np.uint8)
        if base_img is not None
        else field_to_gray(u, locked)
    )
    rgb = np.stack([gray] * 3, axis=-1)
    h, w = gray.shape
    for pts in paths or []:
        pts = np.asarray(pts)
        for x, y in pts[1:]:
            xi, yi = int(x + 0.5), int(y + 0.5)
            if 0 <= yi < h and 0 <= xi < w:
                rgb[yi, xi] = (255, 0, 0)
        # Start marker drawn last so nearby path pixels don't cover it.
        xi, yi = int(pts[0, 0] + 0.5), int(pts[0, 1] + 0.5)
        if 0 <= yi < h and 0 <= xi < w:
            rgb[yi, xi] = (0, 255, 0)
    return rgb


def render_volume_slice(
    u: np.ndarray,
    locked: np.ndarray,
    z: int,
    paths: list[np.ndarray] | None = None,
) -> np.ndarray:
    """RGB render of one z-plane of a 3D volume, with 3D streamlines
    projected onto it: path points within half a cell of the plane draw in
    red (full intensity at the plane, dimmer toward ±0.5), starts in green.
    The reference has no 3D visualization at all (its harness is 2D cv2)."""
    u = np.asarray(u)
    locked = np.asarray(locked)
    if u.ndim != 3:
        raise ValueError(f"expected a 3D volume, got {u.ndim}D")
    rgb = np.stack([field_to_gray(u[z], locked[z])] * 3, axis=-1)
    d, h, w = u.shape
    for pts in paths or []:
        pts = np.asarray(pts)
        for x, y, pz in pts[1:]:
            if abs(float(pz) - z) > 0.5:
                continue
            xi, yi = int(x + 0.5), int(y + 0.5)
            if 0 <= yi < h and 0 <= xi < w:
                fade = 1.0 - abs(float(pz) - z)
                rgb[yi, xi] = (int(255 * max(fade, 0.5)), 0, 0)
        x0, y0, z0 = pts[0]
        if abs(float(z0) - z) <= 0.5:
            xi, yi = int(x0 + 0.5), int(y0 + 0.5)
            if 0 <= yi < h and 0 <= xi < w:
                rgb[yi, xi] = (0, 255, 0)
    return rgb


def save_png(path: str, rgb: np.ndarray) -> None:
    from PIL import Image

    Image.fromarray(rgb).save(path)


def click_streamline(
    u: np.ndarray,
    locked: np.ndarray,
    x: float,
    y: float,
    base_img: np.ndarray | None = None,
    step_size: float = C.DEFAULT_STEP_SIZE,
    cd_precision: float = C.DEFAULT_CD_PRECISION,
    mode: str = "reference",
) -> np.ndarray | None:
    """The interactive window's click action, GUI-free: walk the
    streamline from clicked pixel (x, y) and return the rendered overlay,
    or None when the walk is rejected (obstacle start / <=2-point path —
    the window silently ignores those, matching HarmonicMap's
    click handler at harmonic_map.py:103-131)."""
    from .path import compute_path

    try:
        pts = compute_path(
            u, locked, float(x), float(y), step_size, cd_precision, mode=mode
        )
    except EpicError:
        return None
    return render(u, locked, [pts], base_img=base_img)


def interactive(
    u: np.ndarray,
    locked: np.ndarray,
    base_img: np.ndarray | None = None,
    step_size: float = C.DEFAULT_STEP_SIZE,
    cd_precision: float = C.DEFAULT_CD_PRECISION,
    mode: str = "reference",
    window_title: str = "epic_tpu_torch harmonic map",
    hold: bool = False,
) -> None:
    """Click-to-streamline window (HarmonicMap.show semantics: left click
    draws the streamline from the clicked pixel; Esc quits; ``hold`` keeps
    previous streamlines on screen). Requires OpenCV with GUI support."""
    try:
        import cv2
    except ImportError as e:  # pragma: no cover - optional dependency
        raise EpicError(2, "interactive viz requires opencv-python") from e

    base = render(u, locked, base_img=base_img)
    shown = base.copy()

    def on_mouse(event, x, y, flags, param):  # pragma: no cover - GUI
        nonlocal shown
        if event != cv2.EVENT_LBUTTONUP:
            return
        if not hold:
            shown = base.copy()
        overlay = click_streamline(
            u, locked, x, y, base_img=base_img, step_size=step_size,
            cd_precision=cd_precision, mode=mode)
        if overlay is None:
            return
        shown = overlay
        cv2.imshow(window_title, shown[:, :, ::-1])

    cv2.imshow(window_title, shown[:, :, ::-1])  # pragma: no cover - GUI
    cv2.setMouseCallback(window_title, on_mouse)
    while cv2.waitKey(0) != 27:
        pass
    cv2.destroyAllWindows()
