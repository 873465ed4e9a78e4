"""Numpy copy of ``repro.data.digits``: the port imports nothing of the JAX
package.

Procedural 3-domain digit datasets (MNIST / USPS / MNIST-M analogues).

The evaluation datasets are gated offline (repro band 2/5), so we generate
three *visually distinct* digit domains that preserve what matters for the
paper's claims: a shared label space (digits 0-9), domain gaps of different
sizes (M<->U small, M<->MM large), and per-sample style noise.

  domain "M"  : clean anti-aliased strokes, white on black (MNIST-like)
  domain "U"  : rendered at 14x14 then upsampled + blur + thicker strokes
                (USPS-like resolution/style shift)
  domain "MM" : digit blended over a random colored low-frequency background
                with inverted-foreground mixing (MNIST-M-like)

All images are (28, 28, 3) float32 in [0, 1].
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

IMAGE_SHAPE = (28, 28, 3)
NUM_CLASSES = 10
DOMAINS = ("M", "U", "MM")

# Stroke skeletons on a [0,1]^2 canvas: list of polylines per digit.
_T, _B, _L, _R, _M = 0.12, 0.88, 0.22, 0.78, 0.5
_STROKES = {
    0: [[(_L, _T), (_R, _T), (_R, _B), (_L, _B), (_L, _T)]],
    1: [[(_M, _T), (_M, _B)], [(0.35, 0.25), (_M, _T)]],
    2: [[(_L, _T), (_R, _T), (_R, _M), (_L, _M), (_L, _B), (_R, _B)]],
    3: [[(_L, _T), (_R, _T), (_R, _B), (_L, _B)], [(_L, _M), (_R, _M)]],
    4: [[(_L, _T), (_L, _M), (_R, _M)], [(_R, _T), (_R, _B)]],
    5: [[(_R, _T), (_L, _T), (_L, _M), (_R, _M), (_R, _B), (_L, _B)]],
    6: [[(_R, _T), (_L, _T), (_L, _B), (_R, _B), (_R, _M), (_L, _M)]],
    7: [[(_L, _T), (_R, _T), (0.45, _B)]],
    8: [[(_L, _T), (_R, _T), (_R, _B), (_L, _B), (_L, _T)],
        [(_L, _M), (_R, _M)]],
    9: [[(_R, _M), (_L, _M), (_L, _T), (_R, _T), (_R, _B), (_L, _B)]],
}


def _render_skeleton(digit: int, size: int, rng: np.random.Generator,
                     thickness: float) -> np.ndarray:
    """Rasterize the digit's polylines with random affine jitter."""
    angle = rng.uniform(-0.25, 0.25)
    scale = rng.uniform(0.85, 1.1)
    dx, dy = rng.uniform(-0.06, 0.06, size=2)
    ca, sa = np.cos(angle), np.sin(angle)

    ys, xs = np.mgrid[0:size, 0:size]
    px = (xs + 0.5) / size
    py = (ys + 0.5) / size
    img = np.zeros((size, size), np.float32)

    for line in _STROKES[digit]:
        pts = np.asarray(line, np.float32) - 0.5
        pts = pts @ np.array([[ca, -sa], [sa, ca]], np.float32).T * scale
        pts = pts + 0.5 + np.array([dx, dy], np.float32)
        for (x0, y0), (x1, y1) in zip(pts[:-1], pts[1:]):
            # distance from each pixel to segment
            vx, vy = x1 - x0, y1 - y0
            L2 = vx * vx + vy * vy + 1e-9
            t = np.clip(((px - x0) * vx + (py - y0) * vy) / L2, 0.0, 1.0)
            d = np.hypot(px - (x0 + t * vx), py - (y0 + t * vy))
            img = np.maximum(img, np.clip(1.0 - d / thickness, 0.0, 1.0))
    return img


def _blur(img: np.ndarray, k: int = 3) -> np.ndarray:
    """Cheap separable box blur."""
    pad = k // 2
    p = np.pad(img, ((pad, pad), (pad, pad)), mode="edge")
    out = np.zeros_like(img)
    for i in range(k):
        for j in range(k):
            out += p[i:i + img.shape[0], j:j + img.shape[1]]
    return out / (k * k)


def _low_freq_noise(size: int, rng: np.random.Generator,
                    cells: int = 4) -> np.ndarray:
    """Bilinear-upsampled random color grid — a colorful BSDS-ish background.
    Returns (size, size, 3)."""
    grid = rng.uniform(0.0, 1.0, size=(cells + 1, cells + 1, 3)).astype(np.float32)
    xs = np.linspace(0.0, cells, size)
    i0 = np.clip(xs.astype(int), 0, cells - 1)
    f = (xs - i0).astype(np.float32)
    rows = grid[i0] * (1 - f)[:, None, None] + grid[i0 + 1] * f[:, None, None]
    out = (rows[:, i0] * (1 - f)[None, :, None]
           + rows[:, i0 + 1] * f[None, :, None])
    return out


def render_digit(digit: int, domain: str,
                 rng: np.random.Generator) -> np.ndarray:
    size = IMAGE_SHAPE[0]
    if domain == "M":
        g = _render_skeleton(digit, size, rng, thickness=0.055)
        g = np.clip(g + rng.normal(0, 0.02, g.shape), 0, 1)
        img = np.repeat(g[..., None], 3, axis=-1)
    elif domain == "U":
        small = _render_skeleton(digit, 14, rng, thickness=0.085)
        g = np.kron(small, np.ones((2, 2), np.float32))
        g = _blur(g, 3)
        g = np.clip(g * rng.uniform(0.75, 1.0)
                    + rng.normal(0, 0.03, g.shape), 0, 1)
        img = np.repeat(g[..., None], 3, axis=-1)
    elif domain == "MM":
        g = _render_skeleton(digit, size, rng, thickness=0.055)
        bg = _low_freq_noise(size, rng)
        fg = 1.0 - bg                       # invert background under the digit
        img = bg * (1.0 - g[..., None]) + fg * g[..., None]
        img = np.clip(img + rng.normal(0, 0.04, img.shape), 0, 1)
    else:
        raise ValueError(f"unknown domain {domain!r}")
    return img.astype(np.float32)


@dataclasses.dataclass
class DigitDataset:
    images: np.ndarray          # (N, 28, 28, 3) float32
    labels: np.ndarray          # (N,) int32
    domain_ids: np.ndarray      # (N,) int32 index into DOMAINS


def render_images(labels: np.ndarray, domain: str,
                  seed: int) -> np.ndarray:
    """Render the GIVEN label sequence in ``domain``: (n, 28, 28, 3)
    float32, one independent style draw per sample from a fresh
    ``default_rng(seed)`` stream.

    This is the domain-interpolation primitive's other endpoint: to
    drift a device's features toward another domain, re-render its
    exact labels there (same seed -> same styles every call, so a
    time-varying mix needs only ONE alt-domain render per device) and
    blend pixel-wise with the original images
    (``repro.data.partition.interpolate_features``)."""
    rng = np.random.default_rng(seed)
    return np.stack([render_digit(int(d), domain, rng) for d in labels])


def make_domain_dataset(domain: str, n: int, seed: int,
                        label_subset=None) -> DigitDataset:
    rng = np.random.default_rng(seed)
    choices = (np.arange(NUM_CLASSES) if label_subset is None
               else np.asarray(label_subset))
    labels = rng.choice(choices, size=n)
    images = np.stack([render_digit(int(d), domain, rng) for d in labels])
    dom = np.full(n, DOMAINS.index(domain), np.int32)
    return DigitDataset(images, labels.astype(np.int32), dom)


def make_mixture(spec: Dict[str, int], seed: int,
                 label_subset=None) -> DigitDataset:
    """spec: domain -> count; e.g. {'M': 500, 'MM': 500} (the paper's
    'mixed' setting M+MM)."""
    parts = [make_domain_dataset(d, n, seed + 17 * i, label_subset)
             for i, (d, n) in enumerate(sorted(spec.items()))]
    return DigitDataset(
        np.concatenate([p.images for p in parts]),
        np.concatenate([p.labels for p in parts]),
        np.concatenate([p.domain_ids for p in parts]))
