"""Drop-in replacement for the reference's `gpu_filters` pybind module.

Function signatures, defaults, return dicts, and exported level constants
match backend/cuda_bindings/bindings.cpp:240-283:

    gaussian_blur(image, sigma=2.0, radius=3, level=1)
    box_blur(image, radius=3, level=1)
    sobel_edge_detection(image, level=1)
    NAIVE=1, SHARED_MEMORY=2, TEXTURE_MEMORY=3

Each returns ``{"image": np.uint8 HWC, "time_ms": float,
"bandwidth_gbps": float, "fps": float}`` (bindings.cpp:84-90).  Errors are
raised as RuntimeError to match pybind's std::runtime_error translation.
"""

from __future__ import annotations

import numpy as np

from ..core import config
from ..core.params import NAIVE, SHARED_MEMORY, TEXTURE_MEMORY, ValidationError
from ..runtime.dispatch import RUNTIME

__all__ = [
    "gaussian_blur",
    "box_blur",
    "sobel_edge_detection",
    "NAIVE",
    "SHARED_MEMORY",
    "TEXTURE_MEMORY",
]


def _as_result(image: np.ndarray, metrics) -> dict:
    return {
        "image": image,
        "time_ms": float(metrics.time_ms),
        "bandwidth_gbps": float(metrics.bandwidth_gbps),
        "fps": float(metrics.fps),
    }


def gaussian_blur(
    image: np.ndarray,
    sigma: float = config.DEFAULT_SIGMA,
    radius: int = config.DEFAULT_RADIUS,
    level: int = config.DEFAULT_LEVEL,
) -> dict:
    """Apply Gaussian blur to image on the GPU.

    level: 1=naive oracle, 2=optimized (accepts the TEXTURE_MEMORY=3 and
    SHARED_MEMORY=2 aliases the reference's own tools use, see
    core/params.py).
    """
    try:
        out, metrics = RUNTIME.gaussian_blur(
            image, sigma=float(sigma), radius=int(radius), level=int(level)
        )
    except ValidationError as exc:
        raise RuntimeError(str(exc)) from None
    return _as_result(out, metrics)


def box_blur(
    image: np.ndarray,
    radius: int = config.DEFAULT_RADIUS,
    level: int = config.DEFAULT_LEVEL,
) -> dict:
    """Apply box blur to image on the GPU. level: 1=naive, 2=optimized."""
    try:
        out, metrics = RUNTIME.box_blur(image, radius=int(radius), level=int(level))
    except ValidationError as exc:
        raise RuntimeError(str(exc)) from None
    return _as_result(out, metrics)


def sobel_edge_detection(image: np.ndarray, level: int = config.DEFAULT_LEVEL) -> dict:
    """Apply Sobel edge detection to image on the GPU. level: 1=naive, 2=optimized."""
    try:
        out, metrics = RUNTIME.sobel_edge_detection(image, level=int(level))
    except ValidationError as exc:
        raise RuntimeError(str(exc)) from None
    return _as_result(out, metrics)
