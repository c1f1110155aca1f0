"""Filter model families: configured, composable filter objects.

The reference exposes three filter families, each with a naive and an
optimized level (image_filters.h:45-104).  Here each family is a small
immutable model object with two faces:

* ``apply(jnp_image, ...)`` -- a pure jax function usable inside a caller's
  own jit/vmap/shard_map composition (the level picks the implementation
  tier; numerics follow the reference semantics for that level);
* ``__call__(np_image)`` -- convenience execution through the process-wide
  runtime with compiled-executable caching and metrics.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np

from ..core import config
from ..core.params import normalize_level, validate_box_params, validate_gaussian_params
from ..ops import ref
from ..ops.weights import gaussian_kernel_f32


@dataclass(frozen=True)
class GaussianBlur:
    sigma: float = config.DEFAULT_SIGMA
    radius: int = config.DEFAULT_RADIUS
    level: int = 2

    def __post_init__(self):
        validate_gaussian_params(self.sigma, self.radius)
        normalize_level("gaussian", self.level)

    @property
    def weights(self) -> np.ndarray:
        return gaussian_kernel_f32(self.radius, float(self.sigma))

    def apply(self, image: jnp.ndarray, weights: jnp.ndarray | None = None) -> jnp.ndarray:
        """Pure function: (H, W, C) u8 -> u8.  Traceable under jit."""
        w = self.weights if weights is None else weights
        lvl = normalize_level("gaussian", self.level)
        impl = ref.gaussian_blur if lvl == 1 else _level2("gaussian")
        return impl(image, w, self.radius)

    def __call__(self, image: np.ndarray) -> tuple[np.ndarray, dict]:
        from ..runtime.dispatch import RUNTIME

        out, metrics = RUNTIME.gaussian_blur(
            image, sigma=self.sigma, radius=self.radius, level=self.level
        )
        return out, metrics.as_dict()


@dataclass(frozen=True)
class BoxBlur:
    radius: int = config.DEFAULT_RADIUS
    level: int = 2

    def __post_init__(self):
        validate_box_params(self.radius)
        normalize_level("box", self.level)

    def apply(self, image: jnp.ndarray) -> jnp.ndarray:
        lvl = normalize_level("box", self.level)
        impl = ref.box_blur if lvl == 1 else _level2("box")
        return impl(image, self.radius)

    def __call__(self, image: np.ndarray) -> tuple[np.ndarray, dict]:
        from ..runtime.dispatch import RUNTIME

        out, metrics = RUNTIME.box_blur(image, radius=self.radius, level=self.level)
        return out, metrics.as_dict()


@dataclass(frozen=True)
class SobelEdgeDetection:
    level: int = 2

    def __post_init__(self):
        normalize_level("sobel", self.level)

    def apply(self, image: jnp.ndarray) -> jnp.ndarray:
        lvl = normalize_level("sobel", self.level)
        if lvl == 1:
            return ref.sobel(image, 1)
        return _level2("sobel")(image)

    def __call__(self, image: np.ndarray) -> tuple[np.ndarray, dict]:
        from ..runtime.dispatch import RUNTIME

        out, metrics = RUNTIME.sobel_edge_detection(image, level=self.level)
        return out, metrics.as_dict()


def _level2(name: str):
    """The level-2 implementation on (H, W, C) images (the served rows
    function, ops/pallas/api.py)."""
    from ..ops.pallas.api import image_fn
    from ..runtime.device import use_interpret

    return image_fn(name, 2, use_interpret())


def get_filter(name: str, **params):
    """Factory by API name: get_filter('gaussian', sigma=3.0, level=2)."""
    families = {
        "gaussian": GaussianBlur,
        "box": BoxBlur,
        "sobel": SobelEdgeDetection,
    }
    if name not in families:
        raise ValueError(f"Unknown filter: {name}")
    return families[name](**params)
