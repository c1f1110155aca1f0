"""Compatibility shim: `import gpu_filters` works exactly as with the
reference's pybind11 module (backend/cuda_bindings/bindings.cpp:240), but is
backed by the JAX framework in gpu_image_processing/."""

from gpu_image_processing.api.filters import (  # noqa: F401
    NAIVE,
    SHARED_MEMORY,
    TEXTURE_MEMORY,
    box_blur,
    gaussian_blur,
    sobel_edge_detection,
)
