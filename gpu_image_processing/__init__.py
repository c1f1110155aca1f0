"""gpu_image_processing: a JAX rebuild of Pfactorial01/gpu_image_processing.

The reference stack (CUDA kernels -> pybind11 `gpu_filters` -> FastAPI ->
web UI) is re-designed around JAX on an NVIDIA GPU:

* CUDA device kernels        -> Pallas (Triton) kernels + XLA jnp tiers (ops/)
* pybind11 host bridge       -> jit-cache dispatch runtime (runtime/)
* Nsight Compute profiling   -> XLA cost analysis + jax.profiler (profiling/)
* FastAPI + uvicorn          -> stdlib-threaded HTTP server (server/)
* single GPU                 -> jax.sharding.Mesh batch/spatial parallelism
                                (parallel/)

Top-level exports mirror the `gpu_filters` module surface
(backend/cuda_bindings/bindings.cpp:240-283).
"""

from .api.filters import (  # noqa: F401
    NAIVE,
    SHARED_MEMORY,
    TEXTURE_MEMORY,
    box_blur,
    gaussian_blur,
    sobel_edge_detection,
)

__version__ = "0.1.0"

__all__ = [
    "gaussian_blur",
    "box_blur",
    "sobel_edge_detection",
    "NAIVE",
    "SHARED_MEMORY",
    "TEXTURE_MEMORY",
    "__version__",
]
