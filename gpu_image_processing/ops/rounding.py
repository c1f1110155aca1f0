"""uint8 quantization matching the CUDA `(unsigned char)(x + 0.5f)` cast.

Every kernel in the reference converts its f32 accumulator back to uint8 with
`(unsigned char)(sum + 0.5f)` (e.g. image_filters.cu:102,394,1232,1444).  A C
cast truncates toward zero; for the non-negative sums produced by these
filters this is `floor(sum + 0.5)` -- round-half-up, NOT round-half-even, so
`jnp.rint` would be wrong for *.5 values.
"""

from __future__ import annotations

import jax.numpy as jnp


def quantize_u8(x: jnp.ndarray) -> jnp.ndarray:
    """floor(x + 0.5) clamped to [0, 255], as uint8."""
    return jnp.clip(jnp.floor(x + jnp.float32(0.5)), 0.0, 255.0).astype(jnp.uint8)


def quantize_u8_f32(x: jnp.ndarray) -> jnp.ndarray:
    """Same rounding but staying in float32 (for fused intermediates).

    The reference's separable blurs write the horizontal pass to a uint8 temp
    buffer (image_filters.cu:761,811-839); our fused kernels keep the
    intermediate on chip but must quantize it identically to preserve
    bit-parity of the second pass.
    """
    return jnp.clip(jnp.floor(x + jnp.float32(0.5)), 0.0, 255.0)
