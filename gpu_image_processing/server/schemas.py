"""Request/response schemas for the REST API.

Field-for-field match of the reference's pydantic models
(backend/app.py:46-63) so existing reference clients work unchanged.  They
are plain dataclasses with explicit field checks, so the server needs
nothing beyond the standard library: a request with a missing or
ill-typed field raises SchemaError, which the server answers with 422.
Numeric strings and integral floats are accepted where a number is
expected, as pydantic's lax mode does.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional

from ..core import config


class SchemaError(ValueError):
    """A request body that does not fit its schema."""


def _as_int(name: str, value: Any) -> int:
    if isinstance(value, bool):
        raise SchemaError(f"{name}: expected an integer, got {value!r}")
    if isinstance(value, int):
        return value
    if isinstance(value, float) and value.is_integer():
        return int(value)
    if isinstance(value, str):
        try:
            return int(value.strip())
        except ValueError:
            pass
    raise SchemaError(f"{name}: expected an integer, got {value!r}")


def _as_float(name: str, value: Any) -> float:
    if isinstance(value, bool):
        raise SchemaError(f"{name}: expected a number, got {value!r}")
    if isinstance(value, (int, float)):
        return float(value)
    if isinstance(value, str):
        try:
            return float(value.strip())
        except ValueError:
            pass
    raise SchemaError(f"{name}: expected a number, got {value!r}")


_TRUE = ("true", "1", "yes", "on", "t", "y")
_FALSE = ("false", "0", "no", "off", "f", "n")


def _as_bool(name: str, value: Any) -> bool:
    if isinstance(value, bool):
        return value
    if isinstance(value, int) and value in (0, 1):
        return bool(value)
    if isinstance(value, str) and value.strip().lower() in _TRUE + _FALSE:
        return value.strip().lower() in _TRUE
    raise SchemaError(f"{name}: expected a boolean, got {value!r}")


def _as_str(name: str, value: Any) -> str:
    if not isinstance(value, str):
        raise SchemaError(f"{name}: expected a string, got {type(value).__name__}")
    return value


@dataclass
class FilterRequest:
    image: str                      # base64 encoded (data-URL prefix ok)
    filter: str                     # "gaussian" | "box" | "sobel"
    level: int = 1                  # 1=naive, 2=optimized, 4=advanced
    sigma: Optional[float] = config.DEFAULT_SIGMA
    radius: Optional[int] = config.DEFAULT_RADIUS
    enable_profiling: bool = False  # deep XLA profiling (ncu analog)

    @classmethod
    def from_json(cls, body: Any) -> "FilterRequest":
        """Validate a decoded JSON object; unknown keys are ignored."""
        if not isinstance(body, dict):
            raise SchemaError("expected a JSON object")
        missing = [k for k in ("image", "filter") if k not in body]
        if missing:
            raise SchemaError(f"missing field(s): {', '.join(missing)}")
        sigma = body.get("sigma", config.DEFAULT_SIGMA)
        radius = body.get("radius", config.DEFAULT_RADIUS)
        return cls(
            image=_as_str("image", body["image"]),
            filter=_as_str("filter", body["filter"]),
            level=_as_int("level", body.get("level", 1)),
            sigma=None if sigma is None else _as_float("sigma", sigma),
            radius=None if radius is None else _as_int("radius", radius),
            enable_profiling=_as_bool("enable_profiling",
                                      body.get("enable_profiling", False)),
        )


@dataclass
class FilterResponse:
    processed_image: str
    metrics: Dict[str, Any]
    info: Dict[str, Any]

    def model_dump(self) -> dict:
        return dataclasses.asdict(self)


@dataclass
class AllLevelsResponse:
    original_image: str
    results: Dict[str, FilterResponse]   # "level_1", "level_2", ...
    image_info: Dict[str, Any]
    profiling_available: bool = False

    def model_dump(self) -> dict:
        return dataclasses.asdict(self)
