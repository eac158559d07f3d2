"""Normalized [0,1] <-> plain parameter value mapping.

Hosts (and our serving API) drive parameters as normalized values exactly
like a VST host does; this mirrors the reference's LinearParameter
(`src/vst/parameter.cc:58-83`): linear range mapping with
optional step quantization (`divisions`), so automation written against
the plugin maps 1:1 onto this framework.

A copy of `beatrice_vst_tpu/params/normalize.py` (the port imports nothing of the
JAX package).
"""

from __future__ import annotations

from .schema import ListParameter, StringParameter


def normalize(param, plain: float) -> float:
    """Plain value -> normalized [0,1]."""
    if isinstance(param, StringParameter):
        raise TypeError("string parameters have no normalized form")
    lo, hi = float(param.min_value), float(param.max_value)
    if hi <= lo:
        return 0.0
    x = (float(plain) - lo) / (hi - lo)
    return min(1.0, max(0.0, x))


def denormalize(param, normalized: float) -> float:
    """Normalized [0,1] -> plain value, with step quantization when the
    parameter declares divisions (parameter.cc:58-72)."""
    if isinstance(param, StringParameter):
        raise TypeError("string parameters have no normalized form")
    x = min(1.0, max(0.0, float(normalized)))
    lo, hi = float(param.min_value), float(param.max_value)
    divisions = param.divisions
    if divisions and divisions > 0:
        x = round(x * divisions) / divisions
    plain = lo + x * (hi - lo)
    if isinstance(param, ListParameter):
        return int(round(plain))
    return plain


def quantized_normalized(param, normalized: float) -> float:
    """Snap a normalized value to the parameter's grid (for UI display)."""
    return normalize(param, denormalize(param, normalized))
