"""jax's dtype promotion and conversion rules, without jax.

The reference computes with jax's 64-bit mode off. Its binary operations
promote through jax's type lattice, in which a Python scalar is *weakly
typed*: ``int8_column * 300`` stays int8 (the literal wraps to 44), while
``int32_column * 1.5`` is float32. PyTorch promotes differently (an int32
sum is int64, a scalar may be kept in double precision), so the port never
relies on it: every operand is converted here to the dtype this lattice
gives, and the operation runs in that dtype.

Dtypes are named by numpy's names; the weak types are ``"i*"`` (a Python
int, or a result that stayed weak) and ``"f*"`` (a Python float). With x64
off, 64-bit results narrow to 32 bits and the weak types compute as int32
and float32.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "result_type",
    "dtype_name",
    "torch_dtype_of",
    "canonical_name",
    "is_float",
    "is_int",
    "is_unsigned",
    "convert",
    "flush_denormals",
    "scalar_tensor",
]

# jax/_src/dtypes.py::_type_promotion_lattice: each type and the types
# directly above it
_LATTICE = {
    "bool": ("i*",),
    "i*": ("uint8", "int8"),
    "uint8": ("uint16", "int16"),
    "uint16": ("uint32", "int32"),
    "uint32": ("uint64", "int64"),
    "uint64": ("f*",),
    "int8": ("int16",),
    "int16": ("int32",),
    "int32": ("int64",),
    "int64": ("f*",),
    "f*": ("bfloat16", "float16", "c*"),
    "bfloat16": ("float32",),
    "float16": ("float32",),
    "float32": ("float64",),
    "float64": ("complex128",),
    "c*": ("complex64",),
    "complex64": ("complex128",),
    "complex128": (),
}


def _upper(t: str) -> frozenset:
    out, todo = {t}, [t]
    while todo:
        for u in _LATTICE[todo.pop()]:
            if u not in out:
                out.add(u)
                todo.append(u)
    return frozenset(out)


_UPPER = {t: _upper(t) for t in _LATTICE}

# x64 off: 64-bit types compute in 32 bits; the weak types are int32 and
# float32 values that keep their weak flag
_CANONICAL = {"int64": "int32", "uint64": "uint32", "float64": "float32",
              "complex128": "complex64"}

_TORCH = {"bool": torch.bool, "int8": torch.int8, "uint8": torch.uint8,
          "int16": torch.int16, "int32": torch.int32, "uint32": torch.uint32,
          "float16": torch.float16, "float32": torch.float32}
_NAMES = {v: k for k, v in _TORCH.items()}
_NAMES[torch.int64] = "int64"
_NAMES[torch.float64] = "float64"


def _lattice_join(a: str, b: str) -> str:
    """Least upper bound of two lattice types (weak types included)."""
    common = _UPPER[a] & _UPPER[b]
    for t in common:
        if _UPPER[t] == common:
            return t
    raise TypeError(f"no common type for {a} and {b}")


def canonical_name(dtype) -> str:
    """numpy name of ``dtype`` with x64 off (int64 -> int32, ...)."""
    name = str(np.dtype(dtype))
    return _CANONICAL.get(name, name)


def result_type(*entries) -> tuple[str, bool]:
    """The dtype jax gives an operation over ``entries`` (``(dtype name,
    weak)`` pairs): ``(canonical dtype name, weak)``."""
    t = None
    for name, weak in entries:
        lt = ("i*" if is_int(name) else "f*") if weak and name != "bool" else name
        t = lt if t is None else _lattice_join(t, lt)
    if t == "i*":
        return "int32", True
    if t == "f*":
        return "float32", True
    return _CANONICAL.get(t, t), False


def dtype_name(dtype: torch.dtype) -> str:
    """numpy name of a torch dtype."""
    return _NAMES[dtype]


def torch_dtype_of(name: str) -> torch.dtype:
    """Torch dtype of a canonical name; the dtypes the port's tables do not
    hold (bfloat16, complex) raise."""
    try:
        return _TORCH[name]
    except KeyError:
        raise TypeError(f"dtype {name} is not ported: the port's tables hold no "
                        f"{name} column") from None


def is_float(name: str) -> bool:
    return name.startswith(("float", "bfloat"))


def is_int(name: str) -> bool:
    return name.startswith(("int", "uint"))


def is_unsigned(name: str) -> bool:
    return name.startswith("uint")


def _check_python_int(v) -> None:
    """A Python int enters a jax computation as int32 (x64 off): outside its
    range jax raises ``OverflowError``, and so does the port."""
    if isinstance(v, int) and not isinstance(v, bool) and not -2**31 <= v < 2**31:
        raise OverflowError(f"Python int {v} does not fit int32 (64-bit mode is off)")


def scalar_tensor(value, name: str, device=None) -> torch.Tensor:
    """A 0-d tensor of dtype ``name`` holding the Python scalar ``value``,
    converted as jax converts a weak scalar: ints wrap into narrower int
    types, floats round to nearest (through numpy, never through double
    precision twice)."""
    _check_python_int(value)
    with np.errstate(over="ignore", invalid="ignore"):
        a = np.asarray(value).astype(np.dtype(name))
    return torch.from_numpy(np.array(a, copy=True)).to(device)


_TINY32 = 2.0 ** -126


def flush_denormals(t: torch.Tensor) -> torch.Tensor:
    """float32 denormals to zero (sign kept). XLA computes float32 with
    denormals flushed, in the operands and the results of arithmetic and
    comparisons (on the CPU and the TPU alike); torch keeps them."""
    if t.dtype == torch.float32:
        return torch.where(t.abs() < _TINY32, t * 0, t)
    return t


def convert(x: torch.Tensor, name: str) -> torch.Tensor:
    """``x`` converted to ``name`` as ``lax.convert_element_type`` does on
    the CPU: ints wrap, floats to ints truncate and saturate (NaN to 0),
    anything to bool is ``!= 0`` (a float32 denormal is 0 there)."""
    dt = torch_dtype_of(name)
    if x.dtype == dt:
        return x
    if x.is_floating_point() and is_int(name):
        info = torch.iinfo(dt)
        d = x.double()
        d = torch.where(torch.isnan(d), 0.0, d.clamp(info.min, info.max))
        return d.trunc().to(dt)
    if name == "bool":
        return flush_denormals(x) != 0
    return x.to(dt)
