"""Compile each distinct JAX Pallas call once a process, for the port's
tests.

The port's tests run the JAX package's kernels in interpret mode as the
reference.  An eager interpret-mode `pallas_call` is traced and compiled
anew at every call, a few seconds each, though many calls repeat the same
kernel at the same static configuration and shapes (the masked add of the
BPR reduction, the extraction and the carry scan, for one).  Inside
`cached()`, `jax.experimental.pallas.pallas_call` returns one `jax.jit` of
the call per distinct kernel and configuration, so a repeat reuses the
compiled program.  The JAX package is not touched: it looks the function up
on the `pl` module at call time.  A configuration whose parts cannot all be
keyed by value (any object other than plain data, functions with such
closures and their wrappers, partials, dataclasses and arrays) is not
cached.
"""

from __future__ import annotations

import contextlib
import dataclasses
import enum
import functools

import jax
import jax.experimental.pallas as pl
import numpy as np

#: key -> the jitted call; kept for the process, across test modules.
_CALLS: dict = {}


def _key(obj):
    """A hashable key equal for equal configurations; TypeError for an
    object that cannot be keyed by value."""
    if obj is None or isinstance(obj, (bool, int, float, str, enum.Enum, np.dtype)):
        return obj
    if isinstance(obj, type):
        return ("type", obj)
    if isinstance(obj, (list, tuple)):
        return (type(obj).__name__, tuple(_key(o) for o in obj))
    if isinstance(obj, dict):
        return ("dict", tuple(sorted((k, _key(v)) for k, v in obj.items())))
    if isinstance(obj, functools.partial):
        return ("partial", _key(obj.func), _key(obj.args), _key(obj.keywords))
    if isinstance(obj, jax.ShapeDtypeStruct):
        return ("sds", obj.shape, str(obj.dtype))
    if isinstance(obj, (np.ndarray, jax.Array)):
        arr = np.asarray(obj)
        return ("array", arr.shape, arr.dtype.str, arr.tobytes())
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return (type(obj), tuple((f.name, _key(getattr(obj, f.name)))
                                 for f in dataclasses.fields(obj)))
    if hasattr(obj, "__wrapped__"):
        # A wrapper around a function (pallas wraps each index map).
        return ("wrapped", type(obj), _key(obj.__wrapped__))
    if callable(obj) and hasattr(obj, "__code__"):
        cells = tuple(_key(c.cell_contents) for c in obj.__closure__ or ())
        return ("fn", obj.__code__, cells, _key(obj.__defaults__), _key(obj.__kwdefaults__))
    raise TypeError(f"cannot key {type(obj)}")


@contextlib.contextmanager
def cached():
    """Within the block, identical pallas_call configurations share one
    compiled program."""
    original = pl.pallas_call

    def pallas_call(kernel, *args, **kwargs):
        try:
            key = _key((kernel, args, kwargs))
        except TypeError:
            return original(kernel, *args, **kwargs)
        if key not in _CALLS:
            _CALLS[key] = jax.jit(original(kernel, *args, **kwargs))
        return _CALLS[key]

    pl.pallas_call = pallas_call
    try:
        yield
    finally:
        pl.pallas_call = original
