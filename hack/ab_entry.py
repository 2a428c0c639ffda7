"""A kernel library's C entry point for the A/B tools
(``hack/flash_ab.py``, ``decode_ab.py``, ``chunk_ab.py``,
``window_off_ab.py``), whichever tree built the library: ``name`` in a
tree whose kernels take no key window, else ``name + "_window"``
called with window 0 (the window comes just before the trailing dtype
and stream)."""

import ctypes


def entry(cdll, name, argtypes):
    """``name``'s callable over ``argtypes``, its signature without a
    window (``..., dtype, stream``)."""
    try:
        fn = getattr(cdll, name + "_window")
    except AttributeError:
        fn = getattr(cdll, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        return fn
    fn.argtypes = argtypes[:-2] + [ctypes.c_int] + argtypes[-2:]
    fn.restype = ctypes.c_int
    return lambda *a: fn(*a[:-2], 0, *a[-2:])
