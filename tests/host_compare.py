"""Exact comparison of host-side results of the two packages (numpy only).

``assert_same(a, b)`` walks dataclasses (by field), dicts (same keys in the
same order), lists and tuples (same type and length), and requires every
array to have the same dtype and the same values (``array_equal``), and
every other leaf the same type and value.
"""

import dataclasses

import numpy as np


def assert_same(a, b, what=""):
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, what
        for f in dataclasses.fields(a):
            assert_same(getattr(a, f.name), getattr(b, f.name),
                        f"{what}.{f.name}")
    elif isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), (what, a, b)
        for k in a:
            assert_same(a[k], b[k], f"{what}[{k!r}]")
    elif isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{what}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and isinstance(b, np.ndarray), what
        assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        assert type(a) is type(b) and a == b, (what, a, b)
