"""Bounded LRU cache for plans and energy functions.

A copy of ``rocquantum_tpu/utils/cache.py``. The port caches circuit plans
by structural key (compiler/interpreter.py) and gradient functions by
traced structure (api.py). A long-lived service sweeping many circuit
structures must not grow those caches without bound, so each is a
:class:`BoundedCache`: least-recently-used entries are evicted past
``maxsize`` (overridable via ``ROCQ_EXEC_CACHE_SIZE``). Evicting a live
entry is safe: the next use plans it again.
"""

from __future__ import annotations

import os
from collections import OrderedDict

_DEFAULT_SIZE = 256


def _default_size() -> int:
    try:
        return max(1, int(os.environ.get("ROCQ_EXEC_CACHE_SIZE",
                                         _DEFAULT_SIZE)))
    except ValueError:
        return _DEFAULT_SIZE


class BoundedCache:
    """Dict-like LRU cache: reads refresh recency, inserts evict the oldest
    entry once ``maxsize`` is exceeded."""

    def __init__(self, maxsize: int = None):
        self._maxsize = maxsize
        self._data: OrderedDict = OrderedDict()

    @property
    def maxsize(self) -> int:
        return self._maxsize if self._maxsize is not None else _default_size()

    def get(self, key, default=None):
        try:
            self._data.move_to_end(key)
        except KeyError:
            return default
        return self._data[key]

    def __contains__(self, key) -> bool:
        return key in self._data

    def __getitem__(self, key):
        self._data.move_to_end(key)
        return self._data[key]

    def __setitem__(self, key, value) -> None:
        self._data[key] = value
        self._data.move_to_end(key)
        while len(self._data) > self.maxsize:
            self._data.popitem(last=False)

    def __len__(self) -> int:
        return len(self._data)

    def clear(self) -> None:
        self._data.clear()
