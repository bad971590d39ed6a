"""Small utilities: get_time_string (from utils/logging.py) and
get_function_args. Counterpart of storygen_tpu/utils/util.py."""
from __future__ import annotations

import inspect
from typing import Any, Dict

from storygen_tpu_torch.utils.logging import get_time_string  # re-export

__all__ = ["get_time_string", "get_function_args"]


def get_function_args() -> Dict[str, Any]:
    """The calling function's bound arguments as a dict (to re-serialize a
    call's keyword arguments into a run's config record)."""
    frame = inspect.currentframe().f_back
    args, varargs, keywords, values = inspect.getargvalues(frame)
    out = {name: values[name] for name in args}
    if keywords:
        out.update(values[keywords])
    return out
