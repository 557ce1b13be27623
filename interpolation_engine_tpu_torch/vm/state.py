"""Value types and the key hash of the VM state, numpy only.

The counterpart of the numpy part of ``interpolation_engine_tpu/vm/state.py``:
the same value-type codes and the same ``fnv1a_np``. It imports nothing from
either package, because ``_shared`` may install it under the JAX package's
module name before that package's compiler can be imported.
"""

from __future__ import annotations

import numpy as np

# value types
T_EMPTY = 0
T_INT = 1
T_STR = 2
T_LIST = 3

HASH_BASE = 1000003  # polynomial rolling-hash base (mod 2^32)


def fnv1a_np(data: bytes) -> np.uint32:
    h = 0
    p = 1
    for b in data:
        h = (h + (b + 1) * p) & 0xFFFFFFFF
        p = (p * HASH_BASE) & 0xFFFFFFFF
    return np.uint32(h)
