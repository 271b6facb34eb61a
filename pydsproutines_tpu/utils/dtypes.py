"""Dtype policy.

The reference keeps an explicit dtype discipline (SURVEY.md §1): fast paths are
complex64/float32, reference/parity paths complex128/float64. On the GPU the
compute dtype is complex64 (stored as interleaved float32); float64 paths are
only used for CPU parity testing (requires ``jax.config.update("jax_enable_x64",
True)``, done in the test conftest).
"""

import jax.numpy as jnp
import numpy as np

COMPLEX_DTYPE = jnp.complex64
FLOAT_DTYPE = jnp.float32

_REAL_OF = {
    np.dtype(np.complex64): np.float32,
    np.dtype(np.complex128): np.float64,
    np.dtype(np.float32): np.float32,
    np.dtype(np.float64): np.float64,
}

_COMPLEX_OF = {
    np.dtype(np.float32): np.complex64,
    np.dtype(np.float64): np.complex128,
    np.dtype(np.complex64): np.complex64,
    np.dtype(np.complex128): np.complex128,
}


def real_dtype_for(dtype) -> np.dtype:
    """Return the matching real dtype for a complex (or real) dtype."""
    return np.dtype(_REAL_OF[np.dtype(dtype)])


def complex_dtype_for(dtype) -> np.dtype:
    """Return the matching complex dtype for a real (or complex) dtype."""
    return np.dtype(_COMPLEX_OF[np.dtype(dtype)])
