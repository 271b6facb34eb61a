"""Masked batch row operations.

Reference semantics: /root/reference/custom_kernels/maskedaccess.cu —
block-per-row kernels that multiply only mask-selected rows
(multiplyOnlyMaskedRows :20) or pick one of two multiplicand banks per row
(multiplyRowsBasedOnMask :49). The reference's own benchmark
(benchmark_maskedkernels.py) studies masked kernel-launch costs; here the
predicated form is the dense one — XLA fuses the jnp.where select into the
multiply, so masked-off rows cost a select, not a branch, and the whole
batch stays one elementwise pass."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


@jax.jit
def multiply_only_masked_rows(mask: jnp.ndarray, x: jnp.ndarray,
                              y: jnp.ndarray,
                              mask_value_used=1) -> jnp.ndarray:
    """out[i] = x[i] * y[i] where mask[i] == mask_value_used, else x[i]
    passes through unchanged (the reference kernel leaves `out` untouched for
    unselected rows; with a fresh output that means copying x is the useful
    contract). mask: (M,), x/y: (M, N)."""
    sel = (mask == mask_value_used)[:, None]
    return jnp.where(sel, x * y, x)


@jax.jit
def multiply_rows_based_on_mask(mask: jnp.ndarray, x: jnp.ndarray,
                                y0: jnp.ndarray,
                                y1: jnp.ndarray) -> jnp.ndarray:
    """out[i] = x[i] * (y1[i] if mask[i] else y0[i])
    (reference multiplyRowsBasedOnMask, maskedaccess.cu:49)."""
    sel = (mask != 0)[:, None]
    return x * jnp.where(sel, y1, y0)


@functools.partial(jax.jit, static_argnames=("capacity", "mask_value_used"))
def multiply_masked_rows_gathered(mask: jnp.ndarray, x: jnp.ndarray,
                                  y: jnp.ndarray, capacity: int | None = None,
                                  mask_value_used=1):
    """Compacting variant: gather the selected rows to the front (fixed
    ``capacity``, the fixed-capacity idiom used throughout for data-dependent
    outputs) and multiply only those — the choice when the selected
    fraction is small enough that dense predication wastes real bandwidth.
    Returns (rows (capacity, N), count)."""
    m = x.shape[0]
    cap = capacity if capacity is not None else m
    sel = mask == mask_value_used
    order = jnp.argsort(~sel)          # selected rows first, stable
    idx = order[:cap]
    rows = x[idx] * y[idx]
    valid = sel[idx]
    return jnp.where(valid[:, None], rows, 0), jnp.sum(sel).astype(jnp.int32)
