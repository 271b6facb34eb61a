"""Matrix profile: normalized sliding-window self-similarity over all
diagonals.

Reference semantics: /root/reference/matrixProfileRoutines.py (MatrixProfile
:23 — _computeDiagonal :165, _chainify :96) and
custom_kernels/matrixProfile.cu (diagonal-parallel kernels).

For diagonal d and window W:

    kdiag_d[i] = | sum_{j<W} x[i+j] * conj(x[i+j+d]) |^2
                 / energy[i] / energy[i+d]

Design: diagonals are batched into a padded (D, N-W+1) matrix —
each row is one diagonal's normalized profile, with zeros past its valid
length — computed by a vmapped shift-gather + one batched moving-sum
convolution (the reference CUDA kernel assigns one thread-block per diagonal;
here the whole diagonal batch is a single fused XLA computation). Chain
extraction (threshold runs along diagonals) reuses the fixed-capacity
threshold_edges idiom.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from pydsproutines_tpu.utils.dtypes import real_dtype_for


@functools.partial(jax.jit, static_argnames=("window", "num_diags",
                                             "batch_size"))
def matrix_profile(x: jnp.ndarray, window: int, num_diags: int,
                   batch_size: int = 64):
    """Normalized matrix profile diagonals 1..num_diags as a padded
    (num_diags, N-W+1) matrix; row d-1 holds diagonal d with entries past its
    valid length (N-W+1-d) zeroed."""
    n = x.shape[-1]
    nout = n - window + 1
    rdt = real_dtype_for(x.dtype)
    ones = jnp.ones(window, dtype=rdt)

    power = (x.real * x.real + x.imag * x.imag).astype(rdt)
    norms_sq = jnp.convolve(power, ones, mode="valid")   # (nout,)

    xpad = jnp.concatenate([x, jnp.zeros(num_diags + 1, dtype=x.dtype)])
    npad = jnp.concatenate([norms_sq, jnp.ones(num_diags + 1, dtype=rdt)])

    def one_diag(d):
        shifted = jax.lax.dynamic_slice(xpad, (d,), (n,))
        pdt = x * jnp.conj(shifted)
        kdiag = jnp.convolve(pdt, ones.astype(pdt.dtype), mode="valid")
        mag = kdiag.real * kdiag.real + kdiag.imag * kdiag.imag
        e2 = jax.lax.dynamic_slice(npad, (d,), (nout,))
        out = mag / norms_sq / e2
        valid = jnp.arange(nout) < (nout - d)
        return jnp.where(valid, out, 0)

    diags = jnp.arange(1, num_diags + 1)
    nchunks = -(-num_diags // batch_size)
    pad = nchunks * batch_size - num_diags
    dpad = jnp.concatenate([diags, jnp.broadcast_to(diags[-1:], (pad,))])
    out = jax.lax.map(jax.vmap(one_diag), dpad.reshape(nchunks, batch_size))
    return out.reshape(nchunks * batch_size, nout)[:num_diags]


class MatrixProfile:
    """Matrix profile with optional chain extraction (reference MatrixProfile,
    matrixProfileRoutines.py:23)."""

    def __init__(self, window_length: int, output_chains: bool = False,
                 min_threshold: float | None = None,
                 min_chain_length: int = 0):
        self._window = int(window_length)
        self._output_chains = output_chains
        if output_chains and min_threshold is None:
            raise ValueError("min_threshold cannot be None if output_chains")
        self._min_threshold = min_threshold
        self._min_chain_length = int(min_chain_length)

    def compute(self, x: jnp.ndarray, num_diags: int | None = None):
        """Returns the padded diagonal matrix, or the chain list when
        ``output_chains`` (list of (diagIdx, start, end) like the reference)."""
        x = jnp.asarray(x)
        n = x.shape[-1]
        if num_diags is None:
            num_diags = n - self._window
        mp = matrix_profile(x, self._window, int(num_diags))
        if not self._output_chains:
            return mp
        return self._chains_from_matrix(np.asarray(mp))

    def _chains_from_matrix(self, mp: np.ndarray):
        chains = []
        for row, diag in enumerate(mp):
            d = row + 1
            valid = diag[: diag.shape[-1] - d] if d < diag.shape[-1] else diag[:0]
            idx = np.argwhere(valid > self._min_threshold).reshape(-1)
            if idx.size == 0:
                continue
            starts, ends, lengths = self._chainify(idx, self._min_chain_length)
            for s, l in zip(starts, lengths):
                chains.append((d, int(idx[s]), int(idx[s] + l)))
        return chains

    @staticmethod
    def _chainify(idx_arr: np.ndarray, min_chain_length: int = 0):
        """Contiguous-run extraction over an index array (reference _chainify,
        matrixProfileRoutines.py:96)."""
        d = np.diff(idx_arr)
        ii = np.argwhere(d > 1).reshape(-1) + 1
        starts = np.hstack((0, ii))
        ends = np.hstack((ii, idx_arr.size))
        lengths = ends - starts
        sel = np.argwhere(lengths > min_chain_length).reshape(-1)
        return starts[sel], ends[sel], lengths[sel]
