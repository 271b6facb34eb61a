"""Dense sliding normalized multi-template dot product.

Reference semantics: custom_kernels/multiplySlices.cu
(slidingMultiplyNormalised :114, multiTemplateSlidingDotProduct :252) — the
short-template time-domain matched filter: for every shift s and template t,

    qf2[t, s] = | sum_n x[s+n] * conj(tmpl[t, n]) |^2
                / sum_n |x[s+n]|^2 / ||tmpl_t||^2

The correlations of all templates come from one batched FFT product; the
window energies from a causal moving sum of |x|^2.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from pydsproutines_tpu.ops.filters import _conv_causal_matmul
from pydsproutines_tpu.ops.xcorr import _abs_sq
from pydsproutines_tpu.utils.fftlen import next_fast_len


@jax.jit
def _sliding(x, templates):
    n = x.shape[-1]
    tlen = templates.shape[-1]
    nshifts = n - tlen + 1
    nfft = next_fast_len(n)
    xf = jnp.fft.fft(x, nfft)
    tf = jnp.fft.fft(templates, nfft, axis=-1)
    # circular cross-correlation; nfft >= n keeps shifts 0..n-L wrap-free
    corr = jnp.fft.ifft(xf[None, :] * jnp.conj(tf), axis=-1)[:, :nshifts]
    power = _abs_sq(x)
    energy = _conv_causal_matmul(jnp.ones(tlen, power.dtype), power)[tlen - 1:]
    tnorm = jnp.sum(_abs_sq(templates), axis=-1)
    return _abs_sq(corr) / energy[None, :] / tnorm[:, None]


def sliding_multiply_normalised(x, templates) -> jnp.ndarray:
    """QF^2 of every template against every dense shift of ``x``.

    x : (N,) complex; templates : (T, L) or (L,) complex, L <= N.
    Returns (T, N - L + 1) real at x's precision.
    """
    templates = jnp.atleast_2d(jnp.asarray(templates))
    x = jnp.asarray(x)
    if int(templates.shape[-1]) > int(x.shape[-1]):
        raise ValueError("template longer than input")
    return _sliding(x, templates.astype(x.dtype))

