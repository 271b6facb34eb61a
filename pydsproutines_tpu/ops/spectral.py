"""Spectral transforms: CZT (Bluestein zoom-FFT), direct DFT at arbitrary
frequencies, analytic tone spectrum, integer-multiple padded FFT, and
overlap-add burst FFT.

Reference semantics: /root/reference/spectralRoutines.py (czt :77, CZTCached
:239, IntegerMultipleFFT :128, dft :637, toneSpectrum :663) and
/root/reference/burstyRoutines.py:14 (burstFFT).

Notes:
  * The CZT chirp phases grow like n^2 — they are precomputed on the host in
    float64 (plan time) and stored at compute precision, so the chirps stay
    accurate at complex64.
  * ``CZT`` is a cached *plan* (the reference's CZTCached/pbIppCZT32fc): the
    chirp vectors ww/fv/aa are weights of a jitted closure; ``run_many``
    batches rows through one padded FFT.
  * ``dft`` against an arbitrary frequency list is a tone-bank matrix product
    (the reference's genTones.cu dotTonesScaling kernels).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from pydsproutines_tpu.utils.dtypes import real_dtype_for
from pydsproutines_tpu.utils.fftlen import next_fast_len


def _chirp_phase_exp(scale: float, kk2: np.ndarray) -> np.ndarray:
    """exp(-1j * scale * kk2) evaluated in float64 with phase wrapped mod 2*pi
    before the complex exponential, to keep precision for large kk2."""
    phase = np.mod(scale * kk2, 2.0 * np.pi)
    return np.exp(-1j * phase)


class CZT:
    """Cached chirp-Z transform plan (Bluestein).

    Evaluates the spectrum of a length-``m`` input at ``k`` bins starting at
    ``f1`` spaced by ``bin_width`` (inclusive of f2): freqs = f1 + arange(k) *
    bin_width, k = int((f2-f1)/bin_width + 1).

    Matches the reference CZTCached (/root/reference/spectralRoutines.py:239):
    nfft = next_fast_len(m + k - 1, maxPrime=7), ww/fv/aa chirp vectors, run =
    x*aa -> fft(nfft) -> *fv -> ifft -> slice*ww.
    """

    def __init__(self, xlength: int, f1: float, f2: float, bin_width: float,
                 fs: float, dtype=jnp.complex64):
        self.f1 = float(f1)
        self.bin_width = float(bin_width)
        self.fs = float(fs)
        self.k = int((f2 - f1) / bin_width + 1)
        self.m = int(xlength)
        self.nfft = next_fast_len(self.m + self.k - 1, max_prime=7)
        self.dtype = jnp.dtype(dtype)

        m, k = self.m, self.k
        kk = np.arange(-m + 1, max(k - 1, m - 1) + 1, dtype=np.float64)
        kk2 = kk * kk / 2.0
        scale = 2.0 * np.pi * (f2 - f1 + bin_width) / (k * fs)
        ww = _chirp_phase_exp(scale, kk2)
        chirpfilter = 1.0 / ww[: k - 1 + m]
        fv = np.fft.fft(chirpfilter, self.nfft)
        nn = np.arange(m, dtype=np.float64)
        aa = np.exp(-1j * np.mod(2.0 * np.pi * f1 / fs * nn, 2.0 * np.pi))
        aa = aa * ww[m + np.arange(m) - 1]

        # Plan constants stay HOST numpy and are embedded as program constants
        # by the per-instance jitted closure below.
        npdt = np.dtype(self.dtype)
        self.ww_tail = ww[m - 1: m + k - 1].astype(npdt)
        self.fv = fv.astype(npdt)
        self.aa = aa.astype(npdt)
        # direct tone-bank path: for modest bin counts a single (m, k) matmul
        # replaces Bluestein's two padded FFTs (the reference makes the same
        # tradeoff, spectralRoutines.py czt vs dft). Engaged when the tone
        # matrix is small enough to embed (<= 32 MB).
        self.tones = None
        if m * k <= 4_000_000:
            t_idx = np.arange(m, dtype=np.float64)
            f_hz = self.freqs().astype(np.float64)
            phase = np.mod(np.outer(t_idx, f_hz / fs), 1.0) * 2.0 * np.pi
            self.tones = np.exp(-1j * phase).astype(npdt)
        self._fn = None

    def freqs(self) -> np.ndarray:
        """Frequency bin centers (host-side, like CZTCached.getFreq)."""
        return np.arange(self.k) * self.bin_width + self.f1

    def __call__(self, x: jnp.ndarray) -> jnp.ndarray:
        """CZT along the last axis. Works for 1-D input or batched rows."""
        if self._fn is None:
            if self.tones is not None:
                tones = self.tones
                self._fn = jax.jit(lambda xx: _czt_direct(xx, tones))
            else:
                aa, fv, ww_tail = self.aa, self.fv, self.ww_tail
                m, k, nfft = self.m, self.k, self.nfft
                self._fn = jax.jit(
                    lambda xx: _czt_core(xx, aa, fv, ww_tail, m, k, nfft))
        return self._fn(x)

    run = __call__
    run_many = __call__


def _czt_direct(x, tones):
    """CZT as one tone-bank matmul (exact direct DFT at the CZT bins)."""
    return jnp.einsum("...t,tk->...k", x, jnp.asarray(tones),
                      precision=jax.lax.Precision.HIGHEST)


def _czt_core(x, aa, fv, ww_tail, m, k, nfft):
    """Bluestein pipeline; ``aa``/``fv``/``ww_tail`` may be host numpy
    constants (closed over) or traced arrays."""
    fy = jnp.fft.fft(x * aa, n=nfft, axis=-1)
    g = jnp.fft.ifft(fy * fv, axis=-1)
    return g[..., m - 1: m + k - 1] * ww_tail


@functools.lru_cache(maxsize=64)
def get_czt_plan(xlength: int, f1: float, f2: float, bin_width: float,
                 fs: float, dtype_str: str = "complex64") -> CZT:
    """Memoized CZT plan factory — reuses the per-plan jitted closures across
    repeated one-shot calls with the same geometry."""
    return CZT(xlength, f1, f2, bin_width, fs, dtype=jnp.dtype(dtype_str))


def czt(x: jnp.ndarray, f1: float, f2: float, bin_width: float, fs: float,
        dtype=None) -> jnp.ndarray:
    """One-shot CZT (reference czt, spectralRoutines.py:77). For repeated use
    with the same geometry build a ``CZT`` plan instead."""
    plan = get_czt_plan(x.shape[-1], float(f1), float(f2), float(bin_width),
                        float(fs),
                        str(jnp.dtype(dtype if dtype is not None else x.dtype)))
    return plan(x)


@functools.partial(jax.jit, static_argnames=("fs",))
def dft(x: jnp.ndarray, freqs: jnp.ndarray, fs: float = 1.0) -> jnp.ndarray:
    """Direct DFT of ``x`` at arbitrary ``freqs`` (reference dft,
    spectralRoutines.py:637): out[i] = sum_n exp(-2j*pi*f_i*n/fs) * x[n].

    Expressed as a (num_freqs, n) tone-bank times the signal.
    """
    rdt = real_dtype_for(x.dtype)
    n = jnp.arange(x.shape[-1], dtype=rdt)
    phase = (-2.0 * jnp.pi / fs) * freqs.astype(rdt)[:, None] * n[None, :]
    tones = jnp.exp(1j * phase).astype(x.dtype)
    return jnp.matmul(tones, x, precision=jax.lax.Precision.HIGHEST)


def tone_spectrum(f0: float, freqs: jnp.ndarray, fs: float, n: int,
                  phi: float = 0.0, amplitude: float = 1.0) -> jnp.ndarray:
    """Analytic spectrum of a length-``n`` tone at ``f0`` evaluated at
    ``freqs`` (reference toneSpectrum, spectralRoutines.py:663):
    -1j*A*(1 - exp(-2j*pi*(f-f0)*N/fs)) / (2*pi*(f-f0)/fs) * exp(1j*phi)."""
    df = freqs - f0
    num = 1.0 - jnp.exp(-1j * 2 * jnp.pi * df * n / fs)
    den = 2 * jnp.pi * df / fs
    safe = jnp.where(den == 0, 1.0, den)
    vals = -1j * amplitude * num / safe * jnp.exp(1j * phi)
    # Removable singularity at f == f0: the L'Hopital limit is A*N*exp(1j*phi).
    return jnp.where(den == 0, amplitude * n * jnp.exp(1j * phi), vals)


class IntegerMultipleFFT:
    """Padded FFT of length multiple*N via ``multiple`` tone-shifted length-N
    FFTs (reference IntegerMultipleFFT, spectralRoutines.py:128).

    This is a batched FFT over a (multiple, N) matrix — the tone table is
    precomputed plan state.
    """

    def __init__(self, multiple: int, unpad_length: int, dtype=jnp.complex64):
        self.multiple = int(multiple)
        self.n = int(unpad_length)
        i = np.arange(self.multiple, dtype=np.float64)[:, None]
        nn = np.arange(self.n, dtype=np.float64)[None, :]
        tones = np.exp(-1j * 2 * np.pi * (i / self.multiple) * (nn / self.n))
        # host numpy, embedded as a program constant (see CZT)
        self.tones = tones.astype(np.dtype(dtype))
        self._fns = {}

    def fft(self, x: jnp.ndarray, reorder: bool = False) -> jnp.ndarray:
        """Row i of the output is fft(x * tone_i). With ``reorder`` the rows
        are interleaved to equal jnp.fft.fft(x, n=multiple*N)."""
        fn = self._fns.get(bool(reorder))
        if fn is None:
            tones = self.tones

            def _impl(xx):
                out = jnp.fft.fft(xx[None, :] * tones, axis=-1)
                return out.T.reshape(-1) if reorder else out

            fn = self._fns.setdefault(bool(reorder), jax.jit(_impl))
        return fn(x)

    @property
    def padded_length(self) -> int:
        return self.multiple * self.n


@functools.partial(jax.jit, static_argnames=("length",))
def burst_fft(x: jnp.ndarray, length: int) -> jnp.ndarray:
    """Overlap-add fold-then-FFT spectrum of length-multiple bursts
    (reference burstFFT, /root/reference/burstyRoutines.py:14): zero-pad x to a
    multiple of ``length``, fold rows, sum, then one length-``length`` FFT."""
    n = x.shape[-1]
    alpha = -(-n // length)
    pad = alpha * length - n
    xp = jnp.pad(x, (0, pad))
    folded = jnp.sum(xp.reshape(-1, length), axis=0)
    return jnp.fft.fft(folded)
