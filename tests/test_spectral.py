import jax.numpy as jnp
import numpy as np

from pydsproutines_tpu.ops import (
    CZT,
    czt,
    dft,
    tone_spectrum,
    IntegerMultipleFFT,
    burst_fft,
)


def _np_czt_reference(x, f1, f2, binWidth, fs):
    """Direct DFT evaluation at the CZT frequency grid — analytic ground
    truth, independent of the Bluestein algorithm."""
    k = int((f2 - f1) / binWidth + 1)
    freqs = f1 + np.arange(k) * binWidth
    n = np.arange(len(x))
    return np.array([np.sum(x * np.exp(-2j * np.pi * f * n / fs)) for f in freqs])


def test_czt_matches_direct_dft(rng):
    n = 400
    fs = 1000.0
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex128)
    f1, f2, step = -100.0, 100.0, 2.5
    plan = CZT(n, f1, f2, step, fs, dtype=jnp.complex128)
    ours = np.asarray(plan(jnp.asarray(x)))
    ref = _np_czt_reference(x, f1, f2, step, fs)
    assert np.max(np.abs(ours - ref)) / np.max(np.abs(ref)) < 1e-9
    # frequency grid
    assert np.allclose(plan.freqs(), f1 + np.arange(plan.k) * step)


def test_czt_complex64_tolerance(rng):
    n = 1000
    fs = 10000.0
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
    f1, f2, step = 0.0, 500.0, 5.0
    ours = np.asarray(czt(jnp.asarray(x), f1, f2, step, fs))
    ref = _np_czt_reference(x.astype(np.complex128), f1, f2, step, fs)
    assert np.max(np.abs(ours - ref)) / np.max(np.abs(ref)) < 1e-4


def test_czt_batched_rows(rng):
    n, b = 128, 4
    fs = 100.0
    x = (rng.standard_normal((b, n)) + 1j * rng.standard_normal((b, n)))
    plan = CZT(n, -10.0, 10.0, 0.5, fs, dtype=jnp.complex128)
    batched = np.asarray(plan(jnp.asarray(x)))
    for i in range(b):
        single = np.asarray(plan(jnp.asarray(x[i])))
        assert np.allclose(batched[i], single)


def test_dft_matches_fft_bins(rng):
    n = 64
    x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    fs = 1.0
    freqs = np.arange(n) / n * fs
    ours = np.asarray(dft(jnp.asarray(x), jnp.asarray(freqs), fs))
    ref = np.fft.fft(x)
    assert np.max(np.abs(ours - ref)) < 1e-9


def test_tone_spectrum_matches_dft_of_tone():
    fs = 1000.0
    n = 512
    f0 = 123.456
    phi = 0.7
    t = np.arange(n) / fs
    x = np.exp(1j * (2 * np.pi * f0 * t + phi))
    freqs = np.linspace(f0 - 5, f0 + 5, 21)
    analytic = np.asarray(tone_spectrum(f0, jnp.asarray(freqs), fs, n, phi=phi))
    direct = np.array([np.sum(x * np.exp(-2j * np.pi * f * t)) for f in freqs])
    # The analytic formula is the continuous-integral approximation; agreement
    # is to ~1/N relative.
    rel = np.abs(analytic - direct) / np.max(np.abs(direct))
    assert np.max(rel) < 5e-3


def test_integer_multiple_fft_reorder(rng):
    n, mult = 100, 7
    x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    imfft = IntegerMultipleFFT(mult, n, dtype=jnp.complex128)
    ours = np.asarray(imfft.fft(jnp.asarray(x), reorder=True))
    ref = np.fft.fft(x, n=n * mult)
    assert np.max(np.abs(ours - ref)) < 1e-8


def test_burst_fft(rng):
    length = 32
    x = rng.standard_normal(100) + 1j * rng.standard_normal(100)
    ours = np.asarray(burst_fft(jnp.asarray(x), length))
    xp = np.pad(x, (0, 4 * length - 100))
    ref = np.fft.fft(xp.reshape(-1, length).sum(axis=0))
    assert np.max(np.abs(ours - ref)) < 1e-9
