import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as sps

from pydsproutines_tpu.ops.wola import wola, Channeliser


def _np_wola_reference(f_tap, x, Dec, N):
    """Direct re-derivation of the reference wola() loop
    (filterRoutines.py:578)."""
    L = len(f_tap)
    nprimePts = len(x) // Dec
    out = np.zeros((nprimePts, N), dtype=np.complex128)
    for nprime in range(nprimePts):
        n = nprime * Dec
        dft_in = np.zeros(N, dtype=np.complex128)
        for a in range(N):
            for b in range(L // N):
                if n - (b * N + a) >= 0:
                    dft_in[a] += x[n - (b * N + a)] * f_tap[b * N + a]
        out[nprime] = np.fft.ifft(dft_in) * N
        if Dec * 2 == N and nprime % 2 != 0:
            out[nprime][1::2] = -out[nprime][1::2]
    return out


def test_wola_matches_reference_n_eq_dec(rng):
    N = Dec = 8
    f_tap = sps.firwin(8 * N, 1.0 / Dec)
    x = (rng.standard_normal(256) + 1j * rng.standard_normal(256))
    ours = np.asarray(wola(jnp.asarray(f_tap), jnp.asarray(x), Dec, N))
    ref = _np_wola_reference(f_tap, x, Dec, N)
    assert ours.shape == ref.shape
    assert np.max(np.abs(ours - ref)) < 1e-9


def test_wola_matches_reference_n_eq_2dec(rng):
    Dec, N = 4, 8
    f_tap = sps.firwin(4 * N, 1.0 / Dec)
    x = (rng.standard_normal(200) + 1j * rng.standard_normal(200))
    ours = np.asarray(wola(jnp.asarray(f_tap), jnp.asarray(x), Dec, N))
    ref = _np_wola_reference(f_tap, x, Dec, N)
    assert np.max(np.abs(ours - ref)) < 1e-9


def test_wola_channel_extraction(rng):
    """A tone centred on channel k should appear with dominant energy in
    channel k of the WOLA output."""
    N = Dec = 16
    fs = 1.0
    f_tap = sps.firwin(8 * N, 1.0 / Dec)
    k = 3
    f0 = k / N * fs
    nsamps = 4096
    t = np.arange(nsamps)
    x = np.exp(1j * 2 * np.pi * f0 * t / fs)
    out = np.asarray(wola(jnp.asarray(f_tap), jnp.asarray(x), Dec, N))
    energy = np.mean(np.abs(out[8:]) ** 2, axis=0)  # skip warm-up
    assert np.argmax(energy) == k
    assert energy[k] > 100 * np.sort(energy)[-2]


def test_channeliser_streaming_continuity(rng):
    """Two sequential channelise() calls must equal one call on the
    concatenated input (reference Channeliser delay + warm-up discard)."""
    Dec = N = 8
    numtaps = 4 * N
    x = (rng.standard_normal(512) + 1j * rng.standard_normal(512)).astype(np.complex64)

    c1 = Channeliser(num_taps=numtaps, num_channels=N, dec=Dec)
    out_a = np.asarray(c1.channelise(jnp.asarray(x[:256])))
    out_b = np.asarray(c1.channelise(jnp.asarray(x[256:])))
    seq = np.vstack([out_a, out_b])

    c2 = Channeliser(num_taps=numtaps, num_channels=N, dec=Dec)
    full = np.asarray(c2.channelise(jnp.asarray(x)))

    assert seq.shape == full.shape
    assert np.max(np.abs(seq - full)) < 1e-5


def test_channeliser_freqs():
    c = Channeliser(num_taps=32, num_channels=8, dec=8)
    f = np.asarray(c.channel_freqs(8000.0))
    assert f[0] == 0
    assert f.min() < 0  # wrapped axis
    assert c.channel_fs(8000.0) == 1000.0


def _np_wola_vectorized(f_tap, x, dec, n):
    """float64 reference: the same fold as _np_wola_reference, vectorized
    over output rows (a (rows, L) window gather)."""
    L = len(f_tap)
    rows = len(x) // dec
    idx = np.arange(rows)[:, None] * dec - np.arange(L)[None, :]
    win = np.where(idx >= 0, x[np.clip(idx, 0, None)], 0)
    folded = (win * f_tap[None, :]).reshape(rows, L // n, n).sum(axis=1)
    out = np.fft.ifft(folded, axis=-1) * n
    if n == 2 * dec:
        out[1::2, 1::2] *= -1
    return out


@pytest.mark.parametrize("rows", [301, 600])
@pytest.mark.parametrize("nch,B", [(64, 32), (128, 16), (256, 8)])
def test_wola_float64_reference_wide(rng, nch, B, rows):
    """complex64 WOLA at channelizer widths agrees with a float64 reference
    to float32 grade, including ragged tails (len(x) not a row multiple)."""
    h = np.hanning(nch * B)
    x = (rng.standard_normal(rows * nch + nch // 3)
         + 1j * rng.standard_normal(rows * nch + nch // 3))
    x = x.astype(np.complex64)
    got = np.asarray(wola(jnp.asarray(h, jnp.float32), jnp.asarray(x),
                          nch, nch))
    ref = _np_wola_vectorized(h, x.astype(np.complex128), nch, nch)
    assert got.shape == ref.shape == (rows, nch)
    assert np.max(np.abs(got - ref)) / np.max(np.abs(ref)) < 2e-6


@pytest.mark.parametrize("dec", [32, 64, 128])
def test_wola_float64_reference_oversampled(rng, dec):
    """n == 2*dec (oversampled) at channelizer widths, odd-row flip
    included, agrees with the float64 reference."""
    n = 2 * dec
    h = np.hanning(n * 8)
    x = (rng.standard_normal(dec * 333)
         + 1j * rng.standard_normal(dec * 333)).astype(np.complex64)
    got = np.asarray(wola(jnp.asarray(h, jnp.float32), jnp.asarray(x),
                          dec, n))
    ref = _np_wola_vectorized(h, x.astype(np.complex128), dec, n)
    assert got.shape == ref.shape
    assert np.max(np.abs(got - ref)) / np.max(np.abs(ref)) < 2e-6


@pytest.mark.parametrize("dec,n", [(16, 16), (8, 16)])
def test_wola_complex_taps(rng, dec, n):
    """Complex prototype taps (frequency-shifted filters) fold with their
    imaginary part on both geometries."""
    L = 4 * n
    h = sps.firwin(L, 1.0 / dec) * np.exp(2j * np.pi * 0.1 * np.arange(L))
    x = rng.standard_normal(dec * 50) + 1j * rng.standard_normal(dec * 50)
    got = np.asarray(wola(jnp.asarray(h), jnp.asarray(x), dec, n))
    ref = _np_wola_reference(h, x, dec, n)
    assert np.max(np.abs(got - ref)) < 1e-9


def test_wola_planes_matches_complex_api(rng):
    """wola_planes (quadrature-plane I/O) must equal wola on the complex
    array, on both supported geometries."""
    from pydsproutines_tpu.ops.wola import wola, wola_planes

    h = rng.standard_normal(512).astype(np.float32)
    x = (rng.standard_normal(64 * 300)
         + 1j * rng.standard_normal(64 * 300)).astype(np.complex64)
    for dec, n in ((64, 64), (32, 64)):
        ref = np.asarray(wola(jnp.asarray(h), jnp.asarray(x), dec, n))
        o_re, o_im = wola_planes(jnp.asarray(h),
                                 jnp.asarray(x.real.astype(np.float32)),
                                 jnp.asarray(x.imag.astype(np.float32)),
                                 dec, n)
        got = np.asarray(o_re) + 1j * np.asarray(o_im)
        assert got.shape == ref.shape
        assert np.max(np.abs(got - ref)) < 1e-9


def test_wola_planes_flat_matches(rng):
    """Flat-plane surface returns the row-major channel matrix bytes."""
    from pydsproutines_tpu.ops.wola import wola, wola_planes_flat

    h = rng.standard_normal(512).astype(np.float32)
    x = (rng.standard_normal(64 * 300)
         + 1j * rng.standard_normal(64 * 300)).astype(np.complex64)
    ref = np.asarray(wola(jnp.asarray(h), jnp.asarray(x), 64, 64))
    f_re, f_im = wola_planes_flat(jnp.asarray(h),
                                  jnp.asarray(x.real.astype(np.float32)),
                                  jnp.asarray(x.imag.astype(np.float32)),
                                  64, 64)
    got = (np.asarray(f_re) + 1j * np.asarray(f_im)).reshape(ref.shape)
    assert np.max(np.abs(got - ref)) < 1e-9
