import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as sps

from pydsproutines_tpu.ops.filters import (
    lfilter_fir,
    StreamFilter,
    upfirdn,
    get_upfirdn_size,
    StreamUpfirdn,
    moving_average,
    complex_moving_sum,
    medfilt,
    resample_factor_wizard,
)


def test_lfilter_fir_matches_scipy(rng):
    taps = sps.firwin(31, 0.25)
    x = (rng.standard_normal(500) + 1j * rng.standard_normal(500))
    ours = np.asarray(lfilter_fir(jnp.asarray(taps), jnp.asarray(x)))
    ref = sps.lfilter(taps, 1.0, x)
    assert np.max(np.abs(ours - ref)) < 1e-9


def test_lfilter_fir_fft_method(rng):
    taps = sps.firwin(129, 0.1)
    x = (rng.standard_normal(2000) + 1j * rng.standard_normal(2000))
    ours = np.asarray(lfilter_fir(jnp.asarray(taps), jnp.asarray(x), method="fft"))
    ref = sps.lfilter(taps, 1.0, x)
    assert np.max(np.abs(ours - ref)) < 1e-7


def test_stream_filter_block_continuity(rng):
    """Filtering in blocks must equal filtering the whole signal at once
    (reference CupyFilter delay-line semantics)."""
    taps = sps.firwin(64, 0.2)
    x = (rng.standard_normal(1024) + 1j * rng.standard_normal(1024))
    ref = sps.lfilter(taps, 1.0, x)

    sf = StreamFilter(jnp.asarray(taps), dtype=jnp.complex128)
    blocks = [np.asarray(sf.lfilter(jnp.asarray(x[i: i + 256])))
              for i in range(0, 1024, 256)]
    ours = np.concatenate(blocks)
    assert np.max(np.abs(ours - ref)) < 1e-9


def test_upfirdn_matches_scipy(rng):
    taps = sps.firwin(48, 0.2)
    x = rng.standard_normal(301) + 1j * rng.standard_normal(301)
    for up, down in [(1, 1), (3, 2), (2, 3), (5, 4), (1, 7)]:
        ours = np.asarray(upfirdn(jnp.asarray(taps), jnp.asarray(x), up, down))
        ref = sps.upfirdn(taps, x, up, down)
        assert ours.shape == ref.shape, (up, down, ours.shape, ref.shape)
        assert get_upfirdn_size(len(x), len(taps), up, down) == len(ref)
        assert np.max(np.abs(ours - ref)) < 1e-9, (up, down)


def test_upfirdn_batched_rows(rng):
    taps = sps.firwin(16, 0.3)
    x = rng.standard_normal((3, 100)) + 1j * rng.standard_normal((3, 100))
    ours = np.asarray(upfirdn(jnp.asarray(taps), jnp.asarray(x), 2, 3))
    for i in range(3):
        ref = sps.upfirdn(taps, x[i], 2, 3)
        assert np.max(np.abs(ours[i] - ref)) < 1e-9


def test_stream_upfirdn_continuity(rng):
    """Block-wise resample matches the reference run_upfirdn skip logic."""
    taps = sps.firwin(32, 0.25)
    up, down, mem = 2, 4, 64
    x = rng.standard_normal(1024) + 1j * rng.standard_normal(1024)

    su = StreamUpfirdn(jnp.asarray(taps), up, down, memory=mem,
                       dtype=jnp.complex128)
    blocks = [np.asarray(su.resample(jnp.asarray(x[i: i + 256])))
              for i in range(0, 1024, 256)]
    ours = np.concatenate(blocks)

    # reference equivalent: upfirdn of [zeros(mem), x] with the same skip
    full = sps.upfirdn(taps, np.concatenate([np.zeros(mem), x[:256]]), up, down)
    skip = mem * up // down
    assert np.allclose(blocks[0], full[skip: skip + 256 * up // down])
    # continuity: block 2 must continue where an extended run would
    full2 = sps.upfirdn(taps, np.concatenate([x[256 - mem: 256], x[256:512]]), up, down)
    assert np.allclose(blocks[1], full2[skip: skip + 256 * up // down])


def test_moving_average_matches_lfilter(rng):
    L = 8
    x = rng.standard_normal(100).astype(np.float32)
    ours = np.asarray(moving_average(jnp.asarray(x), L))
    ref = sps.lfilter(np.ones(L) / L, 1.0, x)
    assert np.max(np.abs(ours - ref)) < 1e-5
    # 2-D rows
    x2 = rng.standard_normal((4, 64)).astype(np.float32)
    ours2 = np.asarray(moving_average(jnp.asarray(x2), L))
    for i in range(4):
        ref2 = sps.lfilter(np.ones(L) / L, 1.0, x2[i])
        assert np.max(np.abs(ours2[i] - ref2)) < 1e-5


def test_complex_moving_sum(rng):
    L = 5
    x = (rng.standard_normal(50) + 1j * rng.standard_normal(50)).astype(np.complex64)
    ours = np.asarray(complex_moving_sum(jnp.asarray(x), L))
    ref = np.array([np.abs(np.sum(x[i: i + L])) ** 2 for i in range(50 - L + 1)])
    assert ours.shape == (46,)
    assert np.max(np.abs(ours - ref)) < 1e-3


def test_medfilt_matches_scipy(rng):
    x = rng.standard_normal(200)
    for k in (3, 5, 9):
        ours = np.asarray(medfilt(jnp.asarray(x), k))
        ref = sps.medfilt(x, k)
        assert np.max(np.abs(ours - ref)) < 1e-12, k


def test_resample_factor_wizard():
    assert resample_factor_wizard(48000, 44100) == (147, 160)
    assert resample_factor_wizard(100, 200) == (2, 1)


def test_upfirdn_polyphase_grid_matches_scipy(rng):
    """Exhaustive (up, down, taps, n) grid incl. down > up, taps shorter than
    up, and coprime/non-coprime factor pairs — pins the strided polyphase
    formulation against scipy exactly (reference upfirdn.cu parity)."""
    for up in (1, 2, 3, 5, 8):
        for down in (1, 2, 3, 5, 7):
            for T in (1, 4, 15, 101):
                for n in (1, 17, 256):
                    x = rng.standard_normal(n)
                    h = rng.standard_normal(T)
                    ref = sps.upfirdn(h, x, up, down)
                    got = np.asarray(
                        upfirdn(jnp.asarray(h), jnp.asarray(x), up, down))
                    assert got.shape == ref.shape, (up, down, T, n)
                    np.testing.assert_allclose(
                        got, ref, atol=1e-5, rtol=1e-4,
                        err_msg=str((up, down, T, n)))


def test_upfirdn_complex_taps_and_signal(rng):
    x = (rng.standard_normal(200)
         + 1j * rng.standard_normal(200)).astype(np.complex64)
    h = rng.standard_normal(31).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(upfirdn(jnp.asarray(h), jnp.asarray(x), 4, 3)),
        sps.upfirdn(h, x, 4, 3), atol=1e-4)
    hc = (rng.standard_normal(31)
          + 1j * rng.standard_normal(31)).astype(np.complex64)
    np.testing.assert_allclose(
        np.asarray(upfirdn(jnp.asarray(hc), jnp.asarray(x), 3, 5)),
        sps.upfirdn(hc, x, 3, 5), atol=1e-4)


@pytest.mark.parametrize("up,down,T", [(5, 4, 95), (5, 4, 730), (3, 2, 41),
                                        (1, 4, 257), (2, 3, 16)])
def test_upfirdn_scipy_parity_grid(rng, up, down, T):
    """complex64 upfirdn (real taps) is float32-grade against scipy's
    float64 upfirdn across rational ratios and tap counts, including
    outputs that span several 128-aligned blocks plus a ragged tail."""
    from pydsproutines_tpu.ops.filters import get_upfirdn_size

    cols = 128 * (up // np.gcd(up, down))
    n = int(np.ceil(2 * 128 * cols * down / up)) // 8 + 777
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)
         ).astype(np.complex64)
    h = rng.standard_normal(T).astype(np.float32)
    got = np.asarray(upfirdn(jnp.asarray(h), jnp.asarray(x), up, down))
    ref = sps.upfirdn(h.astype(np.float64), x.astype(np.complex128),
                      up, down)
    assert got.shape == ref.shape == (get_upfirdn_size(n, T, up, down),)
    np.testing.assert_allclose(got, ref, atol=2e-4 * np.sqrt(T), rtol=1e-4,
                               err_msg=str((up, down, T)))


def test_fir_upfirdn_fused_matches_chain(rng):
    """fir_upfirdn == upfirdn(lfilter_fir(...)) on all but the documented
    FIR-tail region, and == full-conv scipy semantics everywhere."""
    from pydsproutines_tpu.ops.filters import fir_upfirdn, lfilter_fir

    n, t1, t2, up, down = 4096, 64, 33, 5, 4
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)
         ).astype(np.complex64)
    h1 = rng.standard_normal(t1).astype(np.float32)
    h2 = rng.standard_normal(t2).astype(np.float32)
    fused = np.asarray(fir_upfirdn(jnp.asarray(h1), jnp.asarray(h2),
                                   jnp.asarray(x), up, down))
    chain = np.asarray(upfirdn(jnp.asarray(h2),
                               lfilter_fir(jnp.asarray(h1), jnp.asarray(x)),
                               up, down))
    assert fused.shape == chain.shape
    tail = -(-(t2 - 1) // down)
    np.testing.assert_allclose(fused[:-tail], chain[:-tail],
                               atol=1e-3, rtol=1e-4)
    # full-conv truth: the fused tail is the scipy-correct one
    y64 = np.convolve(h1.astype(np.float64), x.astype(np.complex128))
    z64 = sps.upfirdn(h2.astype(np.float64), y64, up, down)
    np.testing.assert_allclose(fused, z64[:len(fused)], atol=1e-3, rtol=1e-4)


def test_medfilt_chunked_path_matches_one_shot(rng, monkeypatch):
    """Force the streaming chunked path (long-capture memory bound) and pin
    it to scipy."""
    import pydsproutines_tpu.ops.filters as F

    x = rng.standard_normal(40_000).astype(np.float32)
    ref = sps.medfilt(x, 11)
    monkeypatch.setattr(F, "_MEDFILT_ELEMS", 1 << 16)
    got = np.asarray(F.medfilt.__wrapped__(jnp.asarray(x), 11))
    np.testing.assert_allclose(got, ref)


@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("n,k", [(5000, 129), (4096, 5), (700, 31),
                                 (2048, 255)])
def test_medfilt_scipy_exact(rng, monkeypatch, n, k, chunked):
    """medfilt bit-matches scipy across window sizes, one-shot and through
    the chunked long-capture path."""
    import pydsproutines_tpu.ops.filters as F

    x = rng.standard_normal(n).astype(np.float32)
    if chunked:
        monkeypatch.setattr(F, "_MEDFILT_ELEMS", 1 << 14)
    got = np.asarray(F.medfilt.__wrapped__(jnp.asarray(x), k))
    assert np.array_equal(got, sps.medfilt(x, k)), (n, k, chunked)


def test_fir_upfirdn_planes_flat_matches(rng):
    """Flat-plane chain surface == fir_upfirdn on the complex array."""
    from pydsproutines_tpu.ops.filters import (fir_upfirdn,
                                               fir_upfirdn_planes_flat)
    n = 4096
    x = (rng.standard_normal(n)
         + 1j * rng.standard_normal(n)).astype(np.complex64)
    h1 = rng.standard_normal(32).astype(np.float32)
    h2 = rng.standard_normal(19).astype(np.float32)
    for up, down in ((5, 4), (3, 7), (1, 1)):
        ref = np.asarray(fir_upfirdn(jnp.asarray(h1), jnp.asarray(h2),
                                     jnp.asarray(x), up, down))
        o_re, o_im = fir_upfirdn_planes_flat(
            jnp.asarray(h1), jnp.asarray(h2),
            jnp.asarray(x.real.astype(np.float32)),
            jnp.asarray(x.imag.astype(np.float32)), up, down)
        got = np.asarray(o_re) + 1j * np.asarray(o_im)
        assert got.shape == ref.shape, (up, down)
        scale = max(1.0, np.abs(ref).max())
        assert np.max(np.abs(got - ref)) / scale < 1e-6, (up, down)
