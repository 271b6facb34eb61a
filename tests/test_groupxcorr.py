import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pydsproutines_tpu.ops.groupxcorr import (
    GroupXcorr,
    GroupXcorrCZT,
    GroupXcorrFFT,
    TemplateCrossCorrelator,
)
from pydsproutines_tpu.signal import rand_psk_syms


def _np_group_xcorr_czt_reference(y, starts, lengths, f1, f2, binWidth, fs,
                                  rx, shifts):
    """Re-derivation of reference GroupXcorrCZT.xcorr (xcorrRoutines.py:996)
    using direct DFT evaluation at the CZT grid (analytic ground truth)."""
    starts = starts - starts[0]
    numGroups = len(starts)
    maxLength = int(np.max(lengths))
    ystack = np.zeros((numGroups, maxLength), dtype=complex)
    for i in range(numGroups):
        ystack[i, : lengths[i]] = y[starts[i]: starts[i] + lengths[i]]
    ystack = ystack.conj()
    ystackNormSq = np.linalg.norm(ystack.flatten()) ** 2

    k = int((f2 - f1) / binWidth + 1)
    cztFreq = f1 + np.arange(k) * binWidth
    nn = np.arange(maxLength)
    dftmat = np.exp(-2j * np.pi * cztFreq[:, None] * nn[None, :] / fs)
    groupPhases = np.exp(-2j * np.pi * cztFreq * starts.reshape(-1, 1) / fs)

    xc = np.zeros((len(shifts), k))
    for i, shift in enumerate(shifts):
        combined = np.zeros(k, dtype=complex)
        rxNormSq = 0.0
        for g in range(numGroups):
            ygroup = ystack[g, : lengths[g]]
            rxgroup = rx[shift + starts[g]: shift + starts[g] + lengths[g]]
            rxNormSq += np.linalg.norm(rxgroup) ** 2
            pdt = np.zeros(maxLength, dtype=complex)
            pdt[: lengths[g]] = ygroup * rxgroup
            pdtczt = dftmat @ pdt
            combined += pdtczt * groupPhases[g]
        xc[i] = np.abs(combined) ** 2 / rxNormSq / ystackNormSq
    return xc, cztFreq


def _make_bursty_scene(key, num_groups=3, glen=128, gap=64, rxlen=2048,
                       offset=300, fshift=0.0, noise=0.05):
    """Bursts of one signal placed periodically; returns (y, starts, lengths,
    rx) where y is the burst concatenation layout at offset 0 and rx contains
    it at ``offset``."""
    ks = jax.random.split(key, num_groups + 1)
    starts = np.arange(num_groups) * (glen + gap)
    lengths = np.full(num_groups, glen)
    y = np.zeros(starts[-1] + glen, dtype=np.complex128)
    for i in range(num_groups):
        s, _ = rand_psk_syms(ks[i], glen, 4, dtype=jnp.complex128)
        y[starts[i]: starts[i] + glen] = np.asarray(s)
    rng = np.random.default_rng(7)
    rx = noise * (rng.standard_normal(rxlen) + 1j * rng.standard_normal(rxlen))
    sig = y * np.exp(1j * 2 * np.pi * fshift * np.arange(y.size))
    rx[offset: offset + y.size] += sig
    return y, starts, lengths, rx


def test_group_xcorr_czt_parity_and_peak(key):
    y, starts, lengths, rx = _make_bursty_scene(key, fshift=0.004)
    shifts = np.arange(295, 306)
    gx = GroupXcorrCZT(y, starts, lengths, f1=-0.01, f2=0.01, bin_width=5e-4,
                       fs=1.0, dtype=jnp.complex128)
    xc, freqs = gx.xcorr(jnp.asarray(rx), jnp.asarray(shifts))
    xc = np.asarray(xc)
    ref, ref_freqs = _np_group_xcorr_czt_reference(
        y, starts, lengths, -0.01, 0.01, 5e-4, 1.0, rx, shifts)
    assert np.allclose(freqs, ref_freqs)
    assert np.max(np.abs(xc - ref)) < 1e-6
    si, fi = np.unravel_index(np.argmax(xc), xc.shape)
    assert shifts[si] == 300
    assert abs(freqs[fi] - 0.004) < 5e-4


def test_group_xcorr_fft_peak(key):
    y, starts, lengths, rx = _make_bursty_scene(key)
    glen = lengths[0]
    ygroups = np.stack([y[s: s + glen] for s in starts])
    gx = GroupXcorrFFT(ygroups, starts, fs=1.0, dtype=jnp.complex128)
    shifts = np.arange(290, 311)
    xc = np.asarray(gx.xcorr(jnp.asarray(rx), jnp.asarray(shifts)))
    assert xc.shape == (21, glen)
    si, fi = np.unravel_index(np.argmax(xc), xc.shape)
    assert shifts[si] == 300
    assert fi == 0  # no frequency offset
    # coherent combining: QF2 at the peak should be near 1 (low noise)
    assert xc[si, fi] > 0.8


def test_group_xcorr_fft_vs_single_group_fast_xcorr(key):
    """With one group, GroupXcorrFFT equals fastXcorr freq-scan CAF rows."""
    from pydsproutines_tpu.ops import fast_xcorr
    y, starts, lengths, rx = _make_bursty_scene(key, num_groups=1)
    glen = lengths[0]
    ygroups = y[None, :glen]
    gx = GroupXcorrFFT(ygroups, starts[:1], fs=1.0, dtype=jnp.complex128)
    shifts = np.arange(295, 305)
    xc = np.asarray(gx.xcorr(jnp.asarray(rx), jnp.asarray(shifts)))
    caf = np.asarray(fast_xcorr(jnp.asarray(y[:glen]), jnp.asarray(rx),
                                freqsearch=True, output_caf=True,
                                shifts=jnp.asarray(shifts)))
    assert np.max(np.abs(xc - caf)) < 1e-9


def test_group_xcorr_freq_list(key):
    y, starts, lengths, rx = _make_bursty_scene(key, fshift=0.003)
    freqs = np.arange(-0.01, 0.0101, 1e-3)
    gx = GroupXcorr(y, starts, lengths, freqs, fs=1.0, dtype=jnp.complex128)
    shifts = np.arange(295, 306)
    xc, fpeaks = gx.xcorr(jnp.asarray(rx), jnp.asarray(shifts))
    xc = np.asarray(xc)
    i = np.argmax(xc)
    assert shifts[i] == 300
    assert abs(np.asarray(fpeaks)[i] - 0.003) < 1e-3
    assert xc[i] > 0.8


def test_template_cross_correlator(key):
    k1, k2, k3 = jax.random.split(key, 3)
    t1, _ = rand_psk_syms(k1, 64, 4, dtype=jnp.complex128)
    t2, _ = rand_psk_syms(k2, 64, 4, dtype=jnp.complex128)
    templates = np.stack([np.asarray(t1), np.asarray(t2)])
    n = 512
    rng = np.random.default_rng(3)
    x = 0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    x[100:164] += np.asarray(t1)
    x[300:364] += np.asarray(t2)

    tcc = TemplateCrossCorrelator(templates, n, dtype=jnp.complex128)
    nout = np.asarray(tcc.correlate(jnp.asarray(x)))
    assert nout.shape == (2, n - 64 + 1)
    # QF (not QF^2) ~ 1 at the right places
    assert abs(np.abs(nout[0, 100]) - 1.0) < 0.05
    assert abs(np.abs(nout[1, 300]) - 1.0) < 0.05

    best, idx = tcc.correlate(jnp.asarray(x), return_max=True)
    best, idx = np.asarray(best), np.asarray(idx)
    assert idx[100] == 0 and idx[300] == 1
    assert best[100] > 0.9 and best[300] > 0.9


def test_multi_preamble_correlator(key):
    """FFT-subset multi-preamble correlator (reference ippMultiCorrelator
    design README, implemented here): finds the right preamble, time index,
    and carrier-offset column on a synthetic oversampled scene."""
    import scipy.signal as sps
    from pydsproutines_tpu.ops import MultiPreambleCorrelator
    from pydsproutines_tpu.signal import rand_psk_syms

    rng = np.random.default_rng(9)
    k_, l_, osr = 3, 32, 4
    fsp = 1000.0
    fs = osr * fsp
    pres = np.stack([
        np.asarray(rand_psk_syms(jax.random.key(i), l_, 4,
                                 dtype=jnp.complex128)[0])
        for i in range(k_)]).astype(np.complex64)
    # oversample preamble 1 and plant it with a one-bin carrier offset
    up = sps.resample_poly(pres[1], osr, 1).astype(np.complex64)
    n = 4000
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)
         ).astype(np.complex64) * 0.05
    start = 1234
    df = fsp / l_   # one preamble bin
    tone = np.exp(2j * np.pi * df * np.arange(up.size) / fs)
    x[start:start + up.size] += (up * tone).astype(np.complex64)

    mc = MultiPreambleCorrelator(pres, osr)
    shifts = np.arange(1200, 1280)
    qf2 = np.asarray(mc.correlate(jnp.asarray(x), jnp.asarray(shifts)))
    assert qf2.shape == (k_, shifts.size, mc.c)
    ki, si, ci = np.unravel_index(np.argmax(qf2), qf2.shape)
    assert ki == 1
    assert shifts[si] == start
    offs = mc.freq_offsets(fsp)
    assert abs(offs[ci] - df) < fsp / l_ / 2 + 1e-9
    assert qf2[ki, si, ci] > 0.5


@pytest.mark.parametrize("num_groups,nshifts,batch_size,uneven", [
    (4, 64, 64, False),     # one full chunk
    (3, 40, 16, False),     # 2.5 chunks: ragged last chunk trimmed
    (3, 37, 8, True),       # ragged chunk and unequal group lengths
])
def test_group_xcorr_czt_ragged_tail_numpy(rng, num_groups, nshifts,
                                          batch_size, uneven):
    """complex64 GroupXcorrCZT over a shift count that does not fill the
    last chunk matches the float64 NumPy reference on the whole grid and
    finds the planted shift."""
    fs = 1e6
    glen = 128
    starts = np.arange(num_groups) * 384
    lengths = np.full(num_groups, glen)
    if uneven:
        lengths[-1] = glen - 29
    span = int(starts[-1] + glen)
    y = (rng.standard_normal(span)
         + 1j * rng.standard_normal(span)).astype(np.complex64)
    rx = (0.05 * (rng.standard_normal(span + 300)
                  + 1j * rng.standard_normal(span + 300))).astype(np.complex64)
    true_shift = 97
    rx[true_shift: true_shift + span] += y
    bw = fs / glen / 2
    gx = GroupXcorrCZT(y, starts, lengths, -8 * bw, 7 * bw, bw, fs)
    shifts = np.arange(80, 80 + nshifts)
    got, _ = gx.xcorr(jnp.asarray(rx), jnp.asarray(shifts),
                      batch_size=batch_size)
    got = np.asarray(got)
    ref, _ = _np_group_xcorr_czt_reference(
        y.astype(np.complex128), starts, lengths, -8 * bw, 7 * bw, bw, fs,
        rx.astype(np.complex128), shifts)
    assert got.shape == ref.shape == (nshifts, gx.plan.k)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5 * ref.max())
    si, _ = np.unravel_index(np.argmax(got), got.shape)
    assert shifts[si] == true_shift
