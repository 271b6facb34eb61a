#!/usr/bin/env python
"""End-to-end TDOA/FDOA workflow walkthrough.

Mirrors the reference's implied processing pipeline (SURVEY.md §3.6,
/root/reference: signalCreationRoutines -> xcorrRoutines -> xcorrDatabase ->
localizationRoutines) in one runnable script:

  1. synthesize a two-receiver scene: the same QPSK burst arrives at two
     receivers with a relative delay (sub-sample) and Doppler offset
  2. coarse search: frequency-scanning sliding xcorr (`fast_xcorr`) finds
     the integer-sample delay and coarse frequency bin
  3. fine search: CZT frequency zoom + steering-vector sub-sample time
     refinement (`fine_freq_time_search`)
  4. quality + accuracy bounds: QF^2 -> effective SNR -> Stein sigma_DTO
  5. persist to `XcorrDB`, then localize with a TDOA grid search

Runs in a few seconds (`python examples/tdoa_pipeline.py`) on whatever
device JAX finds: the GPU when there is one, else the CPU.
"""

import sys
import os
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

from pydsproutines_tpu.signal import rand_psk_syms, add_sig_to_noise
from pydsproutines_tpu.signal.creation import propagate_signal
from pydsproutines_tpu.ops import (
    fast_xcorr, czt_xcorr, fine_freq_time_search,
    convert_qf2_to_eff_snr, sigma_dto,
)
from pydsproutines_tpu.io.xcorrdb import XcorrDB
from pydsproutines_tpu.estimation.localization import grid_search_tdoa


def main():
    fs = 100e3                      # channel sample rate [Hz]
    n = 8192                        # burst length [samples]
    true_td = 1234.5 / fs           # true relative delay: 1234.5 samples
    true_fd = 213.4                 # true Doppler offset [Hz]
    snr = 100.0                     # in-band linear SNR at each receiver

    key = jax.random.PRNGKey(0)
    k1, k2, k3 = jax.random.split(key, 3)
    burst, _ = rand_psk_syms(k1, n, 4)

    # receiver 1 sees the burst at index 1000; receiver 2 sees it 1234.5
    # samples later with a Doppler shift. propagate_signal applies the
    # sub-sample delay via an FFT phase ramp (reference propagateSignal).
    _, rx1 = add_sig_to_noise(k2, burst, noise_len=16384, sig_start_idx=1000,
                              snr_inband_linear=snr)
    delayed, _ = propagate_signal(burst, 0.5 / fs, fs, freq=true_fd)
    out = add_sig_to_noise(k3, delayed, noise_len=16384, sig_start_idx=2234,
                           snr_inband_linear=snr)
    rx2 = out[1].astype(jnp.complex64)
    rx1 = rx1.astype(jnp.complex64)

    # -- 2. coarse: freq-scanning xcorr of rx1's burst against rx2 ---------
    cutout = rx1[1000:1000 + n]
    qf2, bins = fast_xcorr(cutout, rx2, freqsearch=True)
    qf2, bins = np.asarray(qf2), np.asarray(bins)
    shift = int(qf2.argmax())
    bin_ = int(bins[shift])
    coarse_fd = bin_ * fs / n if bin_ < n // 2 else (bin_ - n) * fs / n
    # QF^2 here is depressed by deterministic misalignment (the half-sample
    # delay and the off-bin Doppler), which the fine stage removes
    print(f"coarse: delay={shift - 1000} samples (true 1234), "
          f"freq={coarse_fd:.1f} Hz (true {true_fd}), QF^2={qf2[shift]:.3f}")

    # -- 3. fine: CZT freq zoom + sub-sample time refinement ---------------
    _, fhz = czt_xcorr(cutout, rx2, coarse_fd - 2 * fs / n,
                       coarse_fd + 2 * fs / n, fs, czt_step=0.5,
                       shifts=np.array([shift]))
    fine_fd = float(np.asarray(fhz)[0])

    y_aligned = rx2[shift:shift + n]
    ff, timediff, _ = fine_freq_time_search(
        cutout, y_aligned, fine_res=[0.5, 0.1], freqfound=fine_fd,
        freq_res=fs / n, fs=fs,
        td_scan_range=np.arange(-1.0, 1.0, 0.01) / fs)   # +-1 sample scan
    frac = float(timediff) * fs    # positive = y later than x
    delay = (shift - 1000) + frac
    print(f"fine:   freq={float(ff):.2f} Hz (true {true_fd}), sub-sample "
          f"offset={frac:+.3f} -> delay={delay:.3f} samples (true 1234.5)")

    # -- 4. accuracy bounds (Stein) from the scene's link SNRs -------------
    from pydsproutines_tpu.ops import expected_eff_snr
    eff_snr = float(expected_eff_snr(snr, snr))
    td_sigma = float(sigma_dto(fs, fs, n / fs, eff_snr))
    print(f"bounds: eff SNR={eff_snr:.1f}, sigma_DTO={td_sigma * fs:.4f} "
          f"samples (fine delay err {abs(delay - 1234.5):.4f})")

    # -- 5. persist + localize ---------------------------------------------
    with tempfile.TemporaryDirectory() as d:
        db = XcorrDB(os.path.join(d, "results.db"))
        db.create_xcorr_results_table("pair12", fc=1e9, fs=int(fs),
                                      s1="rx1", s2="rx2", xctype=0)
        base = dict(time_sec=0, tidx=1000, cutoutlen=n,
                    td_scan_start=0, td_scan_numsteps=len(qf2),
                    td_scan_step=1, desc=b"example")
        db.insert_peak_result("pair12", base, qf2=qf2[shift],
                              td=delay / fs, td_sigma=td_sigma,
                              fd=float(ff))
        print(f"db:     stored peak row in {db.tables()}")
        db.close()

    # localize: two receiver pairs on a 10 km flat grid (speed of sound-free
    # pure geometry — positions in meters, delay in seconds)
    s1 = np.array([[0.0, 0.0, 0.0], [0.0, 0.0, 0.0]])
    s2 = np.array([[8000.0, 0.0, 0.0], [0.0, 8000.0, 0.0]])
    tgt = np.array([3000.0, 2000.0, 0.0])
    c = 299792458.0
    tds = [(np.linalg.norm(tgt - b) - np.linalg.norm(tgt - a)) / c
           for a, b in zip(s1, s2)]
    xr = np.arange(0.0, 10000.0, 100.0)
    cost = np.asarray(grid_search_tdoa(s1, s2, tds, [1e-7, 1e-7],
                                       xr, xr, 0.0)).reshape(len(xr), len(xr))
    ij = np.unravel_index(np.argmin(cost), cost.shape)   # weighted residual: minimize
    print(f"geoloc: grid peak at x={xr[ij[1]]:.0f} m, y={xr[ij[0]]:.0f} m "
          f"(true {tgt[0]:.0f}, {tgt[1]:.0f})")

    # -- 6. TDOA -> hyperboloid -> WGS84 ground curve ------------------------
    # Two GEO relays observing one ground emitter: the measured TDOA defines
    # a two-sheet hyperboloid with the satellites as foci; intersecting the
    # correct sheet with the WGS84 spheroid yields the ground-position curve
    # (reference hyperboloidRoutines.py:346 intersectOblateSpheroid).
    from pydsproutines_tpu.estimation.geometry import Hyperboloid
    a_wgs, b_wgs = 6378137.0, 6356752.314245
    lat, lon = np.deg2rad(35.0), np.deg2rad(127.0)
    e2 = 1 - (b_wgs / a_wgs) ** 2
    nrad = a_wgs / np.sqrt(1 - e2 * np.sin(lat) ** 2)
    emitter = np.array([nrad * np.cos(lat) * np.cos(lon),
                        nrad * np.cos(lat) * np.sin(lon),
                        nrad * (1 - e2) * np.sin(lat)])
    r_geo = 42164e3
    sat1 = r_geo * np.array([np.cos(np.deg2rad(116.0)),
                             np.sin(np.deg2rad(116.0)), 0.0])
    sat2 = r_geo * np.array([np.cos(np.deg2rad(113.0)),
                             np.sin(np.deg2rad(113.0)), 0.0])
    td_meas = (np.linalg.norm(sat2 - emitter)
               - np.linalg.norm(sat1 - emitter)) / c  # would come from xcorr
    hyp = Hyperboloid.from_foci(sat1, sat2, td_meas * c)
    curve, _ = hyp.intersect_oblate_spheroid(num_pts=500)
    dmin = np.linalg.norm(curve - emitter[:, None], axis=0).min()
    print(f"ground: hyperboloid x WGS84 curve has {curve.shape[1]} points, "
          f"passes {dmin / 1e3:.1f} km from the true emitter")


if __name__ == "__main__":
    main()
