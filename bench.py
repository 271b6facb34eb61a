#!/usr/bin/env python
"""Official benchmark: one JSON line per BASELINE.json config.

Configs (BASELINE.json "configs", in order):
  1. fft_xcorr_freqscan_1Mx128   — the reference's north-star workload
     (benchmarks/README.md: 1M-sample cutout x 128 shifts — NumPy 15.9 s,
     Cython/IPP 3.9 s, CuPy GPU 0.29 s). Also emitted at 10M x 128 (ref GPU
     3 s).
  2. fir_upfirdn_chain           — FIR filter + polyphase upfirdn resample.
  3. wola_64ch                   — WOLA polyphase channelizer.
  4. group_xcorr_czt             — bursty group xcorr over a CZT CAF grid
     (ippGroupXcorrCZT workload).
  5. qpsk_demod_batch / cp2fsk_viterbi — burst-batched QPSK demod chain
     (eye-opening -> phase lock -> map -> preamble search -> bits) and the
     CPFSK Viterbi trellis demod.

vs_baseline: configs with published reference numbers (1) use them; the rest
have no published absolutes (SURVEY.md §6), so vs_baseline is measured against
the reference's own CPU tier re-derived in numpy/scipy ON THIS HOST at reduced
size (the reference's benchmarks double as CPU-vs-GPU parity sweeps the same
way, /root/reference/benchmarks/benchmark_xcorrs.py).

Timing methodology: every rep perturbs the input, a host fetch of a small
real output forces completion, and device time is separated from the
dispatch floor by differencing unrolled in-jit rep counts. I/O is real
float32 planes (complex formed in-trace).

Every line names the device (platform, device_kind, count) and the cards'
power limits. The script refuses to run without a GPU and exits nonzero if
any config failed.
"""

from __future__ import annotations

import functools
import json
import sys
import time

import numpy as np


R_LO, R_HI = 1, 4

# Dispatch jitter floor (seconds). A rep-count difference below a few
# multiples of this is timer noise, not device time.
TIMER_NOISE_FLOOR = 2e-4


class NoiseDominatedError(RuntimeError):
    """The rep-differenced interval never rose above timer noise."""


class TimedSeconds(float):
    """Per-rep seconds (median across trials) with measurement spread.

    Behaves as a plain float (median) everywhere; ``spread_pct`` is
    100*(max-min)/median across the independent trials, ``n_trials`` the
    number of trials that produced a noise-clean reading.
    """
    spread_pct: float = 0.0
    n_trials: int = 1


def rep_differenced(step, *args, r_lo=R_LO, r_hi=R_HI, tries=3, max_r_hi=512,
                    trials=3):
    """Run ``step(*args, n_reps)`` at two rep counts; return per-rep seconds.

    ``step`` must force all reps to execute (perturbed inputs) and return
    something whose first leaf is small and real (host-fetchable).

    A sub-ms kernel can make ``t_hi - t_lo`` fall below
    dispatch jitter and the old ``max(diff, 1e-9)`` clamp published a garbage
    official number.  Now the high rep count escalates geometrically until
    the differenced interval exceeds 5x the observed timer jitter (with an
    absolute floor); if it never does, we raise instead of emitting.

    A single point estimate cannot separate a change from run-to-run
    spread, so each call runs ``trials`` independent dispatch sequences (fresh salts) at
    the escalated rep geometry and returns the MEDIAN as a ``TimedSeconds``
    carrying ``spread_pct`` so the official artifact can publish error bars.
    """
    def timed(nr, salt):
        ts = []
        for rep in range(tries):
            t0 = time.perf_counter()
            out = step(*args, np.int32(salt + rep), nr)
            np.asarray(jax_tree_first(out))
            ts.append(time.perf_counter() - t0)
        return min(ts), max(ts) - min(ts)

    def one_trial(salt):
        t_lo, j_lo = timed(r_lo, salt)
        t_hi, j_hi = timed(r_hi, salt)
        diff = t_hi - t_lo
        noise = max(j_lo, j_hi, TIMER_NOISE_FLOOR)
        return diff, noise

    timed(r_lo, 0)  # compile + warm the low-rep program
    salt = 100
    while True:
        timed(r_hi, 0)  # compile + warm the high-rep program
        diff, noise = one_trial(salt)
        if diff > 5 * noise:
            break
        if r_hi >= max_r_hi:
            raise NoiseDominatedError(
                f"rep-differenced interval noise-dominated at r_hi={r_hi}: "
                f"diff={diff:.3e}s vs 5*noise={5 * noise:.3e}s — refusing to "
                "emit a clamped value")
        r_hi = min(r_hi * 4, max_r_hi)
        salt += 100

    # extra independent trials at the escalated geometry (compiles cached)
    dts = [diff / (r_hi - r_lo)]
    attempts = 0
    while len(dts) < trials and attempts < 2 * trials:
        attempts += 1
        salt += 100
        diff, noise = one_trial(salt)
        if diff > 5 * noise:                 # drop dispatch-hiccup readings
            dts.append(diff / (r_hi - r_lo))

    med = float(np.median(dts))
    out = TimedSeconds(med)
    out.spread_pct = 100.0 * (max(dts) - min(dts)) / med if len(dts) > 1 \
        else float("nan")
    out.n_trials = len(dts)
    return out


def jax_tree_first(tree):
    import jax
    leaves = jax.tree_util.tree_leaves(tree)
    leaf = leaves[0]
    return leaf.reshape(-1)[0] if hasattr(leaf, "reshape") else leaf


DEVICE: dict = {}


def emit(metric, value, unit, baseline, dt=None, extra=None):
    value = float(value)
    if not np.isfinite(value) or value <= 0:
        raise ValueError(f"{metric}: non-finite/non-positive value {value!r}")
    rec = {
        "metric": metric,
        "value": round(value, 4),
        "unit": unit,
        "vs_baseline": round(value / baseline, 3),
        "device": DEVICE,
    }
    if isinstance(dt, TimedSeconds):
        # error bars: median of n_trials independent dispatch sequences;
        # spread = (max-min)/median. A >10% spread means round-over-round
        # deltas inside that band are NOISE, not improvements/regressions.
        if np.isfinite(dt.spread_pct):
            rec["spread_pct"] = round(dt.spread_pct, 2)
        rec["n_trials"] = dt.n_trials
        if not np.isfinite(dt.spread_pct) or dt.spread_pct > 10.0:
            rec["noisy"] = True
    if extra:
        rec.update(extra)
    print(json.dumps(rec), flush=True)


# ---------------------------------------------------------------------------
# Config 1: frequency-scanning FFT xcorr (1M and 10M)
# ---------------------------------------------------------------------------

def bench_fft_xcorr(n, nshifts, batch, r_hi=R_HI):
    import jax
    import jax.numpy as jnp
    from pydsproutines_tpu.ops.xcorr import _fast_xcorr_impl

    rxlen = n + nshifts + 2 * r_hi * 4 + 16
    rng = np.random.default_rng(0)
    cutout_ri = rng.standard_normal((2, n), dtype=np.float32)
    rx_ri = rng.standard_normal((2, rxlen), dtype=np.float32)

    @functools.partial(jax.jit, static_argnames=("n_reps",))
    def step(cut_ri, r_ri, salt, n_reps):
        cut = jax.lax.complex(cut_ri[0], cut_ri[1])
        r = jax.lax.complex(r_ri[0], r_ri[1])
        shifts = jnp.arange(nshifts) + salt % 8

        def one_rep(base):
            qf2, freqs = _fast_xcorr_impl(
                cut, r, shifts + base, n=n, freqsearch=True, output_caf=False,
                abs_result=True, batch_size=batch, step=1)
            return qf2, freqs.astype(jnp.int32)

        # unrolled reps at distinct shift bases: loop-invariant work (rx
        # power prefix sum, plan constants) is CSE'd once, per-sweep work is
        # repeated — unlike lax.map, which re-runs the invariants per rep
        outs = [one_rep(jnp.int32(i)) for i in range(n_reps)]
        return jax.tree_util.tree_map(lambda *a: jnp.stack(a), *outs)

    d_cut = jax.device_put(jnp.asarray(cutout_ri))
    d_rx = jax.device_put(jnp.asarray(rx_ri))
    dt = rep_differenced(step, d_cut, d_rx, r_hi=r_hi, max_r_hi=16)
    return n * nshifts / dt / 1e9, dt  # G(sample*shift)/s


# ---------------------------------------------------------------------------
# Config 2: FIR + upfirdn polyphase resample chain
# ---------------------------------------------------------------------------

def bench_fir_upfirdn(n=4_194_304, fir_taps=128, rs_taps=95, up=5, down=4):
    import jax
    import jax.numpy as jnp
    from pydsproutines_tpu.ops.filters import fir_upfirdn_planes_flat

    rng = np.random.default_rng(1)
    x_ri = rng.standard_normal((2, n), dtype=np.float32)
    h_fir = rng.standard_normal(fir_taps).astype(np.float32)
    h_rs = rng.standard_normal(rs_taps).astype(np.float32)

    # flat-plane fused chain (combined-taps single memory pass;
    # accuracy-equivalent to lfilter_fir + upfirdn). Anti-memoization
    # perturbs the INPUT (the host tap pipeline makes the K tables
    # program constants either way). Two harness shapes: unrolled reps
    # (XLA overlaps consecutive reps, r_hi capped for compile time) with a
    # scan-over-reps FALLBACK (constant program size, escalates past
    # dispatch noise, conservative because the rep carry serializes) used
    # only when the unrolled reading is noise-refused.
    @functools.partial(jax.jit, static_argnames=("n_reps",))
    def step(xri, salt, n_reps):
        outs = []
        for i in range(n_reps):
            o_re, o_im = fir_upfirdn_planes_flat(
                h_fir, h_rs, xri[0] * (1.0 + 1e-7 * (salt + i)),
                xri[1], up, down)
            outs.append(jnp.sum(o_re[:128]) + jnp.sum(o_im[-128:]))
        return jnp.stack(outs)

    @functools.partial(jax.jit, static_argnames=("n_reps",))
    def step_scan(xri, salt, n_reps):
        def body(acc, i):
            o_re, o_im = fir_upfirdn_planes_flat(
                h_fir, h_rs,
                xri[0] * (1.0 + 1e-7 * (salt.astype(jnp.float32) + i)),
                xri[1], up, down)
            return acc + jnp.sum(o_re[:128]) + jnp.sum(o_im[-128:]), None
        acc, _ = jax.lax.scan(body, jnp.float32(0),
                              jnp.arange(n_reps, dtype=jnp.float32))
        return acc

    d_x = jax.device_put(jnp.asarray(x_ri))
    fell_back = False
    try:
        dt = rep_differenced(step, d_x, max_r_hi=16)
    except NoiseDominatedError:
        dt = rep_differenced(step_scan, d_x, max_r_hi=512)
        fell_back = True
    rate = n / dt / 1e9  # GS/s input

    # CPU tier baseline (reference numpy/scipy path) at reduced size
    import scipy.signal as sps
    nb = n // 16
    xb = (x_ri[0, :nb] + 1j * x_ri[1, :nb]).astype(np.complex64)
    t0 = time.perf_counter()
    yb = sps.lfilter(h_fir, 1.0, xb)
    zb = sps.upfirdn(h_rs, yb, up, down)
    cpu_rate = nb / (time.perf_counter() - t0) / 1e9
    return rate, cpu_rate, dt, fell_back


# ---------------------------------------------------------------------------
# Config 3: WOLA channelizer
# ---------------------------------------------------------------------------

def bench_wola(n=8_388_608, nch=64, dec=64, taps=2048):
    import jax
    import jax.numpy as jnp
    from pydsproutines_tpu.ops.wola import wola_planes_flat

    rng = np.random.default_rng(2)
    x_ri = rng.standard_normal((2, n), dtype=np.float32)
    h = rng.standard_normal(taps).astype(np.float32)

    @functools.partial(jax.jit, static_argnames=("n_reps",))
    def step(xri, salt, n_reps):
        # flat-plane path: 1-D quadrature planes in, 1-D planes of the
        # row-major channel matrix out (bit-identical bytes to the 2-D
        # planes).
        # Anti-memoization perturbs the 2048-tap FILTER (the taps change
        # per rep, so XLA cannot CSE reps) instead of the 8M input, whose
        # perturbation would add a 32 MB read+write pass. Forcing reads a
        # small slice of each output plane.
        outs = []
        for i in range(n_reps):
            hh = jnp.asarray(h) * (1.0 + 1e-7 * (salt + i))
            o_re, o_im = wola_planes_flat(hh, xri[0], xri[1], dec, nch)
            outs.append(jnp.sum(o_re[:128]) + jnp.sum(o_im[-128:]))
        return jnp.stack(outs)

    @functools.partial(jax.jit, static_argnames=("n_reps",))
    def step_scan(xri, salt, n_reps):
        # noise-refusal fallback: constant program size escalates past
        # dispatch jitter; conservative (the rep carry serializes the
        # per-rep tap perturbation against the channelizer)
        def body(acc, i):
            hh = jnp.asarray(h) * (1.0 + 1e-7 * (salt.astype(jnp.float32)
                                                 + i))
            o_re, o_im = wola_planes_flat(hh, xri[0], xri[1], dec, nch)
            return acc + jnp.sum(o_re[:128]) + jnp.sum(o_im[-128:]), None
        acc, _ = jax.lax.scan(body, jnp.float32(0),
                              jnp.arange(n_reps, dtype=jnp.float32))
        return acc

    d_x = jax.device_put(jnp.asarray(x_ri))
    fell_back = False
    try:
        dt = rep_differenced(step, d_x, max_r_hi=16)
    except NoiseDominatedError:
        dt = rep_differenced(step_scan, d_x, max_r_hi=512)
        fell_back = True
    rate = n / dt / 1e9

    # CPU tier baseline: vectorized numpy WOLA fold + batched IFFT
    nb = 1 << 19
    xb = (x_ri[0, :nb] + 1j * x_ri[1, :nb]).astype(np.complex64)
    t0 = time.perf_counter()
    nprime = nb // dec
    idx = (np.arange(nprime)[:, None] * dec - np.arange(taps)[None, :])
    valid = idx >= 0
    win = np.where(valid, xb[np.clip(idx, 0, nb - 1)], 0)
    folded = (win * h[None, :]).reshape(nprime, taps // nch, nch).sum(axis=1)
    chans = np.fft.ifft(folded, axis=-1) * nch
    cpu_rate = nb / (time.perf_counter() - t0) / 1e9
    del chans
    return rate, cpu_rate, dt, fell_back


# ---------------------------------------------------------------------------
# Config 4: group xcorr + CZT frequency scan
# ---------------------------------------------------------------------------

def bench_group_xcorr(m=8, glen=4096, nfreq=128, nshifts=1024):
    import jax
    import jax.numpy as jnp
    from pydsproutines_tpu.ops.groupxcorr import GroupXcorrCZT

    fs = 1e6
    period = 4 * glen
    starts = np.arange(m) * period
    lengths = np.full(m, glen)
    span = int(starts[-1] + glen)
    rng = np.random.default_rng(3)
    y = (rng.standard_normal(span)
         + 1j * rng.standard_normal(span)).astype(np.complex64)
    rxlen = span + nshifts + 64
    rx_ri = rng.standard_normal((2, rxlen), dtype=np.float32)
    bw = fs / glen / 4
    f1, f2 = -nfreq / 2 * bw, (nfreq / 2 - 1) * bw
    gx = GroupXcorrCZT(y, starts, lengths, f1, f2, bw, fs)
    shifts = np.arange(nshifts)

    @functools.partial(jax.jit, static_argnames=("n_reps",))
    def step(rri, salt, n_reps):
        outs = []
        for i in range(n_reps):
            rx = jax.lax.complex(rri[0] * (1.0 + 1e-7 * (salt + i)), rri[1])
            caf, _ = gx.xcorr(rx, shifts, step=1)
            outs.append(jnp.max(caf))
        return jnp.stack(outs)

    d_rx = jax.device_put(jnp.asarray(rx_ri))
    dt = rep_differenced(step, d_rx, max_r_hi=16)   # unrolled-rep program
    rate = m * glen * nshifts / dt / 1e9  # Gsample-shift/s

    # CPU tier baseline: scipy czt per group per shift (reference
    # GroupXcorrCZT.xcorr python path) at 16 shifts, scaled
    from scipy.signal import czt as sp_czt
    nb_shifts = 16
    rx = (rx_ri[0] + 1j * rx_ri[1]).astype(np.complex64)
    ystack = np.stack([np.conj(y[s: s + glen]) for s in starts])
    k = gx.plan.k
    w = np.exp(-2j * np.pi * bw / fs)
    a = np.exp(2j * np.pi * f1 / fs)
    t0 = time.perf_counter()
    for sh in range(nb_shifts):
        comb = np.zeros(k, dtype=complex)
        for g in range(m):
            pdt = rx[sh + starts[g]: sh + starts[g] + glen] * ystack[g]
            comb += sp_czt(pdt, k, w, a)
        _ = np.abs(comb) ** 2
    cpu_rate = m * glen * nb_shifts / (time.perf_counter() - t0) / 1e9
    return rate, cpu_rate, dt


# ---------------------------------------------------------------------------
# Config 5: burst-batched QPSK demod chain + CPFSK Viterbi
# ---------------------------------------------------------------------------

def bench_qpsk_demod_batch(B=256, nsyms=1024, osr=4, amble_len=32,
                           search_len=64):
    import jax
    import jax.numpy as jnp
    from pydsproutines_tpu.ops.demod import (DemodulatorBatchQPSK,
                                             PSK_BITMAPS)

    L = nsyms * osr
    rng = np.random.default_rng(4)
    x_ri = rng.standard_normal((2, B, L), dtype=np.float32)
    amble = rng.integers(0, 4, amble_len).astype(np.int32)
    d = DemodulatorBatchQPSK()

    @functools.partial(jax.jit, static_argnames=("n_reps",))
    def step(xri, salt, n_reps):
        # scan over reps: this chain is ~60 us/rep, so the harness escalates
        # to large rep counts — a scan keeps the program constant-size where
        # an unrolled body would explode compile time.
        def body(acc, i):
            xb = jax.lax.complex(
                xri[0] * (1.0 + 1e-7 * (salt.astype(jnp.float32) + i)),
                xri[1])
            res = d.demod_batch(xb, osr, jnp.asarray(amble),
                                search_start=0, search_len=search_len,
                                num_out_syms=nsyms - amble_len - search_len)
            return acc + jnp.sum(res.best_matches).astype(jnp.float32), None
        acc, _ = jax.lax.scan(
            body, jnp.float32(0), jnp.arange(n_reps, dtype=jnp.float32))
        return acc

    d_x = jax.device_put(jnp.asarray(x_ri))
    dt = rep_differenced(step, d_x)
    rate = B * L / dt / 1e6  # Msamples/s through the demod chain

    # CPU tier baseline: reference numpy single-burst chain, 4 bursts scaled
    t0 = time.perf_counter()
    for b in range(4):
        x = (x_ri[0, b] + 1j * x_ri[1, b]).astype(np.complex64)
        x_rs = x.reshape(-1, osr)
        eo = np.abs(x_rs).mean(axis=0)
        xeo = x_rs[:, np.argmax(eo)]
        reimp = xeo ** 2
        re, im = reimp.real, reimp.imag
        mat = np.array([[np.sum(re * re), np.sum(re * im)],
                        [np.sum(re * im), np.sum(im * im)]])
        _, vecs = np.linalg.eigh(mat)
        theta = np.arctan2(vecs[1, -1], vecs[0, -1])
        reimc = xeo * np.exp(1j * (-theta / 2 + np.pi / 4))
        syms = np.zeros(nsyms, np.uint8)
        gray4 = np.array([[2, 1], [3, 0]], np.uint8)
        syms = gray4[(reimc.real > 0).astype(int), (reimc.imag > 0).astype(int)]
        best = (-1, 0, 0)
        for s in range(search_len):
            win = syms[s: s + amble_len].astype(int)
            for r in range(4):
                matches = int(np.sum((win + r) % 4 == amble))
                if matches > best[0]:
                    best = (matches, s, r)
        rot = (syms.astype(int) + best[2]) % 4
        _ = PSK_BITMAPS[4][rot]
    cpu_rate = 4 * L / (time.perf_counter() - t0) / 1e6
    return rate, cpu_rate, dt


def bench_cp2fsk_viterbi(B=64, nsyms=512, up=8):
    import jax
    import jax.numpy as jnp
    from pydsproutines_tpu.ops.viterbi import _viterbi_run

    # 2-state CP2FSK-like trellis: alphabet +-1 tones, fully connected
    alphabet = np.array([1.0, -1.0], dtype=np.complex64)
    pretransitions = np.array([[0, 1], [0, 1]], dtype=np.int32)
    pulse = np.ones((1, up), dtype=np.complex64)
    omegas = np.zeros(1, dtype=np.float32)
    start_mask = np.array([True, True])
    L = nsyms * up
    rng = np.random.default_rng(5)
    y_ri = rng.standard_normal((2, B, L), dtype=np.float32)

    pret_static = tuple(map(tuple, pretransitions.tolist()))
    start_static = tuple(bool(v) for v in start_mask)

    def make_step(survivor):
        from pydsproutines_tpu.ops.viterbi import viterbi_path_acs_batch

        @functools.partial(jax.jit, static_argnames=("n_reps",))
        def step(yri, salt, n_reps):
            def one(yrow):
                # faithful 'branch' semantics: control flow is
                # data-independent for memoryless pulses (round-3 proof),
                # so the static tables collapse the trellis to gather+sum.
                paths, metrics = _viterbi_run(
                    yrow, jnp.asarray(alphabet), jnp.asarray(pretransitions),
                    jnp.asarray(pulse), jnp.asarray(omegas),
                    jnp.asarray(start_mask), up=up, pulselen=up, k_syms=1,
                    pathlen=nsyms, survivor_metric=survivor,
                    pret_static=pret_static, start_static=start_static)
                return metrics[jnp.argmin(metrics)]

            # scan over reps (constant program size under harness escalation)
            def body(acc, i):
                yb = jax.lax.complex(
                    yri[0] * (1.0 + 1e-7 * (salt.astype(jnp.float32) + i)),
                    yri[1])
                if survivor == "path":
                    # non-degenerate textbook ACS — the real trellis
                    # measure, batched bursts-minor (round 5)
                    paths, metrics = viterbi_path_acs_batch(
                        yb, jnp.asarray(alphabet),
                        jnp.asarray(pretransitions), jnp.asarray(pulse),
                        jnp.asarray(omegas), jnp.asarray(start_mask),
                        up=up, pulselen=up, k_syms=1, pathlen=nsyms,
                        pret_static=pret_static,
                        start_static=start_static)
                    return acc + jnp.sum(jnp.min(metrics, axis=1)), None
                return acc + jnp.sum(jax.vmap(one)(yb)), None
            acc, _ = jax.lax.scan(
                body, jnp.float32(0), jnp.arange(n_reps, dtype=jnp.float32))
            return acc
        return step

    d_y = jax.device_put(jnp.asarray(y_ri))
    # the branch path is ~tens of us/rep (scan-free gather+sum): scan-over-
    # reps keeps program size constant, so escalate far enough to clear
    # dispatch jitter instead of noise-refusing
    dt = rep_differenced(make_step("branch"), d_y, max_r_hi=16384)
    rate = B * nsyms / dt / 1e6  # Msymbols/s across the burst batch
    dt_path = rep_differenced(make_step("path"), d_y, max_r_hi=2048)
    rate_path = B * nsyms / dt_path / 1e6

    # CPU tier baseline: per-symbol numpy trellis on 2 bursts, scaled
    t0 = time.perf_counter()
    for b in range(2):
        y = (y_ri[0, b] + 1j * y_ri[1, b]).astype(np.complex64)
        metrics = np.zeros(2)
        for nsm in range(nsyms):
            seg = y[nsm * up: (nsm + 1) * up]
            bm = np.array([[np.sum(np.abs(seg - a) ** 2) for a in alphabet]
                           for _ in range(2)])
            tot = metrics[None, :] + bm
            metrics = tot.min(axis=1)
    cpu_rate = 2 * nsyms / (time.perf_counter() - t0) / 1e6
    return rate, cpu_rate, dt, rate_path, dt_path


def bench_cpm_viterbi_k2(B=64, nsyms=512, up=8):
    """Pulse-memory CPM trellis (k_syms = 2, the case the reference's C++
    PyViterbiDemodulator exists for): path-metric MLSE over the (A+1)^2
    window-state space via the min-plus associative scan
    (ops/viterbi.py _viterbi_run_path_acs)."""
    import jax
    import jax.numpy as jnp
    from pydsproutines_tpu.ops.viterbi import viterbi_path_acs_batch

    alphabet = np.array([1.0, -1.0], dtype=np.complex64)
    pretransitions = np.array([[0, 1], [0, 1]], dtype=np.int32)
    pulse = np.full((1, 2 * up), 0.5, dtype=np.complex64)  # spans 2 symbols
    omegas = np.array([0.05], dtype=np.float32)
    start_mask = np.array([True, True])
    L = nsyms * up
    rng = np.random.default_rng(7)
    y_ri = rng.standard_normal((2, B, L), dtype=np.float32)
    pret_static = tuple(map(tuple, pretransitions.tolist()))
    start_static = tuple(bool(v) for v in start_mask)

    @functools.partial(jax.jit, static_argnames=("n_reps",))
    def step(yri, salt, n_reps):
        def body(acc, i):
            yb = jax.lax.complex(
                yri[0] * (1.0 + 1e-7 * (salt.astype(jnp.float32) + i)),
                yri[1])
            # bursts-minor batched ACS: the burst axis is the minor
            # dimension of the tiny (C, C) min-plus tiles
            paths, metrics = viterbi_path_acs_batch(
                yb, jnp.asarray(alphabet), jnp.asarray(pretransitions),
                jnp.asarray(pulse), jnp.asarray(omegas),
                jnp.asarray(start_mask), up=up, pulselen=2 * up, k_syms=2,
                pathlen=nsyms, pret_static=pret_static,
                start_static=start_static)
            return acc + jnp.sum(jnp.min(metrics, axis=1)), None
        acc, _ = jax.lax.scan(
            body, jnp.float32(0), jnp.arange(n_reps, dtype=jnp.float32))
        return acc

    d_y = jax.device_put(jnp.asarray(y_ri))
    dt = rep_differenced(step, d_y, max_r_hi=2048)
    return B * nsyms / dt / 1e6, dt


def bench_receiver_e2e(n_rows=131072, nch=64):
    """Aggregate end-to-end pipeline throughput (VERDICT round-4 item 8):
    wideband block -> WOLA channelize -> channel select -> freq-scan xcorr
    -> CAF peak -> demod, all in the ONE jitted WidebandReceiver.step.
    The BASELINE north star is aggregate pipeline rate, not isolated ops;
    this metric is the composed-chain number (dominated by the channelize
    at this geometry — the xcorr/demod stages run on one channel)."""
    import jax
    import jax.numpy as jnp
    from pydsproutines_tpu.models.receiver import WidebandReceiver

    rxv = WidebandReceiver(num_channels=nch, num_taps=8 * nch,
                           template_len=1024, num_shifts=256, osr=4,
                           demod_syms=128, m=4)
    n_wide = n_rows * nch
    rng = np.random.default_rng(11)
    t_ri, _ = rxv.example_inputs(seed=1)
    t_ri = np.asarray(t_ri, dtype=np.float32)
    rx_ri = rng.standard_normal((2, n_wide), dtype=np.float32) * 0.1

    @functools.partial(jax.jit, static_argnames=("n_reps",))
    def step(tri, xri, salt, n_reps):
        def body(acc, i):
            x2 = xri * (1.0 + 1e-7 * (salt.astype(jnp.float32) + i))
            qf2, ipeak, fbin, energy, syms = rxv.step(tri, x2)
            return acc + qf2 + energy[0] + syms[0].astype(jnp.float32), None
        acc, _ = jax.lax.scan(body, jnp.float32(0),
                              jnp.arange(n_reps, dtype=jnp.float32))
        return acc

    d_t = jax.device_put(jnp.asarray(t_ri))
    d_rx = jax.device_put(jnp.asarray(rx_ri))
    dt = rep_differenced(step, d_t, d_rx, max_r_hi=32)
    return n_wide / dt / 1e9, dt  # wideband GS/s through the full chain


def main():
    from pydsproutines_tpu.utils.device import (card_power_limits,
                                                require_gpu,
                                                setup_compile_cache)

    only = sys.argv[1] if len(sys.argv) > 1 else None
    setup_compile_cache()
    DEVICE.update(require_gpu())
    DEVICE["power_limit"] = card_power_limits().splitlines()
    failed = []

    def guard(name, fn):
        # one failing config must not take down the rest of the sweep, but
        # the run as a whole then fails
        try:
            fn()
        except Exception as e:  # noqa: BLE001
            failed.append(name)
            print(f"# {name} failed: {type(e).__name__}: {e}",
                  file=sys.stderr, flush=True)

    def _x1m():
        rate, dt = bench_fft_xcorr(1_000_000, 128, 128)
        emit("fft_xcorr_freqscan_1Mx128", rate, "Gsample-shift/s",
             1_000_000 * 128 / 0.29 / 1e9, dt)  # ref GPU best
    if only in (None, "xcorr1m"):
        guard("xcorr1m", _x1m)

    def _x10m():
        rate, dt = bench_fft_xcorr(10_000_000, 128, 16, r_hi=2)
        emit("fft_xcorr_freqscan_10Mx128", rate, "Gsample-shift/s",
             10_000_000 * 128 / 3.0 / 1e9, dt)  # ref GPU best
    if only in (None, "xcorr10m"):
        guard("xcorr10m", _x10m)
    if only in (None, "wola"):
        def _wola():
            rate, cpu, dt, fb = bench_wola()
            emit("wola_64ch_8M", rate, "GS/s", cpu, dt,
                 extra={"harness": "scan_fallback_lower_bound"} if fb
                 else None)
        guard("wola", _wola)
    if only in (None, "firupfirdn"):
        def _fir():
            rate, cpu, dt, fb = bench_fir_upfirdn()
            emit("fir_upfirdn_chain_4M", rate, "GS/s", cpu, dt,
                 extra={"harness": "scan_fallback_lower_bound"} if fb
                 else None)
        guard("firupfirdn", _fir)
    if only in (None, "groupxcorr"):
        def _gx():
            rate, cpu, dt = bench_group_xcorr()
            emit("group_xcorr_czt_8x4096x128x1024", rate,
                 "Gsample-shift/s", cpu, dt)
        guard("groupxcorr", _gx)
    if only in (None, "demod"):
        def _dm():
            rate, cpu, dt = bench_qpsk_demod_batch()
            emit("qpsk_demod_batch_256x4096", rate, "Msamples/s", cpu, dt)
        guard("demod", _dm)
    if only in (None, "viterbi"):
        def _vit():
            rate, cpu, dt, rate_p, dt_p = bench_cp2fsk_viterbi()
            # HEADLINE: the non-degenerate path-metric trellis (textbook
            # ACS as a min-plus associative scan) — a real data-dependent
            # sequential recursion, evaluated in O(log N) depth
            emit("cp2fsk_viterbi_path_64x512", rate_p, "Msymbols/s", cpu,
                 dt_p)
            # pulse-memory MLSE (k_syms=2) over the window-state trellis —
            # the case the reference's C++ port exists for
            rate_k2, dt_k2 = bench_cpm_viterbi_k2()
            emit("cpm_viterbi_k2_path_64x512", rate_k2, "Msymbols/s", cpu,
                 dt_k2)
            # faithful-to-reference 'branch' survivor semantics: provably
            # data-INDEPENDENT for memoryless pulses (round-3 proof), so
            # the device work is a precomputed-table gather+sum — NOT a
            # sequential trellis; labeled accordingly
            emit("cp2fsk_viterbi_branch_tables_64x512", rate, "Msymbols/s",
                 cpu, dt)
        guard("viterbi", _vit)

    if only in (None, "receiver"):
        def _rx():
            rate, dt = bench_receiver_e2e()
            # baseline: the reference has no single-program equivalent; the
            # derived aggregate anchor is its best GPU xcorr rate 0.43 Gss/s
            # (BASELINE.md) — vs_baseline compares wideband GS/s to that
            emit("wideband_receiver_e2e_8M", rate, "GS/s", 0.43, dt)
        guard("receiver", _rx)
    if failed:
        print(f"# failed configs: {', '.join(failed)}", file=sys.stderr,
              flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
