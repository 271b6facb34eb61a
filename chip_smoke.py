#!/usr/bin/env python
"""Chip smoke test: the wideband receiver and the public fast_xcorr, once
each at full width on a GPU, checked against float64 NumPy.

    python chip_smoke.py           # one GPU
    python chip_smoke.py --four    # four GPUs: the sharded layer only

One GPU runs five phases in one process: device (the card's name and power
limit), receiver (``WidebandReceiver.run`` on an 8,388,608-sample capture
with a planted QPSK burst), north star (``fast_xcorr`` frequency scan of a
1,000,000-sample cutout over 128 shifts), streaming (``Channeliser`` blocks
against one whole call) and memory (the receiver step's compiled memory).
``--four`` runs ``sharded_wola`` and ``sharded_caf_peak`` on a 1-D mesh of
four GPUs, each against the same op on one GPU.

Each check prints its error beside its tolerance. Only when every phase
passes does the last line read {"ok": true, "device": {...}}; otherwise the
script exits nonzero without it. Scenes are generated from fixed seeds.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

# Tolerances, each with the precision that justifies it. float32 FFTs and
# products (cuFFT, elementwise folds, full-f32 matmuls) keep ~1e-6 of the
# largest value; a TF32 product keeps ~1e-3 and fails all of these.
ENERGY_RTOL = 2e-5    # channel energy: f32 fold + IFFT, tree-summed rows
QF2_RTOL = 2e-5       # peak QF^2: f32 spectrum and exact window energies
QF2_GRID_RTOL = 2e-5  # every shift's QF^2, relative to the peak QF^2
SAME_RTOL = 1e-6      # one op computed two ways in f32 (blocks, shards)

RECEIVER = dict(num_channels=64, num_taps=512, template_len=1024,
                num_shifts=256, osr=4, demod_syms=128, m=4,
                n_wide=8_388_608, noise=1.0, seed=7)
NORTH_STAR = dict(n=1_000_000, nshifts=128, noise=0.5, seed=11)
STREAM = dict(num_channels=64, num_taps=512, n=8_388_608, blocks=8, seed=5)
FOUR = dict(wola_n=8_388_608, num_channels=64, num_taps=512,
            xcorr_n=1_000_000, nshifts=128, seed=13)


class Phase:
    """Collects one phase's checks: (name, error, tolerance) or exact
    equalities, printed as they are made."""

    def __init__(self, name: str):
        self.name = name
        self.failed: list[str] = []
        self.t0 = time.perf_counter()

    def within(self, what: str, err: float, tol: float):
        good = bool(err <= tol)
        print(f"  {self.name}: {what} max error {err:.3e} (tolerance "
              f"{tol:.0e}) {'within' if good else 'EXCEEDS'}", flush=True)
        if not good:
            self.failed.append(what)

    def equal(self, what: str, got, want):
        good = bool(np.array_equal(np.asarray(got), np.asarray(want)))
        shown = got if np.size(got) == 1 else f"{np.size(got)} values"
        print(f"  {self.name}: {what} {shown} "
              f"{'equals' if good else 'DIFFERS FROM'} reference", flush=True)
        if not good:
            self.failed.append(what)

    def require(self, what: str, cond: bool):
        """A property of the generated scene that the checks rely on."""
        if not cond:
            print(f"  {self.name}: scene check failed: {what}", flush=True)
            self.failed.append(what)

    def done(self) -> bool:
        dt = time.perf_counter() - self.t0
        state = "FAILED: " + ", ".join(self.failed) if self.failed \
            else "passed"
        print(f"phase {self.name}: {state} ({dt:.1f} s wall, compile "
              f"included)", flush=True)
        return not self.failed


def _rel(got, ref) -> float:
    got = np.asarray(got, np.complex128)
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


# ---------------------------------------------------------------------------
# receiver
# ---------------------------------------------------------------------------

def receiver_scene(cfg: dict):
    """A capture holding a continuous QPSK stream on one channel, offset by
    a known frequency bin, in complex Gaussian noise. Returns (template,
    rx, truth), complex.

    Each symbol is a decaying one-sided pulse over its ``osr`` channel
    samples, so one eye phase is clearly best and the template's spectrum
    has one clear peak. The wideband stream holds each channel-rate sample
    for N samples, starting half a block early, so the channel filter's
    centre falls inside one held block: the channel output is G * cc[r - d]
    plus small leakage, with d the block under the filter centre."""
    rng = np.random.default_rng(cfg["seed"])
    nch, osr, n = cfg["num_channels"], cfg["osr"], cfg["template_len"]
    n_wide = cfg["n_wide"]
    chan = int(rng.integers(1, nch))
    kb = int(rng.integers(1, n // 16))
    s0 = int(rng.integers(cfg["num_shifts"] // 4,
                          3 * cfg["num_shifts"] // 4))
    d = int(np.ceil(((cfg["num_taps"] - 1) / 2 - nch // 2) / nch))
    nsym = n_wide // nch // osr + 2
    syms = np.exp(0.5j * np.pi * rng.integers(0, 4, nsym))
    cc = (syms[:, None] * 0.5 ** np.arange(osr)).reshape(-1)
    t = np.arange(n_wide)
    sig = cc[(t + nch // 2) // nch]
    f_w = chan / nch + kb / (n * nch)
    rx = sig * np.exp(2j * np.pi * f_w * t)
    rx += cfg["noise"] * (rng.standard_normal(n_wide)
                          + 1j * rng.standard_normal(n_wide)) / np.sqrt(2)
    template = cc[s0 - d: s0 - d + n]
    return template, rx, dict(channel=chan, shift=s0, bin=kb)


def receiver_reference(cfg: dict, f_tap, template, rx):
    """float64 NumPy chain: WOLA by its defining sum, strongest channel,
    per-shift FFT scan, eye opening, blind phase lock and symbol map."""
    nch, L = cfg["num_channels"], f_tap.size
    rows = rx.size // nch
    r = np.arange(rows)[:, None]
    a = np.arange(nch)[None, :]
    dft_in = np.zeros((rows, nch), np.complex128)
    for b in range(L // nch):
        idx = r * nch - b * nch - a
        dft_in += np.where(idx >= 0, rx[np.maximum(idx, 0)], 0) \
            * f_tap[b * nch + a]
    ch = np.fft.ifft(dft_in, axis=-1) * nch
    energy = np.mean(np.abs(ch) ** 2, axis=0)
    best = int(np.argmax(energy))
    x = ch[:, best]
    n, nsh = cfg["template_len"], cfg["num_shifts"]
    win = np.lib.stride_tricks.sliding_window_view(x, n)[:nsh]
    spec = np.abs(np.fft.fft(win * np.conj(template), axis=-1)) ** 2
    qf2 = spec.max(-1) / np.sum(np.abs(template) ** 2) \
        / np.sum(np.abs(win) ** 2, axis=-1)
    ipeak = int(np.argmax(qf2))
    osr, m = cfg["osr"], cfg["m"]
    seg = x[ipeak: ipeak + cfg["demod_syms"] * osr].reshape(-1, osr)
    eye = np.mean(np.abs(seg), axis=0)
    xeo = seg[:, int(np.argmax(eye))]
    p = m // 2
    re, im = (xeo ** p).real, (xeo ** p).imag
    theta = 0.5 * np.arctan2(2 * np.sum(re * im),
                             np.sum(re * re) - np.sum(im * im))
    corr = xeo * np.exp(-1j * theta / p)
    const = np.exp(2j * np.pi * np.arange(m) / m)
    metric = corr.real[:, None] * const.real + corr.imag[:, None] * const.imag
    syms = np.argmax(metric, axis=-1)
    srt = np.sort(metric, axis=-1)
    return dict(energy=energy, best_channel=best, qf2=qf2, ipeak=ipeak,
                bin=int(np.argmax(spec[ipeak])), syms=syms,
                margins=dict(
                    energy=np.sort(energy)[-1] / np.sort(energy)[-2],
                    qf2=np.sort(qf2)[-1] - np.sort(qf2)[-2],
                    bin=np.sort(spec[ipeak])[-1] / np.sort(spec[ipeak])[-2],
                    eye=(np.sort(eye)[-1] - np.sort(eye)[-2]) / eye.max(),
                    sym=np.min(srt[:, -1] - srt[:, -2])
                    / np.max(np.abs(corr))))


def phase_receiver(cfg: dict) -> tuple[bool, object]:
    """WidebandReceiver.run on the planted capture against the float64
    chain. Returns (passed, (receiver, template_ri, rx_ri)) for the memory
    phase."""
    import jax.numpy as jnp
    from pydsproutines_tpu.models import WidebandReceiver

    ph = Phase("receiver")
    rcv = WidebandReceiver(num_channels=cfg["num_channels"],
                           num_taps=cfg["num_taps"],
                           template_len=cfg["template_len"],
                           num_shifts=cfg["num_shifts"], osr=cfg["osr"],
                           demod_syms=cfg["demod_syms"], m=cfg["m"])
    template, rx, truth = receiver_scene(cfg)
    t_ri = jnp.asarray(np.stack([template.real, template.imag])
                       .astype(np.float32))
    rx_ri = jnp.asarray(np.stack([rx.real, rx.imag]).astype(np.float32))
    out = rcv.run(t_ri, rx_ri)
    # the reference sees exactly the float32 samples the receiver saw
    rx32 = np.asarray(rx_ri, np.float64)
    ref = receiver_reference(cfg, np.asarray(rcv.f_tap, np.float64),
                             template, rx32[0] + 1j * rx32[1])
    mg = ref["margins"]
    ph.require(f"strongest channel stands out ({mg['energy']:.2f}x)",
               mg["energy"] > 1.5)
    ph.require(f"peak QF^2 stands out ({mg['qf2']:.3f})", mg["qf2"] > 0.1)
    ph.require(f"peak bin stands out ({mg['bin']:.2f}x)", mg["bin"] > 1.5)
    ph.require(f"eye phase stands out ({mg['eye']:.2e})", mg["eye"] > 1e-3)
    ph.require(f"symbol decisions clear ({mg['sym']:.2e})", mg["sym"] > 1e-4)
    ph.require("reference finds the planted channel, shift and bin",
               (ref["best_channel"], ref["ipeak"], ref["bin"])
               == (truth["channel"], truth["shift"], truth["bin"]))
    ph.equal("best channel", out["best_channel"], ref["best_channel"])
    ph.equal("best shift", out["best_shift"], ref["ipeak"])
    ph.equal("frequency bin", out["freq_bin"], ref["bin"])
    ph.equal("demodulated symbols", np.asarray(out["demod_syms"]),
             ref["syms"])
    q_ref = ref["qf2"][ref["ipeak"]]
    ph.within("peak QF^2 (relative)", abs(out["qf2_peak"] - q_ref) / q_ref,
              QF2_RTOL)
    e = np.asarray(out["channel_energy"])
    ph.within("channel energies (relative)",
              float(np.max(np.abs(e - ref["energy"]) / ref["energy"])),
              ENERGY_RTOL)
    return ph.done(), (rcv, t_ri, rx_ri)


def phase_memory(rcv, t_ri, rx_ri) -> bool:
    """The receiver step's compiled memory analysis and the device's peak
    bytes in use so far."""
    import jax

    ph = Phase("memory")
    compiled = type(rcv).step.lower(rcv, t_ri, rx_ri).compile()
    ma = compiled.memory_analysis()
    print(f"  memory: receiver step memory_analysis: {ma}", flush=True)
    stats = jax.devices()[0].memory_stats() or {}
    print(f"  memory: peak_bytes_in_use "
          f"{stats.get('peak_bytes_in_use', 'not reported')}", flush=True)
    ph.require("memory analysis available", ma is not None)
    return ph.done()


# ---------------------------------------------------------------------------
# north star: public fast_xcorr
# ---------------------------------------------------------------------------

def xcorr_scene(cfg: dict):
    """A random cutout planted at a known shift and frequency bin inside a
    noisy capture; 128 uniform shifts around it."""
    rng = np.random.default_rng(cfg["seed"])
    n, nsh = cfg["n"], cfg["nshifts"]
    start = int(rng.integers(0, 1000))
    plant = start + int(rng.integers(nsh // 8, 7 * nsh // 8))
    kb = int(rng.integers(1, n))
    cut = (rng.standard_normal(n) + 1j * rng.standard_normal(n)) \
        .astype(np.complex64)
    rxlen = start + nsh + n + 16
    rx = cfg["noise"] * (rng.standard_normal(rxlen)
                         + 1j * rng.standard_normal(rxlen))
    rx[plant: plant + n] += cut * np.exp(2j * np.pi * kb * np.arange(n) / n)
    shifts = start + np.arange(nsh)
    return cut, rx.astype(np.complex64), shifts, dict(shift=plant, bin=kb)


def xcorr_reference(cut, rx, shifts):
    """complex128 per-shift FFT scan: (QF^2, peak bin) per shift."""
    c = np.conj(cut.astype(np.complex128))
    cns = np.sum(np.abs(c) ** 2)
    qf2 = np.zeros(len(shifts))
    bins = np.zeros(len(shifts), np.int64)
    for i, s in enumerate(shifts):
        w = rx[s: s + cut.size].astype(np.complex128)
        spec = np.abs(np.fft.fft(w * c)) ** 2
        bins[i] = int(np.argmax(spec))
        qf2[i] = spec[bins[i]] / cns / np.sum(np.abs(w) ** 2)
    return qf2, bins


def phase_north_star(cfg: dict) -> bool:
    import jax.numpy as jnp
    from pydsproutines_tpu.ops import fast_xcorr

    ph = Phase("north_star")
    cut, rx, shifts, truth = xcorr_scene(cfg)
    qf2, bins = fast_xcorr(jnp.asarray(cut), jnp.asarray(rx),
                           freqsearch=True, shifts=shifts)
    qf2, bins = np.asarray(qf2), np.asarray(bins)
    rq, rb = xcorr_reference(cut, rx, shifts)
    i_ref = int(np.argmax(rq))
    ph.require("reference finds the planted shift and bin",
               (shifts[i_ref], rb[i_ref]) == (truth["shift"], truth["bin"]))
    i = int(np.argmax(qf2))
    ph.equal("peak shift", shifts[i], shifts[i_ref])
    ph.equal("peak bin", bins[i], rb[i_ref])
    ph.within("peak QF^2 (relative)", abs(qf2[i] - rq[i_ref]) / rq[i_ref],
              QF2_RTOL)
    ph.within("QF^2 over all shifts (relative to peak)",
              float(np.max(np.abs(qf2 - rq)) / rq[i_ref]), QF2_GRID_RTOL)
    print(f"  north_star: {int(np.sum(bins == rb))}/{len(shifts)} shifts "
          f"have the reference's peak bin", flush=True)
    return ph.done()


# ---------------------------------------------------------------------------
# streaming: Channeliser blocks == one whole call
# ---------------------------------------------------------------------------

def phase_streaming(cfg: dict) -> bool:
    import jax.numpy as jnp
    from pydsproutines_tpu.ops import Channeliser

    ph = Phase("streaming")
    rng = np.random.default_rng(cfg["seed"])
    n = cfg["n"]
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)) \
        .astype(np.complex64)
    kw = dict(num_taps=cfg["num_taps"], num_channels=cfg["num_channels"])
    whole = np.asarray(Channeliser(**kw).channelise(jnp.asarray(x)))
    ch = Channeliser(**kw)
    blocks = [np.asarray(ch.channelise(jnp.asarray(b)))
              for b in np.split(x, cfg["blocks"])]
    seq = np.concatenate(blocks)
    ph.equal("rows", seq.shape, whole.shape)
    if seq.shape == whole.shape:
        ph.within("blocks vs whole call (relative)", _rel(seq, whole),
                  SAME_RTOL)
    return ph.done()


# ---------------------------------------------------------------------------
# four GPUs: the sharded layer against one GPU
# ---------------------------------------------------------------------------

def phase_four(cfg: dict, ndev: int = 4) -> bool:
    import jax
    import jax.numpy as jnp
    from scipy import signal as sps
    from jax.sharding import Mesh
    from pydsproutines_tpu.ops import fast_xcorr, wola
    from pydsproutines_tpu.parallel import sharded_caf_peak, sharded_wola

    ph = Phase("four")
    devices = jax.devices()
    ph.require(f"{ndev} devices ({len(devices)} found)",
               len(devices) >= ndev)
    if len(devices) < ndev:
        return ph.done()
    mesh = Mesh(np.array(devices[:ndev]), ("dsp",))
    one = devices[0]
    rng = np.random.default_rng(cfg["seed"])

    nch, n = cfg["num_channels"], cfg["wola_n"]
    h = jnp.asarray(sps.firwin(cfg["num_taps"], 1.0 / nch), jnp.float32)
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)) \
        .astype(np.complex64)
    ref = np.asarray(wola(jax.device_put(h, one),
                          jax.device_put(jnp.asarray(x), one), nch, nch))
    got = np.asarray(sharded_wola(h, jnp.asarray(x), nch, nch, mesh))
    ph.equal("sharded_wola shape", got.shape, ref.shape)
    if got.shape == ref.shape:
        ph.within("sharded_wola vs one device (relative)", _rel(got, ref),
                  SAME_RTOL)

    xc = dict(n=cfg["xcorr_n"], nshifts=cfg["nshifts"], noise=0.5,
              seed=cfg["seed"])
    cut, rx, shifts, truth = xcorr_scene(xc)
    q1, b1 = fast_xcorr(jax.device_put(jnp.asarray(cut), one),
                        jax.device_put(jnp.asarray(rx), one),
                        freqsearch=True, shifts=shifts)
    q1, b1 = np.asarray(q1), np.asarray(b1)
    i = int(np.argmax(q1))
    qs, ss, fs = sharded_caf_peak(jnp.asarray(cut), jnp.asarray(rx),
                                  jnp.asarray(shifts), mesh)
    ph.equal("sharded_caf_peak shift", int(ss), int(shifts[i]))
    ph.equal("sharded_caf_peak bin", int(fs), int(b1[i]))
    ph.require("one device finds the planted shift and bin",
               (shifts[i], b1[i]) == (truth["shift"], truth["bin"]))
    ph.within("sharded_caf_peak QF^2 vs one device (relative)",
              abs(float(qs) - q1[i]) / q1[i], SAME_RTOL)
    return ph.done()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU sharded checks")
    args = ap.parse_args(argv)

    from pydsproutines_tpu.utils.device import (card_power_limits,
                                                require_gpu,
                                                setup_compile_cache)
    print(f"compile cache: {setup_compile_cache()}", flush=True)
    try:
        dev = require_gpu()
        if args.four and dev["count"] < 4:
            raise RuntimeError(f"--four needs 4 GPUs, found {dev['count']}")
        print(f"device: {dev['platform']} {dev['kind']} x{dev['count']}",
              flush=True)
        print(card_power_limits(), flush=True)
    except Exception as e:  # noqa: BLE001
        print(f"phase device: FAILED: {type(e).__name__}: {e}",
              file=sys.stderr, flush=True)
        return 2
    print("phase device: passed", flush=True)

    results = []

    def run(name, fn, *a):
        try:
            out = fn(*a)
        except Exception as e:  # noqa: BLE001
            print(f"phase {name}: FAILED: {type(e).__name__}: {e}",
                  flush=True)
            results.append(False)
            return None
        ok, extra = out if isinstance(out, tuple) else (out, None)
        results.append(ok)
        return extra

    if args.four:
        run("four", phase_four, FOUR)
    else:
        rx_state = run("receiver", phase_receiver, RECEIVER)
        if rx_state is not None:
            run("memory", phase_memory, *rx_state)
        run("north_star", phase_north_star, NORTH_STAR)
        run("streaming", phase_streaming, STREAM)
    if not results or not all(results):
        print("chip_smoke: FAILED", file=sys.stderr, flush=True)
        return 1
    print(json.dumps({"ok": True, "device": dev}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
