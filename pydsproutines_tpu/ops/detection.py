"""Burst / energy detection.

Reference semantics: /root/reference/filterRoutines.py (BurstDetector :792,
cupyThresholdEdges :701, cupyGatherEdges :749, energyDetection :1031) and
custom_kernels/thresholding.cu, peakfinding.cu.

Design: data-dependent outputs (edge lists, peak lists, burst
slices) become fixed-capacity arrays plus a count — the idiom the reference's
own GPU kernels already use (thresholdEdges capacity+counts, findLocalMaxima
maxNumPeaks) and the only shape-stable way under XLA. Invalid slots are filled
with -1.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from pydsproutines_tpu.ops.filters import medfilt


class Edges(NamedTuple):
    """Fixed-capacity [start, end) slice list. Only the first ``count`` rows
    are valid; invalid slots are -1."""
    starts: jnp.ndarray   # (capacity,) int32
    ends: jnp.ndarray     # (capacity,) int32, exclusive
    count: jnp.ndarray    # scalar int32


@functools.partial(jax.jit, static_argnames=("capacity", "min_length", "max_length"))
def threshold_edges(power: jnp.ndarray, threshold, capacity: int,
                    min_length: int = 0, max_length: int = 2**31 - 1) -> Edges:
    """Find [start, end) runs where ``power > threshold``, with length limits
    (reference detectViaThresholdWithLengthLimits, filterRoutines.py:848 and
    the thresholdEdges/gatherThresholdEdgesResults kernel pair).

    A run still open at the end of the array is closed at len(power) (the
    reference gather kernel's trailing-edge handling).
    """
    above = power > threshold
    prev = jnp.concatenate([jnp.zeros(1, dtype=bool), above[:-1]])
    rising = above & ~prev                      # run starts at i
    nxt = jnp.concatenate([above[1:], jnp.zeros(1, dtype=bool)])
    falling = above & ~nxt                      # run ends at i (inclusive)

    starts = jnp.nonzero(rising, size=capacity, fill_value=-1)[0].astype(jnp.int32)
    ends_inc = jnp.nonzero(falling, size=capacity, fill_value=-2)[0].astype(jnp.int32)
    ends = ends_inc + 1                          # exclusive
    n_runs = jnp.sum(rising).astype(jnp.int32)

    lengths = ends - starts
    valid = (jnp.arange(capacity) < n_runs) & (lengths >= min_length) & (lengths <= max_length)

    # compact the surviving runs to the front
    order = jnp.argsort(~valid, stable=True)     # valid first, stable
    invalid_sorted = jnp.sort(~valid)            # False (valid) first
    starts_c = jnp.where(invalid_sorted, -1, starts[order])
    ends_c = jnp.where(invalid_sorted, -1, ends[order])
    count = jnp.sum(valid).astype(jnp.int32)
    return Edges(starts_c, ends_c, count)


@functools.partial(jax.jit, static_argnames=("max_peaks",))
def find_local_maxima(x: jnp.ndarray, height, max_peaks: int):
    """Indices of local maxima above ``height`` (reference cupyFindLocalMaxima,
    cupyExtensions.py:651 / peakfinding.cu:15). Returns (indices, count) with
    fixed capacity ``max_peaks``; invalid slots are -1."""
    left = jnp.concatenate([jnp.full(1, -jnp.inf, x.dtype), x[:-1]])
    right = jnp.concatenate([x[1:], jnp.full(1, -jnp.inf, x.dtype)])
    is_peak = (x > left) & (x > right) & (x > height)
    idx = jnp.nonzero(is_peak, size=max_peaks, fill_value=-1)[0].astype(jnp.int32)
    return idx, jnp.sum(is_peak).astype(jnp.int32)


def auto_detect_threshold(medfiltered: jnp.ndarray, noise_levels: np.ndarray,
                          multiplier: float = 1.0):
    """Histogram-based noise-plateau threshold estimate (reference
    autoDetectThreshold, filterRoutines.py:877): histogram the median-filtered
    power over ``noise_levels`` bin edges and return the first bin edge that
    is a local minimum of the counts, scaled by ``multiplier``. Returns None
    if no local minimum exists (as the reference does)."""
    counts, edges = jnp.histogram(medfiltered, bins=jnp.asarray(noise_levels))
    counts = np.asarray(counts)
    for i in range(1, counts.size - 1):
        if counts[i] < counts[i - 1] and counts[i] < counts[i + 1]:
            return float(noise_levels[i]) * multiplier
    return None


@functools.partial(jax.jit, static_argnames=("iters",))
def kmeans2(x: jnp.ndarray, seed_lo, seed_hi, iters: int = 20):
    """Simple 1-D 2-means (replaces the reference's scipy.cluster.vq kmeans in
    detectSingleEmitter, filterRoutines.py:917). Returns (codebook_lo,
    codebook_hi) after ``iters`` Lloyd iterations from the given seeds."""
    def step(carry, _):
        lo, hi = carry
        assign_hi = jnp.abs(x - hi) < jnp.abs(x - lo)
        n_hi = jnp.maximum(jnp.sum(assign_hi), 1)
        n_lo = jnp.maximum(jnp.sum(~assign_hi), 1)
        new_hi = jnp.sum(jnp.where(assign_hi, x, 0)) / n_hi
        new_lo = jnp.sum(jnp.where(~assign_hi, x, 0)) / n_lo
        return (new_lo, new_hi), None
    (lo, hi), _ = jax.lax.scan(step, (jnp.asarray(seed_lo, x.dtype),
                                      jnp.asarray(seed_hi, x.dtype)),
                               None, length=iters)
    return lo, hi


class BurstDetector:
    """Median-filter + threshold burst detector (reference BurstDetector,
    filterRoutines.py:792), fixed-capacity outputs.

    Typical use::

        bd = BurstDetector(medfiltlen=64)
        bd.medfilt(x)                       # |x|^2 -> median filter
        thr = bd.auto_detect_threshold(np.arange(0, 1, 1e-2))
        edges = bd.detect_via_threshold(thr, capacity=256, min_length=100)
    """

    def __init__(self, medfiltlen: int):
        if medfiltlen % 2 != 1:
            raise ValueError("medfiltlen must be odd")
        self.medfiltlen = int(medfiltlen)
        self.amp_sq = None
        self.medfiltered = None
        self.threshold = None

    def medfilt(self, x: jnp.ndarray) -> jnp.ndarray:
        """Compute |x|^2 and median filter it (no need to abs first)."""
        self.amp_sq = (x.real * x.real + x.imag * x.imag) if jnp.iscomplexobj(x) \
            else x * x
        self.medfiltered = medfilt(self.amp_sq, self.medfiltlen)
        return self.medfiltered

    def detect_via_threshold(self, threshold: float, capacity: int = 256,
                             min_length: int = 0,
                             max_length: int = 2**31 - 1) -> Edges:
        self._require_medfilt()
        self.threshold = threshold
        return threshold_edges(self.medfiltered, threshold, capacity,
                               min_length, max_length)

    def auto_detect_threshold(self, noise_levels: np.ndarray,
                              multiplier: float = 1.0):
        self._require_medfilt()
        return auto_detect_threshold(self.medfiltered, noise_levels, multiplier)

    def detect_single_emitter(self, ratio: float = 4.0, capacity: int = 256,
                              min_length: int = 0,
                              max_length: int = 2**31 - 1) -> Edges:
        """2-means cluster of the filtered power; threshold = cluster-mean
        midpoint (reference detectSingleEmitter, filterRoutines.py:917)."""
        self._require_medfilt()
        x = self.medfiltered
        hi_seed = jnp.max(x)
        below = jnp.where(x < hi_seed / ratio, x, jnp.nan)
        lo_seed = jnp.nanmin(below)
        lo_seed = jnp.where(jnp.isnan(lo_seed), jnp.min(x), lo_seed)
        lo, hi = kmeans2(x, lo_seed, hi_seed)
        self.threshold = (lo + hi) / 2
        return threshold_edges(x, self.threshold, capacity, min_length, max_length)

    def detect_regular_sections(self, section_size_range,
                                ratio: float = 1.5):
        """Estimate the period of a regularly bursting signal (reference
        detectRegularSections, filterRoutines.py:938).

        For each candidate period P, the filtered power is folded into rows
        of length P and column-averaged; the correct period phase-aligns the
        bursts, so its P-point mean profile splits into the widest-separated
        2-means clusters. Returns (metric (S, 2) of [codebook gap,
        distortion], codebooks (S, 2)); pick the P with the largest gap.
        Candidate periods imply different fold shapes, so the scan runs one
        jitted fold+cluster per size (coarse-then-fine scans keep S small,
        as the reference docstring prescribes).
        """
        self._require_medfilt()
        sizes = np.asarray(section_size_range).astype(int)
        metric = np.zeros((sizes.size, 2))
        codebooks = np.zeros((sizes.size, 2))
        x = self.medfiltered
        n = int(x.shape[-1])
        for i, p in enumerate(sizes):
            prof = _fold_profile(x, int(p), n - n % int(p))
            hi_seed = jnp.max(prof)
            below = jnp.where(prof < hi_seed / ratio, prof, jnp.nan)
            lo_seed = jnp.nanmin(below)
            lo_seed = jnp.where(jnp.isnan(lo_seed), jnp.min(prof), lo_seed)
            lo, hi = kmeans2(prof, lo_seed, hi_seed)
            dist = jnp.mean(jnp.minimum(jnp.abs(prof - lo),
                                        jnp.abs(prof - hi)))
            codebooks[i] = (float(lo), float(hi))
            metric[i] = (float(hi - lo), float(dist))
        return metric, codebooks

    def _require_medfilt(self):
        if self.medfiltered is None:
            raise ValueError("Run medfilt() first.")


@functools.partial(jax.jit, static_argnames=("p", "trunc"))
def _fold_profile(x: jnp.ndarray, p: int, trunc: int) -> jnp.ndarray:
    """Column means of x[:trunc] folded into rows of length p."""
    return jnp.mean(jnp.abs(x[:trunc]).reshape(-1, p), axis=0)


def energy_detection(amp_sq: jnp.ndarray, medfiltlen: int,
                     snr_req_linear: float = 4.0, noise_indices=None,
                     capacity: int = 256):
    """Energy detector (reference energyDetection, filterRoutines.py:1031):
    median filter the power, estimate the noise floor over ``noise_indices``
    (default first 100k samples), and return runs exceeding
    noise*snr_req_linear.

    Returns (mean_noise, req_power, medfiltered, edges)."""
    if noise_indices is None:
        noise_indices = jnp.arange(min(100_000, amp_sq.shape[-1]))
    filtered = medfilt(amp_sq, medfiltlen)
    mean_noise = jnp.mean(filtered[noise_indices])
    req_power = mean_noise * snr_req_linear
    edges = threshold_edges(filtered, req_power, capacity)
    return mean_noise, req_power, filtered, edges
