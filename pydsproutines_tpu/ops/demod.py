"""PSK and CPFSK demodulation.

Reference semantics: /root/reference/demodulationRoutines.py
(SimpleDemodulatorPSK :44 — getEyeOpening :101, mapSyms :112, lockPhase :139,
ambleRotate :194, symsToBits :244, unpack/pack :273/:318, findPlainText :340,
detect_B_or_Q :396; SimpleDemodulatorBPSK :455, SimpleDemodulatorQPSK :475,
SimpleDemodulator8PSK :520; demodulateCP2FSK :1214; BurstyDemodulatorCP2FSK
:1261; ML_demod_QPSK :1366) and the fused GPU chain in
custom_kernels/demodulation.cu / eyeOpeningKernel.cu.

Design: every stage is batched and branch-free. The phase lock uses
the closed-form 2x2 symmetric eigen-decomposition (the same trick as the
reference's lockPhase_mapSyms_singleBlkKernel_qpsk CUDA kernel,
demodulation.cu:857-870) instead of an SVD; symbol mapping is a dot-product
against constellation vectors (a small matmul); the preamble rotation search is
a one-hot gather-sum over (shift, rotation). Everything vmaps over bursts.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from pydsproutines_tpu.utils.dtypes import real_dtype_for

# Constellations: monotonically increasing angle index (reference pskdicts).
_SQ2 = np.sqrt(2.0) / 2.0
PSK_CONSTS = {
    2: np.array([1.0, -1.0], dtype=np.complex128),
    4: np.array([1.0, 1.0j, -1.0, -1.0j], dtype=np.complex128),
    8: np.array([1.0, _SQ2 * (1 + 1j), 1.0j, _SQ2 * (-1 + 1j),
                 -1.0, _SQ2 * (-1 - 1j), -1.0j, _SQ2 * (1 - 1j)],
                dtype=np.complex128),
}
# Gray bit mapping per increasing angle index (reference pskbitmaps).
PSK_BITMAPS = {
    2: np.array([0b1, 0b0], dtype=np.uint8),
    4: np.array([0b11, 0b01, 0b00, 0b10], dtype=np.uint8),
    8: np.array([0b000, 0b001, 0b011, 0b010, 0b110, 0b111, 0b101, 0b100],
                dtype=np.uint8),
}


# ---------------------------------------------------------------------------
# Stage functions (all jit/vmap friendly)
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("osr",))
def get_eye_opening(x: jnp.ndarray, osr: int):
    """Best sampling phase by maximum mean |x| over OSR phases (reference
    getEyeOpening, demodulationRoutines.py:101; batched GPU variant
    eyeOpeningKernel.cu:5). Returns (resampled syms, phase index, metric)."""
    x_rs = x.reshape(-1, osr)
    metric = jnp.mean(jnp.abs(x_rs), axis=0)
    i = jnp.argmax(metric)
    return x_rs[:, i], i, metric


def _sym_eig2(a, b, c):
    """Eigen-decomposition of [[a, b], [b, c]]: returns (lam_max, lam_min,
    angle of principal eigenvector)."""
    tr = a + c
    half_diff = (a - c) / 2
    root = jnp.sqrt(half_diff * half_diff + b * b)
    lam_max = tr / 2 + root
    lam_min = tr / 2 - root
    theta = 0.5 * jnp.arctan2(2 * b, a - c)
    return lam_max, lam_min, theta


@functools.partial(jax.jit, static_argnames=("m",))
def lock_phase(reim: jnp.ndarray, m: int):
    """Blind phase lock: raise to m/2 power (fold to BPSK), form the 2x2 real
    self-product, take the principal eigenvector angle (reference lockPhase,
    demodulationRoutines.py:139 — SVD there, closed-form 2x2 eig here, as the
    reference's own CUDA kernel does). Returns (corrected, svd_metric, angle).
    """
    powerup = m // 2
    reimp = reim ** powerup
    re, im = reimp.real, reimp.imag
    a = jnp.sum(re * re)
    b = jnp.sum(re * im)
    c = jnp.sum(im * im)
    lam_max, lam_min, theta = _sym_eig2(a, b, c)
    svd_metric = lam_min / lam_max
    corrected = reim * jnp.exp(-1j * theta / powerup)
    return corrected, svd_metric, theta


@functools.partial(jax.jit, static_argnames=("m",))
def map_syms(reimc: jnp.ndarray, m: int) -> jnp.ndarray:
    """Map phase-locked samples to symbol indices 0..m-1 by max dot product
    with the constellation vectors (reference mapSyms,
    demodulationRoutines.py:112) — a (N, 2) x (2, m) matmul at full f32."""
    const = jnp.asarray(PSK_CONSTS[m], dtype=reimc.dtype)
    rdt = real_dtype_for(reimc.dtype)
    vecs = jnp.stack([const.real, const.imag]).astype(rdt)   # (2, m)
    pts = jnp.stack([reimc.real, reimc.imag], axis=-1).astype(rdt)  # (N, 2)
    metric = jnp.matmul(pts, vecs,
                        precision=jax.lax.Precision.HIGHEST)  # (N, m)
    return jnp.argmax(metric, axis=-1).astype(jnp.uint8)


@jax.jit
def map_syms_bpsk(reimc: jnp.ndarray) -> jnp.ndarray:
    """Specialized BPSK mapping: sign of the real part (reference
    SimpleDemodulatorBPSK.mapSyms, demodulationRoutines.py:463)."""
    return (reimc.real < 0).astype(jnp.uint8)


@jax.jit
def map_syms_qpsk(reimc: jnp.ndarray) -> jnp.ndarray:
    """Specialized QPSK quadrant-gray mapping (reference
    SimpleDemodulatorQPSK.mapSyms, demodulationRoutines.py:492). Assumes the
    constellation has been rotated into the 'box' (correctPhase adds pi/4).
    Arithmetic form of the gray table [[2,1],[3,0]] — a 2x2 table gather
    lowers to a scalar XLA gather per sample."""
    xp = (reimc.real > 0).astype(jnp.int32)
    yp = (reimc.imag > 0).astype(jnp.int32)
    return jnp.where(yp == 1, 1 - xp, 2 + xp).astype(jnp.uint8)


@jax.jit
def map_syms_8psk(reimc: jnp.ndarray, eo_scaling) -> jnp.ndarray:
    """Specialized 8PSK 3-comparator mapping (reference
    SimpleDemodulator8PSK.mapSyms, demodulationRoutines.py:540). ``eo_scaling``
    is the max eye-opening metric (amplitude scale)."""
    map8 = np.zeros((2, 2, 2), dtype=np.uint8)
    map8[1, 1, 1] = 0; map8[0, 1, 1] = 1; map8[1, 0, 1] = 2; map8[0, 0, 1] = 3
    map8[1, 1, 0] = 4; map8[0, 0, 0] = 5; map8[1, 0, 0] = 6; map8[0, 1, 0] = 7

    x, y = reimc.real, reimc.imag
    thresh = jnp.abs(jnp.abs(jnp.cos(np.pi / 8) * eo_scaling)
                     - jnp.abs(jnp.sin(np.pi / 8) * eo_scaling))
    xmy = jnp.abs(x) - jnp.abs(y)
    z = jnp.abs(xmy) - thresh
    c1z = z > 0
    cx2 = x > 0
    cy2 = y > 0
    cxmy2 = xmy > 0
    cx3 = cxmy2 & cx2
    cy3 = (~cxmy2) & cy2
    idx1 = (c1z & cxmy2) | ((~c1z) & cx2)
    idx2 = (c1z & (cx3 | cy3)) | ((~c1z) & cy2)
    idx0 = c1z
    # select chain over the 8 table entries instead of a 3-index table
    # gather
    lin = (idx0.astype(jnp.int32) * 4 + idx1.astype(jnp.int32) * 2
           + idx2.astype(jnp.int32))
    flat = np.asarray(map8).reshape(-1)
    out = jnp.zeros_like(lin)
    for v in range(8):
        out = jnp.where(lin == v, int(flat[v]), out)
    return out.astype(jnp.uint8)


@functools.partial(jax.jit, static_argnames=("m", "search_len", "amble_len"))
def compare_int_preambles(amble: jnp.ndarray, syms: jnp.ndarray, m: int,
                          search_start: int, search_len: int,
                          amble_len: int) -> jnp.ndarray:
    """Count preamble matches per (shift, rotation): matches[i, (p-s) % m] +=1
    (reference compareIntPreambles C routine,
    cython_ext/compareIntPreambles/compareIntPreambles.c:13). Vectorized as a
    one-hot sum — batched over all shifts and rotations at once."""
    shifts = search_start + jnp.arange(search_len)
    idx = shifts[:, None] + jnp.arange(amble_len)[None, :]
    windows = syms[idx].astype(jnp.int32)                    # (S, L)
    diff = jnp.mod(amble.astype(jnp.int32)[None, :] - windows, m)
    onehot = jax.nn.one_hot(diff, m, dtype=jnp.uint32)       # (S, L, m)
    return jnp.sum(onehot, axis=1)                           # (S, m)


@functools.partial(jax.jit, static_argnames=("m",))
def syms_to_bits(syms: jnp.ndarray, m: int, bitmap=None,
                 phase_sym_shift: int = 0) -> jnp.ndarray:
    """Map symbol indices to bit values via (rolled) bitmap (reference
    symsToBits, demodulationRoutines.py:244)."""
    bm = jnp.roll(jnp.asarray(PSK_BITMAPS[m] if bitmap is None else bitmap),
                  phase_sym_shift)
    # rolled-bitmap lookup as m selects instead of a table gather; bm may
    # be traced (phase_sym_shift often is), so select on values
    out = jnp.zeros(syms.shape, bm.dtype)
    for v in range(m):
        out = jnp.where(syms == v, bm[v], out)
    return out


def unpack_to_binary_bytes(packed: np.ndarray, m: int) -> np.ndarray:
    """One byte per bit expansion of symbol bit values (reference
    unpackToBinaryBytes, demodulationRoutines.py:273). Host-side numpy."""
    bits_per_val = int(np.log2(m))
    unpacked = np.unpackbits(np.asarray(packed, dtype=np.uint8)).reshape(-1, 8)
    return unpacked[:, -bits_per_val:]


def pack_binary_bytes_to_bits(unpacked: np.ndarray) -> np.ndarray:
    """np.packbits over the flattened unpacked matrix (reference
    packBinaryBytesToBits, demodulationRoutines.py:318)."""
    return np.packbits(np.asarray(unpacked).reshape(-1))


def find_plain_text(syms: np.ndarray, m: int, bitmap=None,
                    phase_sym_shift: int = 0):
    """Search symbol alignments for the most readable UTF-8 characters
    (reference findPlainText, demodulationRoutines.py:340). Host-side."""
    syms = np.asarray(syms)
    symbol_skips = np.arange(np.lcm(m, 8), dtype=np.uint32)
    utf8chars = np.zeros(symbol_skips.size, dtype=np.uint32)
    for i, skip in enumerate(symbol_skips):
        mapped = np.asarray(syms_to_bits(jnp.asarray(syms[skip:]), m, bitmap,
                                         phase_sym_shift))
        packed = pack_binary_bytes_to_bits(unpack_to_binary_bytes(mapped, m))
        utf8chars[i] = np.count_nonzero((packed >= 0x21) & (packed <= 0x7E))
    return int(np.argmax(utf8chars)), utf8chars


@jax.jit
def detect_b_or_q(reim: jnp.ndarray, threshold: float = 0.5):
    """BPSK-vs-QPSK classification via the 2x2 self-product eigenvalue ratio
    (reference detect_B_or_Q, demodulationRoutines.py:396). Row-wise for 2-D
    input. Returns (m array: 2 or 4, ratio array)."""
    reim2 = jnp.atleast_2d(reim)
    re, im = reim2.real, reim2.imag
    a = jnp.sum(re * re, axis=-1)
    b = jnp.sum(re * im, axis=-1)
    c = jnp.sum(im * im, axis=-1)
    lam_max, lam_min, _ = _sym_eig2(a, b, c)
    ratio = lam_min / lam_max
    m = jnp.where(ratio < threshold, 2, 4).astype(jnp.uint8)
    return m, ratio


# ---------------------------------------------------------------------------
# Demodulator classes (reference-compatible workflow)
# ---------------------------------------------------------------------------

class SimpleDemodulatorPSK:
    """Generic BPSK/QPSK/8PSK demodulator: eye-opening -> blind phase lock ->
    constellation mapping (reference SimpleDemodulatorPSK,
    demodulationRoutines.py:44)."""

    def __init__(self, m: int, bitmap=None, cluster_threshold: float = 0.1):
        self.m = int(m)
        self.bitmap = PSK_BITMAPS[self.m] if bitmap is None else np.asarray(bitmap)
        self.cluster_threshold = cluster_threshold
        # interim outputs (reference attribute parity)
        self.xeo = None
        self.xeo_i = None
        self.eo_metric = None
        self.reimc = None
        self.svd_metric = None
        self.angleCorrection = None
        self.syms = None
        self.matches = None

    # subclass hooks -------------------------------------------------------
    def _correct_phase(self, reim, phase):
        return reim * jnp.exp(1j * phase)

    def _map(self, reimc):
        return map_syms(reimc, self.m)

    # main chain -----------------------------------------------------------
    def demod(self, x: jnp.ndarray, osr: int):
        self.xeo, self.xeo_i, self.eo_metric = get_eye_opening(x, osr)
        reimc, self.svd_metric, theta = lock_phase(self.xeo, self.m)
        powerup = self.m // 2
        self.angleCorrection = theta
        self.reimc = self._correct_phase(self.xeo, -theta / powerup)
        self.syms = self._map(self.reimc)
        return self.syms

    def amble_rotate(self, amble: jnp.ndarray, search=None, syms=None):
        """Preamble search over shifts and constellation rotations (reference
        ambleRotate, demodulationRoutines.py:194). Returns (rotated syms,
        sample index, rotation, best match count)."""
        syms = self.syms if syms is None else syms
        amble = jnp.asarray(amble)
        if search is None:
            start, length = 0, syms.shape[-1] - amble.shape[-1] + 1
        else:
            search = np.asarray(search)
            start, length = int(search[0]), int(search[-1] - search[0] + 1)
        self.matches = compare_int_preambles(
            amble, syms, self.m, start, length, amble.shape[-1])
        flat = jnp.argmax(self.matches)
        s, rotation = jnp.unravel_index(flat, self.matches.shape)
        sample = start + s
        rotated = jnp.mod(syms + rotation, self.m).astype(jnp.uint8)
        best = self.matches[s, rotation]
        return rotated, sample, rotation, best

    def syms_to_bits(self, syms=None, phase_sym_shift: int = 0):
        syms = self.syms if syms is None else syms
        return syms_to_bits(syms, self.m, jnp.asarray(self.bitmap), phase_sym_shift)


class SimpleDemodulatorBPSK(SimpleDemodulatorPSK):
    """Specialized BPSK (reference :455)."""

    def __init__(self, bitmap=None, cluster_threshold: float = 0.1):
        super().__init__(2, bitmap, cluster_threshold)

    def _map(self, reimc):
        return map_syms_bpsk(reimc)


class SimpleDemodulatorQPSK(SimpleDemodulatorPSK):
    """Specialized QPSK with quadrant-gray comparators (reference :475)."""

    def __init__(self, bitmap=None, cluster_threshold: float = 0.1):
        super().__init__(4, bitmap, cluster_threshold)

    def _correct_phase(self, reim, phase):
        # rotate into the comparator 'box' (reference correctPhase adds pi/4)
        return reim * jnp.exp(1j * (phase + np.pi / 4))

    def _map(self, reimc):
        return map_syms_qpsk(reimc)


class SimpleDemodulator8PSK(SimpleDemodulatorPSK):
    """Specialized 8PSK 3-comparator demodulator (reference :520)."""

    def __init__(self, bitmap=None, cluster_threshold: float = 0.1):
        super().__init__(8, bitmap, cluster_threshold)

    def _map(self, reimc):
        return map_syms_8psk(reimc, jnp.max(self.eo_metric))


# ---------------------------------------------------------------------------
# Burst-batched PSK demod chain
# ---------------------------------------------------------------------------

class BatchDemodResult(NamedTuple):
    """Outputs of the burst-batched PSK chain (the reference's demodBatch
    output tuple, demodulationRoutines.py:1168-1175)."""
    reimc: jnp.ndarray          # (B, nsym) phase-locked constellation
    syms: jnp.ndarray           # (B, nsym) uint8 mapped symbols (pre-rotation)
    eo_idx: jnp.ndarray         # (B,) eye-opening phase per burst
    eo_metric: jnp.ndarray      # (B, osr)
    svd_metric: jnp.ndarray     # (B,) phase-lock cluster quality
    theta: jnp.ndarray          # (B,) phase-lock angle
    best_matches: jnp.ndarray   # (B,) best preamble match count
    best_rotations: jnp.ndarray  # (B,) winning constellation rotation
    best_idx: jnp.ndarray       # (B,) winning preamble start (symbol index)
    rotated_syms: jnp.ndarray   # (B, nsym) rotation-corrected symbols
    bits: jnp.ndarray           # (B, num_out_syms*bps) unpacked payload bits
    bit_counts: jnp.ndarray     # (B,) valid symbols written per burst


@functools.partial(jax.jit, static_argnames=(
    "m", "osr", "search_start", "search_len", "amble_len", "num_out_syms",
    "variant"))
def _psk_demod_batch_impl(xbatch, lengths, amble, *, m, osr, search_start,
                          search_len, amble_len, num_out_syms, variant):
    """Whole burst-batched chain in one trace: masked eye-opening -> masked
    2x2-eig phase lock -> constellation map -> preamble shift/rotation search
    -> payload cut + rotate + bit unpack. The re-expression of the
    reference's one-block-per-burst fused kernel
    (custom_kernels/demodulation.cu:814, eyeOpeningKernel.cu:5): vmap over the
    burst axis replaces the CUDA block axis; XLA fuses the stages.
    """
    B, L = xbatch.shape
    nsym = L // osr
    rdt = real_dtype_for(xbatch.dtype)
    # phase-major (B, osr, nsym) layout: the long nsym axis is minor (the
    # natural reshape (B, nsym, osr) would put osr, often 4, there).
    xp = xbatch[:, : nsym * osr]
    x_po = jnp.stack([xp[:, p::osr] for p in range(osr)], axis=1)
    pos_po = (jnp.arange(nsym)[None, :] * osr
              + jnp.arange(osr)[:, None]).astype(jnp.int32)   # (osr, nsym)
    mask_po = pos_po[None, :, :] < lengths[:, None, None]     # (B, osr, nsym)

    # -- eye opening (masked mean |x| per phase) ------------------------------
    absx = jnp.abs(x_po).astype(rdt)
    counts = jnp.sum(mask_po, axis=2).astype(rdt)             # (B, osr)
    eo_metric = jnp.sum(absx * mask_po, axis=2) / jnp.maximum(counts, 1)
    eo_idx = jnp.argmax(eo_metric, axis=-1)                   # (B,)
    xeo = jnp.take_along_axis(
        x_po, eo_idx[:, None, None], axis=1)[:, 0, :]         # (B, nsym)
    symmask = jnp.take_along_axis(
        mask_po, eo_idx[:, None, None], axis=1)[:, 0, :]      # (B, nsym)
    nsym_valid = jnp.sum(symmask, axis=1).astype(jnp.int32)   # (B,)

    # -- blind phase lock (masked 2x2 self-product, closed-form eig) ----------
    powerup = m // 2
    reimp = jnp.where(symmask, xeo, 0) ** powerup
    re, im = reimp.real.astype(rdt), reimp.imag.astype(rdt)
    a = jnp.sum(re * re, axis=1)
    b = jnp.sum(re * im, axis=1)
    c = jnp.sum(im * im, axis=1)
    lam_max, lam_min, theta = _sym_eig2(a, b, c)
    svd_metric = lam_min / jnp.maximum(lam_max, jnp.finfo(rdt).tiny)
    box = np.pi / 4 if variant == "qpsk" else 0.0
    reimc = xeo * jnp.exp(1j * (-theta / powerup + box))[:, None]

    # -- constellation mapping -------------------------------------------------
    if variant == "bpsk":
        syms = map_syms_bpsk(reimc)
    elif variant == "qpsk":
        syms = map_syms_qpsk(reimc)
    elif variant == "8psk":
        syms = jax.vmap(
            lambda row, s: map_syms_8psk(row, s))(reimc,
                                                  jnp.max(eo_metric, axis=1))
    else:
        syms = map_syms(reimc.reshape(-1), m).reshape(B, nsym)

    # -- preamble shift x rotation search (all bursts) ------------------------
    # windows via a stack of STATIC slices (instead of advanced-index
    # gathers or per-(a, r) accumulate loops of small ops), then ONE
    # broadcast compare against all (rotation, position) targets
    shifts = search_start + jnp.arange(search_len)
    syms_i = syms.astype(jnp.int32)
    windows = jnp.stack(
        [jax.lax.slice(syms_i, (0, search_start + a),
                       (B, search_start + a + search_len))
         for a in range(amble_len)], axis=-1)                    # (B, S, A)
    # tgt[r, a] = (amble[a] - r) mod m: rotated window matches amble at a
    tgt = jnp.mod(amble.astype(jnp.int32)[None, :]
                  - jnp.arange(m, dtype=jnp.int32)[:, None], m)  # (m, A)
    eq = (windows[:, :, None, :] == tgt[None, None, :, :])
    matches = jnp.sum(eq.astype(jnp.int32), axis=-1)             # (B, S, m)
    # shifts whose amble window runs past the burst's valid symbols lose
    valid_shift = (shifts[None, :] + amble_len) <= nsym_valid[:, None]
    matches = jnp.where(valid_shift[:, :, None], matches, -1)
    flat = jnp.argmax(matches.reshape(B, -1), axis=1)
    s_best = (flat // m).astype(jnp.int32)
    best_rotations = (flat % m).astype(jnp.int32)
    best_idx = search_start + s_best
    best_matches = jnp.take_along_axis(
        matches.reshape(B, -1), flat[:, None], axis=1)[:, 0]
    rotated = jnp.mod(syms.astype(jnp.int32) + best_rotations[:, None],
                      m).astype(jnp.uint8)

    # -- payload cut + bit unpack (reference cutAndRotateFromPreambles) -------
    out_pos = best_idx[:, None] + amble_len + jnp.arange(num_out_syms)[None, :]
    in_range = out_pos < nsym_valid[:, None]
    # contiguous per-burst cut: one dynamic slice per row (a take_along_axis
    # here is a scalar gather over B*num_out_syms elements). Right padding
    # keeps the slice un-clamped when the cut runs past the burst end; the
    # zero tail is masked out by in_range regardless.
    rotated_p = jnp.pad(rotated, ((0, 0), (0, num_out_syms)))
    gathered = jax.vmap(
        lambda row, s: jax.lax.dynamic_slice(row, (s,), (num_out_syms,)))(
        rotated_p, best_idx + amble_len)
    gathered = jnp.where(in_range, gathered, 0)
    bit_counts = jnp.sum(in_range, axis=1).astype(jnp.int32)
    bps = int(np.log2(m))
    # tiny-table lookup as a select chain instead of a gather
    bmap = np.asarray(PSK_BITMAPS[m]).astype(np.int32)
    bitvals = jnp.zeros_like(gathered, dtype=jnp.int32)
    for v in range(m):
        bitvals = jnp.where(gathered == v, int(bmap[v]), bitvals)
    # unpack to one byte per bit, MSB first (reference unpackToBinaryBytes)
    shifts_b = np.arange(bps - 1, -1, -1, dtype=np.int32)
    bits = ((bitvals[:, :, None] >> shifts_b[None, None, :]) & 1).astype(
        jnp.uint8).reshape(B, num_out_syms * bps)
    bits = jnp.where(jnp.repeat(in_range, bps, axis=1), bits, 0)

    return BatchDemodResult(
        reimc=reimc, syms=syms, eo_idx=eo_idx.astype(jnp.int32),
        eo_metric=eo_metric, svd_metric=svd_metric, theta=theta,
        best_matches=best_matches, best_rotations=best_rotations,
        best_idx=best_idx, rotated_syms=rotated, bits=bits,
        bit_counts=bit_counts)


class DemodulatorBatchPSK:
    """Burst-batched PSK demodulator: the full eye-opening -> phase-lock ->
    map -> preamble-search -> bit-cut chain over a (bursts, maxlen) matrix
    with per-burst lengths/masks, in ONE jitted program (reference
    CupyDemodulatorQPSK.demodBatch / getEyeOpeningBatch / cutAndRotate-
    FromPreambles, demodulationRoutines.py:915-1175, and the fused kernel
    custom_kernels/demodulation.cu:814).

    ``variant`` picks the specialized mapping ("bpsk"/"qpsk"/"8psk"), default
    the generic dot-product map. Symbol/rotation conventions match
    ``SimpleDemodulatorPSK`` exactly, so batched output row b equals the
    single-burst chain run on ``xbatch[b, :lengths[b]]``.
    """

    def __init__(self, m: int, variant: str = "generic", bitmap=None):
        self.m = int(m)
        self.variant = variant
        self.bitmap = PSK_BITMAPS[self.m] if bitmap is None else np.asarray(bitmap)

    def demod_batch(self, xbatch: jnp.ndarray, osr: int, amble,
                    search_start: int = 0, search_len: int = 128,
                    num_out_syms: int | None = None,
                    lengths=None) -> BatchDemodResult:
        B, L = xbatch.shape
        nsym = L // osr
        amble = jnp.asarray(amble)
        if lengths is None:
            lengths = jnp.full((B,), L, dtype=jnp.int32)
        else:
            lengths = jnp.asarray(lengths, dtype=jnp.int32)
        if num_out_syms is None:
            num_out_syms = nsym - int(amble.shape[-1]) - search_start
        search_len = int(min(search_len, nsym - int(amble.shape[-1])
                             - search_start + 1))
        return _psk_demod_batch_impl(
            xbatch, lengths, amble, m=self.m, osr=int(osr),
            search_start=int(search_start), search_len=search_len,
            amble_len=int(amble.shape[-1]),
            num_out_syms=int(num_out_syms), variant=self.variant)


class DemodulatorBatchQPSK(DemodulatorBatchPSK):
    """QPSK burst-batched chain (reference CupyDemodulatorQPSK,
    demodulationRoutines.py:915)."""

    def __init__(self, bitmap=None):
        super().__init__(4, "qpsk", bitmap)


# ---------------------------------------------------------------------------
# CPFSK demodulation
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("up",))
def demodulate_cp2fsk(syms: jnp.ndarray, h: float, up: int):
    """2-tone dot-product CP2FSK demod (reference demodulateCP2FSK,
    demodulationRoutines.py:1214). Returns (bits, bitCost, tones)."""
    rdt = real_dtype_for(syms.dtype)
    mvals = jnp.asarray([[-1.0], [1.0]], dtype=rdt)
    phase = jnp.pi * h * jnp.arange(up, dtype=rdt) / up
    tones = jnp.exp(1j * phase[None, :] * mvals).astype(syms.dtype)  # (2, up)
    num_syms = syms.shape[-1] // up
    folded = syms[: num_syms * up].reshape(num_syms, up)
    # cost[k, i] = |vdot(symbol_i, tone_k)| = |sum(conj(symbol) * tone)|
    prods = jnp.conj(folded) @ tones.T                        # (numSyms, 2)
    bit_cost = jnp.abs(prods).T                               # (2, numSyms)
    bits = jnp.argmax(bit_cost, axis=0).astype(jnp.uint8)
    return bits, bit_cost, tones


class BurstyDemodulatorCP2FSK:
    """Joint synchronous demodulation of regularly spaced CP2FSK bursts
    (reference BurstyDemodulatorCP2FSK, demodulationRoutines.py:1261): one
    correlation pass against both tones, then the per-symbol max costs are
    summed across all bursts at each candidate alignment; the argmax alignment
    demodulates every burst at once."""

    def __init__(self, burst_len: int, guard_len: int, up: int = 1,
                 h: float = 0.5):
        self.burst_len = int(burst_len)
        self.guard_len = int(guard_len)
        self.period = self.burst_len + self.guard_len
        self.up = int(up)
        self.h = float(h)
        self.burst_idxs = None
        self.d_costs = None
        self.search_idx = None

    def set_burst_idxs(self, burst_idxs):
        self.burst_idxs = np.asarray(burst_idxs)

    def demod(self, x: jnp.ndarray, num_bursts: int | None = None,
              search_idx=None):
        if self.burst_idxs is None:
            if num_bursts is None:
                raise ValueError("set_burst_idxs() first or pass num_bursts")
            self.set_burst_idxs(np.arange(num_bursts))

        up, h = self.up, self.h
        rdt = real_dtype_for(x.dtype)
        phase = jnp.pi * h * jnp.arange(up, dtype=rdt) / up
        gtone = jnp.exp(1j * phase).astype(x.dtype)
        tones = jnp.stack([jnp.conj(gtone), gtone])           # (2, up)

        # one-pass correlation: xc[k, i] = sum_j x[i+j] * conj(tones[k, j])
        n_out = x.shape[-1] - up + 1
        idx = jnp.arange(n_out)[:, None] + jnp.arange(up)[None, :]
        windows = x[idx]                                      # (n_out, up)
        xc = windows @ jnp.conj(tones).T                      # (n_out, 2)
        xc_abs = jnp.abs(xc)
        xc_argmax = jnp.argmax(xc_abs, axis=-1)
        xc_max = jnp.max(xc_abs, axis=-1)

        burst_starts = self.burst_idxs * self.period * up
        symbol_spacing = np.arange(0, self.burst_len * up, up)
        gen_idx = (burst_starts[:, None] + symbol_spacing[None, :]).flatten()

        if search_idx is None:
            search_idx = np.arange(n_out - int(gen_idx[-1]))
        search_idx = np.asarray(search_idx)
        gi = jnp.asarray(gen_idx)
        si = jnp.asarray(search_idx)
        costs = jnp.sum(xc_max[si[:, None] + gi[None, :]], axis=-1)
        self.d_costs = costs
        self.search_idx = search_idx

        mi = si[jnp.argmax(costs)]
        dbits = xc_argmax[mi + gi].reshape(-1, self.burst_len).astype(jnp.uint8)
        return dbits, mi


def ml_demod_qpsk(y: jnp.ndarray, h: jnp.ndarray, up: int, num_syms: int):
    """Brute-force ML QPSK over all 4^num_syms sequences (reference
    ML_demod_QPSK, demodulationRoutines.py:1366), fully batched: all candidate
    symbol sequences are synthesized and convolved with the channel at once.
    Returns (best base-4 sequence, best index, cost array)."""
    total = 4 ** num_syms
    # base-4 digits of every candidate, most significant first
    ints = np.arange(total)
    digits = np.stack([(ints // 4 ** (num_syms - 1 - k)) % 4
                       for k in range(num_syms)], axis=1).astype(np.uint8)
    syms = jnp.exp(1j * jnp.asarray(digits) * (np.pi / 2)).astype(y.dtype)
    ups = jnp.zeros((total, num_syms * up), dtype=y.dtype)
    ups = ups.at[:, ::up].set(syms)
    h = jnp.asarray(h, dtype=y.dtype)
    test = jax.vmap(lambda row: jnp.convolve(row, h, mode="full"))(ups)
    test = test[:, up: up + y.shape[-1]]
    cost = -jnp.linalg.norm(test - y[None, :], axis=-1)
    ii = int(jnp.argmax(cost))
    return digits[ii], ii, cost
