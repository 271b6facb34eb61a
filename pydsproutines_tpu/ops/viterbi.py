"""Viterbi demodulation of multi-source CPM-like signals.

Reference semantics: /root/reference/viterbiDemodClasses.py (ViterbiDemodulator
:18 — run :53, calcAllBranchMetrics :143, calcPathMetrics :233,
genOmegaVectors :256) and its native C++ port
(cython_ext/PyViterbiDemodulator/viterbiDemodulator.cpp).

Model: states are the alphabet symbols; each state keeps one survivor path.
The branch metric from predecessor state q to state p at symbol step n is

    || y[n*up : n*up+pulselen] - sum_i pulse_i * upsampled(path) .
       exp(-j*omega_i*(n*up+k)) ||^2

where the synthesized segment only depends on the last pulselen/up symbols of
the survivor path. The path metric accumulates the *short* branch metric (the
first ``up`` samples only).

Design: the reference spawns per-symbol worker threads with condition
variables (viterbiDemodulator.h:57-61); that design does not transfer. Here
the trellis is a ``lax.scan`` over symbols whose step vmaps over (state x
pre-transition) pairs; each survivor carries a fixed-length window of its last
pulselen/up symbols (all the branch metric needs), so the step is static-shape
and fuses into a handful of batched convolution/matmul ops. Throughput comes
from vmapping whole bursts, not from parallelizing one trellis (SURVEY.md §7).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


class ViterbiDemodulator:
    """Trellis demodulator (reference ViterbiDemodulator,
    viterbiDemodClasses.py:18).

    Parameters
    ----------
    alphabet : (A,) complex — constellation symbol values.
    pretransitions : (A, T) int — allowed predecessor states per state.
    pulses : (L, pulselen) complex — per-source pulse shapes (constant
        amplitude/phase embedded).
    omegas : (L,) float — per-source angular frequency offsets (rad/sample).
    up : int — samples per symbol.
    allowed_start_idx : int array — states allowed at symbol 0.
    """

    def __init__(self, alphabet, pretransitions, pulses, omegas, up: int,
                 allowed_start_idx=np.array([0]),
                 survivor_metric: str = "branch"):
        # trellis constants stay HOST numpy and are embedded as program
        # constants in the per-instance jitted closure
        if survivor_metric not in ("branch", "path"):
            raise ValueError("survivor_metric must be 'branch' (reference "
                             "semantics) or 'path' (textbook ACS)")
        self.survivor_metric = survivor_metric
        self.alphabet = np.asarray(alphabet, dtype=np.complex64)
        self.pretransitions = np.asarray(pretransitions, dtype=np.int32)
        if self.alphabet.shape[0] != self.pretransitions.shape[0]:
            raise ValueError("Number of transitions is inconsistent.")
        self.pulses = np.asarray(pulses, dtype=np.complex64)
        self.omegas = np.asarray(omegas, dtype=np.float32)
        self.up = int(up)
        if self.omegas.shape[0] != self.pulses.shape[0]:
            raise ValueError("Number of sources is inconsistent.")
        self.pulselen = int(self.pulses.shape[1])
        if self.pulselen % self.up != 0:
            raise ValueError("pulse length must be a multiple of up")
        self.pulse_len_in_syms = self.pulselen // self.up
        self.allowed_start_idx = np.asarray(allowed_start_idx)
        self._run_fns = {}

    def run(self, y: jnp.ndarray, pathlen: int):
        """Demodulate ``pathlen`` symbols from ``y``. Returns (best path
        symbol values, final path metrics, all survivor paths)."""
        pathlen = int(pathlen)
        fn = self._run_fns.get(pathlen)
        if fn is None:
            a_mask = np.zeros(self.alphabet.shape[0], dtype=bool)
            a_mask[self.allowed_start_idx] = True
            alphabet, pretransitions = self.alphabet, self.pretransitions
            pulses, omegas = self.pulses, self.omegas
            up, pulselen = self.up, self.pulselen
            k_syms = self.pulse_len_in_syms

            survivor = self.survivor_metric

            pret_static = tuple(map(tuple, pretransitions.tolist()))
            start_static = tuple(bool(v) for v in a_mask)

            def _impl(y):
                paths, metrics = _viterbi_run(
                    y.astype(jnp.complex64), jnp.asarray(alphabet),
                    jnp.asarray(pretransitions), jnp.asarray(pulses),
                    jnp.asarray(omegas), jnp.asarray(a_mask), up=up,
                    pulselen=pulselen, k_syms=k_syms, pathlen=pathlen,
                    survivor_metric=survivor, pret_static=pret_static,
                    start_static=start_static)
                best = jnp.argmin(metrics)
                vals = jnp.asarray(alphabet)[paths]
                return vals[best], metrics, vals

            fn = self._run_fns.setdefault(pathlen, jax.jit(_impl))
        return fn(y)


# fast-path caps: branch-metric table is (pathlen, codes) with
# codes = (A+1)^k_syms; the synth tensor adds (pathlen, codes, pulselen)
_VITERBI_MAX_CODES = 1024
_VITERBI_MAX_TABLE = 1 << 24

# min-plus associative-scan caps (ADVICE round-4: the compose step
# materializes O(pathlen * S^3)-element intermediates per scan level with
# no size gate). S = states in the min-plus recursion ((A+1)^k_syms for
# the pulse-memory MLSE, A for the memoryless path variant); the scan
# builds (pathlen, S, S) matrices and each compose level touches
# ~pathlen * S^3 candidate sums.
_ACS_MAX_STATES = 128
_ACS_MAX_ELEMS = 1 << 27        # pathlen * S^3 budget (f32 elements)


def _viterbi_acs_viable(a: int, k_syms: int, pathlen: int) -> bool:
    s = (a + 1) ** k_syms if k_syms > 1 else a
    return s <= _ACS_MAX_STATES and pathlen * s ** 3 <= _ACS_MAX_ELEMS


def _viterbi_fast_viable(a: int, k_syms: int, pathlen: int,
                         pulselen: int) -> bool:
    codes = (a + 1) ** k_syms
    return (codes <= _VITERBI_MAX_CODES
            and pathlen * codes * pulselen <= _VITERBI_MAX_TABLE)


@functools.partial(jax.jit,
                   static_argnames=("up", "pulselen", "k_syms", "pathlen",
                                    "survivor_metric", "pret_static",
                                    "start_static"))
def _viterbi_run(y, alphabet, pretransitions, pulses, omegas, start_mask, *,
                 up, pulselen, k_syms, pathlen,
                 survivor_metric: str = "branch", pret_static=None,
                 start_static=None):
    """Dispatcher.

    * k_syms == 1 (memoryless pulses — the CPFSK norm): the branch metric
      depends only on (step, state), never on the predecessor, so ALL
      branch metrics precompute in one vectorized pass and the sequential
      part is a tiny gather/add ACS (_viterbi_run_memoryless) — ~10x less
      serial work per symbol than the general scan.
    * otherwise: the general scan. The table path (_viterbi_run_fast,
      parity-kept) stays non-default.

    ``survivor_metric``: "branch" (default) reproduces the reference's
    survivor selection — argmin over the BRANCH metric only
    (/root/reference/viterbiDemodClasses.py:243). For memoryless pulses
    that selection is degenerate (branch metrics are identical across
    predecessors, ties always break to transition 0 — proved in round 3).
    "path" is the deliberate semantics improvement: survivors minimize
    path metric + branch metric, the textbook Viterbi recursion.
    """
    if k_syms == 1:
        return _viterbi_run_memoryless(
            y, alphabet, pretransitions, pulses, omegas, start_mask, up=up,
            pulselen=pulselen, pathlen=pathlen,
            survivor_metric=survivor_metric, pret_static=pret_static,
            start_static=start_static)
    if (survivor_metric == "path" and pret_static is not None
            and _viterbi_acs_viable(alphabet.shape[0], k_syms, pathlen)):
        # pulse-memory MLSE as a min-plus associative scan over the
        # (A+1)^k_syms window-state trellis (round-5; see
        # _viterbi_run_path_acs). Size-gated: large state counts or long
        # paths fall back to the sequential scan below.
        return _viterbi_run_path_acs(
            y, alphabet, pretransitions, pulses, omegas, start_mask, up=up,
            pulselen=pulselen, k_syms=k_syms, pathlen=pathlen,
            pret_static=pret_static, start_static=start_static)
    return _viterbi_run_scan(
        y, alphabet, pretransitions, pulses, omegas, start_mask, up=up,
        pulselen=pulselen, k_syms=k_syms, pathlen=pathlen,
        survivor_metric=survivor_metric)


def _branch_idx_tables(pret: np.ndarray, start: np.ndarray, pathlen: int):
    """Host unroll of the FAITHFUL (branch-metric-only) survivor recursion
    for memoryless pulses.

    Round-3 proof, taken to its conclusion: with k_syms == 1 the branch
    metric is identical across predecessors, so the scan's survivor choice
    depends only on which predecessors are alive — and aliveness evolves
    data-INDEPENDENTLY (alive'[p] = any(alive[pret[p]])). The entire
    backpointer structure therefore unrolls on the host; the device-side
    algorithm collapses to one gather + sum over the precomputed branch
    tables (no sequential scan at all). Ties break to the first alive
    transition, and dead states take pret[p, 0], exactly as argmin over
    inf-masked equal values does in the scan.

    Returns (idx, alive_final): idx[m, p] = survivor state at symbol m of
    the path ending in state p — these ARE the survivor paths."""
    A, T = pret.shape
    alive = start.astype(bool).copy()
    bq = np.zeros((pathlen, A), np.int32)
    for n in range(1, pathlen):
        new_alive = np.zeros(A, bool)
        for p in range(A):
            ts = [t for t in range(T) if alive[pret[p, t]]]
            bq[n, p] = pret[p, ts[0] if ts else 0]
            new_alive[p] = bool(ts)
        alive = new_alive
    idx = np.zeros((pathlen, A), np.int32)
    idx[pathlen - 1] = np.arange(A)
    for m in range(pathlen - 1, 0, -1):
        idx[m - 1] = bq[m, idx[m]]
    return idx, alive


@functools.partial(jax.jit,
                   static_argnames=("up", "pulselen", "pathlen",
                                    "survivor_metric", "unroll",
                                    "pret_static", "start_static"))
def _viterbi_run_memoryless(y, alphabet, pretransitions, pulses, omegas,
                            start_mask, *, up, pulselen, pathlen,
                            survivor_metric: str = "branch",
                            unroll: int = 8, pret_static=None,
                            start_static=None):
    """Memoryless-pulse (k_syms == 1) trellis: precomputed branch tables +
    a backpointer ACS scan + backtrack.

    With pulselen == up the synthesized segment for state p is just
    alphabet[p] * pulse (no survivor-window dependence), so bm[n, p]
    precomputes for every step in one pass:

        s[n, p, t] = alphabet[p] * sum_i pulse_i[t] e^{-j omega_i (n up+t)}
        bm[n, p]   = || valid(y[n up + t]) - s[n, p, t] ||^2

    The scan body is then 5 tiny ops on (A,) vectors emitting one (A,)
    backpointer row — no synth, no (A, pathlen) path-matrix rewrite (the
    general scan's per-step path copy alone is A*pathlen elements/step).
    Semantics identical to _viterbi_run_scan for k_syms == 1, including
    dead-predecessor inf masking and the reference's tie-to-first-
    transition survivor choice."""
    A = alphabet.shape[0]
    ylen = y.shape[0]
    inf = jnp.float32(jnp.inf)
    ypad = jnp.concatenate([y, jnp.zeros(pulselen + up, dtype=y.dtype)])

    # ---- branch tables, one pass --------------------------------------------
    n_all = jnp.arange(pathlen, dtype=jnp.float32)
    t_rel = jnp.arange(pulselen, dtype=jnp.float32)
    phase = jnp.exp(-1j * omegas[None, :, None]
                    * (n_all[:, None, None] * up + t_rel[None, None, :]))
    base = jnp.einsum("it,nit->nt", pulses.astype(jnp.complex64),
                      phase.astype(jnp.complex64))         # (pathlen, P)
    s = alphabet[None, :, None] * base[:, None, :]          # (pathlen, A, P)
    idx = (jnp.arange(pathlen)[:, None] * up
           + jnp.arange(pulselen)[None, :])
    ywin = ypad[idx]                                        # (pathlen, P)
    valid = idx < ylen
    d = jnp.where(valid[:, None, :], ywin[:, None, :] - s, 0.0)
    dsq = d.real * d.real + d.imag * d.imag
    bm_full = jnp.sum(dsq, axis=-1)                         # (pathlen, A)
    bm_short = jnp.sum(dsq[..., :up], axis=-1)

    if (survivor_metric == "branch" and pret_static is not None
            and start_static is not None):
        # data-independent control flow: host-precomputed survivor indices,
        # device work = one gather + sum (see _branch_idx_tables)
        idx_np, alive_final = _branch_idx_tables(
            np.asarray(pret_static, np.int32),
            np.asarray(start_static, bool), pathlen)
        gat = jnp.take_along_axis(bm_short, jnp.asarray(idx_np), axis=1)
        metrics = jnp.where(jnp.asarray(alive_final),
                            jnp.sum(gat, axis=0), inf)
        return jnp.asarray(idx_np.T), metrics

    if (survivor_metric == "path" and pathlen > 1
            and _viterbi_acs_viable(A, 1, pathlen)):
        # (size-gated: the compose step materializes O(pathlen * A^3)
        # intermediates; larger trellises take the sequential scan below)
        # The memoryless path-metric recursion is a MIN-PLUS AFFINE map per
        # symbol: m_n[p] = min_t m_{n-1}[pret[p,t]] + bm_short[n, p] (the
        # bm_full term is constant across t here, so selection reduces to
        # argmin over predecessor path metrics). Min-plus maps compose
        # associatively, so ALL prefix metrics evaluate in logarithmic
        # depth over (A, A) min-plus matrices — the serial 6-us-per-step
        # ACS scan (launch-latency bound, exp_viterbi_unroll.py)
        # disappears while the recursion stays fully data-DEPENDENT
        # (unlike the 'branch' static tables). Backtracking composes
        # (A,)-index maps the same way (blocked chain core below).
        pret = pretransitions
        A_ = A
        T = pret.shape[1]
        # per-step matrices M_n[p, j] = bm_short[n, p] + (0 if j is a
        # predecessor of p else inf), for n = 1..pathlen-1
        adj = jnp.full((A_, A_), inf).at[
            jnp.arange(A_)[:, None], pret].set(0.0)      # static indices
        # B=1 route through the blocked three-phase chain core (round 5:
        # jax's associative_scan re-slices the whole array per level —
        # see _minplus_chain_batched)
        mats = (bm_short[1:, :, None] + adj[None, :, :])[..., None]
        m0 = jnp.where(start_mask, bm_short[0], inf)
        metrics_b, codeseq = _minplus_chain_batched(
            mats, m0[:, None], pret, np.ones((A_, T), bool))
        return codeseq[..., 0].T.astype(jnp.int32), metrics_b[:, 0]

    metrics0 = jnp.where(start_mask, bm_short[0], inf)
    pret = pretransitions

    def step(metrics, n):
        pre = metrics[pret]                                 # (A, T)
        pre_inf = jnp.isinf(pre)
        if survivor_metric == "path":
            # textbook ACS: minimize path + branch (branch is constant in
            # t here, so this is argmin over predecessor path metrics)
            cand = jnp.where(pre_inf, inf, pre + bm_full[n][:, None])
        else:
            # reference semantics: branch metric only — constant across t,
            # so argmin returns the FIRST alive transition (ties to 0)
            cand = jnp.where(pre_inf, inf, bm_full[n][:, None])
        best_t = jnp.argmin(cand, axis=1)
        best_q = jnp.take_along_axis(pret, best_t[:, None], axis=1)[:, 0]
        all_inf = jnp.all(pre_inf, axis=1)
        new_metrics = jnp.where(all_inf, inf, metrics[best_q] + bm_short[n])
        return new_metrics, best_q

    metrics, backptr = jax.lax.scan(
        step, metrics0, jnp.arange(1, pathlen, dtype=jnp.int32),
        unroll=unroll)

    # ---- backtrack every final state's survivor path -------------------------
    def trace(s, bp):
        return bp[s], s

    def trace_one(end):
        first, rest = jax.lax.scan(trace, end, backptr, reverse=True,
                                   unroll=unroll)
        return jnp.concatenate([first[None], rest])

    paths = jax.vmap(trace_one)(jnp.arange(A, dtype=jnp.int32))
    return paths, metrics


def _code_branch_tables(y, alphabet, pulses, omegas, *, up, pulselen,
                        k_syms, pathlen):
    """(bm_full, bm_short) branch-metric tables over (pathlen, codes),
    codes = (A+1)^k_syms window codes (digit 0 = pre-start silence, digit
    a+1 = alphabet[a], oldest..newest). One vectorized pass: per-code pulse
    synth + per-step source phases, shared by the table-driven scan and the
    min-plus MLSE."""
    A = alphabet.shape[0]
    ylen = y.shape[0]
    base = A + 1
    codes = base ** k_syms
    ypad = jnp.concatenate([y, jnp.zeros(pulselen + up, dtype=y.dtype)])
    cvec = np.arange(codes)
    digits = (cvec[:, None] // base ** np.arange(k_syms - 1, -1, -1)[None, :]
              ) % base
    valtable = jnp.concatenate(
        [jnp.zeros(1, alphabet.dtype), alphabet])
    win_syms = valtable[jnp.asarray(digits)]              # (codes, k_syms)
    upw = jnp.zeros((codes, k_syms * up), dtype=alphabet.dtype)
    upw = upw.at[:, ::up].set(win_syms)

    def conv_code(w):
        def one_src(pulse):
            c = jnp.convolve(w, pulse, mode="full")
            return jax.lax.dynamic_slice(c, ((k_syms - 1) * up,),
                                         (pulselen,))
        return jax.vmap(one_src)(pulses)
    s0 = jax.vmap(conv_code)(upw)                         # (codes, L, P)

    n_all = jnp.arange(pathlen, dtype=jnp.float32)
    t_rel = jnp.arange(pulselen, dtype=jnp.float32)
    phase = jnp.exp(-1j * omegas[None, :, None]
                    * (n_all[:, None, None] * up + t_rel[None, None, :]))
    S = jnp.einsum("cit,nit->nct", s0.astype(jnp.complex64),
                   phase.astype(jnp.complex64))           # (pathlen, codes, P)
    idx = (jnp.arange(pathlen)[:, None] * up
           + jnp.arange(pulselen)[None, :])
    ywin = ypad[idx]
    valid = idx < ylen
    d = jnp.where(valid[:, None, :], ywin[:, None, :] - S, 0.0)
    dsq = d.real * d.real + d.imag * d.imag
    return jnp.sum(dsq, axis=-1), jnp.sum(dsq[..., :up], axis=-1)


@functools.partial(jax.jit,
                   static_argnames=("up", "pulselen", "k_syms", "pathlen",
                                    "pret_static", "start_static"))
def _viterbi_run_path_acs(y, alphabet, pretransitions, pulses, omegas,
                          start_mask, *, up, pulselen, k_syms, pathlen,
                          pret_static, start_static):
    """Pulse-memory (k_syms > 1) MLSE as a min-plus associative scan over
    the (A+1)^k_syms window-state trellis.

    The reference's C++ Viterbi port exists precisely for this case
    (/root/reference/cython_ext/PyViterbiDemodulator/viterbiDemodulator.cpp
    — per-symbol worker threads) and the round-4 general scan ran it at the
    serial-launch-latency floor (~6 us/symbol regardless of unroll,
    benchmarks/exp_viterbi_unroll.py). Redesign: expand the state to the
    full pulse window code c (the branch metric depends only on (step, c) —
    the _code_branch_tables fact), so the path-metric recursion becomes

        M_n[c'] = min_c  M_{n-1}[c] + T_n[c', c],
        T_n[c', c] = bm_short[n, c'] + (0 if c -> c' legal else inf)

    — a min-plus matrix chain, evaluated in O(log N) depth via
    ``associative_scan`` exactly like the memoryless 'path' variant.
    Transition legality: c' = (c mod B^{k-1})*B + (p'+1) for some oldest
    dropped digit, with the newest digit of c an allowed pretransition of
    p'. Note this is EXACT MLSE over window states — a strict improvement
    on the A-survivor general scan, which carries one window per alphabet
    state (per-survivor decision feedback). Tested against a brute-force
    window-state Viterbi (tests/test_viterbi.py).

    Returns (paths (A, pathlen) int32, metrics (A,)): per final alphabet
    state, the best window-state path ending in that symbol.
    """
    A = alphabet.shape[0]
    base = A + 1
    codes = base ** k_syms
    inf = jnp.float32(jnp.inf)
    bm_full, bm_short = _code_branch_tables(
        y, alphabet, pulses, omegas, up=up, pulselen=pulselen,
        k_syms=k_syms, pathlen=pathlen)
    del bm_full  # path-metric selection accumulates the short branch

    # ---- static transition structure (host numpy) ---------------------------
    pret = np.asarray(pret_static, np.int32)
    cvec = np.arange(codes)
    tail = cvec // base                                   # c' without newest
    candc = (np.arange(base)[None, :] * base ** (k_syms - 1)
             + tail[:, None]).astype(np.int32)            # (codes, base)
    dnew = cvec % base                                    # newest digit of c'
    dq = tail % base                                      # newest digit of c
    legal_state = np.zeros((A + 1, A + 1), bool)          # [dq, dnew]
    for p in range(A):
        legal_state[pret[p] + 1, p + 1] = True
    legc = legal_state[dq[:, None], dnew[:, None]]        # (codes, 1)
    legc = np.broadcast_to(legc, candc.shape).copy()      # same for every u
    adjc = np.full((codes, codes), np.inf, np.float32)
    rows = np.repeat(cvec, base)[legc.reshape(-1)]
    cols = candc.reshape(-1)[legc.reshape(-1)]
    adjc[rows, cols] = 0.0

    # ---- init: window = silence + first symbol -> code p+1 ------------------
    start = np.asarray(start_static, bool)
    m0 = jnp.full((codes,), inf)
    init_codes = np.arange(1, A + 1)
    m0 = m0.at[jnp.asarray(init_codes)].set(
        jnp.where(jnp.asarray(start), bm_short[0, jnp.asarray(init_codes)],
                  inf))

    # B=1 route through the blocked three-phase chain core
    mats = (bm_short[1:, :, None] + jnp.asarray(adjc)[None])[..., None]
    metrics_cb, codeseq_b = _minplus_chain_batched(mats, m0[:, None],
                                                   candc, legc)
    metrics_c = metrics_cb[:, 0]
    codeseq = codeseq_b[..., 0]                             # (pathlen, C)
    stateseq = (codeseq % base).astype(jnp.int32) - 1       # (pathlen, C)

    # ---- reduce to the (A,) per-final-alphabet-state API --------------------
    group = (np.arange(base ** (k_syms - 1))[None, :] * base
             + (np.arange(A) + 1)[:, None]).astype(np.int32)  # (A, B^{k-1})
    mg = metrics_c[jnp.asarray(group)]                      # (A, B^{k-1})
    j = jnp.argmin(mg, axis=-1)
    metrics = jnp.take_along_axis(mg, j[:, None], axis=-1)[:, 0]
    cstar = jnp.take_along_axis(jnp.asarray(group), j[:, None], axis=-1)[:, 0]
    paths = stateseq[:, cstar].T
    return paths, metrics


def _minplus_chain_batched(mats, m0, candc, legc):
    """Batched min-plus Viterbi chain with the BURST axis MINOR.

    mats: (N-1, S, S, B) step matrices (bm + inf-masked adjacency),
    m0: (S, B) initial metrics, candc/legc: (S, U) static predecessor
    candidate codes + legality (numpy). Returns (metrics (S, B),
    stateseq-codes (N, S, B)).

    Why bursts-minor: a vmap over bursts puts B LEADING, so the (S, S)
    min-plus tiles keep the tiny S (9 for CP2FSK k_syms=2, 2 for the
    memoryless trellis) as the minor dimension; with B minor every
    elementwise pass runs over the long burst axis.
    """
    inf = jnp.float32(jnp.inf)
    L, S, _, B = mats.shape

    # three-phase evaluation instead of a full associative_scan of matrix
    # products: jax's associative_scan re-slices and concatenates the whole
    # (L, S, S, B) array ~3x per level, far more traffic than the math
    # itself. Phase A reduces each KBL-step
    # block to ONE transfer matrix by a pairwise tree (log2(KBL) fused
    # passes over the mats, no interleave concats); phase B chains the
    # NB block matrices with a tiny vector scan; phase C replays each
    # block with a small-carry vector scan to emit every step's metrics.
    kbl = 16
    nb = -(-L // kbl)
    pad = nb * kbl - L
    if pad:
        ident = jnp.where(jnp.eye(S, dtype=bool)[:, :, None], 0.0, inf)
        mats = jnp.concatenate(
            [mats, jnp.broadcast_to(ident, (pad, S, S, B))], axis=0)
    matsp = mats.reshape(nb, kbl, S, S, B)

    cur = matsp
    while cur.shape[1] > 1:
        a = cur[:, 0::2]
        b = cur[:, 1::2]
        # "later after earlier": C[p, j] = min_k b[p, k] + a[k, j]
        cur = jnp.min(b[..., :, :, None, :] + a[..., None, :, :, :],
                      axis=-3)
    blockmats = cur[:, 0]                                  # (NB, S, S, B)

    def bstep(m, mb):
        nm = jnp.min(mb + m[None, :, :], axis=1)
        return nm, m                                       # emit EXCLUSIVE

    _, m_starts = jax.lax.scan(bstep, m0, blockmats)       # (NB, S, B)

    def cstep(m, mt):
        nm = jnp.min(mt + m[:, None, :, :], axis=2)
        return nm, nm

    matsk = jnp.moveaxis(matsp, 1, 0)                      # (kbl, NB, S, S, B)
    _, m_all = jax.lax.scan(cstep, m_starts, matsk)        # (kbl, NB, S, B)
    all_m = jnp.moveaxis(m_all, 0, 1).reshape(nb * kbl, S, B)[:L]
    metrics = all_m[-1]
    m_prev = jnp.concatenate([m0[None], all_m[:-1]], axis=0)

    candc_j = jnp.asarray(candc)                           # (S, U)
    # cand[l, s, u, b] = m_prev[l, candc[s, u], b]
    cand = jnp.where(jnp.asarray(legc)[None, :, :, None],
                     m_prev[:, candc_j, :], inf)
    best_u = jnp.argmin(cand, axis=-2)                     # (N-1, S, B)
    bq = candc_j[jnp.arange(candc_j.shape[0])[None, :, None],
                 best_u]                                   # (N-1, S, B)

    # blocked reverse composition of the backpointer index maps (same
    # three-phase structure as the metrics above): F_l = bq[l] maps state
    # at symbol l+1 -> symbol l; suffix[m] = (F_m o ... o F_{L-1})(end).
    idmap = jnp.broadcast_to(jnp.arange(S, dtype=bq.dtype)[:, None],
                             (S, B))
    if pad:
        bq = jnp.concatenate(
            [bq, jnp.broadcast_to(idmap, (pad, S, B))], axis=0)
    bqp = bq.reshape(nb, kbl, S, B)
    curi = bqp
    while curi.shape[1] > 1:
        a = curi[:, 0::2]                                  # earlier
        b_ = curi[:, 1::2]                                 # later
        curi = jnp.take_along_axis(a, b_, axis=-2)         # earlier o later
    blockmaps = curi[:, 0]                                 # (NB, S, B)

    def rstep(tail, hb):
        return jnp.take_along_axis(hb, tail, axis=-2), tail

    _, tails = jax.lax.scan(rstep, idmap, blockmaps, reverse=True)

    def rcstep(c, fk):
        s = jnp.take_along_axis(fk, c, axis=-2)
        return s, s

    bqk = jnp.moveaxis(bqp, 1, 0)                          # (kbl, NB, S, B)
    _, s_all = jax.lax.scan(rcstep, tails, bqk, reverse=True)
    suffix = jnp.moveaxis(s_all, 0, 1).reshape(nb * kbl, S, B)[:L]
    codeseq = jnp.concatenate([suffix, idmap[None]], axis=0)  # (N, S, B)
    return metrics, codeseq


@functools.partial(jax.jit,
                   static_argnames=("up", "pulselen", "k_syms", "pathlen",
                                    "survivor_metric", "pret_static",
                                    "start_static"))
def viterbi_path_acs_batch(ys, alphabet, pretransitions, pulses, omegas,
                           start_mask, *, up, pulselen, k_syms, pathlen,
                           survivor_metric="path", pret_static,
                           start_static):
    """Batched path-metric Viterbi over a (B, nsamps) burst matrix via the
    bursts-minor min-plus associative scan (round 5).

    Exact same per-burst semantics as ``_viterbi_run`` with
    survivor_metric='path' (k_syms == 1: the A-state memoryless trellis;
    k_syms > 1: MLSE over the (A+1)^k window-state trellis) — this is the
    THROUGHPUT surface for burst batches, the reference's block-per-burst
    GPU pattern (/root/reference/custom_kernels/demodulation.cu one block
    per burst). Returns (paths (B, A, pathlen) int32, metrics (B, A)).
    """
    if survivor_metric != "path":
        raise ValueError("batched ACS implements survivor_metric='path'")
    A = alphabet.shape[0]
    inf = jnp.float32(jnp.inf)
    pret = np.asarray(pret_static, np.int32)
    start = np.asarray(start_static, bool)

    if k_syms == 1:
        # memoryless A-state trellis (identical recursion to the k=1
        # 'path' branch of _viterbi_run_memoryless)
        def tables(y):
            n_all = jnp.arange(pathlen, dtype=jnp.float32)
            t_rel = jnp.arange(up, dtype=jnp.float32)
            phase = jnp.exp(-1j * omegas[None, :, None]
                            * (n_all[:, None, None] * up
                               + t_rel[None, None, :]))
            base_ = jnp.einsum("it,nit->nt",
                               pulses[:, :up].astype(jnp.complex64),
                               phase.astype(jnp.complex64))
            s = alphabet[None, :, None] * base_[:, None, :]
            idx = (jnp.arange(pathlen)[:, None] * up
                   + jnp.arange(up)[None, :])
            ypad = jnp.concatenate([y, jnp.zeros(up, y.dtype)])
            d = jnp.where((idx < y.shape[0])[:, None, :],
                          ypad[idx][:, None, :] - s, 0.0)
            return jnp.sum(d.real ** 2 + d.imag ** 2, -1)  # (N, A)

        bm = jax.vmap(tables)(ys)                          # (B, N, A)
        bm_t = jnp.moveaxis(bm, 0, -1)                     # (N, A, B)
        adj = np.full((A, A), np.inf, np.float32)
        adj[np.arange(A)[:, None], pret] = 0.0
        mats = bm_t[1:, :, None, :] + jnp.asarray(adj)[None, :, :, None]
        m0 = jnp.where(jnp.asarray(start)[:, None], bm_t[0], inf)
        candc = pret
        legc = np.ones_like(pret, bool)
        metrics, seq = _minplus_chain_batched(mats, m0, candc, legc)
        return (jnp.moveaxis(seq, -1, 0).astype(jnp.int32)
                .transpose(0, 2, 1), jnp.moveaxis(metrics, -1, 0))

    base = A + 1
    codes = base ** k_syms
    bm_full, bm_short = jax.vmap(
        lambda y: _code_branch_tables(y, alphabet, pulses, omegas, up=up,
                                      pulselen=pulselen, k_syms=k_syms,
                                      pathlen=pathlen))(ys)
    del bm_full
    bm_t = jnp.moveaxis(bm_short, 0, -1)                   # (N, C, B)

    # static transition structure (as _viterbi_run_path_acs)
    cvec = np.arange(codes)
    tail = cvec // base
    candc = (np.arange(base)[None, :] * base ** (k_syms - 1)
             + tail[:, None]).astype(np.int32)
    dnew = cvec % base
    dq = tail % base
    legal_state = np.zeros((A + 1, A + 1), bool)
    for p in range(A):
        legal_state[pret[p] + 1, p + 1] = True
    legc = np.broadcast_to(
        legal_state[dq[:, None], dnew[:, None]], candc.shape).copy()
    adjc = np.full((codes, codes), np.inf, np.float32)
    rows = np.repeat(cvec, base)[legc.reshape(-1)]
    cols = candc.reshape(-1)[legc.reshape(-1)]
    adjc[rows, cols] = 0.0

    mats = bm_t[1:, :, None, :] + jnp.asarray(adjc)[None, :, :, None]
    init_codes = np.arange(1, A + 1)
    m0 = jnp.full((codes, ys.shape[0]), inf)
    m0 = m0.at[jnp.asarray(init_codes)].set(
        jnp.where(jnp.asarray(start)[:, None],
                  bm_t[0, jnp.asarray(init_codes)], inf))

    metrics_c, codeseq = _minplus_chain_batched(mats, m0, candc, legc)
    stateseq = (codeseq % base).astype(jnp.int32) - 1      # (N, C, B)

    group = (np.arange(base ** (k_syms - 1))[None, :] * base
             + (np.arange(A) + 1)[:, None]).astype(np.int32)
    mg = metrics_c[jnp.asarray(group)]                     # (A, G', B)
    j = jnp.argmin(mg, axis=1)                             # (A, B)
    metrics = jnp.min(mg, axis=1)                          # (A, B)
    cstar = jnp.asarray(group)[jnp.arange(A)[:, None], j]  # (A, B)
    # paths[n, a, b] = stateseq[n, cstar[a, b], b]
    paths = stateseq[jnp.arange(pathlen)[:, None, None],
                     cstar[None, :, :],
                     jnp.arange(ys.shape[0])[None, None, :]]
    return (jnp.moveaxis(paths, -1, 0).transpose(0, 2, 1)
            .astype(jnp.int32),
            jnp.moveaxis(metrics, -1, 0))


@functools.partial(jax.jit,
                   static_argnames=("up", "pulselen", "k_syms", "pathlen"))
def _viterbi_run_fast(y, alphabet, pretransitions, pulses, omegas,
                      start_mask, *, up, pulselen, k_syms, pathlen):
    """Table-driven trellis: identical metrics to _viterbi_run_scan, but the
    synth/branch work is hoisted OUT of the sequential recursion.

    The branch metric at step n depends only on (n, window code), where the
    code is the base-(A+1) encoding of the survivor's last k_syms symbols
    (digit 0 = pre-start silence, digit a+1 = alphabet[a]). All
    (pathlen, codes) full/short metrics are computed up front as one
    vectorized pass — per-source pulse synth for every code, per-step source
    phases e^{-j omega (n*up+t)} applied by broadcasting — so the lax.scan
    body is a pure add-compare-select on (A,) vectors with backpointer
    emission, and survivor paths are rebuilt by a trivial backtrack scan.
    The round-2 implementation ran small convolutions and an (A, pathlen)
    survivor-path copy inside every step and was latency-bound at ~15 us per
    symbol step (VERDICT round-3 item #9).
    """
    A = alphabet.shape[0]
    T = pretransitions.shape[1]
    ylen = y.shape[0]
    base = A + 1
    codes = base ** k_syms
    inf = jnp.float32(jnp.inf)

    ypad = jnp.concatenate([y, jnp.zeros(pulselen + up, dtype=y.dtype)])

    # ---- static code tables (numpy, embedded as constants) -----------------
    cvec = np.arange(codes)
    digits = (cvec[:, None] // base ** np.arange(k_syms - 1, -1, -1)[None, :]
              ) % base                                    # oldest..newest
    # symbol value per digit: 0 for silence, alphabet[d-1] otherwise
    # (value table is traced — alphabet is a device array)
    valtable = jnp.concatenate(
        [jnp.zeros(1, alphabet.dtype), alphabet])         # (A+1,)
    win_syms = valtable[jnp.asarray(digits)]              # (codes, k_syms)
    # code transition: drop oldest digit, append newest symbol p
    nextcode = ((cvec % base ** (k_syms - 1))[:, None] * base
                + (np.arange(A) + 1)[None, :])            # (codes, A)

    # ---- synth table: model segment for every code ---------------------------
    # upsampled windows (codes, k_syms*up); conv each source pulse; take the
    # same segment synth() takes: offset (k_syms-1)*up, length pulselen
    upw = jnp.zeros((codes, k_syms * up), dtype=alphabet.dtype)
    upw = upw.at[:, ::up].set(win_syms)

    def conv_code(w):
        def one_src(pulse):
            c = jnp.convolve(w, pulse, mode="full")
            return jax.lax.dynamic_slice(c, ((k_syms - 1) * up,), (pulselen,))
        return jax.vmap(one_src)(pulses)                  # (L, pulselen)
    s0 = jax.vmap(conv_code)(upw)                         # (codes, L, pulselen)

    # per-step per-source phase: e^{-j omega (n*up + t)}
    n_all = jnp.arange(pathlen, dtype=jnp.float32)
    t_rel = jnp.arange(pulselen, dtype=jnp.float32)
    phase = jnp.exp(-1j * omegas[None, :, None]
                    * (n_all[:, None, None] * up + t_rel[None, None, :]))
    # S[n, c, t] = sum_i s0[c, i, t] * phase[n, i, t]
    S = jnp.einsum("cit,nit->nct", s0.astype(jnp.complex64),
                   phase.astype(jnp.complex64))           # (pathlen, codes, P)

    # observation windows + validity
    ywin = ypad[(jnp.arange(pathlen)[:, None] * up
                 + jnp.arange(pulselen)[None, :])]        # (pathlen, P)
    valid = (jnp.arange(pathlen)[:, None] * up
             + jnp.arange(pulselen)[None, :]) < ylen

    d = jnp.where(valid[:, None, :], ywin[:, None, :] - S, 0.0)
    dsq = d.real * d.real + d.imag * d.imag
    bm_full = jnp.sum(dsq, axis=-1)                       # (pathlen, codes)
    bm_short = jnp.sum(dsq[..., :up], axis=-1)

    # ---- init (n = 0): window = silence + first symbol => code = p + 1 ------
    init_codes = jnp.arange(1, A + 1, dtype=jnp.int32)
    metrics0 = jnp.where(start_mask, bm_short[0, init_codes], inf)

    # ---- ACS recursion with backpointers -------------------------------------
    nextcode_j = jnp.asarray(nextcode, dtype=jnp.int32)
    pret = pretransitions

    def step(carry, n):
        metrics, code = carry
        bmf = bm_full[n]
        bms = bm_short[n]
        # candidate codes per (p, t): survivor window of predecessor + p
        nc = nextcode_j[code[pret], jnp.arange(A, dtype=jnp.int32)[:, None]]
        full = bmf[nc]                                    # (A, T)
        short = bms[nc]
        pre_inf = jnp.isinf(metrics)[pret]
        full = jnp.where(pre_inf, inf, full)
        short = jnp.where(pre_inf, inf, short)
        best_t = jnp.argmin(full, axis=1)
        best_q = jnp.take_along_axis(pret, best_t[:, None], axis=1)[:, 0]
        all_inf = jnp.all(jnp.isinf(full), axis=1)
        new_metrics = jnp.where(
            all_inf, inf,
            metrics[best_q] + jnp.take_along_axis(
                short, best_t[:, None], axis=1)[:, 0])
        new_code = jnp.take_along_axis(nc, best_t[:, None], axis=1)[:, 0]
        return (new_metrics, new_code), best_q

    (metrics, _), backptr = jax.lax.scan(
        step, (metrics0, init_codes), jnp.arange(1, pathlen, dtype=jnp.int32),
        unroll=4)                                         # (pathlen-1, A)

    # ---- backtrack every final state's survivor path -------------------------
    def trace(carry, bp):
        s = carry
        prev = bp[s]
        return prev, s

    ends = jnp.arange(A, dtype=jnp.int32)

    def trace_one(end):
        first, rest = jax.lax.scan(trace, end, backptr, reverse=True,
                                   unroll=4)
        return jnp.concatenate([first[None], rest])

    paths = jax.vmap(trace_one)(ends)                     # (A, pathlen)
    return paths, metrics


@functools.partial(jax.jit,
                   static_argnames=("up", "pulselen", "k_syms", "pathlen",
                                    "survivor_metric"))
def _viterbi_run_scan(y, alphabet, pretransitions, pulses, omegas,
                      start_mask, *, up, pulselen, k_syms, pathlen,
                      survivor_metric: str = "branch"):
    A = alphabet.shape[0]
    T = pretransitions.shape[1]
    L = pulses.shape[0]
    ylen = y.shape[0]
    inf = jnp.float32(jnp.inf)

    # pad y so the pulselen-long branch window never runs off the end; the
    # reference's clipped numpy slice is reproduced with a validity mask.
    ypad = jnp.concatenate([y, jnp.zeros(pulselen + up, dtype=y.dtype)])

    def synth(window, n):
        """Synthesize the model samples at absolute times n*up + [0, pulselen)
        from the last k_syms+? symbols ``window`` (window[-1] = symbol at n).

        window: (k_syms,) complex, symbols n-k_syms+1 .. n.
        """
        upw = jnp.zeros(k_syms * up, dtype=window.dtype).at[::up].set(window)
        # conv with each pulse; sample m of upw is absolute (n-k_syms+1)*up + m
        def one_src(pulse, omega):
            c = jnp.convolve(upw, pulse, mode="full")
            seg = jax.lax.dynamic_slice(c, ((k_syms - 1) * up,), (pulselen,))
            t = (n * up + jnp.arange(pulselen)).astype(jnp.float32)
            return seg * jnp.exp(-1j * omega * t)
        x = jax.vmap(one_src)(pulses, omegas)           # (L, pulselen)
        return jnp.sum(x, axis=0)

    def branch_metrics(windows, n):
        """windows: (A, k_syms) predecessor-extended windows per (p, t).
        Returns (branch (A,T), shortbranch (A,T)) given survivor windows."""
        yseg = jax.lax.dynamic_slice(ypad, (n * up,), (pulselen,))
        valid = (n * up + jnp.arange(pulselen)) < ylen

        def per_state(p):
            def per_trans(t):
                q = pretransitions[p, t]
                w = jnp.concatenate([windows[q, 1:], alphabet[p][None]])
                s = synth(w, n)
                d = jnp.where(valid, yseg - s, 0.0)
                full = jnp.sum(jnp.abs(d) ** 2)
                short = jnp.sum(jnp.abs(d[:up]) ** 2)
                return full, short
            return jax.vmap(per_trans)(jnp.arange(T))
        return jax.vmap(per_state)(jnp.arange(A))       # each (A, T)

    # ---- initial step (n = 0): reference run() init loop --------------------
    init_windows = jnp.zeros((A, k_syms), dtype=alphabet.dtype)
    init_windows = init_windows.at[:, -1].set(alphabet)
    y0 = ypad[:up]

    def init_metric(a):
        s = synth(init_windows[a], 0)
        return jnp.sum(jnp.abs(y0 - s[:up]) ** 2)
    metrics0 = jax.vmap(init_metric)(jnp.arange(A))
    metrics0 = jnp.where(start_mask, metrics0, inf)

    paths0 = jnp.zeros((A, pathlen), dtype=jnp.int32)
    paths0 = paths0.at[:, 0].set(jnp.arange(A, dtype=jnp.int32))
    windows0 = jnp.where(start_mask[:, None], init_windows, 0)

    # ---- scan over symbols 1..pathlen-1 -------------------------------------
    def step(carry, n):
        metrics, windows, paths = carry
        full, short = branch_metrics(windows, n)
        # add predecessor-inf masking (reference calcAllBranchMetrics)
        pre_inf = jnp.isinf(metrics)[pretransitions]    # (A, T)
        full = jnp.where(pre_inf, inf, full)
        short = jnp.where(pre_inf, inf, short)

        if survivor_metric == "path":
            # opt-in textbook ACS (VERDICT round-3: the reference's
            # branch-only selection degenerates for memoryless pulses)
            sel = metrics[pretransitions] + full
        else:
            sel = full
        best_t = jnp.argmin(sel, axis=1)                # (A,)
        best_q = jnp.take_along_axis(pretransitions, best_t[:, None], axis=1)[:, 0]
        all_inf = jnp.all(jnp.isinf(full), axis=1)
        new_metrics = jnp.where(
            all_inf, inf,
            metrics[best_q] + jnp.take_along_axis(short, best_t[:, None], axis=1)[:, 0])
        new_paths = paths[best_q].at[:, n].set(jnp.arange(A, dtype=jnp.int32))
        new_windows = jnp.concatenate(
            [windows[best_q, 1:], alphabet[:, None]], axis=1)
        return (new_metrics, new_windows, new_paths), None

    (metrics, windows, paths), _ = jax.lax.scan(
        step, (metrics0, windows0, paths0), jnp.arange(1, pathlen))
    return paths, metrics


class BurstyViterbiDemodulator(ViterbiDemodulator):
    """Trellis demod of periodic bursts with guard gaps (reference
    BurstyViterbiDemodulator, viterbiDemodClasses.py:263).

    Symbols are laid out as repeating periods of ``num_burst_syms`` active
    symbols followed by ``num_guard_syms`` silent ones. During guard periods
    all survivor paths freeze; at each new burst every surviving end-state is
    fully connected to the allowed start states, with the branch metric
    spanning the guard gap (the synthesized pulse tail + zeros must match the
    observation there too).

    Implemented as one ``lax.scan`` whose step switches between
    normal / guard-skip / new-burst behaviour on (n mod period); survivor
    windows carry ``pulselen/up + num_guard_syms`` symbols so the new-burst
    branch can synthesize across the gap without replaying the whole path.
    """

    def __init__(self, alphabet, pretransitions, pulses, omegas, up: int,
                 num_burst_syms: int, num_guard_syms: int,
                 allowed_start_idx=None):
        if allowed_start_idx is None:
            allowed_start_idx = np.arange(len(alphabet))
        super().__init__(alphabet, pretransitions, pulses, omegas, up,
                         allowed_start_idx)
        self.num_burst_syms = int(num_burst_syms)
        self.num_guard_syms = int(num_guard_syms)
        self.num_period_syms = self.num_burst_syms + self.num_guard_syms

    def run(self, y: jnp.ndarray, pathlen: int):
        pathlen = int(pathlen)
        fn = self._run_fns.get(("bursty", pathlen))
        if fn is None:
            a_mask = np.zeros(self.alphabet.shape[0], dtype=bool)
            a_mask[self.allowed_start_idx] = True
            alphabet, pretransitions = self.alphabet, self.pretransitions
            pulses, omegas = self.pulses, self.omegas
            up, pulselen = self.up, self.pulselen
            k_syms = self.pulse_len_in_syms
            burst, guard = self.num_burst_syms, self.num_guard_syms
            period = self.num_period_syms

            def _impl(y):
                paths, metrics = _bursty_viterbi_run(
                    y.astype(jnp.complex64), jnp.asarray(alphabet),
                    jnp.asarray(pretransitions), jnp.asarray(pulses),
                    jnp.asarray(omegas), jnp.asarray(a_mask), up=up,
                    pulselen=pulselen, k_syms=k_syms, pathlen=pathlen,
                    burst=burst, guard=guard)
                best = jnp.argmin(metrics)
                # guard-period symbols are never decided — they are silent
                # (0), as in the reference where paths[n] stays 0 through
                # guard periods
                phase = jnp.arange(pathlen) % period
                active = phase < burst
                symvals = jnp.where(active[None, :],
                                    jnp.asarray(alphabet)[paths], 0)
                return symvals[best], metrics, symvals

            fn = self._run_fns.setdefault(("bursty", pathlen), jax.jit(_impl))
        return fn(y)


@functools.partial(
    jax.jit,
    static_argnames=("up", "pulselen", "k_syms", "pathlen", "burst", "guard"))
def _bursty_viterbi_run(y, alphabet, pretransitions, pulses, omegas,
                        start_mask, *, up, pulselen, k_syms, pathlen, burst,
                        guard):
    A = alphabet.shape[0]
    T = pretransitions.shape[1]
    ylen = y.shape[0]
    period = burst + guard
    W = k_syms + guard                    # carry window length in symbols
    guardlen = guard * up
    extlen = guardlen + pulselen
    inf = jnp.float32(jnp.inf)
    ypad = jnp.concatenate([y, jnp.zeros(extlen + up, dtype=y.dtype)])

    def synth_span(window, t_abs_start, nsamps_pulse, lead_syms):
        """Synthesize model samples at absolute times t_abs_start +
        [0, nsamps_pulse) from the last (lead_syms) symbols of ``window``
        whose final symbol sits at absolute symbol position covering
        t_abs_start's span end. Uses the full W-length window; conv start
        offset selects the span."""
        upw = jnp.zeros(W * up, dtype=window.dtype).at[::up].set(window)

        def one_src(pulse, omega):
            c = jnp.convolve(upw, pulse, mode="full")
            seg = jax.lax.dynamic_slice(c, ((W - 1 - lead_syms) * up,),
                                        (nsamps_pulse,))
            t = (t_abs_start + jnp.arange(nsamps_pulse)).astype(jnp.float32)
            return seg * jnp.exp(-1j * omega * t)
        return jnp.sum(jax.vmap(one_src)(pulses, omegas), axis=0)

    def normal_step(n, metrics, windows, paths):
        yseg = jax.lax.dynamic_slice(ypad, (n * up,), (pulselen,))
        valid = (n * up + jnp.arange(pulselen)) < ylen

        def per_state(p):
            def per_trans(t):
                q = pretransitions[p, t]
                w = jnp.concatenate([windows[q, 1:], alphabet[p][None]])
                s = synth_span(w, n * up, pulselen, 0)
                d = jnp.where(valid, yseg - s, 0.0)
                return jnp.sum(jnp.abs(d) ** 2), jnp.sum(jnp.abs(d[:up]) ** 2)
            return jax.vmap(per_trans)(jnp.arange(T))
        full, short = jax.vmap(per_state)(jnp.arange(A))
        pre_inf = jnp.isinf(metrics)[pretransitions]
        full = jnp.where(pre_inf, inf, full)
        short = jnp.where(pre_inf, inf, short)
        best_t = jnp.argmin(full, axis=1)
        best_q = jnp.take_along_axis(pretransitions, best_t[:, None], axis=1)[:, 0]
        all_inf = jnp.all(jnp.isinf(full), axis=1)
        new_metrics = jnp.where(
            all_inf, inf,
            metrics[best_q] + jnp.take_along_axis(short, best_t[:, None],
                                                  axis=1)[:, 0])
        new_paths = paths[best_q].at[:, n].set(jnp.arange(A, dtype=jnp.int32))
        new_windows = jnp.concatenate(
            [windows[best_q, 1:], alphabet[:, None]], axis=1)
        return new_metrics, new_windows, new_paths

    def guard_step(n, metrics, windows, paths):
        # freeze paths/metrics; the window still slides (a zero symbol enters)
        new_windows = jnp.concatenate(
            [windows[:, 1:], jnp.zeros((A, 1), dtype=windows.dtype)], axis=1)
        return metrics, new_windows, paths

    def newburst_step(n, metrics, windows, paths):
        yseg = jax.lax.dynamic_slice(ypad, ((n - guard) * up,), (extlen,))
        valid = ((n - guard) * up + jnp.arange(extlen)) < ylen

        def per_state(p):
            def per_prev(q):
                w = jnp.concatenate([windows[q, 1:], alphabet[p][None]])
                s = synth_span(w, (n - guard) * up, extlen, guard)
                d = jnp.where(valid, yseg - s, 0.0)
                full = jnp.sum(jnp.abs(d) ** 2)
                short = jnp.sum(jnp.abs(d[: guardlen + up]) ** 2)
                return full, short
            return jax.vmap(per_prev)(jnp.arange(A))
        full, short = jax.vmap(per_state)(jnp.arange(A))   # (A_p, A_q)
        pre_inf = jnp.isinf(metrics)[None, :]
        full = jnp.where(pre_inf | ~start_mask[:, None], inf, full)
        short = jnp.where(pre_inf | ~start_mask[:, None], inf, short)
        best_q = jnp.argmin(full, axis=1)
        all_inf = jnp.all(jnp.isinf(full), axis=1)
        new_metrics = jnp.where(
            all_inf, inf,
            metrics[best_q] + jnp.take_along_axis(short, best_q[:, None],
                                                  axis=1)[:, 0])
        new_paths = jnp.where(all_inf[:, None], paths,
                              paths[best_q].at[:, n].set(
                                  jnp.arange(A, dtype=jnp.int32)))
        new_windows = jnp.where(
            all_inf[:, None],
            jnp.concatenate([windows[:, 1:],
                             jnp.zeros((A, 1), windows.dtype)], axis=1),
            jnp.concatenate([windows[best_q, 1:], alphabet[:, None]], axis=1))
        return new_metrics, new_windows, new_paths

    # initial step (n = 0) — same as the base demodulator
    init_windows = jnp.zeros((A, W), dtype=alphabet.dtype)
    init_windows = init_windows.at[:, -1].set(alphabet)

    def init_metric(a):
        s = synth_span(init_windows[a], 0, pulselen, 0)
        return jnp.sum(jnp.abs(ypad[:up] - s[:up]) ** 2)
    metrics0 = jnp.where(start_mask, jax.vmap(init_metric)(jnp.arange(A)), inf)
    paths0 = jnp.zeros((A, pathlen), dtype=jnp.int32)
    paths0 = paths0.at[:, 0].set(jnp.arange(A, dtype=jnp.int32))
    windows0 = jnp.where(start_mask[:, None], init_windows, 0)

    def step(carry, n):
        metrics, windows, paths = carry
        phase = n % period
        mode = jnp.where(phase == 0, 1, jnp.where(phase >= burst, 2, 0))
        out = jax.lax.switch(
            mode,
            [lambda args: normal_step(*args),
             lambda args: newburst_step(*args),
             lambda args: guard_step(*args)],
            (n, metrics, windows, paths))
        return out, None

    (metrics, windows, paths), _ = jax.lax.scan(
        step, (metrics0, windows0, paths0), jnp.arange(1, pathlen))
    return paths, metrics
