"""Checkpointed block-processing pipeline runner.

The reference checkpoints at the results level, not the computation level
(SURVEY.md §5): XcorrDB rows are keyed by unique scan parameters so
reprocessing is skippable (/root/reference/xcorrDatabase/_core.py:47-69
UNIQUE constraint), and GroupDatabase tracks the last processed capture
(/root/reference/usrpRoutines.py:700-704). This runner composes those same
semantics into a restartable long-capture job:

  * the capture is processed in fixed-size blocks (static shapes — one
    compile serves every block),
  * each block's xcorr result is written to an XcorrDB table keyed by the
    block's time index, committed per block,
  * on restart, completed blocks are detected from the DB and skipped, and
    processing resumes at the first missing block.

A crash between blocks loses at most one uncommitted block — the failure
recovery model the reference implies and a multi-hour capture job needs.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from pydsproutines_tpu.io.xcorrdb import XcorrDB
from pydsproutines_tpu.ops.xcorr import fast_xcorr


class CheckpointedXcorrPipeline:
    """Process a long capture against a template in resumable blocks.

    Each block covers ``block_shifts`` consecutive shifts; results are
    persisted as type-1 rows (per-shift QF^2 + peak freq bin) in ``table``
    of ``db``. Re-running with the same parameters resumes after the last
    completed block.
    """

    def __init__(self, db: XcorrDB, table: str, template: np.ndarray,
                 fs: float, fc: float = 0.0, block_shifts: int = 1024,
                 batch_size: int = 128, metrics=None):
        self.db = db
        self.table = table
        self.template = template
        self.fs = fs
        self.block_shifts = int(block_shifts)
        self.batch_size = int(batch_size)
        self.metrics = metrics  # utils.metrics.MetricsSink or None
        db.create_xcorr_results_table(
            table, fc, int(fs), "rx", "template", XcorrDB.TYPE_1D,
            desc=b"checkpointed block xcorr")

    # ------------------------------------------------------------------
    def _base(self, block_idx: int) -> dict:
        n = int(np.shape(self.template)[-1])
        return dict(
            time_sec=0, tidx=block_idx * self.block_shifts, cutoutlen=n,
            td_scan_start=float(block_idx * self.block_shifts),
            td_scan_numsteps=self.block_shifts, td_scan_step=1.0,
            fd_scan_start=0.0, fd_scan_numsteps=0, fd_scan_step=0.0,
            rfd_scan_start=0.0, rfd_scan_numsteps=0, rfd_scan_step=0.0)

    def completed_blocks(self) -> set[int]:
        rows = self.db.select_results(self.table)
        # tidx is the 2nd base column
        return {int(r[1]) // self.block_shifts for r in rows}

    def num_blocks(self, rx_len: int) -> int:
        n = int(np.shape(self.template)[-1])
        total_shifts = rx_len - n + 1
        return max(0, total_shifts // self.block_shifts)

    # ------------------------------------------------------------------
    def run(self, rx, progress: bool = False) -> int:
        """Process every missing block of ``rx``; returns the number of
        blocks computed this call (0 if already complete)."""
        rx = jnp.asarray(rx)
        template = jnp.asarray(self.template)
        nblocks = self.num_blocks(int(rx.shape[-1]))
        done = self.completed_blocks()
        computed = 0
        import time as _time
        for bi in range(nblocks):
            if bi in done:
                continue
            t0 = _time.perf_counter()
            s0 = bi * self.block_shifts
            shifts = np.arange(s0, s0 + self.block_shifts)
            qf2, freqs = fast_xcorr(template, rx, freqsearch=True,
                                    shifts=jnp.asarray(shifts),
                                    batch_size=self.batch_size)
            qf2_np, freqs_np = np.asarray(qf2), np.asarray(freqs)
            self.db.insert_1d_result(self.table, self._base(bi),
                                     qf2_np, freqs_np)
            computed += 1
            peak = float(np.max(qf2_np)) if qf2_np.size else 0.0
            if self.metrics is not None:
                # np.asarray above forced device completion, so the wall
                # clock covers the real block (SURVEY.md §5 observability)
                self.metrics.emit("xcorr.block_seconds",
                                  _time.perf_counter() - t0, unit="s",
                                  block=bi, nblocks=nblocks, peak_qf2=peak)
            if progress:
                print(f"block {bi + 1}/{nblocks} done "
                      f"(peak QF2 {peak:.3f})")
        if self.metrics is not None and computed:
            self.metrics.emit("xcorr.blocks_completed",
                              len(self.completed_blocks()), nblocks=nblocks)
        return computed

    def peak(self):
        """Global (shift, qf2, freq bin) across all completed blocks."""
        best = (None, -1.0, None)
        for row in self.db.select_results(self.table):
            base_tidx = int(row[1])
            qf2, fi = XcorrDB.regenerate_1d(row[-3], row[-2])
            k = int(np.argmax(qf2))
            if qf2[k] > best[1]:
                best = (base_tidx + k, float(qf2[k]), int(fi[k]))
        return best
