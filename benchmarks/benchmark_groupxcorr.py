#!/usr/bin/env python
"""Group xcorr + CZT frequency scan on the accelerator.

Mirrors the reference's ippGroupXcorrCZT workload (BASELINE.json config 4):
m bursty template groups coherently combined over a CZT fine-frequency grid,
swept across sample shifts. Usage:

    python benchmarks/benchmark_groupxcorr.py [groups] [grouplen] [nfreq] [shifts]

Timing methodology per bench.py (perturbed reps, rep-count differencing).
"""

import functools
import os
import sys
import time

# repo root on sys.path
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np


def main():
    import jax
    import jax.numpy as jnp
    from pydsproutines_tpu.ops import GroupXcorrCZT

    m = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    glen = int(sys.argv[2]) if len(sys.argv) > 2 else 4096
    nfreq = int(sys.argv[3]) if len(sys.argv) > 3 else 128
    nshifts = int(sys.argv[4]) if len(sys.argv) > 4 else 1024

    fs = 1e6
    period = 4 * glen
    starts = np.arange(m) * period
    lengths = np.full(m, glen)
    span = int(starts[-1] + glen)
    rng = np.random.default_rng(0)
    y = (rng.standard_normal(span) + 1j * rng.standard_normal(span)) \
        .astype(np.complex64)
    rxlen = span + nshifts + 16
    rx_ri = rng.standard_normal((2, rxlen), dtype=np.float32)

    bw = fs / glen / 4
    # Plan state is host numpy closed over by per-instance jitted closures
    # (embedded program constants), so construction never touches the device.
    gx = GroupXcorrCZT(y, starts, lengths, -nfreq / 2 * bw,
                       (nfreq / 2 - 1) * bw, bw, fs)
    shifts = jnp.arange(nshifts)

    @functools.partial(jax.jit, static_argnames=("n_reps",))
    def step(rri, n_reps):
        def one(eps):
            rx = jax.lax.complex(rri[0] * (1.0 + eps), rri[1])
            caf, _ = gx.xcorr(rx, shifts)
            return jnp.max(caf), jnp.argmax(caf)
        return jax.lax.map(one, 1e-7 * jnp.arange(1, n_reps + 1,
                                                  dtype=jnp.float32))

    d_rx = jax.device_put(jnp.asarray(rx_ri))

    def timed(nr):
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            np.asarray(step(d_rx, nr)[0])
            ts.append(time.perf_counter() - t0)
        return min(ts)

    timed(1); timed(4)
    dt = (timed(4) - timed(1)) / 3
    cells = nshifts * gx.czt_freq.size
    print(f"group xcorr CZT: {m} groups x {glen}, {gx.czt_freq.size} freqs, "
          f"{nshifts} shifts: {dt:.4f} s -> {cells / dt / 1e6:.1f} MCAF-cells/s, "
          f"{m * glen * nshifts / dt / 1e9:.2f} Gsample-shift/s")


if __name__ == "__main__":
    main()
