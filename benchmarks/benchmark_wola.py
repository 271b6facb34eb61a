#!/usr/bin/env python
"""WOLA channelizer throughput on the accelerator.

Mirrors the reference's multiChannelWola workload (benchmarks double as
parity checks there, SURVEY.md §4). Usage:

    python benchmarks/benchmark_wola.py [nsamples] [nch] [dec] [taps]

Timing methodology per bench.py: each rep perturbs the input and device
time is separated from the dispatch floor by differencing in-jit rep counts.
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
    from pydsproutines_tpu.ops.wola import wola

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 8_388_608
    nch = int(sys.argv[2]) if len(sys.argv) > 2 else 64
    dec = int(sys.argv[3]) if len(sys.argv) > 3 else 64
    taps = int(sys.argv[4]) if len(sys.argv) > 4 else 2048

    rng = np.random.default_rng(0)
    x_ri = rng.standard_normal((2, n), dtype=np.float32)
    h = rng.standard_normal(taps).astype(np.float32)

    @functools.partial(jax.jit, static_argnames=("n_reps",))
    def step(xri, h, n_reps):
        def one(eps):
            xx = jax.lax.complex(xri[0] * (1.0 + eps), xri[1])
            return jnp.sum(jnp.abs(wola(h, xx, dec, nch)))
        return jax.lax.map(one, 1e-7 * jnp.arange(1, n_reps + 1,
                                                  dtype=jnp.float32))

    d_x = jax.device_put(jnp.asarray(x_ri))
    d_h = jax.device_put(jnp.asarray(h))

    def timed(nr):
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            np.asarray(step(d_x, d_h, nr))
            ts.append(time.perf_counter() - t0)
        return min(ts)

    timed(1); timed(4)                      # warm both programs
    dt = (timed(4) - timed(1)) / 3
    print(f"WOLA {nch} ch, dec {dec}, {taps} taps, {n} samples: "
          f"{dt:.4f} s/run -> {n / dt / 1e9:.2f} GS/s input")


if __name__ == "__main__":
    main()
