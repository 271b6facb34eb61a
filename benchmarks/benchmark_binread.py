#!/usr/bin/env python
"""Capture-file loader throughput: python loops vs the native threaded C++
loader (reference benchmark: multiBinReadThreaded, usrpRoutines.py:88).

Host-side only (no device). Usage: python benchmarks/benchmark_binread.py [files] [samps]
"""
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np


def _timeit(fn):
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def main():
    from pydsproutines_tpu.io.binfiles import simple_bin_read, multi_bin_read

    nfiles = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    nsamps = int(sys.argv[2]) if len(sys.argv) > 2 else 4_000_000
    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory() as d:
        paths = []
        for i in range(nfiles):
            raw = rng.integers(-30000, 30000, 2 * nsamps, dtype=np.int16)
            p = os.path.join(d, f"cap_{i}.bin")
            raw.tofile(p)
            paths.append(p)

        # warm the page cache so both tiers measure conversion + memcpy
        for p in paths:
            simple_bin_read(p, nsamps)
        multi_bin_read(paths, nsamps, threads=4)

        t_simple = min(_timeit(lambda: [simple_bin_read(p, nsamps)
                                        for p in paths]) for _ in range(3))
        t_multi = min(_timeit(lambda: multi_bin_read(paths, nsamps,
                                                     threads=4))
                      for _ in range(3))

    total = nfiles * nsamps
    print(f"simple_bin_read loop : {total / t_simple / 1e6:8.1f} Msamp/s")
    print(f"multi_bin_read (C++) : {total / t_multi / 1e6:8.1f} Msamp/s "
          f"({t_simple / t_multi:.2f}x)")


if __name__ == "__main__":
    main()
