#!/usr/bin/env python
"""Weak- and strong-scaling efficiency of the multi-process layer on a CPU
cluster, with the observability surface exercised under real load.

BASELINE.md's north star asks for "samples/s scaling efficiency measured at
1 chip, 1 host, and N>=2 hosts". This harness establishes the
*methodology* on the code paths a multi-host cluster runs: gloo collectives
across real OS processes, each process holding ONE virtual CPU device (and
pinned to the CPU, so no process opens an accelerator), running the
identical shard_map programs (`sharded_wola` halo exchange +
`sharded_caf_peak` shift sharding) that a device mesh runs.

(One device per process, not two: with multiple virtual devices the
single-process baseline executes them through one intra-op thread pool and
reads ~2x slower than the same work split across processes — a CPU-backend
scheduling artifact that made "efficiency" super-linear. Real accelerators
are independent devices, so the 1-device-per-process layout is the faithful
analogue.)

Scaling modes:
  * weak   — per-process work FIXED; global problem grows with the process
             count. Ideal: t(N) == t(1), efficiency = t(1)/t(N).
  * strong — TOTAL work fixed; each process owns 1/N of it.
             Ideal: t(N) == t(1)/N, efficiency = t(1)/(N*t(N)).

Core pinning: each worker gets a disjoint CPU set when the host has enough
cores. Process counts that exceed the core count are still measured but
flagged ``oversubscribed`` in the artifact — their efficiency mixes
communication overhead with host time-slicing (ideal weak efficiency on a
2-core host at 4 processes is ~0.5, not ~1.0) and must not be read as a
communication-layer number.

Observability under load: every worker drives a MetricsSink (per-rep JSONL
records) and a Heartbeat beacon per timed region; process 0 takes a
``cluster_progress`` snapshot at the end, which lands in the artifact —
the round-3 review asked for the metrics surface to be exercised by this
harness rather than only by its unit tests.

Usage:
    python benchmarks/scaling_efficiency.py [--nprocs 1 2 4]
        [--modes weak strong] [--samples-per-proc 2097152]
        [--shifts-per-proc 256] [--cutout 4096] [--reps 3]
        [--out SCALING.json]
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

WORKER = r"""
import json, os, sys, time
cfg = json.loads(sys.argv[1])
proc, nproc = cfg["proc"], cfg["nproc"]
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
os.environ.pop("JAX_PLATFORMS", None)
import jax
jax.config.update("jax_platforms", "cpu")
if nproc > 1:
    jax.distributed.initialize(coordinator_address="127.0.0.1:%d" % cfg["port"],
                               num_processes=nproc, process_id=proc)
sys.path.insert(0, cfg["repo"])
import numpy as np
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from pydsproutines_tpu.parallel.multihost import (Heartbeat, flat_mesh,
                                                  shard_local_blocks)
from pydsproutines_tpu.parallel import sharded_wola
from pydsproutines_tpu.parallel.xcorr import sharded_caf_peak
from pydsproutines_tpu.utils.metrics import MetricsSink

mesh = flat_mesh("dsp")
nlocal = cfg["samples_per_proc"]
shifts_local = cfg["shifts_per_proc"]
cutlen = cfg["cutout"]
reps = cfg["reps"]
hb = Heartbeat(cfg["hbdir"], process_id=proc, interval=0.0)
sink = MetricsSink(os.path.join(cfg["outdir"],
                                "metrics_%d_%d_%s.jsonl"
                                % (nproc, proc, cfg["mode"])),
                   process_id=proc)

rng = np.random.default_rng(100 + proc)
x_local = (rng.standard_normal(nlocal) + 1j * rng.standard_normal(nlocal)
           ).astype(np.complex64)
gx = shard_local_blocks(x_local, mesh, "dsp")

# rx for the CAF is replicated (every process must hold the same scene for
# its shift range to slice into) — sized by the GLOBAL shift span
rng0 = np.random.default_rng(7)
total_shifts = shifts_local * nproc
rxlen = cutlen + total_shifts + 16
rx = (rng0.standard_normal(rxlen) + 1j * rng0.standard_normal(rxlen)
      ).astype(np.complex64)
cut = rx[100:100 + cutlen].copy()
rep_sharding = NamedSharding(mesh, P())
g_rx = jax.make_array_from_callback(rx.shape, rep_sharding, lambda idx: rx[idx])
g_cut = jax.make_array_from_callback(cut.shape, rep_sharding,
                                     lambda idx: cut[idx])
shifts = np.arange(total_shifts, dtype=np.int32)
gshifts = shard_local_blocks(
    shifts[proc * shifts_local:(proc + 1) * shifts_local], mesh, "dsp")

f_tap = np.hanning(1024).astype(np.float32)
dec, nch = 64, 64


def barrier():
    # a tiny all-reduce over the sharded shift array: every process must
    # contribute its shard, so all processes align here before the timer
    z = jax.jit(jnp.sum)(gshifts)
    jax.block_until_ready(z)


def timed(name, fn, *args):
    out = fn(*args)              # compile + warm
    jax.block_until_ready(out)
    best = float("inf")
    for r in range(reps):
        barrier()
        t0 = time.perf_counter()
        out = fn(*args)
        jax.block_until_ready(out)
        dt = time.perf_counter() - t0
        best = min(best, dt)
        sink.emit(name, dt, unit="s", rep=r, nproc=nproc, mode=cfg["mode"])
        hb.beat(progress={"workload": name, "rep": r}, force=True)
    return best


t_wola = timed("sharded_wola", lambda: sharded_wola(
    jnp.asarray(f_tap), gx, dec, nch, mesh, "dsp"))
t_caf = timed("sharded_caf_peak", lambda: sharded_caf_peak(
    g_cut, g_rx, gshifts, mesh, "dsp", batch_size=64))

# per-phase breakdown (VERDICT round-4 item 7): the same local compute WITHOUT
# shard_map/collectives, on this process's own shard, under the same barrier
# discipline. total - local = collective + halo + launch-skew overhead.
from pydsproutines_tpu.ops.wola import wola as wola_single
from pydsproutines_tpu.ops.xcorr import _fast_xcorr_impl

local_shifts = jnp.asarray(
    shifts[proc * shifts_local:(proc + 1) * shifts_local])
j_rx = jnp.asarray(rx)
j_cut = jnp.asarray(cut)
j_x = jnp.asarray(x_local)
j_tap = jnp.asarray(f_tap)


def local_caf():
    qf2, freqs = _fast_xcorr_impl(
        j_cut, j_rx, local_shifts, n=cutlen, freqsearch=True,
        output_caf=False, abs_result=True,
        batch_size=min(64, shifts_local), step=1)
    i = jnp.argmax(qf2)
    return qf2[i], freqs[i]


t_caf_c = timed("caf_peak_local_compute", local_caf)
t_wola_c = timed("wola_local_compute",
                 lambda: wola_single(j_tap, j_x, dec, nch))
sink.close()

snapshot = None
if proc == 0:
    from pydsproutines_tpu.parallel.multihost import cluster_progress
    snapshot = cluster_progress(cfg["hbdir"], timeout=600.0, expected=nproc)
res = dict(proc=proc, nproc=nproc, t_wola=t_wola, t_caf=t_caf,
           t_wola_c=t_wola_c, t_caf_c=t_caf_c, cluster=snapshot)
with open(os.path.join(cfg["outdir"], "scal_%s_%d_%d.json"
          % (cfg["mode"], nproc, proc)), "w") as f:
    json.dump(res, f)
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_cluster(nproc: int, mode: str, cfg_base: dict, outdir: Path,
                ncores: int) -> dict:
    """Launch nproc workers; returns slowest-worker times + metadata.

    Disjoint taskset pinning when cores suffice; otherwise modulo-shared
    cores with an ``oversubscribed`` flag in the result.
    """
    script = outdir / "scaling_worker.py"
    script.write_text(WORKER)
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS", "PYTHONPATH")}
    port = _free_port()
    hbdir = outdir / f"hb_{mode}_{nproc}"
    # IDENTICAL per-process resources at every process count (one pinned
    # core each, as round 3): a baseline that grabs the whole host makes
    # every multi-process efficiency read ~1/N regardless of the
    # communication layer. Counts beyond the core count share cores
    # round-robin and are flagged.
    cores_per_proc = 1
    oversub = nproc > ncores
    procs = []
    for i in range(nproc):
        if mode == "weak":
            spp = cfg_base["samples_per_proc"]
            shp = cfg_base["shifts_per_proc"]
        else:  # strong: total work fixed at the 1-proc weak size
            spp = cfg_base["samples_per_proc"] // nproc
            shp = cfg_base["shifts_per_proc"] // nproc
        cfg = dict(cfg_base, proc=i, nproc=nproc, port=port, mode=mode,
                   samples_per_proc=spp, shifts_per_proc=shp,
                   outdir=str(outdir), repo=str(REPO), hbdir=str(hbdir))
        lo = (i * cores_per_proc) % ncores
        hi = min(lo + cores_per_proc - 1, ncores - 1)
        pin = ["taskset", "-c", f"{lo}-{hi}"]
        procs.append(subprocess.Popen(
            pin + [sys.executable, str(script), json.dumps(cfg)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    outs = [p.communicate(timeout=900)[0].decode() for p in procs]
    for p, out in zip(procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"worker failed:\n{out[-3000:]}")
    results = [json.loads(
        (outdir / f"scal_{mode}_{nproc}_{i}.json").read_text())
        for i in range(nproc)]
    nrec = sum(1 for i in range(nproc) for _ in open(
        outdir / f"metrics_{nproc}_{i}_{mode}.jsonl"))
    return {"t_wola": max(r["t_wola"] for r in results),
            "t_caf": max(r["t_caf"] for r in results),
            "t_wola_c": max(r["t_wola_c"] for r in results),
            "t_caf_c": max(r["t_caf_c"] for r in results),
            "oversubscribed": oversub,
            "cores_per_proc": cores_per_proc,
            "metrics_records": nrec,
            "cluster": results[0].get("cluster")}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--samples-per-proc", type=int, default=2_097_152)
    ap.add_argument("--shifts-per-proc", type=int, default=256)
    ap.add_argument("--cutout", type=int, default=4096)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--nprocs", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--modes", nargs="+", default=["weak", "strong"],
                    choices=["weak", "strong"])
    ap.add_argument("--out", default=str(REPO / "SCALING.json"))
    args = ap.parse_args(argv)

    cfg_base = dict(samples_per_proc=args.samples_per_proc,
                    shifts_per_proc=args.shifts_per_proc,
                    cutout=args.cutout, reps=args.reps)
    ncores = os.cpu_count() or 1
    t0 = time.time()
    report = {
        "harness": "weak+strong scaling on a gloo CPU cluster (1 virtual "
                   "device per process, disjoint pinned cores where the "
                   "host allows); weak efficiency = t(1)/t(N), strong "
                   "efficiency = t(1)/(N*t(N)), ideal 1.0. Process counts "
                   "flagged oversubscribed share host cores and measure "
                   "time-slicing, not the communication layer.",
        "config": dict(cfg_base, host_cores=ncores),
        "modes": {},
    }
    with tempfile.TemporaryDirectory() as td:
        for mode in args.modes:
            times = {}
            for n in args.nprocs:
                if mode == "strong" and (
                        args.samples_per_proc % n
                        or args.shifts_per_proc % n):
                    continue
                times[n] = run_cluster(n, mode, cfg_base, Path(td), ncores)
            base_n = min(times)
            base = times[base_n]
            mrep = {"workloads": {}, "cluster_snapshot_2proc": None}
            for wl in ("t_wola", "t_caf"):
                name = {"t_wola": "sharded_wola_64ch",
                        "t_caf": "sharded_caf_peak"}[wl]
                entry = {}
                for n, r in times.items():
                    entry[f"t_{n}proc_s"] = round(r[wl], 4)
                    # per-phase split (VERDICT round-4 item 7): local
                    # compute re-timed without shard_map/collectives;
                    # the remainder is collective + halo + launch skew
                    tc = r[wl + "_c"]
                    entry[f"t_{n}proc_local_compute_s"] = round(tc, 4)
                    entry[f"collective_overhead_{n}proc_pct"] = round(
                        100.0 * max(0.0, r[wl] - tc) / r[wl], 1)
                    if r["oversubscribed"]:
                        entry[f"oversubscribed_{n}proc"] = True
                for n in sorted(times):
                    if n == base_n:
                        continue
                    eff = base[wl] / times[n][wl]
                    if mode == "strong":
                        eff /= n / base_n
                    entry[f"efficiency_{n}proc"] = round(eff, 3)
                mrep["workloads"][name] = entry
            two = times.get(2) or times.get(max(times))
            mrep["cluster_snapshot_2proc"] = two.get("cluster")
            mrep["metrics_records"] = {n: r["metrics_records"]
                                       for n, r in times.items()}
            report["modes"][mode] = mrep
    report["wall_seconds"] = round(time.time() - t0, 1)

    Path(args.out).write_text(json.dumps(report, indent=2) + "\n")
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
