"""chip_smoke.py's phases at a tiny size on the CPU, its refusal to run
without a GPU, and (marked ``gpu``) the whole script on a card."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

import chip_smoke as cs

ROOT = Path(cs.__file__).resolve().parent

TINY_RECEIVER = dict(num_channels=8, num_taps=64, template_len=128,
                     num_shifts=64, osr=4, demod_syms=16, m=4,
                     n_wide=8 * 1024, noise=1.0, seed=7)
TINY_XCORR = dict(n=4096, nshifts=32, noise=0.5, seed=11)
TINY_STREAM = dict(num_channels=8, num_taps=64, n=8 * 512, blocks=4, seed=5)
TINY_FOUR = dict(wola_n=8 * 1024, num_channels=8, num_taps=64,
                 xcorr_n=4096, nshifts=32, seed=13)


def test_receiver_scene_plants_its_truth():
    template, rx, truth = cs.receiver_scene(TINY_RECEIVER)
    from scipy import signal as sps
    h = sps.firwin(64, 1.0 / 8)
    ref = cs.receiver_reference(TINY_RECEIVER, h, template, rx)
    assert (ref["best_channel"], ref["ipeak"], ref["bin"]) == \
        (truth["channel"], truth["shift"], truth["bin"])
    assert ref["margins"]["sym"] > 1e-4


def test_receiver_and_memory_phases_tiny(capsys):
    ok, state = cs.phase_receiver(TINY_RECEIVER)
    assert ok, capsys.readouterr().out
    assert cs.phase_memory(*state)
    out = capsys.readouterr().out
    assert "memory_analysis" in out and "tolerance" in out


def test_north_star_phase_tiny(capsys):
    assert cs.phase_north_star(TINY_XCORR), capsys.readouterr().out


def test_streaming_phase_tiny(capsys):
    assert cs.phase_streaming(TINY_STREAM), capsys.readouterr().out


def test_four_phase_tiny_on_virtual_devices(capsys):
    assert len(jax.devices()) >= 4
    assert cs.phase_four(TINY_FOUR), capsys.readouterr().out


def test_phase_reports_error_beyond_tolerance(capsys):
    ph = cs.Phase("x")
    ph.within("err", 1e-3, 2e-5)
    ph.equal("bin", 3, 4)
    assert not ph.done()
    out = capsys.readouterr().out
    assert "EXCEEDS" in out and "DIFFERS" in out and "FAILED" in out


@pytest.mark.parametrize("argv", [[], ["--four"]])
def test_main_refuses_without_gpu(argv, capsys, keep_cache_config):
    assert cs.main(argv) == 2
    out = capsys.readouterr()
    assert '"ok"' not in out.out
    assert "no GPU" in out.err


@pytest.fixture
def gpu():
    """Skip unless a card is present (asked of nvidia-smi: this process's
    JAX is pinned to the CPU)."""
    try:
        listed = subprocess.run(["nvidia-smi", "-L"], capture_output=True,
                                text=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        listed = ""
    if "GPU" not in listed:
        pytest.skip("no GPU on this machine")


@pytest.mark.gpu
def test_chip_smoke_on_gpu(gpu):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    run = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=1200)
    assert run.returncode == 0, run.stdout[-4000:] + run.stderr[-4000:]
    last = json.loads(run.stdout.strip().splitlines()[-1])
    assert last["ok"] and last["device"]["platform"] == "gpu"
