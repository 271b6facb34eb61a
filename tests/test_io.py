import os

import numpy as np
import pytest

from pydsproutines_tpu.io import (
    simple_bin_read,
    multi_bin_read,
    is_int16_clipping,
    FolderReader,
    SortedFolderReader,
    GroupReader,
    GroupDatabase,
    XcorrDB,
    DSPConfig,
)
from pydsproutines_tpu.io.binfiles import _load_native


def _write_capture(path, data_c64):
    interleaved = data_c64.view(np.float32).astype(np.int16)
    interleaved.tofile(path)


def _make_folder(tmp_path, num_files=6, samps=128, t0=1000, gap_at=None):
    rng = np.random.default_rng(42)
    arrays = []
    for i in range(num_files):
        t = t0 + i + (2 if gap_at is not None and i >= gap_at else 0)
        data = (rng.integers(-100, 100, samps)
                + 1j * rng.integers(-100, 100, samps)).astype(np.complex64)
        _write_capture(os.path.join(tmp_path, f"{t}.bin"), data)
        arrays.append(data)
    return arrays


def test_simple_bin_read_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    data = (rng.integers(-1000, 1000, 256)
            + 1j * rng.integers(-1000, 1000, 256)).astype(np.complex64)
    p = str(tmp_path / "a.bin")
    _write_capture(p, data)
    out = simple_bin_read(p, 256)
    assert np.array_equal(out, data)
    # partial read with offset (in bytes: skip 10 complex samples = 40 bytes)
    out2 = simple_bin_read(p, 16, offset=40)
    assert np.array_equal(out2, data[10:26])


def test_multi_bin_read_native_and_fallback(tmp_path):
    arrays = _make_folder(str(tmp_path), num_files=5, samps=64)
    paths = sorted(str(p) for p in tmp_path.glob("*.bin"))
    expected = np.concatenate(arrays)
    out = multi_bin_read(paths, 64, threads=3)
    assert np.array_equal(out, expected)
    assert _load_native() is not None, "native loader should be built"
    # float32 input path exercises the python fallback
    f32 = np.arange(32, dtype=np.float32)
    f32.tofile(str(tmp_path / "f32.bin"))
    out = multi_bin_read([str(tmp_path / "f32.bin")], 16,
                         in_dtype=np.float32)
    assert out.dtype == np.complex64
    assert np.array_equal(out.view(np.float32), f32)


def test_is_int16_clipping():
    ok = np.array([100 + 100j], dtype=np.complex64)
    assert not is_int16_clipping(ok)
    clip = np.array([32500 + 0j], dtype=np.complex64)
    assert is_int16_clipping(clip)


def test_folder_reader_prefetch(tmp_path):
    arrays = _make_folder(str(tmp_path), num_files=6, samps=128)
    fr = FolderReader(str(tmp_path), 128)
    fr.filepaths.sort()
    fr.filenames.sort()
    data, fps = fr.get(2, prefetch=2)
    assert np.array_equal(data, np.concatenate(arrays[:2]))
    assert len(fps) == 2
    # second get consumes prefetched futures
    data2, fps2 = fr.get(2)
    assert np.array_equal(data2, np.concatenate(arrays[2:4]))
    assert fr.has_more_files


def test_sorted_folder_reader(tmp_path):
    arrays = _make_folder(str(tmp_path), num_files=5, samps=64, t0=5000)
    sr = SortedFolderReader(str(tmp_path), 64)
    assert sr.get_final_time() == 5004
    data, fps, fts = sr.get(3)
    assert np.array_equal(fts, [5000, 5001, 5002])
    assert np.array_equal(data, np.concatenate(arrays[:3]))
    sr.start_at_time(5001)
    d, p = sr.get_file_by_time(5001)
    assert np.array_equal(d, arrays[1])


def test_group_reader(tmp_path):
    arrays = _make_folder(str(tmp_path), num_files=6, samps=32, t0=100,
                          gap_at=3)  # groups: [100..102], [105..107]
    gr = GroupReader(str(tmp_path), 32)
    assert gr.num_groups == 2
    d1, p1, t1 = gr.get_group()
    assert np.array_equal(t1, [100, 101, 102])
    assert np.array_equal(d1, np.concatenate(arrays[:3]))
    d2, p2, t2 = gr.get_group()
    assert np.array_equal(t2, [105, 106, 107])
    assert not gr.has_more_groups


def test_group_database(tmp_path):
    db = GroupDatabase(str(tmp_path / "g.db"))
    db.add_table("bursts")
    assert db.get_latest_group_idx("bursts") == -1
    db.insert_group("bursts", 0, 100, 102)
    db.insert_group("bursts", 1, 105, 107)
    assert db.get_latest_group_idx("bursts") == 1
    assert db.get_group_by_idx("bursts", 0) == (0, 100, 102)
    db.update_metatable(107)
    assert db.get_last_processed_time() == 107


def test_xcorr_db_roundtrip(tmp_path):
    db = XcorrDB(str(tmp_path / "xc.db"))
    db.create_xcorr_results_table("results_a", fc=1e9, fs=1_000_000,
                                  s1="sensorA", s2="sensorB", xctype=1)
    assert "results_a" in db.tables()
    meta = db.get_metadata("results_a")
    assert meta[1] == 1e9 and meta[5] == 1

    base = dict(time_sec=1234, tidx=100, cutoutlen=1000, td_scan_start=0.0,
                td_scan_numsteps=128, td_scan_step=1e-6, fd_scan_start=0.0,
                fd_scan_numsteps=0, fd_scan_step=0.0, rfd_scan_start=0.0,
                rfd_scan_numsteps=0, rfd_scan_step=0.0, desc=None)
    qf2 = np.random.default_rng(0).random(128)
    fi = np.arange(128, dtype=np.uint32)
    db.insert_1d_result("results_a", base, qf2, fi)

    rows = db.select_results("results_a", "time_sec=?", (1234,))
    assert len(rows) == 1
    q, f = XcorrDB.regenerate_1d(rows[0][13], rows[0][14])
    assert np.allclose(q, qf2)
    assert np.array_equal(f, fi)

    # UNIQUE constraint: same scan params replace instead of duplicate
    db.insert_1d_result("results_a", base, qf2 * 2, fi)
    assert len(db.select_results("results_a")) == 1

    # type-2 CAF
    db.create_xcorr_results_table("results_caf", 0.0, 1000, "a", "b", 2)
    caf = np.random.default_rng(1).random((16, 64))
    db.insert_2d_result("results_caf", base, caf)
    rows = db.select_results("results_caf")
    caf2 = XcorrDB.regenerate_2d(rows[0][13], 16)
    assert np.allclose(caf2, caf)


def test_dsp_config(tmp_path):
    ini = tmp_path / "test.ini"
    ini.write_text("""
[src_mysrc]
srcdir = /data/captures
fs = 1000000
fc = 100e6
conjSamples = false
headerBytes = 0
dtype = int16
lonlatalt = 103.8,1.35,15.0

[sig_mysig]
target_fc = 100.1e6
baud = 25000
numBurstBits = 480
numGuardBits = 20
numPeriodBits = 500
numBursts = 12

[pro_myproc]
src = mysrc
sig = mysig
numTaps = 128
target_osr = 4
threshold = 2.5

[myworkspace]
pro_myproc
""")
    cfg = DSPConfig(str(ini))
    assert set(cfg.all_sources) == {"mysrc"}
    assert set(cfg.all_signals) == {"mysig"}
    assert set(cfg.all_processes) == {"myproc"}
    assert set(cfg.all_workspaces) == {"myworkspace"}

    src = cfg.get_src("mysrc")
    assert src.fs == 1e6 and src.fc == 100e6
    assert src.lonlatalt == (103.8, 1.35, 15.0)
    assert src.conj_samples is False

    sig = cfg.get_sig("mysig")
    assert sig.baud == 25000
    assert sig.num_period_bits == 500
    assert not sig.has_channels

    proc = cfg.get_process("myproc")
    assert proc.num_taps == 128
    assert proc.src.fs == 1e6          # linked source
    assert proc.sig.baud == 25000      # linked signal

    cfg.load_section("myworkspace")
    assert set(cfg.processes) == {"myproc"}


def test_xcorr_viewer_cli(tmp_path, capsys):
    """Headless DB browser lists, describes, and plots result rows
    (reference xcorrDatabase/viewer.py capability, headless)."""
    import numpy as np
    from pydsproutines_tpu.io.xcorrdb import XcorrDB
    from pydsproutines_tpu.viz import xcorr_viewer

    dbp = str(tmp_path / "v.db")
    db = XcorrDB(dbp)
    base = dict(time_sec=1, tidx=0, cutoutlen=100, td_scan_start=0.0,
                td_scan_numsteps=32, td_scan_step=1.0, fd_scan_start=-8.0,
                fd_scan_numsteps=16, fd_scan_step=1.0, rfd_scan_start=0.0,
                rfd_scan_numsteps=0, rfd_scan_step=0.0)
    db.create_xcorr_results_table("t1", 1e9, 1_000_000, "a", "b",
                                  XcorrDB.TYPE_1D)
    qf2 = np.zeros(32); qf2[7] = 0.9
    db.insert_1d_result("t1", base, qf2, np.arange(32))
    db.create_xcorr_results_table("t2", 1e9, 1_000_000, "a", "b",
                                  XcorrDB.TYPE_2D)
    caf = np.random.default_rng(0).random((32, 16))
    db.insert_2d_result("t2", base, caf)
    db.close()

    xcorr_viewer.main([dbp])
    out = capsys.readouterr().out
    assert "t1" in out and "t2" in out

    xcorr_viewer.main([dbp, "t1"])
    out = capsys.readouterr().out
    assert "peak qf2=0.9000 at step 7" in out

    png = str(tmp_path / "caf.png")
    xcorr_viewer.main([dbp, "t2", "--row", "0", "--plot", png])
    assert (tmp_path / "caf.png").stat().st_size > 1000


def test_streaming_capture_loader(tmp_path):
    """Native ring-buffer streaming pipeline delivers frames in order with
    halo history, and block-wise filtering over the stream equals filtering
    the concatenated capture (the continuity property the halo exists for)."""
    import numpy as np
    from pydsproutines_tpu.io.binfiles import (StreamingCaptureLoader,
                                               _load_stream_native)

    rng = np.random.default_rng(5)
    samps, nfiles, halo = 1000, 6, 64
    raw = rng.integers(-2000, 2000, size=(nfiles, samps * 2)).astype(np.int16)
    paths = []
    for i in range(nfiles):
        p = tmp_path / f"cap{i}.bin"
        raw[i].tofile(p)
        paths.append(str(p))
    full = raw.reshape(-1).astype(np.float32).view(np.complex64)

    assert _load_stream_native() is not None, \
        "native stream lib should be built"
    got = []
    with StreamingCaptureLoader(paths, samps, halo=halo, num_workers=3,
                                ring_capacity=3) as ldr:
        for i, frame in ldr:
            assert frame.shape == (halo + samps,)
            if i == 0:
                assert np.all(frame[:halo] == 0)
            else:
                np.testing.assert_array_equal(
                    frame[:halo], full[i * samps - halo: i * samps])
            np.testing.assert_array_equal(frame[halo:],
                                          full[i * samps:(i + 1) * samps])
            got.append(frame[halo:])
    np.testing.assert_array_equal(np.concatenate(got), full)

    # pure-python fallback path produces identical frames
    ldr2 = StreamingCaptureLoader(paths, samps, halo=halo, num_workers=2,
                                  ring_capacity=2)
    ldr2._handle = None  # force fallback branch
    from concurrent.futures import ThreadPoolExecutor
    from pydsproutines_tpu.io.binfiles import simple_bin_read
    ldr2._pool = ThreadPoolExecutor(max_workers=2)
    ldr2._cap = 2
    ldr2._futures = [ldr2._pool.submit(simple_bin_read, f, samps)
                     for f in paths[:2]]
    ldr2._submitted = 2
    ldr2._tail = np.zeros(halo, np.complex64)
    frames2 = [f for _, f in ldr2]
    ldr2.close()
    for (i, f1), f2 in zip(enumerate(got), frames2):
        np.testing.assert_array_equal(f1, f2[halo:])


def test_checkpointed_xcorr_pipeline(tmp_path):
    """Resumable block processing: interrupting after some blocks and
    re-running completes only the missing ones; global peak is found
    (results-level checkpoint semantics, SURVEY.md §5)."""
    import numpy as np
    import jax.numpy as jnp
    from pydsproutines_tpu.io.xcorrdb import XcorrDB
    from pydsproutines_tpu.models.pipeline import CheckpointedXcorrPipeline

    rng = np.random.default_rng(3)
    n, nshifts = 512, 2048
    template = (rng.standard_normal(n)
                + 1j * rng.standard_normal(n)).astype(np.complex64)
    rx = (rng.standard_normal(nshifts + n)
          + 1j * rng.standard_normal(nshifts + n)).astype(np.complex64) * 0.3
    rx[900:900 + n] += template

    db = XcorrDB(str(tmp_path / "ckpt.db"))
    pipe = CheckpointedXcorrPipeline(db, "job1", template, fs=1e6,
                                     block_shifts=512)
    assert pipe.num_blocks(rx.shape[-1]) == 4

    # simulate a partial run: process blocks 0-1 then "crash"
    full = CheckpointedXcorrPipeline(db, "job1", template, fs=1e6,
                                     block_shifts=512)
    rxj = jnp.asarray(rx)
    for bi in range(2):
        s0 = bi * 512
        from pydsproutines_tpu.ops.xcorr import fast_xcorr
        qf2, freqs = fast_xcorr(jnp.asarray(template), rxj, freqsearch=True,
                                shifts=jnp.arange(s0, s0 + 512))
        db.insert_1d_result("job1", full._base(bi), np.asarray(qf2),
                            np.asarray(freqs))
    assert full.completed_blocks() == {0, 1}

    # resume: only 2 remaining blocks computed
    computed = full.run(rxj)
    assert computed == 2
    assert full.completed_blocks() == {0, 1, 2, 3}
    # idempotent
    assert full.run(rxj) == 0
    shift, qf2v, _ = full.peak()
    assert shift == 900 and qf2v > 0.5


def test_split_high_amp_subfolders(tmp_path):
    """Reference splitHighAmpSubfolders semantics (usrpRoutines.py:450):
    amplitude detection, buffered group expansion, gap splitting,
    subfolder copies, and the database variant."""
    src = tmp_path / "cap"
    src.mkdir()
    rng = np.random.default_rng(3)
    for i in range(10):
        t = 2000 + i
        data = (rng.integers(-50, 50, 32)
                + 1j * rng.integers(-50, 50, 32)).astype(np.complex64)
        if i in (3, 8):  # loud files
            data[5] = 30000 + 0j
        _write_capture(os.path.join(str(src), f"{t}.bin"), data)

    sr = SortedFolderReader(str(src), 32)
    times = sr.split_high_amp_subfolders(str(tmp_path / "out"), min_amp=1e3,
                                         only_extract_times=True)
    assert times == [2002, 2003, 2004, 2007, 2008, 2009]

    groups = sr.split_high_amp_subfolders(str(tmp_path / "out"), min_amp=1e3,
                                          only_extract_groups=True)
    assert groups == [[2002, 2003, 2004], [2007, 2008, 2009]]

    out = tmp_path / "out"
    ret = sr.split_high_amp_subfolders(str(out), min_amp=1e3)
    assert ret == times
    assert sorted(os.listdir(out)) == ["000000", "000001"]
    assert sorted(os.listdir(out / "000000")) == ["2002.bin", "2003.bin",
                                                  "2004.bin"]
    assert sorted(os.listdir(out / "000001")) == ["2007.bin", "2008.bin",
                                                  "2009.bin"]
    # copied bytes identical
    a = open(src / "2003.bin", "rb").read()
    b = open(out / "000000" / "2003.bin", "rb").read()
    assert a == b

    # database variant records [start, end] per group, no copies
    dbdir = tmp_path / "dbout"
    sr.split_high_amp_subfolders(str(dbdir), select_times=times,
                                 use_database=True)
    from pydsproutines_tpu.io.binfiles import GroupDatabase
    gd = GroupDatabase(str(dbdir / "groups.db"))
    rows = gd.get_all_groups("groups")
    assert rows == [(0, 2002, 2004), (1, 2007, 2009)]

    # empty selection raises (reference IndexError)
    import pytest as _pytest
    with _pytest.raises(IndexError):
        sr.split_high_amp_subfolders(str(out), min_amp=1e9)
