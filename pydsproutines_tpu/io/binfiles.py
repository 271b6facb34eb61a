"""Binary capture readers.

Reference semantics: /root/reference/usrpRoutines.py (simpleBinRead :51,
multiBinReadThreaded :88, isInt16Clipping :159, FolderReader :179,
SortedFolderReader :374, GroupReader :597, GroupDatabase :685).

The multi-file hot path uses the native threaded C++ loader
(native/binloader.cpp — fread + int16->float32 striped across std::threads,
writing straight into the numpy output buffer), built from native/Makefile
into native/build/ on first use, with a ThreadPoolExecutor+numpy fallback
where no C++ compiler is available. Readers prefetch upcoming
files on a background executor so the device never waits on disk (the
reference's futureBinRead pattern).
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import fcntl
import fnmatch
import functools
import os
import sqlite3
import subprocess

import numpy as np

_NATIVE_DIR = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", "native"))


def _native_lib(name: str):
    """ctypes handle of native/build/<name>, (re)built by make when missing
    or older than its source; None when it neither exists nor builds. A
    file lock keeps concurrent processes from building at once."""
    path = os.path.join(_NATIVE_DIR, "build", name)
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(os.path.join(_NATIVE_DIR, "build", ".lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            subprocess.run(["make", "-s", "-C", _NATIVE_DIR, f"build/{name}"],
                           check=True, capture_output=True, timeout=300)
    except (OSError, subprocess.SubprocessError):
        pass  # no toolchain: a library built earlier still serves
    try:
        return ctypes.CDLL(path)
    except OSError:
        return None


@functools.cache
def _load_native():
    lib = _native_lib("libdspbinloader.so")
    if lib is not None:
        lib.load_int16_files.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
            ctypes.c_long, ctypes.c_long,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int]
        lib.load_int16_files.restype = ctypes.c_int
        lib.load_int16_file.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.c_long,
            ctypes.POINTER(ctypes.c_float)]
        lib.load_int16_file.restype = ctypes.c_int
    return lib



def simple_bin_read(filename, num_samps: int = -1, in_dtype=np.int16,
                    out_dtype=np.complex64, offset: int = 0) -> np.ndarray:
    """Read interleaved I/Q samples from one file (reference simpleBinRead).
    ``num_samps`` counts complex samples; -1 reads the whole file."""
    in_dtype = np.dtype(in_dtype)
    if in_dtype.kind == "c":
        raise TypeError("in_dtype must be a real type (e.g. int16/float32).")
    count = -1 if num_samps < 0 else num_samps * 2
    data = np.fromfile(filename, dtype=in_dtype, count=count, offset=offset)
    return data.astype(np.float32).view(out_dtype)


def multi_bin_read(filenames, num_samps: int, in_dtype=np.int16,
                   out_dtype=np.complex64, offset: int = 0,
                   threads: int = 4) -> np.ndarray:
    """Read many equal-length capture files into one array (reference
    multiBinReadThreaded). Uses the native threaded loader for int16 input
    when available."""
    filenames = list(filenames)
    n = len(filenames)
    native = _load_native()
    if (native is not None and np.dtype(in_dtype) == np.int16
            and np.dtype(out_dtype) == np.complex64):
        out = np.empty(n * num_samps * 2, dtype=np.float32)
        paths = (ctypes.c_char_p * n)(
            *[os.fsencode(f) for f in filenames])
        rc = native.load_int16_files(
            paths, n, num_samps, offset,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), threads)
        if rc != 0:
            raise IOError(f"native loader failed with status {rc}")
        return out.view(np.complex64)

    alldata = np.zeros(n * num_samps, dtype=out_dtype)
    with concurrent.futures.ThreadPoolExecutor(max_workers=max(threads, 1)) as ex:
        futs = {ex.submit(simple_bin_read, f, num_samps, in_dtype, out_dtype,
                          offset): i for i, f in enumerate(filenames)}
        for fut in concurrent.futures.as_completed(futs):
            i = futs[fut]
            alldata[i * num_samps: (i + 1) * num_samps] = fut.result()
    return alldata


def is_int16_clipping(data, threshold: int = 32000) -> bool:
    """Detect near-full-scale int16 recordings (reference isInt16Clipping)."""
    data = np.asarray(data)
    if data.dtype == np.complex64:
        fdata = data.view(np.float32)
    elif data.dtype == np.complex128:
        fdata = data.view(np.float64)
    else:
        fdata = data
    return bool(np.any(np.abs(fdata) > threshold))


class FolderReader:
    """Sequential reader over a folder of equal-size capture files with
    background prefetch (reference FolderReader, usrpRoutines.py:179)."""

    def __init__(self, folderpath, num_samps_per_file: int,
                 extension: str = ".bin", in_dtype=np.int16,
                 out_dtype=np.complex64, ignore_insufficient_data: bool = True):
        self.folderpath = folderpath
        self.num_samps_per_file = int(num_samps_per_file)
        self.extension = extension
        self.in_dtype = np.dtype(in_dtype)
        self.out_dtype = np.dtype(out_dtype)
        self.ignore_insufficient_data = ignore_insufficient_data
        self.executor = concurrent.futures.ThreadPoolExecutor(1)
        self.futures: list = []
        self.refresh_filelists()

    @property
    def has_more_files(self) -> bool:
        return self.fidx < len(self.filepaths)

    def refresh_filelists(self):
        req_min = self.in_dtype.itemsize * 2 * self.num_samps_per_file
        contents = os.listdir(self.folderpath)
        if self.ignore_insufficient_data:
            contents = [f for f in contents if os.path.getsize(
                os.path.join(self.folderpath, f)) >= req_min]
        self.filenames = fnmatch.filter(contents, "*" + self.extension)
        self.filepaths = [os.path.join(self.folderpath, f)
                          for f in self.filenames]
        self.reset()

    def reset(self):
        self.fidx = 0
        self.futures = []

    def start_at_index(self, i: int):
        self.fidx = int(i)
        self.futures.clear()

    def get(self, num_files: int, prefetch: int = 0):
        """Read the next num_files files (consuming prefetched results
        first), then queue ``prefetch`` more reads in the background.
        Returns (data flattened, filepaths read)."""
        start = self.fidx
        data = np.zeros((num_files, self.num_samps_per_file),
                        dtype=self.out_dtype)
        i = 0
        remainder = num_files
        while self.futures and remainder > 0:
            fut = self.futures.pop(0)
            data[i, :] = fut.result().astype(np.float32).view(self.out_dtype)
            i += 1
            remainder -= 1
            self.fidx += 1
        while remainder > 0:
            data[i, :] = simple_bin_read(
                self.filepaths[self.fidx], self.num_samps_per_file,
                self.in_dtype, self.out_dtype)
            i += 1
            self.fidx += 1
            remainder -= 1
        additional = prefetch - len(self.futures)
        for a in range(additional):
            idx = self.fidx + len(self.futures)
            if idx < len(self.filepaths):
                self.futures.append(self.executor.submit(
                    np.fromfile, self.filepaths[idx], dtype=self.in_dtype,
                    count=self.num_samps_per_file * 2))
        fps = self.filepaths[start: self.fidx]
        return data.reshape(-1), fps

    def get_next_file(self):
        if self.fidx >= len(self.filepaths):
            raise ValueError("Insufficient files remaining.")
        fp = self.filepaths[self.fidx]
        self.fidx += 1
        return simple_bin_read(fp, self.num_samps_per_file, self.in_dtype,
                               self.out_dtype), fp


class SortedFolderReader(FolderReader):
    """FolderReader over integer-timestamp filenames, time-sorted with
    gap checking (reference SortedFolderReader, usrpRoutines.py:374)."""

    def __init__(self, folderpath, num_samps_per_file: int,
                 extension: str = ".bin", in_dtype=np.int16,
                 out_dtype=np.complex64, ensure_incremental: bool = True):
        super().__init__(folderpath, num_samps_per_file, extension, in_dtype,
                         out_dtype)
        self.filetimes = np.array(
            [int(os.path.splitext(f)[0]) for f in self.filenames])
        order = np.argsort(self.filetimes)
        self.filetimes = self.filetimes[order]
        self.filenames = [self.filenames[i] for i in order]
        self.filepaths = [self.filepaths[i] for i in order]
        if ensure_incremental and self.filetimes.size > 1:
            assert np.all(np.diff(self.filetimes) == 1), \
                "file timestamps are not contiguous"

    def get_final_time(self):
        return self.filetimes[-1]

    def start_at_time(self, start_time: int):
        idx = int(np.argwhere(self.filetimes == start_time)[0, 0])
        self.start_at_index(idx)

    def get_path_by_time(self, req_time: int):
        return self.filepaths[int(np.argwhere(
            self.filetimes == req_time).flatten()[0])]

    def get_file_by_time(self, req_time):
        if isinstance(req_time, (int, np.integer)):
            paths = [self.get_path_by_time(req_time)]
        else:
            paths = [self.get_path_by_time(t) for t in req_time]
        data = multi_bin_read(paths, self.num_samps_per_file, self.in_dtype,
                              self.out_dtype)
        return data, paths if len(paths) > 1 else paths[0]

    def get(self, num_files: int, prefetch: int = 0):
        data, fps = super().get(num_files, prefetch)
        fts = self.filetimes[self.fidx - num_files: self.fidx]
        return data, fps, fts

    def split_high_amp_subfolders(self, target_folder_path: str,
                                  select_times=None, min_amp: float = 1e3,
                                  buf_front: int = 1, buf_back: int = 1,
                                  only_extract_times: bool = False,
                                  only_extract_groups: bool = False,
                                  fmt: str = "%06d",
                                  use_database: bool = False,
                                  db_file_path: str | None = None):
        """Detect files whose peak amplitude exceeds ``min_amp``, expand each
        hit by [t - buf_front, t + buf_back], and either copy the resulting
        contiguous groups into numbered subfolders of ``target_folder_path``
        or record them in a GroupDatabase (reference splitHighAmpSubfolders,
        usrpRoutines.py:450).

        Returns the sorted unique ``select_times`` so a second reader can
        snapshot the same groups synchronously. ``only_extract_times``
        returns just that list; ``only_extract_groups`` returns the times
        split into contiguous groups (list of lists). The internal read
        index is never touched.
        """
        import shutil

        if select_times is None:
            select_times = []
            for path, t in zip(self.filepaths, self.filetimes):
                data = simple_bin_read(path, self.num_samps_per_file,
                                       self.in_dtype, self.out_dtype)
                if float(np.max(np.abs(data))) > min_amp:
                    select_times.extend(
                        range(int(t) - buf_front, int(t) + buf_back + 1))
        select_times = sorted(set(int(t) for t in select_times))
        if len(select_times) == 0:
            raise IndexError("No groups were found. Perhaps try lowering "
                             "the min_amp threshold?")
        if only_extract_times:
            return select_times

        st = np.asarray(select_times)
        cuts = np.concatenate(
            [[0], np.flatnonzero(np.diff(st) > 1) + 1, [st.size]])
        groups = [select_times[cuts[i]: cuts[i + 1]]
                  for i in range(cuts.size - 1)]
        if only_extract_groups:
            return groups

        if use_database:
            if db_file_path is None:
                db_file_path = os.path.join(target_folder_path, "groups.db")
            os.makedirs(os.path.dirname(db_file_path) or ".", exist_ok=True)
            gd = GroupDatabase(db_file_path)
            gd.add_table("groups")
            for i, grp in enumerate(groups):
                gd.insert_group("groups", i, grp[0], grp[-1])
        else:
            os.makedirs(target_folder_path, exist_ok=True)
            for i, grp in enumerate(groups):
                subdir = os.path.join(target_folder_path, fmt % i)
                os.makedirs(subdir, exist_ok=True)
                for t in grp:
                    src = os.path.join(self.folderpath,
                                       f"{t}{self.extension}")
                    if os.path.isfile(src):
                        shutil.copy2(src, os.path.join(
                            subdir, os.path.basename(src)))
        return select_times


class GroupReader(SortedFolderReader):
    """Reader that partitions timestamped files into contiguous groups (burst
    recordings separated by gaps) and yields one group at a time (reference
    GroupReader, usrpRoutines.py:597 — note it does NOT require incremental
    times, the gaps define the groups)."""

    def __init__(self, folderpath, num_samps_per_file: int,
                 extension: str = ".bin", in_dtype=np.int16,
                 out_dtype=np.complex64):
        super().__init__(folderpath, num_samps_per_file, extension, in_dtype,
                         out_dtype, ensure_incremental=False)
        self._parse_groups()
        self.gidx = 0

    def _parse_groups(self):
        if self.filetimes.size == 0:
            self.group_bounds = []
            return
        splits = np.argwhere(np.diff(self.filetimes) > 1).flatten() + 1
        idx = np.split(np.arange(self.filetimes.size), splits)
        self.group_bounds = [(int(g[0]), int(g[-1] + 1)) for g in idx]

    def reset(self):
        super().reset()
        self.gidx = 0

    @property
    def has_more_groups(self) -> bool:
        return self.gidx < len(self.group_bounds)

    @property
    def num_groups(self) -> int:
        return len(self.group_bounds)

    def get_group(self):
        """Read all files of the next group. Returns (data, paths, times)."""
        if not self.has_more_groups:
            raise ValueError("No more groups.")
        start, end = self.group_bounds[self.gidx]
        self.gidx += 1
        paths = self.filepaths[start:end]
        data = multi_bin_read(paths, self.num_samps_per_file, self.in_dtype,
                              self.out_dtype)
        return data, paths, self.filetimes[start:end]


class GroupDatabase:
    """sqlite tracker of processed burst groups + last-processed time
    (reference GroupDatabase, usrpRoutines.py:685)."""

    def __init__(self, dbfilepath: str = "groups.db"):
        self.dbfilepath = dbfilepath
        self.con = sqlite3.connect(dbfilepath)
        self.cur = self.con.cursor()
        self.add_metatable()

    def add_metatable(self):
        self.cur.execute(
            "CREATE TABLE IF NOT EXISTS meta(lastfiletime INTEGER)")
        self.con.commit()

    def update_metatable(self, lastfiletime: int):
        self.cur.execute("DELETE FROM meta")
        self.cur.execute("INSERT INTO meta VALUES(?)", (int(lastfiletime),))
        self.con.commit()

    def get_last_processed_time(self):
        row = self.cur.execute("SELECT lastfiletime FROM meta").fetchone()
        return row[0] if row else None

    def add_table(self, tablename: str):
        self.cur.execute(
            f"CREATE TABLE IF NOT EXISTS {tablename}"
            "(gidx INTEGER UNIQUE, starttime INTEGER, endtime INTEGER)")
        self.con.commit()

    def get_latest_group_idx(self, tablename: str):
        row = self.cur.execute(
            f"SELECT MAX(gidx) FROM {tablename}").fetchone()
        return row[0] if row and row[0] is not None else -1

    def insert_group(self, tablename: str, gidx: int, starttime: int,
                     endtime: int):
        self.cur.execute(
            f"INSERT OR REPLACE INTO {tablename} VALUES(?,?,?)",
            (int(gidx), int(starttime), int(endtime)))
        self.con.commit()

    def get_group_by_idx(self, tablename: str, gidx: int):
        return self.cur.execute(
            f"SELECT * FROM {tablename} WHERE gidx=?", (int(gidx),)).fetchone()

    def get_all_groups(self, tablename: str):
        return self.cur.execute(
            f"SELECT * FROM {tablename} ORDER BY gidx").fetchall()


# ---------------------------------------------------------------------------
# Streaming capture pipeline (native ring buffer)
# ---------------------------------------------------------------------------

@functools.cache
def _load_stream_native():
    lib = _native_lib("libdspstream.so")
    if lib is not None:
        lib.stream_open.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
            ctypes.c_long, ctypes.c_long, ctypes.c_int, ctypes.c_int]
        lib.stream_open.restype = ctypes.c_void_p
        lib.stream_next.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)]
        lib.stream_next.restype = ctypes.c_int
        lib.stream_close.argtypes = [ctypes.c_void_p]
        lib.stream_close.restype = None
    return lib



class StreamingCaptureLoader:
    """Ordered streaming frames over a list of int16 capture files, with a
    halo of previous-frame samples prepended to each frame — the warm-up
    history a streaming filter / Channeliser needs (reference delay-line
    semantics, filterRoutines.py:663-675; prefetch model usrpRoutines.py:246).

    Backed by the native ring-buffer pipeline (native/stream_pipeline.cpp)
    when built; otherwise a ThreadPoolExecutor prefetch fallback with
    identical output. Iterate to get (frame_index, complex64 array of
    halo + samps_per_file samples); use as a context manager to release the
    reader pool.
    """

    def __init__(self, filenames, samps_per_file: int, halo: int = 0,
                 num_workers: int = 4, ring_capacity: int = 8):
        if halo < 0 or halo > samps_per_file:
            raise ValueError("halo must be in [0, samps_per_file]")
        self.filenames = [str(f) for f in filenames]
        self.samps_per_file = int(samps_per_file)
        self.halo = int(halo)
        self._native = _load_stream_native()
        self._handle = None
        self._idx = 0
        if self._native is not None and self.filenames:
            arr = (ctypes.c_char_p * len(self.filenames))(
                *[f.encode() for f in self.filenames])
            self._handle = self._native.stream_open(
                arr, len(self.filenames), self.samps_per_file, self.halo,
                int(num_workers), int(ring_capacity))
            if not self._handle:
                raise RuntimeError("stream_open failed (bad arguments)")
        else:
            from concurrent.futures import ThreadPoolExecutor
            self._pool = ThreadPoolExecutor(max_workers=int(num_workers))
            self._futures = [
                self._pool.submit(simple_bin_read, f, self.samps_per_file)
                for f in self.filenames[:int(ring_capacity)]]
            self._submitted = len(self._futures)
            self._tail = np.zeros(self.halo, np.complex64)
            self._cap = int(ring_capacity)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __iter__(self):
        return self

    def __next__(self):
        if self._idx >= len(self.filenames):
            raise StopIteration
        i = self._idx
        if self._handle is not None:
            out = np.empty((self.halo + self.samps_per_file) * 2, np.float32)
            rc = self._native.stream_next(
                self._handle, out.ctypes.data_as(
                    ctypes.POINTER(ctypes.c_float)))
            if rc < 0:
                raise IOError(
                    f"stream_next failed with {rc} on {self.filenames[i]}")
            frame = out.view(np.complex64)
        else:
            data = self._futures[i % self._cap].result()
            if self._submitted < len(self.filenames):
                self._futures[self._submitted % self._cap] = self._pool.submit(
                    simple_bin_read, self.filenames[self._submitted],
                    self.samps_per_file)
                self._submitted += 1
            frame = np.concatenate([self._tail, data])
            if self.halo:
                self._tail = data[-self.halo:].copy()
        self._idx = i + 1
        return i, frame

    def close(self):
        if self._handle is not None:
            self._native.stream_close(self._handle)
            self._handle = None
        elif hasattr(self, "_pool"):
            self._pool.shutdown(wait=False)
