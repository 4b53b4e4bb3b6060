"""Python interface to the native extraction layer.

The C++ library (cpp/) replaces the capabilities the reference consumes from
impg / odgi / povu (SURVEY.md §2.2): PAF+CIGAR window projection over a FASTA
sequence store, producing the haplotype-by-site allele matrices that feed the
device statistics.  Binding is ctypes over a plain C ABI (pybind11 is not in
this environment).

The library is built on demand with ``make -C cpp`` on first use.  A pure
Python fallback (:mod:`impop_tpu.extract.pyfallback`) implements the same
projection for environments without a compiler, and serves as the oracle for
the C++ tests.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from typing import List, NamedTuple, Optional

import numpy as np

__all__ = ["WindowMatrix", "NativeExtractor", "load_library", "library_path", "split_window_matrix", "site_weights_from_keys"]

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_CPP_DIR = os.path.join(_REPO_ROOT, "cpp")
_LIB_NAME = "libimpop_extract.so"


class WindowMatrix(NamedTuple):
    names: List[str]       # sorted haplotype row names ("contig:qs-qe")
    site_keys: List[str]   # "pos:ref>alt" per column
    site_pos: np.ndarray   # [s] int64 target positions
    geno: np.ndarray       # [n, s] int8; 1 alt, 0 ref, -1 uncovered


def library_path() -> str:
    return os.path.join(_CPP_DIR, _LIB_NAME)


def _build_library() -> None:
    subprocess.run(["make", "-C", _CPP_DIR, "-s"], check=True,
                   capture_output=True, text=True)


_lib: Optional[ctypes.CDLL] = None


def load_library(rebuild: bool = False) -> ctypes.CDLL:
    global _lib
    if _lib is not None and not rebuild:
        return _lib
    path = library_path()
    if rebuild or not os.path.exists(path):
        _build_library()
    lib = ctypes.CDLL(path)
    lib.ix_open.restype = ctypes.c_void_p
    lib.ix_open.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.ix_error.restype = ctypes.c_char_p
    lib.ix_error.argtypes = [ctypes.c_void_p]
    lib.ix_close.argtypes = [ctypes.c_void_p]
    lib.ix_extract.restype = ctypes.c_void_p
    lib.ix_extract.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.POINTER(ctypes.c_longlong),
        ctypes.POINTER(ctypes.c_longlong),
    ]
    lib.ix_copy_geno.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_byte)]
    lib.ix_name.restype = ctypes.c_char_p
    lib.ix_name.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
    lib.ix_site_key.restype = ctypes.c_char_p
    lib.ix_site_key.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
    lib.ix_site_pos.restype = ctypes.c_longlong
    lib.ix_site_pos.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
    lib.ix_copy_site_pos.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong)
    ]
    lib.ix_names_blob.restype = ctypes.c_char_p
    lib.ix_names_blob.argtypes = [ctypes.c_void_p]
    lib.ix_site_keys_blob.restype = ctypes.c_char_p
    lib.ix_site_keys_blob.argtypes = [ctypes.c_void_p]
    lib.ix_result_free.argtypes = [ctypes.c_void_p]
    lib.ix_extract_batch.restype = ctypes.c_void_p
    lib.ix_extract_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_longlong),
        ctypes.c_longlong, ctypes.c_int,
    ]
    lib.ix_batch_dims.restype = ctypes.c_int
    lib.ix_batch_dims.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_longlong),
    ]
    lib.ix_batch_error.restype = ctypes.c_char_p
    lib.ix_batch_error.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
    lib.ix_batch_result.restype = ctypes.c_void_p
    lib.ix_batch_result.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
    lib.ix_batch_fill.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.POINTER(ctypes.c_byte),
        ctypes.POINTER(ctypes.c_ubyte), ctypes.POINTER(ctypes.c_ubyte),
        ctypes.POINTER(ctypes.c_float), ctypes.c_longlong, ctypes.c_longlong,
    ]
    lib.ix_batch_fill_all.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_byte),
        ctypes.POINTER(ctypes.c_ubyte), ctypes.POINTER(ctypes.c_ubyte),
        ctypes.POINTER(ctypes.c_float), ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_int,
    ]
    lib.ix_batch_pack_all.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_ubyte), ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_int,
    ]
    lib.ix_batch_free.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


class NativeBatch:
    """Open handle to one extracted window batch (ix_extract_batch).

    Splits ``extract_batch_padded``'s extract-then-read into two pipeline
    stages: the scan's extraction worker opens the batch (the C record
    walk happens there), and the build worker later packs it STRAIGHT
    into the fused scan wire buffer with :meth:`pack_into`
    (ix_batch_pack_all) — no intermediate [w, cap_n, cap_s] int8 tiles,
    no numpy bit-packing passes on the CPU-starved host.
    """

    def __init__(self, lib, handle, count: int):
        self._lib = lib
        self._handle = handle
        self.count = count
        self.dims: List[tuple] = []
        self.errors: List[str] = [""] * count
        n = ctypes.c_longlong()
        s = ctypes.c_longlong()
        for i in range(count):
            if lib.ix_batch_dims(handle, i, ctypes.byref(n),
                                 ctypes.byref(s)) != 0:
                err = lib.ix_batch_error(handle, i)
                self.errors[i] = err.decode() if err else "unknown"
                self.dims.append((0, 0))
            else:
                self.dims.append((n.value, s.value))
        self._blob_cache: dict = {}

    def names(self, i: int) -> List[str]:
        """Row names of window i (deduplicated across the batch)."""
        res = self._lib.ix_batch_result(self._handle, i)
        blob = self._lib.ix_names_blob(res) or b""
        cached = self._blob_cache.get(blob)
        if cached is None:
            cached = blob.decode().splitlines()
            self._blob_cache[blob] = cached
        return cached

    def site_pos(self, i: int) -> np.ndarray:
        """Absolute variant positions of window i's site columns."""
        n, s = self.dims[i]
        out = np.zeros(max(s, 1), np.int64)
        if s:
            res = self._lib.ix_batch_result(self._handle, i)
            self._lib.ix_copy_site_pos(
                res, out.ctypes.data_as(
                    ctypes.POINTER(ctypes.c_longlong)))
        return out[:s]

    def pack_into(self, flat: np.ndarray, out_rows, cap_n: int, cap_s: int,
                  o_m: int, o_sm: int, o_w: int = -1,
                  threads: int = 0) -> None:
        """Pack every window into the pre-zeroed [W, stride] uint8 wire
        buffer ``flat`` (layout: cli._scan_buf_layout); ``out_rows[i]`` is
        window i's buffer row, -1 to skip (failed windows)."""
        assert flat.dtype == np.uint8 and flat.flags.c_contiguous
        rows = (ctypes.c_longlong * self.count)(*out_rows)
        self._lib.ix_batch_pack_all(
            self._handle,
            flat.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
            flat.strides[0], rows, cap_n, cap_s, o_m, o_sm, o_w, threads)

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.ix_batch_free(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class NativeExtractor:
    """PAF + FASTA → per-window allele matrices (C++ fast path)."""

    def __init__(self, paf_path: str, fasta_path: str):
        self._lib = load_library()
        self._handle = self._lib.ix_open(
            paf_path.encode(), fasta_path.encode()
        )
        err = self._lib.ix_error(self._handle)
        if err:
            msg = err.decode()
            self._lib.ix_close(self._handle)
            self._handle = None
            raise RuntimeError(f"extractor open failed: {msg}")

    def close(self) -> None:
        if self._handle is not None:
            self._lib.ix_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _read_result(self, res, n_v: int, s_v: int) -> WindowMatrix:
        geno = np.full((n_v, max(s_v, 1)), -1, dtype=np.int8)
        if n_v:
            buf = geno.ctypes.data_as(ctypes.POINTER(ctypes.c_byte))
            self._lib.ix_copy_geno(res, buf)
        geno = geno[:, :s_v] if s_v else geno[:, :0]
        # bulk reads: one joined blob / one array copy per field instead
        # of n+2s ctypes round trips (dominates at ~1e6 sites)
        nb = self._lib.ix_names_blob(res)
        names = nb.decode().splitlines() if n_v and nb else []
        kb = self._lib.ix_site_keys_blob(res)
        site_keys = kb.decode().splitlines() if s_v and kb else []
        site_pos = np.zeros(s_v, dtype=np.int64)
        if s_v:
            self._lib.ix_copy_site_pos(
                res, site_pos.ctypes.data_as(
                    ctypes.POINTER(ctypes.c_longlong))
            )
        return WindowMatrix(names, site_keys, site_pos, geno)

    def extract(self, target: str, start: int, end: int) -> WindowMatrix:
        n = ctypes.c_longlong()
        s = ctypes.c_longlong()
        res = self._lib.ix_extract(
            self._handle, target.encode(), start, end,
            ctypes.byref(n), ctypes.byref(s),
        )
        if not res:
            err = self._lib.ix_error(self._handle)
            raise RuntimeError(
                f"extract failed for {target}:{start}-{end}: "
                f"{err.decode() if err else 'unknown'}"
            )
        try:
            return self._read_result(res, n.value, s.value)
        finally:
            self._lib.ix_result_free(res)

    def extract_batch(self, target: str, windows,
                      threads: int = 0) -> List[Optional[WindowMatrix]]:
        """Extract a batch of windows in ONE native call.

        Sorted, non-overlapping batches (the tiled-scan common case) take
        the range fast path: one CIGAR walk per PAF record for the whole
        batch instead of one per (record, window) — the host-side analogue
        of batching windows onto the device.  Returns one WindowMatrix per
        window, or None for a window whose extraction failed (its message
        is reported via ``errors``, parallel list attribute on the return's
        ``.errors`` — see below).

        The return value is a plain list; per-window failures are recorded
        as None entries and the corresponding messages are available from
        :meth:`last_errors` until the next batch call.
        """
        wins = [(int(s), int(e)) for s, e in windows]
        count = len(wins)
        self.last_errors: List[str] = [""] * count
        if count == 0:
            return []
        starts = (ctypes.c_longlong * count)(*[s for s, _ in wins])
        ends = (ctypes.c_longlong * count)(*[e for _, e in wins])
        batch = self._lib.ix_extract_batch(
            self._handle, target.encode(), starts, ends, count, threads
        )
        if not batch:
            raise RuntimeError(f"extract_batch failed for {target}")
        try:
            out: List[Optional[WindowMatrix]] = []
            n = ctypes.c_longlong()
            s = ctypes.c_longlong()
            for i in range(count):
                if self._lib.ix_batch_dims(batch, i, ctypes.byref(n),
                                           ctypes.byref(s)) != 0:
                    err = self._lib.ix_batch_error(batch, i)
                    self.last_errors[i] = err.decode() if err else "unknown"
                    out.append(None)
                    continue
                res = self._lib.ix_batch_result(batch, i)
                out.append(self._read_result(res, n.value, s.value))
            return out
        finally:
            self._lib.ix_batch_free(batch)

    def extract_batch_open(self, target: str, windows,
                           threads: int = 0) -> "NativeBatch":
        """Run the batch extraction and return the OPEN native handle.

        The scan's two-stage pipeline calls this on the extraction worker
        (the C record walk runs here) and later wire-packs the result on
        the build worker via :meth:`NativeBatch.pack_into` — see
        cli.extract_native.  Sorted non-overlapping batches take the
        range walker inside (one CIGAR walk per PAF record per batch).
        """
        wins = [(int(s), int(e)) for s, e in windows]
        count = len(wins)
        if count == 0:
            return NativeBatch(self._lib, None, 0)
        starts = (ctypes.c_longlong * count)(*[s for s, _ in wins])
        ends = (ctypes.c_longlong * count)(*[e for _, e in wins])
        batch = self._lib.ix_extract_batch(
            self._handle, target.encode(), starts, ends, count, threads
        )
        if not batch:
            raise RuntimeError(f"extract_batch failed for {target}")
        return NativeBatch(self._lib, batch, count)

    def extract_batch_padded(self, target: str, windows, threads: int = 0,
                             min_cap_n: int = 1, min_cap_s: int = 128,
                             want_weights: bool = False):
        """One native call → padded scan-ready tiles for a window batch.

        Returns ``(geno [w,cap_n,cap_s] int8, member [w,cap_n] bool,
        smask [w,cap_s] bool, wts [w,cap_s] f32 or None, names per window,
        errors per window)`` with the padding/masking loops (and, when
        ``want_weights``, the identity-weight key parsing) done in C++ —
        the per-window numpy assembly dominated the Python profile once the
        extraction itself was range-batched.  ``cap_s`` is rounded up to a
        multiple of 128 (device lane width); ``cap_n`` is the batch max.
        Failed windows get all-False member rows and their message in
        ``errors``; names lists are deduplicated across windows (a scan
        over one region typically has one shared row set).
        """
        wins = [(int(s), int(e)) for s, e in windows]
        count = len(wins)
        if count == 0:
            return (np.zeros((0, 0, 0), np.int8), np.zeros((0, 0), bool),
                    np.zeros((0, 0), bool), None, [], [])
        starts = (ctypes.c_longlong * count)(*[s for s, _ in wins])
        ends = (ctypes.c_longlong * count)(*[e for _, e in wins])
        batch = self._lib.ix_extract_batch(
            self._handle, target.encode(), starts, ends, count, threads
        )
        if not batch:
            raise RuntimeError(f"extract_batch failed for {target}")
        try:
            n_c = ctypes.c_longlong()
            s_c = ctypes.c_longlong()
            dims = []
            errors: List[str] = [""] * count
            for i in range(count):
                if self._lib.ix_batch_dims(batch, i, ctypes.byref(n_c),
                                           ctypes.byref(s_c)) != 0:
                    err = self._lib.ix_batch_error(batch, i)
                    errors[i] = err.decode() if err else "unknown"
                    dims.append((0, 0))
                else:
                    dims.append((n_c.value, s_c.value))
            cap_n = max(min_cap_n, max((n for n, _ in dims), default=1) or 1)
            cap_s = max(min_cap_s,
                        max((s for _, s in dims), default=1) or 1)
            cap_s = ((cap_s + 127) // 128) * 128
            geno = np.full((count, cap_n, cap_s), -1, dtype=np.int8)
            member = np.zeros((count, cap_n), dtype=np.uint8)
            smask = np.zeros((count, cap_s), dtype=np.uint8)
            wts = (np.ones((count, cap_s), dtype=np.float32)
                   if want_weights else None)
            null_f = ctypes.POINTER(ctypes.c_float)()
            # one parallel C call fills every window's padded tile (failed
            # windows are null results inside and stay at the -1/0 padding)
            self._lib.ix_batch_fill_all(
                batch,
                geno.ctypes.data_as(ctypes.POINTER(ctypes.c_byte)),
                member.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
                smask.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
                wts.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
                if want_weights else null_f,
                cap_n, cap_s, threads,
            )
            names: List[List[str]] = []
            blob_cache: dict = {}
            for i in range(count):
                if dims[i] == (0, 0) and errors[i]:
                    names.append([])
                    continue
                res = self._lib.ix_batch_result(batch, i)
                blob = self._lib.ix_names_blob(res) or b""
                cached = blob_cache.get(blob)
                if cached is None:
                    cached = blob.decode().splitlines()
                    blob_cache[blob] = cached
                names.append(cached)
            return (geno, member.view(bool), smask.view(bool), wts, names,
                    errors)
        finally:
            self._lib.ix_batch_free(batch)


def site_weights_from_keys(site_keys) -> np.ndarray:
    """Column-mode identity weights from variant keys ("pos:ref>alt").

    A SNP weighs 1 alignment column; an indel of k bases weighs k (gap
    columns in a pairwise alignment).  Placeholder alleles from windows
    without query sequence (``<INSk>``) decode their stored length.  See
    doc/how_stats.md "Identity definition and impg parity".
    """
    w = np.ones(len(site_keys), dtype=np.float32)
    for i, key in enumerate(site_keys):
        _, rest = key.split(":", 1)
        ref, alt = rest.split(">", 1)
        if alt.startswith("<INS") and alt.endswith(">"):
            try:
                alt = "N" * int(alt[4:-1])
            except ValueError:
                pass
        w[i] = max(len(ref), len(alt), 1)
    return w


def split_window_matrix(wm: WindowMatrix, windows) -> List[WindowMatrix]:
    """Slice one range-extracted WindowMatrix into per-window matrices.

    A tiled scan (the common case: thousands of adjacent windows) only needs
    ONE CIGAR walk per alignment for the whole range; each window is then a
    site-column slice (coverage is already encoded per cell as -1).  This
    removes the per-window re-walk the reference performs with one impg
    process per window.

    Args:
      windows: iterable of (start, end) target intervals
    """
    out = []
    pos = np.asarray(wm.site_pos)
    # insertions ("pos:>ALT", empty ref) follow the extractor's boundary
    # rule start < pos <= end (cpp/window.cc 'I' case); other variants use
    # start <= pos < end
    is_ins = np.asarray([k.split(":", 1)[1].startswith(">")
                         for k in wm.site_keys], dtype=bool)
    for start, end in windows:
        in_win = np.where(
            is_ins, (pos > start) & (pos <= end), (pos >= start) & (pos < end)
        )
        cols = np.nonzero(in_win)[0]
        out.append(WindowMatrix(
            names=wm.names,
            site_keys=[wm.site_keys[c] for c in cols],
            site_pos=pos[cols],
            geno=wm.geno[:, cols] if len(cols) else wm.geno[:, :0],
        ))
    return out
