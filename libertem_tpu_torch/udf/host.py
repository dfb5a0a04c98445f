"""The host engine: numpy UDFs beside the device UDFs, in the same read
pass (counterpart of ``libertem_tpu/udf/host.py``).

A UDF that declares only numpy-like backends, or whose ``process_*``
or ``merge`` the device engine cannot run, processes each block on the
host CPU with mutable-view semantics: its buffers are numpy arrays
(``self.results.x[:] += ...`` works), ``self.xp`` is numpy, its aux
arguments are numpy rows.  The engine reads the pinned host slot of
each block that the host feed filled for the device (one read of the
data for both engines), applies the corrections with
``CorrectionSet.apply_numpy``, and is done with the slot before the
runner asks the feed for the next block.  Tile-method UDFs iterate the
scheme's sig slices when the scheme splits the frame; frame-method
UDFs get whole frames.
"""
from __future__ import annotations

import copy

import numpy as np

from ..common.exceptions import UDFException
from ..common.shape import Shape
from ..common.slice import Slice
from ..common.sparse import to_backend
from .base import UDFData, UDFParams


class HostUDFRunner:
    def __init__(self, entries, prep):
        """``entries``: (UDF index, plan entry) of the host UDFs."""
        self.entries = list(entries)
        self.prep = prep
        self.input_dtype = np.dtype(prep["input_dtype"])
        self.n_nav = prep["n_nav"]
        sig = prep["meta"].dataset_shape.sig
        self._whole_sig_slice = Slice.from_shape(tuple(sig),
                                                 sig_dims=sig.dims)

    def _aux(self, ui) -> dict:
        return self.prep["aux_host"][ui]

    # -- buffers ---------------------------------------------------------

    def init_global(self) -> dict:
        out = {}
        for ui, entry in self.entries:
            bufs = {}
            for name in entry.nav_names:
                b = entry.decls[name]
                bufs[name] = np.zeros((self.n_nav,) + b.extra_shape,
                                      dtype=b.dtype)
            for name in entry.part_names:
                b = entry.decls[name]
                bufs[name] = np.zeros(b.shape, dtype=b.dtype)
            out[ui] = bufs
        return out

    def init_partition(self) -> dict:
        return {
            ui: {
                name: np.zeros(entry.decls[name].shape,
                               dtype=entry.decls[name].dtype)
                for name in entry.part_names
            }
            for ui, entry in self.entries
        }

    def bind_partition_views(self, global_bufs, part_bufs, goff: int,
                             n_sel: int) -> None:
        """The partition's result and aux views on the host UDFs, for
        ``preprocess`` and ``postprocess``."""
        for ui, entry in self.entries:
            udf = entry.udf
            views = {
                name: global_bufs[ui][name][goff:goff + n_sel]
                for name in entry.nav_names
            }
            views.update({n: part_bufs[ui][n] for n in entry.part_names})
            udf._host_mode = True
            udf.results = UDFData(views)
            udf.params = UDFParams(udf._kwargs, {
                k: arr[goff:goff + n_sel]
                for k, arr in self._aux(ui).items()
            })

    def unbind_views(self) -> None:
        for _, entry in self.entries:
            entry.udf._host_mode = False
            entry.udf.results = None
            entry.udf.params = UDFParams(entry.udf._kwargs)

    # -- processing ------------------------------------------------------

    def process_block(self, global_bufs, part_bufs, block: np.ndarray,
                      goff: int, coords: np.ndarray, valid: int) -> None:
        """Every host UDF on the valid frames of one block (the host
        slot, read in place)."""
        meta = self.prep["meta"]
        corrections = self.prep["corrections"]
        if corrections is not None:
            x = corrections.apply_numpy(block[:valid]).astype(
                self.input_dtype, copy=False
            )
        else:
            x = block[:valid].astype(self.input_dtype, copy=False)
        coords = coords[:valid]
        scheme = self.prep["scheme"]
        sig_split = len(scheme) > 1
        for ui, entry in self.entries:
            udf = entry.udf
            views = {
                name: global_bufs[ui][name][goff:goff + valid]
                for name in entry.nav_names
            }
            views.update({n: part_bufs[ui][n] for n in entry.part_names})
            views.update({n: None for n in entry.result_only_names})
            aux = {k: arr[goff:goff + valid]
                   for k, arr in self._aux(ui).items()}
            backend = entry.host_array_backend
            udf._host_mode = True
            meta.tile_valid = np.ones(valid, dtype=bool)
            meta.valid_frames = valid
            meta.global_offset = goff
            meta.array_backend = "numpy"
            meta.sig_slice = self._whole_sig_slice
            meta.tiling_scheme_idx = 0
            udf.params = UDFParams(udf._kwargs, aux)
            try:
                if entry.method == "tile" and sig_split:
                    meta.coordinates = coords
                    self._process_sig_tiles(
                        entry, x, views, scheme, meta, goff, valid,
                        global_bufs[ui], part_bufs[ui],
                    )
                elif entry.method in ("tile", "partition"):
                    udf.results = UDFData(views)
                    meta.coordinates = coords
                    meta._slice = self._slice(goff, valid)
                    if entry.method == "partition":
                        meta._partition_slice = meta._slice
                    xe = to_backend(x, backend)
                    if entry.method == "tile":
                        udf.process_tile(xe)
                    else:
                        udf.process_partition(xe)
                    self._writeback(entry, udf.results, global_bufs[ui],
                                    part_bufs[ui], goff, valid)
                else:
                    if sig_split:
                        raise UDFException(
                            f"{type(udf).__name__} uses process_frame, "
                            f"which needs whole frames, but the scheme "
                            f"splits the frame into {len(scheme)} sig "
                            f"tiles"
                        )
                    self._process_frames(entry, x, views, aux, coords,
                                         backend, global_bufs[ui],
                                         part_bufs[ui], goff, valid)
            finally:
                udf._host_mode = False
                udf.results = None
                udf.params = UDFParams(udf._kwargs)
                meta.array_backend = "torch"
                # the meta is shared with the device UDFs of the run
                meta._slice = meta._partition_slice = None

    def _slice(self, goff: int, n: int, sig_slice=None) -> Slice:
        """The flat-nav Slice of ``n`` frames from ``goff`` (of a sig
        tile, when given)."""
        if sig_slice is None:
            sig_slice = self._whole_sig_slice
        return Slice((goff,) + tuple(sig_slice.origin),
                     Shape((n,) + tuple(sig_slice.shape),
                           sig_dims=sig_slice.shape.dims))

    def _process_frames(self, entry, x, views, aux, coords, backend,
                        global_u, part_u, goff, valid) -> None:
        udf = entry.udf
        meta = self.prep["meta"]
        for i in range(valid):
            # one-row views, not scalars: `self.results.x[:] = v` works
            # for scalar buffers too
            frame_views = {n: views[n][i:i + 1] for n in entry.nav_names}
            frame_views.update({n: views[n] for n in entry.part_names})
            frame_views.update({n: None for n in entry.result_only_names})
            udf.params = UDFParams(udf._kwargs,
                                   {k: v[i] for k, v in aux.items()})
            udf.results = UDFData(frame_views)
            meta.coordinates = coords[i:i + 1]
            meta._slice = self._slice(goff + i, 1)
            udf.process_frame(to_backend(x[i], backend))
            res = udf.results
            # assignments (rather than in-place updates of the views)
            # need an explicit write-back
            for n in entry.nav_names:
                if n in res._touched:
                    global_u[n][goff + i] = res._get(n)
            for n in entry.part_names:
                if n in res._touched:
                    part_u[n][...] = res._get(n)

    def _process_sig_tiles(self, entry, x, views, scheme, meta, goff,
                           valid, global_u, part_u) -> None:
        """Tile-method dispatch over the scheme's sig slices: each slice
        is one contiguous tile; sig buffers are contiguous copies of
        the sub-rectangle, written back after the call."""
        udf = entry.udf
        for k, sig_slice in scheme.slices:
            tile = to_backend(
                np.ascontiguousarray(x[(slice(None),) + sig_slice.get()]),
                entry.host_array_backend,
            )
            tile_views = dict(views)
            sig_wb = []
            for name in entry.part_names:
                if entry.decls[name].kind != "sig":
                    continue
                idx = sig_slice.get() + (slice(None),) * len(
                    entry.decls[name].extra_shape
                )
                cont = np.ascontiguousarray(views[name][idx])
                tile_views[name] = cont
                sig_wb.append((views[name], idx, cont))
            udf.results = UDFData(tile_views)
            meta.sig_slice = sig_slice
            meta.tiling_scheme_idx = k
            meta._slice = self._slice(goff, valid, sig_slice)
            try:
                udf.process_tile(tile)
            finally:
                res = udf.results
                for full, idx, cont in sig_wb:
                    full[idx] = cont
                for n in entry.nav_names:
                    if n in res._touched:
                        global_u[n][goff:goff + valid] = res._get(n)
                for n in entry.part_names:
                    if n in res._touched and entry.decls[n].kind != "sig":
                        part_u[n][...] = res._get(n)

    @staticmethod
    def _writeback(entry, res, global_u, part_u, goff, valid) -> None:
        for n in entry.nav_names:
            if n in res._touched:
                global_u[n][goff:goff + valid] = res._get(n)
        for n in entry.part_names:
            if n in res._touched:
                part_u[n][...] = res._get(n)

    # -- merge -------------------------------------------------------------

    def snapshot_init(self, global_bufs, goff, n_sel) -> dict:
        """For UDFs with a custom merge, a copy of the partition's nav
        rows as ``preprocess`` left them: the merge's ``dest``."""
        out = {}
        for ui, entry in self.entries:
            if not entry.udf._has_custom_merge() or not entry.nav_names:
                continue
            out[ui] = {}
            for n in entry.nav_names:
                rows = global_bufs[ui][n][goff:goff + n_sel]
                out[ui][n] = (copy.deepcopy(rows) if rows.dtype == object
                              else rows.copy())
        return out

    def merge_partition(self, global_bufs, part_bufs, goff0, n_sel,
                        init_rows=None) -> None:
        """Fold one partition's buffers into the run's.  A custom merge
        also gets the nav rows: ``src`` the partition's results,
        ``dest`` their state before processing (the snapshot), and
        writes every buffer."""
        for ui, entry in self.entries:
            udf = entry.udf
            custom = udf._has_custom_merge()
            if not entry.part_names and not (custom and entry.nav_names):
                continue
            dest_d = {n: global_bufs[ui][n] for n in entry.part_names}
            src_d = {n: part_bufs[ui][n] for n in entry.part_names}
            nav_rows = {}
            if custom:
                snap = (init_rows or {}).get(ui)
                for n in entry.nav_names:
                    rows = global_bufs[ui][n][goff0:goff0 + n_sel]
                    src_d[n] = rows.copy()
                    dest_d[n] = (snap[n] if snap is not None
                                 else np.zeros_like(rows))
                    nav_rows[n] = rows
            udf._host_mode = True
            udf.params = UDFParams(udf._kwargs, {
                k: arr[goff0:goff0 + n_sel]
                for k, arr in self._aux(ui).items()
            })
            try:
                dest = UDFData(dest_d)
                udf.merge(dest, UDFData(src_d))
                for n in entry.part_names:
                    if n in dest._touched:
                        global_bufs[ui][n][...] = dest._get(n)
                for n, rows in nav_rows.items():
                    rows[...] = dest._get(n)
            finally:
                udf._host_mode = False
                udf.params = UDFParams(udf._kwargs)
