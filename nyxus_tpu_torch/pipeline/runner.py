"""Batched feature-extraction runner for image pairs (PyTorch port of the
dense padded-bucket path of nyxus_tpu/pipeline/runner.py).

Orchestrates: label discovery -> bucketed batching -> every family over each
padded ROI batch on one torch device -> row assembly.  Crops are assembled
on the host (one padded [B, H, W] plane per bucket, the form of the JAX
package's dense path) and shipped to the device once per bucket; the packed
outputs of all buckets come back in one device-to-host copy per slide.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from .. import columns as col
from .. import registry
from .. import taxonomy as tx
from ..config import EngineConfig
from . import batching, labels


def compute_dtype(cfg: EngineConfig):
    return torch.float64 if cfg.precision == "f64" else torch.float32


def is_oversized(rec, budget_bytes: int, bytes_per_px: int = 16) -> bool:
    """True when the ROI's padded crop cannot fit the batch budget
    (nyxus_tpu/pipeline/oversized.py:38 is_oversized; reference RAM gate
    workflow_2d_segmented.cpp:124-139)."""
    if rec.height > batching._LADDER[-1] or rec.width > batching._LADDER[-1]:
        return True
    hb, wb = batching.bucket_shape(rec.height, rec.width)
    return hb * wb * bytes_per_px > budget_bytes


class PairRunner:
    """Extracts features for all ROIs of one (intensity, labels) pair on
    ``device`` (a torch device; the CPU only when the caller asks for it)."""

    def __init__(self, fset: tx.FeatureSet, cfg: EngineConfig,
                 device="cuda"):
        for flag, what in ((cfg.ibsi, "IBSI mode"),
                           (cfg.mergerois, "mergerois"),
                           (cfg.aniso_customized, "anisotropy")):
            if flag:
                raise NotImplementedError(
                    "nyxus_tpu_torch does not support %s yet" % what)
        self.fset = fset
        self.cfg = cfg
        self.device = torch.device(device)
        self.dtype = compute_dtype(cfg)
        self.families = registry.families_for(fset)

        # internal feature set: user features + everything computed by the
        # dependency-closed family set (only user features reach the output)
        internal = tx.FeatureSet()
        internal.enabled |= fset.enabled
        for name in self.families:
            for c in registry.FAMILIES[name].codes:
                internal.enabled[c] = True
        _, self.slots = col.build_header(internal, cfg)
        self.n_values = sum(w for _, w in self.slots)
        self.member_slots = {}
        off = 0
        for code, width in self.slots:
            self.member_slots[code] = (off, width)
            off += width

        # user-facing output column selection
        _, user_slots = col.build_header(fset, cfg)
        out_cols = []
        for code, width in user_slots:
            o, _ = self.member_slots[code]
            out_cols.extend(range(o, o + width))
        self._out_cols = np.asarray(out_cols, np.int64)
        self._colmap = None

    def run(self, intens: np.ndarray, label_img: np.ndarray,
            blacklist=None, fname: str = "", wholeslide: bool = False):
        """In-memory pair. Returns (labels[int], values[N, n_out]) for all
        ROIs, ascending label order.  Unassigned features hold -0.0
        (reference: roi_cache.h:17).  Blacklisted ROIs (any object with
        ``defined`` and ``check(fname, label)``) keep their row with
        unassigned values (reference: workflow_2d_segmented.cpp:116-121)."""
        if wholeslide:
            raise NotImplementedError(
                "nyxus_tpu_torch does not support whole-slide mode yet")
        with record_function("nyx:discover"):
            all_recs, smin, smax = labels._discover_rois_np(intens, label_img)
        if blacklist is not None and blacklist.defined:
            recs = [r for r in all_recs if not blacklist.check(fname, r.label)]
        else:
            recs = all_recs
        labs_all = np.asarray([r.label for r in all_recs], np.int64)
        values = np.full((len(recs), self.n_values), -0.0, dtype=np.float64)

        budget = self.cfg.ram_limit_mb << 20
        over = [r.label for r in recs if is_oversized(r, budget)]
        if over:
            raise NotImplementedError(
                "nyxus_tpu_torch does not support oversized ROIs yet "
                "(labels %s exceed the %d MB batch budget)"
                % (over[:10], self.cfg.ram_limit_mb))

        outs = []
        for shape, idxs in batching.group_rois(recs, hbm_budget_bytes=budget):
            outs.append((idxs, self._run_batch(
                intens, label_img, [recs[i] for i in idxs], shape, smin,
                smax)))
        if outs:
            # one device-to-host copy per slide: every bucket packs the same
            # member layout, so the packed outputs concatenate
            with record_function("nyx:collect"):
                packed_all = torch.cat([o for _, o in outs],
                                       dim=0).cpu().numpy()
            src, dst = self._colmap
            row = 0
            for idxs, o in outs:
                n = o.shape[0]
                values[np.ix_(np.asarray(idxs), dst)] = \
                    packed_all[row:row + n][:, src]
                row += n

        if len(recs) != len(all_recs):
            # reinsert blacklisted rows with unassigned values
            out = np.full((len(all_recs), len(self._out_cols)), -0.0)
            kept = {r.label: i for i, r in enumerate(recs)}
            for j, r in enumerate(all_recs):
                if r.label in kept:
                    out[j] = values[kept[r.label], self._out_cols]
            return labs_all, out
        return labs_all, values[:, self._out_cols]

    def _run_batch(self, intens, label_img, batch_recs, shape, smin, smax):
        """All families over one padded bucket; returns the packed
        [B, total_width] output on the device.  Each stage is a
        ``nyx:<stage>`` profiler range (near free when no profiler runs)."""
        with record_function("nyx:crops"):
            ctx = self._batch_context(intens, label_img, batch_recs, shape,
                                      smin, smax)
        out = {}
        for name in self.families:
            with record_function("nyx:" + name):
                out[name] = registry.FAMILIES[name].fn(ctx, self.cfg)
        with record_function("nyx:pack"):
            parts, layout, off = [], {}, 0
            for fam in sorted(out):
                for member in sorted(out[fam]):
                    arr = out[fam][member]
                    a2 = arr[:, None] if arr.dim() == 1 else arr
                    layout[(fam, member)] = (off, a2.shape[1])
                    parts.append(a2.to(self.dtype))
                    off += a2.shape[1]
            if self._colmap is None:
                self._colmap = self._build_colmap(layout)
            return torch.cat(parts, dim=1)

    def _batch_context(self, intens, label_img, batch_recs, shape, smin,
                       smax):
        """Host crop assembly of one padded bucket, shipped to the device
        once."""
        hb, wb = shape
        B = len(batch_recs)
        np_dt = np.float64 if self.dtype == torch.float64 else np.float32
        ci = np.zeros((B, hb, wb), np_dt)
        cm = np.zeros((B, hb, wb), bool)
        H, W = label_img.shape
        for bi, r in enumerate(batch_recs):
            h_av = max(0, min(hb, H - r.y0))
            w_av = max(0, min(wb, W - r.x0))
            sl = (slice(r.y0, r.y0 + h_av), slice(r.x0, r.x0 + w_av))
            ci[bi, :h_av, :w_av] = intens[sl]
            cm[bi, :h_av, :w_av] = label_img[sl] == r.label
        meta_i = np.asarray([[r.area, r.height, r.width] for r in batch_recs],
                            np.int32)
        meta_f = np.asarray([[r.vmin, r.vmax, smin, smax]
                             for r in batch_recs], np_dt)
        dev = self.device
        mi = torch.from_numpy(meta_i).to(dev)
        mf = torch.from_numpy(meta_f).to(dev)
        return registry.BatchContext(
            torch.from_numpy(ci).to(dev), torch.from_numpy(cm).to(dev),
            mi[:, 0], mf[:, 0], mf[:, 1], mf[:, 2], mf[:, 3],
            mi[:, 1], mi[:, 2], self.cfg)

    def _build_colmap(self, layout):
        """(src cols in the packed layout, dst cols in the value matrix)."""
        src, dst = [], []
        for (fam, member), (off, w) in layout.items():
            code = registry.FAMILIES[fam].member_code(member)
            if code is None or code not in self.member_slots:
                continue
            doff, dwidth = self.member_slots[code]
            k = min(w, dwidth)
            src.extend(range(off, off + k))
            dst.extend(range(doff, doff + k))
        return np.asarray(src, np.int64), np.asarray(dst, np.int64)
