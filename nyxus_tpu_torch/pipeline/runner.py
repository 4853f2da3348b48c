"""Batched feature-extraction runner for image pairs (PyTorch port of the
dense padded-bucket path of nyxus_tpu/pipeline/runner.py).

Orchestrates: label discovery -> contours and the native host-geometry pass
-> bucketed batching -> every device family over each padded ROI batch on
its torch device(s) -> row assembly -> the host families.  Crops (and, for
the moment families, the per-pixel log contour distances) are assembled on
the host, one padded [B, H, W] plane per bucket, and shipped to the device
once per bucket; the packed outputs of all buckets come back in one
device-to-host copy per slide.

With several devices (``devices=``, from ``parallel.roi_devices``) each
bucket's ROI axis is split by ``parallel.partition`` (JAX's shard_batch
partition, nyxus_tpu/pipeline/runner.py:1015-1046, less its pad rows) and
each shard runs every family on its own device, under
``torch.cuda.device``, from the one host thread: the launches are
asynchronous, so the cards overlap.  The packed rows come back in one
device-to-host copy a device.  Phase 3 runs on the first (primary)
device.

ROIs over the batch budget (``oversized.is_oversized``) take no crop and
no batch: each is streamed through ``oversized.process`` (the reference's
phase 3), whose finish stages run on the runner's device.

Three run modes besides the default (nyxus_tpu/pipeline/runner.py
PairRunner.run / run_streamed): ``mergerois`` makes every nonzero label
one ROI; whole-slide mode makes the slide one ROI with the inclusive
0..H, 0..W box and a four-corner contour; anisotropy (``aniso_x`` /
``aniso_y``) runs on the nearest-neighbour resampled virtual slide with
each ROI's box scaled by ``labels.aniso_bbox``.

Each stage runs under the JAX package's Stopwatch key (``timing.py``)
beside its ``nyx:*`` profiler range.  With the Stopwatch enabled, a
stage synchronises its device at its end, so that the key holds the
card's time and not only the launches' enqueue; disabled (the default),
nothing is synchronised.

Two crop paths share one core (``_run_core``):
* in-memory pairs (``run``): crops are windows of the resident slide, the
  contours of every ROI come from one native call, and the ROI records
  and pixel clouds from one native discovery pass
  (``labels.discover_rois_clouds``)
* file-backed pairs (``run_streamed``): discovery streams tiles, and each
  ROI's padded crop is read from the source once, into a crop cache that
  the contour trace, the pixel clouds and its batch share, so the slide is
  never held whole (the reference's tile re-scan, phase2_2d.cpp:89)

Host stages run inline on the calling thread.  The device launches are
asynchronous, so the host families that read no device result (and the
heavy half of the geometry pass) run while the card works, before the
collect; the families that read device results (centroids, areas) run after
it, in ``registry.split_host_families`` order.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch.profiler import record_function

from .. import columns as col
from .. import native
from .. import registry
from .. import taxonomy as tx
from ..config import EngineConfig
from ..ops.moments import WEIGHTING_EPSILON
from ..parallel import device_guard, partition
from ..timing import Stopwatch, stopwatch
from . import batching, hostfeats, labels
from . import oversized as ovs
from .contour import merged_contour, oversized_contour
from .sources import AnisoResampledSource, ArrayPairSource, MergedLabelSource

# the JAX package's Stopwatch keys of the runner's stages
SW_DISCOVER = "Pipeline/Phase1_discovery/#cca33a"
SW_CONTOURS = "Pipeline/Contours/#777799"
SW_GEOM = "Pipeline/Host/geom_batch/#99bb55"
SW_BATCHES = "Pipeline/Phase2_device_batches/#33cc77"
SW_COLLECT = "Pipeline/Phase2_collect/#33aa99"
SW_HOST = "Pipeline/Host/%s/#bbbbbb"
SW_OVERSIZED = "Pipeline/Phase3_oversized/#cc7733"


def compute_dtype(cfg: EngineConfig):
    return torch.float64 if cfg.precision == "f64" else torch.float32


@contextlib.contextmanager
def stage(key, devices, span=None):
    """One stage of a run: the Stopwatch ``key`` and, where given, the
    ``span`` profiler range; with the Stopwatch enabled, every CUDA device
    of ``devices`` is synchronised before the stage's time is taken."""
    with stopwatch(key), (record_function(span) if span
                          else contextlib.nullcontext()):
        yield
        if Stopwatch.enabled():
            for dev in dict.fromkeys(devices):
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)


def _aniso_records(recs, vrecs, ax, ay):
    """The physical records on the virtual grid (``labels.aniso_bbox``),
    each box widened to the natural box of its members in the virtual
    records ``vrecs``."""
    nat = {r.label: (r.y0, r.y1, r.x0, r.x1) for r in vrecs}
    return [labels.aniso_bbox(r, ax, ay, nat.get(r.label)) for r in recs]


def wholeslide_contours(recs):
    """The whole-slide ROI's synthesised contour: the four corners of its
    inclusive box at the slide max, in raw box coordinates with no +1
    shift (reference: buildWholeSlideContour, contour.cpp:917-933)."""
    out = []
    for r in recs:
        vx = int(r.vmax)
        xr, yb = r.x1 - r.x0, r.y1 - r.y0
        out.append(np.array([[0, 0, vx], [xr, 0, vx], [xr, yb, vx],
                             [0, yb, vx]], np.int64))
    return out


class HostContext:
    """Inputs for host-side (sequential/contour) families
    (nyxus_tpu/pipeline/runner.py:318 HostContext).

    Host families may read previously computed features via
    ``get_feature`` (the reference's fvals-mediated dependencies, e.g.
    hexagonality reading NUM_NEIGHBORS and STAT_FERET_DIAM_*)."""

    def __init__(self, recs, contours, source, get_feature,
                 oversized=frozenset()):
        self.recs = recs            # the host rows' RoiRecords
        self.contours = contours    # merged contour per ROI, local +1 coords
        self.source = source        # ArrayPairSource | TiffPairSource
        self.get_feature = get_feature   # display/member name -> np [N]
        self.hulls = [None] * len(recs)  # filled by the convex-hull family
        self.oversized = oversized  # local indices with NO dense pixel access
        self._points = {}
        self._crops = {}

    def pixels_ok(self, i):
        """False for oversized rows: pair_crop/roi_points would materialize
        the whole AABB; pixel-sweep families skip those rows."""
        return i not in self.oversized

    def pair_crop(self, i):
        """(intens [h, w] float64, mask [h, w] bool) over ROI i's exact AABB."""
        if i not in self._crops:
            r = self.recs[i]
            ii, ll = self.source.read_pair(r.y0, r.x0, r.height, r.width)
            self._crops[i] = (ii, ll == r.label)
        return self._crops[i]

    def roi_points(self, i):
        """(ys, xs) LOCAL pixel coordinates of ROI i."""
        if i not in self._points:
            _, m = self.pair_crop(i)
            self._points[i] = np.nonzero(m)
        return self._points[i]


def _cat(parts, dt):
    return np.concatenate(parts).astype(dt) if parts else np.zeros(0, dt)


def _build_clouds(recs, intens, label_img, skip=frozenset(), pre=None):
    """Concatenated per-ROI pixel clouds (global raster order) for the
    batched native geometry pass: (gx, gy, inten, offsets) aligned with
    ``recs`` (the resident branches of nyxus_tpu/pipeline/runner.py:361
    _build_clouds).  ``pre`` = (gx, gy, inten, offsets, label -> index)
    from the native discovery pass: each ROI's segment is sliced out of it
    (or it is returned whole when ``recs`` are its ROIs in its order);
    otherwise one whole-slide nonzero + stable label sort.  The rows in
    ``skip`` (oversized) get empty clouds."""
    n = len(recs)
    off = np.zeros(n + 1, np.int64)
    gx_p, gy_p, it_p = [], [], []
    if pre is not None:
        gx0, gy0, gi0, off0, lab2k = pre
        if not skip and n == len(lab2k) and all(
                lab2k.get(r.label) == j for j, r in enumerate(recs)):
            return gx0, gy0, gi0, off0
        for j, r in enumerate(recs):
            k = lab2k.get(r.label)
            if j in skip or k is None:
                off[j + 1] = off[j]
                continue
            a, b = int(off0[k]), int(off0[k + 1])
            off[j + 1] = off[j] + (b - a)
            gx_p.append(gx0[a:b])
            gy_p.append(gy0[a:b])
            it_p.append(gi0[a:b])
        return (_cat(gx_p, np.int64), _cat(gy_p, np.int64),
                _cat(it_p, np.float64), off)
    ys, xs = np.nonzero(label_img)
    labs = label_img[ys, xs]
    order = np.argsort(labs, kind="stable")
    ys, xs, labs = ys[order], xs[order], labs[order]
    vals = intens[ys, xs].astype(np.float64)
    uniq, starts = np.unique(labs, return_index=True)
    bounds = np.append(starts, len(labs))
    seg = {int(l): (int(bounds[k]), int(bounds[k + 1]))
           for k, l in enumerate(uniq)}
    for j, r in enumerate(recs):
        if j in skip or r.label not in seg:
            off[j + 1] = off[j]
            continue
        a, b = seg[r.label]
        off[j + 1] = off[j] + (b - a)
        gx_p.append(xs[a:b])
        gy_p.append(ys[a:b])
        it_p.append(vals[a:b])
    return (_cat(gx_p, np.int64), _cat(gy_p, np.int64),
            _cat(it_p, np.float64), off)


def _crop_clouds(recs, crops, skip=frozenset()):
    """The pixel clouds of ``_build_clouds`` read off each ROI's padded
    crop (the streamed branch of nyxus_tpu/pipeline/runner.py:361
    _build_clouds): the same pixels in the same order; ``crops(j, hb, wb)``
    is row j's crop, and the rows in ``skip`` get empty clouds."""
    off = np.zeros(len(recs) + 1, np.int64)
    gx_p, gy_p, it_p = [], [], []
    for j, r in enumerate(recs):
        if j in skip:
            off[j + 1] = off[j]
            continue
        ii, ll = crops(j, *batching.bucket_shape(r.height, r.width))
        cys, cxs = np.nonzero(ll[:r.height, :r.width] == r.label)
        off[j + 1] = off[j] + len(cys)
        gx_p.append(cxs + r.x0)
        gy_p.append(cys + r.y0)
        it_p.append(ii[cys, cxs].astype(np.float64))
    return (_cat(gx_p, np.int64), _cat(gy_p, np.int64),
            _cat(it_p, np.float64), off)


class _CropWindows:
    """Each ROI's crop window (intens, labels) at its bucket shape (hb, wb)
    from its AABB's corner: a view of the resident slide (clipped at the
    slide's edge), or, for a file-backed source, a zero-padded region read
    once and cached until its batch is built (nyxus_tpu/pipeline/runner.py
    padded_crop), so the contour trace, the clouds and the batch share one
    read."""

    def __init__(self, recs, source, resident=None):
        self.recs = recs
        self.source = source
        self.resident = resident
        self._cache = {}

    def __call__(self, i, hb, wb):
        r = self.recs[i]
        if self.resident is not None:
            intens, label_img = self.resident
            return (intens[r.y0:r.y0 + hb, r.x0:r.x0 + wb],
                    label_img[r.y0:r.y0 + hb, r.x0:r.x0 + wb])
        key = (i, hb, wb)
        if key not in self._cache:
            self._cache[key] = self.source.read_pair(r.y0, r.x0, hb, wb)
        return self._cache[key]

    def release(self, idxs, shape):
        """Drop the cached crops of a batch once it is built."""
        for i in idxs:
            self._cache.pop((i,) + tuple(shape), None)


class PairRunner:
    """Extracts features for all ROIs of one (intensity, labels) pair on
    ``device`` (a torch device; the CPU only when the caller asks for it),
    or with each bucket sharded over ``devices`` (a list from
    ``parallel.roi_devices``, whose first entry is the primary device;
    None, or one device, is the one-device path)."""

    def __init__(self, fset: tx.FeatureSet, cfg: EngineConfig,
                 device="cuda", devices=None):
        self.fset = fset
        self.cfg = cfg
        self.devices = [torch.device(d) for d in devices] if devices \
            else [torch.device(device)]
        self.device = self.devices[0]
        self.dtype = compute_dtype(cfg)
        self.families = registry.activated_families(fset)
        self.device_families = tuple(
            n for n in self.families if registry.FAMILIES[n].device)
        self.pre_host, self.post_host = registry.split_host_families(fset)
        self._needs_contour = registry.contour_needed(fset)
        self._needs_logw = any(
            registry.FAMILIES[f].needs_logw for f in self.families)

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
            blacklist=None, fname: str = "", wholeslide: bool = False,
            hu_offset: float = 0.0):
        """In-memory pair. Returns (labels[int], values[N, n_out]) for all
        ROIs, ascending label order.  Unassigned features hold -0.0
        (reference: roi_cache.h:17).  Blacklisted ROIs (any object with
        ``defined`` and ``check(fname, label)``) keep their row with
        unassigned values (reference: workflow_2d_segmented.cpp:116-121).
        ``hu_offset``: the floored original slide minimum that a
        preserve_hu load shifted away, which IH_* adds back.
        ``wholeslide``: the labels are the slide's ones and its one ROI
        takes the inclusive 0..H, 0..W box (reference: init_from_wh,
        aabb.h:53-59).  Under anisotropy the area and the intensity range
        stay physical, and every later read sees the virtual slide
        (reference: phase2_2d.cpp:183-285)."""
        if self.cfg.mergerois:
            label_img = (label_img != 0).astype(np.int64)
        with stage(SW_DISCOVER, self.devices, "nyx:discover"):
            # the records and the pixel clouds in one native pass (numpy
            # and no clouds for labels past int32)
            all_recs, smin, smax, clouds = labels.discover_rois_clouds(
                intens, label_img)
            cloud_recs = all_recs
            if wholeslide and len(all_recs) == 1:
                all_recs[0].y1, all_recs[0].x1 = intens.shape
            if self.cfg.aniso_customized:
                ax, ay = self.cfg.aniso_x, self.cfg.aniso_y
                vH, vW = int(intens.shape[0] * ay), int(intens.shape[1] * ax)
                pr = np.minimum((np.arange(vH) / ay).astype(np.int64),
                                intens.shape[0] - 1)
                pc = np.minimum((np.arange(vW) / ax).astype(np.int64),
                                intens.shape[1] - 1)
                intens = np.ascontiguousarray(intens[pr][:, pc])
                label_img = np.ascontiguousarray(label_img[pr][:, pc])
                # the clouds come from the virtual slide, which every later
                # pixel read sees
                cloud_recs, _, _, clouds = labels.discover_rois_clouds(
                    intens, label_img)
                all_recs = _aniso_records(all_recs, cloud_recs, ax, ay)
            if clouds is not None:
                clouds += ({r.label: k for k, r in enumerate(cloud_recs)},)
        return self._run_core(all_recs, smin, smax,
                              ArrayPairSource(intens, label_img), blacklist,
                              fname, hu_offset, resident=(intens, label_img),
                              wholeslide=wholeslide, clouds=clouds)

    def run_streamed(self, source, blacklist=None, fname: str = "",
                     tile: int = 2048, wholeslide: bool = False,
                     hu_offset: float = 0.0):
        """File-backed pair (a region source such as
        ``sources.TiffPairSource``): tile-streamed discovery, then each
        ROI's padded crop read once; the slide is never held whole in host
        or device memory.  Returns what ``run`` returns; the modes are
        ``run``'s, through ``MergedLabelSource`` and
        ``AnisoResampledSource``."""
        if self.cfg.mergerois:
            source = MergedLabelSource(source)
        with stage(SW_DISCOVER, self.devices, "nyx:discover"):
            all_recs, smin, smax = labels.discover_rois_streamed(source, tile)
            if wholeslide and len(all_recs) == 1:
                all_recs[0].y1, all_recs[0].x1 = source.shape
            if self.cfg.aniso_customized:
                ax, ay = self.cfg.aniso_x, self.cfg.aniso_y
                source = AnisoResampledSource(source, ax, ay)
                all_recs = _aniso_records(
                    all_recs, labels.discover_rois_streamed(source, tile)[0],
                    ax, ay)
        return self._run_core(all_recs, smin, smax, source, blacklist, fname,
                              hu_offset, wholeslide=wholeslide)

    def _run_core(self, all_recs, smin, smax, source, blacklist, fname,
                  hu_offset, resident=None, wholeslide=False, clouds=None):
        """Both paths from discovery on: ``resident`` (intens, labels) for
        an in-memory pair, None when crops are read from ``source``;
        ``clouds``: the native discovery's pixel clouds with their label ->
        index map, or None.

        The RAM gate splits the ROIs (nyxus_tpu/pipeline/runner.py:595-602;
        reference: workflow_2d_segmented.cpp:124-139): trivial ROIs take
        the padded-bucket batches, oversized ones (``oversized.is_oversized``)
        never materialize a dense crop and take the streamed phase-3 pass
        (``oversized.process``), whose finish stages run on this runner's
        device."""
        if blacklist is not None and blacklist.defined:
            recs = [r for r in all_recs if not blacklist.check(fname, r.label)]
        else:
            recs = all_recs
        labs_all = np.asarray([r.label for r in all_recs], np.int64)
        values = np.full((len(recs), self.n_values), -0.0, dtype=np.float64)

        budget = self.cfg.ram_limit_mb << 20
        over_rows = [i for i, r in enumerate(recs)
                     if ovs.is_oversized(r, budget)]
        over_set = set(over_rows)
        triv_rows = [i for i in range(len(recs)) if i not in over_set]

        crops = _CropWindows(recs, source, resident)
        contours = None
        if recs and self._needs_contour:
            contours = self._contours(recs, crops, over_set, wholeslide)
        # host rows: the trivial ROIs, and the oversized ones with a
        # non-empty streamed contour (nyxus_tpu/pipeline/runner.py:727-733)
        host_rows = list(triv_rows)
        if contours is not None:
            host_rows = sorted(host_rows + [
                i for i in over_rows if contours[i].shape[0] > 0])
        hc = None
        if host_rows and (self.pre_host or self.post_host
                          or self._needs_logw):
            hc = self._host_context(recs, values, crops, contours,
                                    host_rows, over_set, clouds)

        static_meta = ()
        if self.cfg.ibsi:
            # IBSI's raw levels size the level axes by the slide max rounded
            # up to a power of two; rows above a ROI's max stay empty and
            # change no feature (nyxus_tpu/pipeline/runner.py:788-800)
            ceil = max(int(smax), 2)
            static_meta = (("max_int", 1 << (ceil - 1).bit_length()),)
        outs = []
        # a request of host families alone (the IMQ families) has no device
        # batch
        batched = triv_rows if self.device_families else []
        for shape, sub in batching.group_rois([recs[i] for i in batched],
                                              hbm_budget_bytes=budget):
            idxs = [batched[j] for j in sub]
            with stage(SW_BATCHES, self.devices):
                lw = self._logw_planes(hc, recs, idxs, shape) \
                    if hc is not None and self._needs_logw else None
                # one shard a device (one shard: the whole bucket), each
                # one's crops, families and pack under its device
                for k, part in partition(len(idxs), len(self.devices)):
                    dev = self.devices[k]
                    sidx = idxs[part]
                    windows = [crops(i, *shape) for i in sidx]
                    with device_guard(dev):
                        outs.append((sidx, self._run_batch(
                            windows, [recs[i] for i in sidx], shape, smin,
                            smax, None if lw is None else lw[part],
                            static_meta, hu_offset, dev)))
                crops.release(idxs, shape)

        # phase 3: the oversized ROIs' streamed passes, host work that runs
        # while the device batches above execute; their results land after
        # the host-geometry scatters, which write unassigned values for
        # oversized rows (nyxus_tpu/pipeline/runner.py:1256-1307)
        over_res = []
        for i in over_rows:
            with stage(SW_OVERSIZED, self.devices, "nyx:oversized"), \
                    device_guard(self.device):
                over_res.append((i, ovs.process(
                    recs[i], source, self.cfg, self.families, smin, smax,
                    contour=None if contours is None else contours[i],
                    hu_offset=hu_offset, device=self.device)))

        if hc is not None:
            if contours is not None:
                # the heavy half of the geometry pass and the host families
                # that read no device result: the device batches above run
                # asynchronously meanwhile
                with stage(SW_GEOM, self.devices, "nyx:geom"):
                    hostfeats.compute_geom(
                        hc, self.cfg, self.families, phase="rest",
                        exclude=hostfeats.DIST_FAMILIES)
            self._run_host(hc, values, self.pre_host)

        if outs:
            # one device-to-host copy per slide and device: every bucket
            # and shard packs the same member layout, so the packed
            # outputs of a device concatenate
            src, dst = self._colmap
            by_dev = {}
            for idxs, o in outs:
                by_dev.setdefault(o.device, []).append((idxs, o))
            with stage(SW_COLLECT, self.devices, "nyx:collect"):
                packed = [(part, torch.cat([o for _, o in part],
                                           dim=0).cpu().numpy())
                          for part in by_dev.values()]
            for part, packed_all in packed:
                row = 0
                for idxs, o in part:
                    n = o.shape[0]
                    values[np.ix_(np.asarray(idxs), dst)] = \
                        packed_all[row:row + n][:, src]
                    row += n

        for i, res in over_res:
            self._scatter(values, [i], res)

        if hc is not None:
            # device-dependent host families (circles, geodetic, neighbors,
            # hexagonality read centroids/areas computed on the device, or
            # by phase 3 for oversized rows)
            self._run_host(hc, values, self.post_host)

        # anisotropy: BBOX_* and the members read off the box report the
        # scaled box, though the crop box was widened to cover every
        # virtual member pixel (reference: basic_morphology.cpp:33-37 reads
        # r.aabb; nyxus_tpu/pipeline/runner.py finish)
        for j, r in enumerate(recs):
            if r.report_bbox is None:
                continue
            ry0, ry1, rx0, rx1 = r.report_bbox
            w, h = float(rx1 - rx0 + 1), float(ry1 - ry0 + 1)
            for member, v in (("BBOX_XMIN", float(rx0)),
                              ("BBOX_YMIN", float(ry0)),
                              ("BBOX_WIDTH", w), ("BBOX_HEIGHT", h),
                              ("EXTENT", r.area / (w * h)),
                              ("ASPECT_RATIO", w / h)):
                code = tx.NAME2CODE_2D.get(member)
                if code in self.member_slots:
                    values[j, self.member_slots[code][0]] = v

        if len(recs) != len(all_recs):
            # reinsert blacklisted rows with unassigned values
            out = np.full((len(all_recs), len(self._out_cols)), -0.0)
            kept = {r.label: i for i, r in enumerate(recs)}
            for j, r in enumerate(all_recs):
                if r.label in kept:
                    out[j] = values[kept[r.label], self._out_cols]
            return labs_all, out
        return labs_all, values[:, self._out_cols]

    def _contours(self, recs, crops, over_set, wholeslide):
        """The merged contour of every ROI, local +1 coordinates.  A
        resident slide whose labels fit int32 traces its trivial ROIs in
        one native call; otherwise each is traced alone from its crop
        (``contour.merged_contour``: the same contour).  Oversized ROIs
        take the streamed byte-mask trace (``contour.oversized_contour``),
        no dense crop.  Whole-slide mode traces nothing: its contour is
        ``wholeslide_contours``'s."""
        resident = crops.resident
        with stage(SW_CONTOURS, self.devices, "nyx:contours"):
            if wholeslide:
                return wholeslide_contours(recs)
            triv = [i for i in range(len(recs)) if i not in over_set]
            contours = [None] * len(recs)
            if resident is not None \
                    and labels._native_labels_ok(resident[1]):
                traced = native.contours_batch(resident[1], resident[0],
                                               [recs[i] for i in triv])
                for i, K in zip(triv, traced):
                    contours[i] = K
            else:
                for i in triv:
                    r = recs[i]
                    ii, ll = crops(i, *batching.bucket_shape(r.height,
                                                             r.width))
                    contours[i] = merged_contour(
                        ll[:r.height, :r.width] == r.label,
                        ii[:r.height, :r.width])
            for i in sorted(over_set):
                contours[i] = oversized_contour(recs[i], crops.source)
        return contours

    def _host_context(self, recs, values, crops, contours, host_rows,
                      over_set, clouds=None):
        """The HostContext of the host rows (``host_rows``, indices into
        ``recs``), and, with contours, their pixel clouds (sliced from the
        discovery pass's ``clouds`` where given) and phase "logw" of the
        native geometry pass: the per-pixel log contour distances the
        moment families consume, and the ROI radius / radial families that
        share that distance search.  Oversized rows get empty clouds."""
        resident = crops.resident
        rows = np.asarray(host_rows)
        over_local = frozenset(j for j, i in enumerate(host_rows)
                               if i in over_set)

        def get_feature(member):
            code = tx.NAME2CODE_2D.get(member)
            if code is None or code not in self.member_slots:
                return np.zeros(len(rows))
            off, _ = self.member_slots[code]
            return values[rows, off]

        host_recs = [recs[i] for i in host_rows]
        hc = HostContext(
            host_recs, None if contours is None else
            [contours[i] for i in host_rows], crops.source, get_feature,
            oversized=over_local)
        hc.rows = rows
        hc.pos = {i: j for j, i in enumerate(host_rows)}
        if contours is None:
            return hc
        with stage(SW_GEOM, self.devices, "nyx:geom"):
            hc.clouds = _build_clouds(host_recs, *resident, over_local,
                                      pre=clouds) \
                if resident is not None else _crop_clouds(
                    host_recs, lambda j, hb, wb: crops(host_rows[j], hb, wb),
                    over_local)
            hostfeats.compute_geom(
                hc, self.cfg,
                tuple(f for f in hostfeats.DIST_FAMILIES
                      if f in self.families),
                want_logw=self._needs_logw,
                logw_eps=WEIGHTING_EPSILON, phase="logw")
        return hc

    def _logw_planes(self, hc, recs, idxs, shape):
        """Padded [B, hb, wb] per-pixel log(sqrt(d2) + eps) of one bucket,
        the host pass's float64 values cast to the compute dtype: ONE flat
        scatter into the padded crop frame (nyxus_tpu/pipeline/runner.py
        build_lw)."""
        hb, wb = shape
        np_dt = np.float64 if self.dtype == torch.float64 else np.float32
        lw_h = np.zeros((len(idxs), hb, wb), np_dt)
        gx, gy, _, coff = hc.clouds
        segs = []
        for bi, i in enumerate(idxs):
            j = hc.pos[i]
            if coff[j + 1] > coff[j]:
                segs.append((bi, int(coff[j]), int(coff[j + 1]),
                             recs[i].y0, recs[i].x0))
        if segs:
            bi_f = np.concatenate([np.full(b - a, bi, np.int64)
                                   for bi, a, b, _, _ in segs])
            gy_f = np.concatenate([gy[a:b] - y0 for _, a, b, y0, _ in segs])
            gx_f = np.concatenate([gx[a:b] - x0 for _, a, b, _, x0 in segs])
            lw_f = np.concatenate([hc.logw_flat[a:b]
                                   for _, a, b, _, _ in segs])
            lw_h[bi_f, gy_f, gx_f] = lw_f
        return lw_h

    def _run_host(self, hc, values, names):
        """Host families in order over the host rows, each scattered into
        ``values`` before the next one runs (later families read earlier
        ones' members)."""
        for name in names:
            with stage(SW_HOST % name, self.devices, "nyx:host:" + name):
                members = registry.FAMILIES[name].host_fn(hc, self.cfg)
            self._scatter(values, hc.rows, {name: members})

    def _scatter(self, values, rows, out):
        """Place family outputs ({family: {member: [N] or [N, K], or a
        number or [K] for one row}}) into the rows ``rows`` of the value
        matrix."""
        rows = np.asarray(rows)
        for name, members in out.items():
            fam = registry.FAMILIES[name]
            for member, arr in members.items():
                code = fam.member_code(member)
                if code is None or code not in self.member_slots:
                    continue
                off, width = self.member_slots[code]
                arr = np.asarray(arr, np.float64).reshape(len(rows), -1)
                w = min(width, arr.shape[1])
                values[rows, off:off + w] = arr[:, :w]

    def _run_batch(self, windows, batch_recs, shape, smin, smax, lw=None,
                   static_meta=(), hu_offset=0.0, device=None):
        """All device families over one padded bucket (or one shard of it)
        on ``device`` (the runner's by default), which the caller has made
        current; returns the packed [B, total_width] output there.  Each
        stage is a ``nyx:<stage>`` profiler range (near free when no
        profiler runs)."""
        with record_function("nyx:crops"):
            ctx = self._batch_context(windows, batch_recs, shape, smin, smax,
                                      lw, static_meta, hu_offset, device)
        out = {}
        for name in self.device_families:
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

    def _batch_context(self, windows, batch_recs, shape, smin, smax, lw=None,
                       static_meta=(), hu_offset=0.0, device=None):
        """Host crop assembly of one padded bucket from each ROI's crop
        window (``_CropWindows``), shipped to ``device`` (the runner's by
        default) once, with the bucket's log-distance planes when given."""
        hb, wb = shape
        B = len(batch_recs)
        np_dt = np.float64 if self.dtype == torch.float64 else np.float32
        ci = np.zeros((B, hb, wb), np_dt)
        cm = np.zeros((B, hb, wb), bool)
        for bi, (r, (iw, lab_w)) in enumerate(zip(batch_recs, windows)):
            h, w = lab_w.shape
            ci[bi, :h, :w] = iw
            cm[bi, :h, :w] = lab_w == r.label
        meta_i = np.asarray([[r.area, r.height, r.width, r.y0, r.x0]
                             for r in batch_recs], np.int32)
        meta_f = np.asarray([[r.vmin, r.vmax, smin, smax, hu_offset]
                             for r in batch_recs], np_dt)
        dev = self.device if device is None else device
        mi = torch.from_numpy(meta_i).to(dev)
        mf = torch.from_numpy(meta_f).to(dev)
        return registry.BatchContext(
            torch.from_numpy(ci).to(dev), torch.from_numpy(cm).to(dev),
            mi[:, 0], mf[:, 0], mf[:, 1], mf[:, 2], mf[:, 3],
            mi[:, 1], mi[:, 2], self.cfg, y0=mi[:, 3], x0=mi[:, 4],
            logw=None if lw is None else torch.from_numpy(lw).to(dev),
            static_meta=static_meta, hu_offset=mf[:, 4])

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
