"""Whole-slide image (WSI) inference: bounded-memory region streaming; the
port's counterpart of deepliif_tpu/utils/wsi.py.

Slides are read by the tiled-TIFF/BigTIFF page reader (``utils.tiff``) for
TIFF-family slides (.tif, .tiff, .svs, .ndpi, .scn, .bif), else by PIL for
anything PIL can open (PNG, JPEG, single-strip TIFF). The other slide
formats of the JAX package (.mrxs, .czi, .dcm, .vms, .vmu, .vsi / .ets,
.svslide and OME-Zarr) raise NotImplementedError (ROADMAP.md, "WSI").

Regions stream to the session's device with the reference's region_size
bound (default 20000 px, reference cli.py:928), read one ahead on a worker
thread; per-region scoring accumulates, and the modality canvases (disk
backed) are stitched and written as tiled BigTIFFs (``utils.tiff``) with
/2, /4, /8 pyramid levels. ``device`` and ``precision`` go to the session
(``models.init_nets``), whose cache is keyed by both.
"""

from __future__ import annotations

import json
import os

import numpy as np
from PIL import Image

Image.MAX_IMAGE_PIXELS = None


# the JAX package's other slide readers, by file name: not ported yet
_UNPORTED = (('.mrxs', 'MIRAX'), ('.czi', 'CZI'), ('.dcm', 'DICOM'),
             ('.vms', 'VMS'), ('.vmu', 'VMU'), ('.vsi', 'VSI'),
             ('.ets', 'VSI'), ('.svslide', 'Sakura'))


def _is_ome_zarr(path):
    """The JAX package's OME-Zarr test (deepliif_tpu/utils/ngff.py
    ``is_ome_zarr``)."""
    if path.lower().endswith('.zarr') and os.path.isdir(path):
        return True
    return os.path.isdir(path) and (
        os.path.exists(os.path.join(path, '.zattrs'))
        or os.path.exists(os.path.join(path, '.zarray')))


def _unported_format(path):
    """The name of the slide format of ``path`` when the port has no
    reader for it yet, else None."""
    for ext, name in _UNPORTED:
        if path.lower().endswith(ext):
            return name
    return 'OME-Zarr' if _is_ome_zarr(path) else None


class WSIReader:
    """Region reader over a slide file.

    Fast path: the tiled-TIFF reader (decodes only intersecting tiles,
    bounded memory — the zarr-view equivalent). Fallback: PIL (whole image
    decoded lazily; crop reads the needed scanlines for most formats)."""

    def __init__(self, path):
        self.path = path
        self._tiled = None
        self._img = None
        fmt = _unported_format(path)
        if fmt:
            from ..roadmap import WSI, not_ported
            raise not_ported(f'reading {os.path.basename(path)!r} (the '
                             f'{fmt} slide reader)', WSI)
        if path.lower().endswith(('.tif', '.tiff', '.svs', '.ndpi',
                                  '.scn', '.bif')):
            try:
                from .tiff import TiledTiffReader
                self._tiled = TiledTiffReader(path)
                self.size = self._tiled.size
                return
            except Exception:
                self._tiled = None
        self._img = Image.open(path)
        self.size = self._img.size  # (w, h)

    def get_information(self):
        w, h = self.size
        return {'size_x': w, 'size_y': h, 'pixel_type': 'uint8',
                'magnification': self.get_magnification()}

    def get_magnification(self):
        """Objective magnification from slide metadata, or None."""
        from .tiff import parse_magnification
        if self._tiled is not None:
            if hasattr(self._tiled, 'get_magnification'):
                return self._tiled.get_magnification()  # NDPI SourceLens etc.
            return parse_magnification(self._tiled.read_description())
        desc = (self._img.tag_v2.get(270)
                if hasattr(self._img, 'tag_v2') else None)
        return parse_magnification(desc)

    def read_region(self, x, y, w, h):
        """Read a region; on failure fall back tile-by-tile and finally to
        zeros (the reference's salvage chain, util/__init__.py:618-691)."""
        try:
            if self._tiled is not None:
                return self._tiled.read_region(x, y, w, h)
            region = self._img.crop((x, y, x + w, y + h)).convert('RGB')
            return np.asarray(region)
        except Exception:
            out = np.zeros((h, w, 3), np.uint8)
            step = 1024
            for ty in range(0, h, step):
                for tx in range(0, w, step):
                    tw, th2 = min(step, w - tx), min(step, h - ty)
                    try:
                        if self._tiled is not None:
                            t = self._tiled.read_region(x + tx, y + ty, tw, th2)
                        else:
                            t = np.asarray(self._img.crop(
                                (x + tx, y + ty, x + tx + tw, y + ty + th2))
                                .convert('RGB'))
                        out[ty:ty + th2, tx:tx + tw] = t
                    except Exception:
                        pass  # leave zeros for the unreadable tile
            return out

    def close(self):
        if self._tiled is not None:
            self._tiled.close()
        if self._img is not None:
            self._img.close()


def _region_producer(reader, coords, q):
    """Region-prefetch worker: feeds ((x, y, w, h), pixels) items into
    ``q``, then a None sentinel. A failure past WSIReader's salvage chain
    (e.g. MemoryError on a 20000px region) is forwarded as ('error', exc)
    so the consumer re-raises instead of blocking on q.get() forever."""
    try:
        for c in coords:
            q.put((c, reader.read_region(*c)))
        q.put(None)
    except BaseException as e:
        q.put(('error', e))


def get_wsi_resolution(path_or_mag, tile_size_base=512):
    """Magnification -> tile size = round(mag/40 * 512) (reference
    models/__init__.py:730-782). Accepts a numeric magnification OR a slide
    path, in which case the objective magnification is read from the file's
    metadata (Aperio AppMag / OME NominalMagnification)."""
    mag = None
    try:
        mag = float(path_or_mag)
    except (TypeError, ValueError):
        if isinstance(path_or_mag, str) and os.path.exists(path_or_mag):
            try:
                reader = WSIReader(path_or_mag)
                mag = reader.get_magnification()
                reader.close()
            except Exception:
                mag = None
    if mag is None:
        return None
    return int(round(mag / 40.0 * tile_size_base))


def infer_results_for_wsi(input_dir, filename, output_dir, model_dir,
                          tile_size, region_size=20000, seg_only=False,
                          seg_intermediate=False, color_dapi=False,
                          color_marker=False, device='cuda', precision=None):
    """Region loop over the slide; accumulates modality canvases + counts
    (reference models/__init__.py:663-727). Runs on ``device`` at
    ``precision`` (default: the model dir's)."""
    from ..models import infer_modalities, init_nets

    os.makedirs(output_dir, exist_ok=True)
    reader = WSIReader(os.path.join(input_dir, filename))
    info = reader.get_information()
    size_x, size_y = info['size_x'], info['size_y']
    print(f'WSI {filename}: {size_x} x {size_y}, region_size {region_size}')

    session = init_nets(model_dir, precision=precision, device=device)
    # full-slide canvases are disk-backed (np.memmap) so peak RSS stays
    # O(region), not O(slide) — a 100k^2 slide would need 30 GB per modality
    # in RAM otherwise (the reference has the same flaw,
    # models/__init__.py:708-712)
    import tempfile
    canvas_dir = tempfile.mkdtemp(prefix='deepliif_wsi_', dir=output_dir)

    def _new_canvas(name):
        return np.memmap(os.path.join(canvas_dir, f'{name}.raw'),
                         dtype=np.uint8, mode='w+',
                         shape=(size_y, size_x, 3))

    canvases = {}
    scoring_total = {'num_total': 0, 'num_pos': 0, 'num_neg': 0}

    def _accumulate(scoring):
        """Flat DeepLIIF scoring or the Ext/SDG per-seg nested dict
        ({'Seg1': {...}, ...}) — both sum into the slide totals."""
        if not scoring:
            return
        parts = (list(scoring.values())
                 if all(isinstance(v, dict) for v in scoring.values())
                 else [scoring])
        for part in parts:
            for k in scoring_total:
                scoring_total[k] += part.get(k, 0)

    # double-buffered region reads: the next region loads on a worker thread
    # while the current one runs inference (host IO overlaps device compute)
    import queue
    import shutil
    import threading
    coords = [(rx, ry, min(region_size, size_x - rx), min(region_size, size_y - ry))
              for ry in range(0, size_y, region_size)
              for rx in range(0, size_x, region_size)]
    q = queue.Queue(maxsize=2)
    threading.Thread(target=_region_producer, args=(reader, coords, q),
                     daemon=True).start()

    try:
        while True:
            item = q.get()
            if item is None:
                break
            if item[0] == 'error':
                raise item[1]
            (rx, ry, rw, rh), region = item
            img = Image.fromarray(region)
            images, scoring = infer_modalities(img, tile_size, model_dir,
                                               opt=session.opt,
                                               seg_only=seg_only,
                                               color_dapi=color_dapi,
                                               color_marker=color_marker,
                                               return_seg_intermediate=seg_intermediate,
                                               precision=precision,
                                               device=device)
            for name, im in images.items():
                if name not in canvases:
                    canvases[name] = _new_canvas(name)
                canvases[name][ry:ry + rh, rx:rx + rw] = np.asarray(im)[:rh, :rw]
            _accumulate(scoring)

        stem = filename.rsplit('.', 1)[0]
        for name, canvas in canvases.items():
            _write_pyramid(os.path.join(output_dir, f'{stem}_{name}.ome.tiff'),
                           canvas)
    finally:
        # a mid-slide failure must not leave multi-GB memmap canvases in
        # the user's output directory
        reader.close()
        del canvases
        shutil.rmtree(canvas_dir, ignore_errors=True)
    scoring_total['percent_pos'] = (
        round(scoring_total['num_pos'] / scoring_total['num_total'] * 100, 1)
        if scoring_total['num_total'] > 0 else 0)
    with open(os.path.join(output_dir, f'{stem}.json'), 'w') as f:
        json.dump(scoring_total, f, indent=2)
    print('WSI scoring:', scoring_total)
    return scoring_total


def infer_cells_for_wsi(input_dir, filename, output_dir, model_dir, tile_size,
                        region_size=20000, version=4, device='cuda',
                        precision=None):
    """Per-region encoded cell data with global coordinate offsets and
    averaged auto-thresholds (reference models/__init__.py:785-947). Runs on
    ``device`` at ``precision`` (default: the model dir's)."""
    from ..models import inference, init_nets, find_marker_key
    from .. import postprocessing as pp

    os.makedirs(output_dir, exist_ok=True)
    reader = WSIReader(os.path.join(input_dir, filename))
    info = reader.get_information()
    size_x, size_y = info['size_x'], info['size_y']
    session = init_nets(model_dir, precision=precision, device=device)

    all_cells = []
    size_threshes, marker_threshes = [], []
    resolution = '40x' if tile_size > 384 else ('20x' if tile_size > 192 else '10x')

    # same double-buffered region pipeline as infer_results_for_wsi: the next
    # region loads on a worker thread while this one runs inference+encoding
    import queue
    import threading
    coords = [(rx, ry, min(region_size, size_x - rx), min(region_size, size_y - ry))
              for ry in range(0, size_y, region_size)
              for rx in range(0, size_x, region_size)]
    q = queue.Queue(maxsize=2)
    threading.Thread(target=_region_producer, args=(reader, coords, q),
                     daemon=True).start()

    try:
        while True:
            item = q.get()
            if item is None:
                break
            if item[0] == 'error':
                raise item[1]
            (rx, ry, rw, rh), region = item
            img = Image.fromarray(region)
            # inference() directly, like the reference (models/__init__.py:
            # 853-875): its seg_only output KEEPS the marker modality that
            # infer_modalities' seg_only file filter would delete (the v3/v4
            # cell data needs it), and the scoring postprocess whose outputs
            # this path discards never runs
            images = inference(img, tile_size=tile_size,
                               overlap_size=tile_size // 16,
                               model_path=model_dir, opt=session.opt,
                               seg_only=True, session=session)
            marker_key = find_marker_key(images)
            # v3/4 use the inferred marker; v5/6 use optical density of the
            # ORIGINAL region (reference models/__init__.py:785-947).
            # Encode after coordinate offsetting, so run the dict version.
            if version in (5, 6):
                data = pp.compute_cell_results(images['Seg'], img, resolution,
                                               version=5)
            else:
                data = pp.compute_cell_results(
                    images['Seg'], images.get(marker_key), resolution,
                    version=3)
            size_threshes.append(data['settings']['default_size_thresh'])
            if data['settings'].get('default_marker_thresh') is not None:
                marker_threshes.append(data['settings']['default_marker_thresh'])
            for c in data['cells']:
                c['bbox'] = [(c['bbox'][0][0] + rx, c['bbox'][0][1] + ry),
                             (c['bbox'][1][0] + rx, c['bbox'][1][1] + ry)]
                c['centroid'] = (c['centroid'][0] + rx, c['centroid'][1] + ry)
                c['boundary'] = [(x + rx, y + ry) for x, y in c['boundary']]
                if version in (4, 6):
                    c = pp.encode_cell_data_v4(c, v6=(version == 6))
                all_cells.append(c)

    finally:
        reader.close()
    results = {
        'cells': all_cells,
        'settings': {
            'default_size_thresh': int(round(np.mean(size_threshes))) if size_threshes else 0,
            'default_marker_thresh': (int(round(np.mean(marker_threshes)))
                                      if marker_threshes else None),
            'noise_thresh': pp.DEFAULT_NOISE_THRESH,
            'large_noise_thresh': pp.calculate_large_noise_thresh('default', resolution),
            'seg_thresh': pp.DEFAULT_SEG_THRESH,
        },
        'dataVersion': version,
    }
    stem = filename.rsplit('.', 1)[0]
    with open(os.path.join(output_dir, f'{stem}_cells.json'), 'w') as f:
        json.dump(results, f)
    return results


def _write_pyramid(path, canvas):
    """Write a pyramidal image. Uses the native tiled-BigTIFF writer when
    available, else falls back to PNG levels."""
    try:
        from .tiff import write_pyramid_tiff
        write_pyramid_tiff(path, canvas, levels=(1, 2, 4, 8))
        return
    except Exception:
        pass
    img = Image.fromarray(canvas)
    img.save(path.replace('.ome.tiff', '.png'))
    for f in (2, 4, 8):
        img.resize((max(1, img.width // f), max(1, img.height // f))).save(
            path.replace('.ome.tiff', f'_L{f}.png'))
