"""The batched tile-inference engine, DeepLIIF family, at float32,
bfloat16 and int8.

Port of deepliif_tpu/models/__init__.py for the flagship path:

  init_nets  -> InferenceSession (cached per model dir and options): options
                + the generator ensemble on ``device`` (native .npz or
                reference .pth/.pt weights) in the session's precision
  run_tiles  -> (N, ts, ts, 3) uint8 tiles -> dict of uint8 outputs; empty
                tiles (gray variance < 9) are skipped on host and filled with
                the model's background colors
  inference / infer_modalities / postprocess -> same API surface and output
                key names as the JAX package; postprocess runs the port's
                host quantifier (``deepliif_tpu_torch.postprocessing``) or,
                with ``device_quant``, the device quantifier
                (``ops.labeling.compute_final_results_device``) on the seg
                canvas that ``inference`` stitched on the session's device

Precision: ``precision=`` (or the model dir's ``precision`` option) is
float32, bfloat16 or int8. int8 quantizes within ``int8_scope``: 'all'
(the default, as in the JAX package: every conv with C_in and C_out >= 16;
at the flagship the 72 ResNet-trunk convs run the fused int8 kernel and 96
others the ``conv_s8`` kernel) or 'resblocks' (the trunk only; every other
conv runs bf16). Activation scales are static when the model dir holds
act_scales.json; else the session calibrates them on the first non-empty
tiles it sees (up to 32, in batches of 4) and writes act_scales.json there
(kept for the session alone when the dir cannot be written), unless
``int8_calibrate`` is False or the fused trunk's per-chunk dynamic scales
serve every quantized conv (scope 'resblocks'); then the scales are
dynamic.
``fuse_stages=True`` (or the model dir's ``fuse_stages`` option; bfloat16
only) runs the translators through their fused stages, the counterpart of
the JAX package's ``DEEPLIIF_FUSE_STAGES=1``.

The device is always explicit (``device='cuda'`` by default, never chosen
by what is available). Not ported yet (ROADMAP.md): the other model
families, seg-only and seg-intermediate outputs, and the TPU engine's mesh
(mesh-sharded labeling included) and async copy pipeline.
"""

from __future__ import annotations

import copy
import functools
import os

import numpy as np
import torch

from .. import roadmap
from ..config import get_opt
from ..nets import ResnetGenerator
from ..ops import quant
from ..utils import checkpoints, luma_u8
from ..utils.tiler import InferenceTiler
from . import deepliif as dl

_FAMILIES = ('DeepLIIF', 'DeepLIIFKD')


def _bucket(n, max_batch=16):
    """Pad a batch count to a power-of-two bucket, clamped to max_batch."""
    b = 1
    while b < n and b < max_batch:
        b *= 2
    return min(b, max_batch)


# default tile-batch cap (--max-batch overrides): on one H100 the batch
# sweep (experiments/torch_batch_sweep.py, PERF.md) found tiles/s within
# about 10 % from batch 8 to 64 at every precision, best at 16 for bf16 and
# int8 and 2.5 % below the best for f32, and peak memory growing with the
# batch. (The JAX package's 128 for bf16 is a TPU v5e figure.) On CUDA
# every forward runs max_batch tiles (InferenceSession.batch_size).
DEFAULT_MAX_BATCH = 16


def configure_device(device):
    """Numerics settings of a session on a CUDA device, process-wide:
    cuDNN would run f32 convs in TF32 (about 3 significant digits) by
    default, so TF32 is turned off for convs and matmuls; cuDNN picks
    deterministic algorithms and no autotuning, so outputs are byte-equal
    run to run (and, with one batch shape per session, ``batch_size``,
    independent of the batch)."""
    if device.type == 'cuda':
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False


class InferenceSession:
    """A loaded DeepLIIF model on ``device``, ready for batched tile
    inference. Output keys: G1..Gm (modalities) and GS (seg).

    ``precision`` (default: the model dir's ``precision`` option, else
    float32) is float32, bfloat16 or int8; ``int8_scope`` 'all' (default)
    or 'resblocks'; ``int8_calibrate`` (default True) calibrates static
    scales on the first tiles where the model dir has none, at the
    ``int8_calib_pct`` percentile (100: the max). ``fuse_stages`` (default:
    the model dir's option, else False) runs the translators' fused stages;
    it needs bfloat16 and raises ValueError otherwise."""

    def __init__(self, model_dir, opt=None, phase='test', max_batch=None,
                 epoch='latest', precision=None, device='cuda',
                 int8_scope=None, fuse_stages=None, int8_calibrate=True,
                 int8_calib_pct=100.0):
        self.model_dir = model_dir
        self.opt = opt if opt is not None else get_opt(model_dir, mode=phase)
        for name, value in (('precision', precision),
                            ('fuse_stages', fuse_stages)):
            if value is not None and value != getattr(self.opt, name, None):
                self.opt = copy.copy(self.opt)   # get_opt is cached: keep
                setattr(self.opt, name, value)   # the shared one unchanged
        self.precision = getattr(self.opt, 'precision', None) or 'float32'
        self.model = getattr(self.opt, 'model', 'DeepLIIF')
        if self.model not in _FAMILIES:
            raise roadmap.not_ported(f'model family {self.model}',
                                     roadmap.FAMILIES)
        self.int8_scope = int8_scope or 'all'
        quant.int8_scope_predicate(self.int8_scope)   # validates the name
        self.int8_calibrate = bool(int8_calibrate)
        self.int8_calib_pct = float(int8_calib_pct)
        self.epoch = str(epoch)
        self.device = torch.device(device)
        configure_device(self.device)
        self.d = dl.def_from_opt(self.opt)
        self.max_batch = DEFAULT_MAX_BATCH if max_batch is None else max_batch
        nets_ = self._load_nets(model_dir)
        self.act_scales = None
        if self.d.quant_int8:
            self.act_scales = quant.load_act_scales(model_dir)
            dl.quantize_nets(nets_, self.int8_scope, self.act_scales)
        self.nets = nets_.to(self.device).eval()

    def calibrate_int8(self, tiles_u8, save=True, max_tiles=32, batch=4,
                       pct=None, per_channel=True):
        """Calibrate static int8 activation scales on sample tiles ((N, s,
        s, 3) uint8, the first ``max_tiles``, in batches of ``batch``; the
        JAX session's ``calibrate_int8``), re-quantize the nets with them
        and, with ``save``, write act_scales.json into the model dir (the
        scales stay with this session when the dir cannot be written).
        ``pct`` (default: the session's ``int8_calib_pct``) clips each
        channel's range to that percentile of |x|. Returns the scales."""
        if not self.d.quant_int8:
            raise ValueError('calibrate_int8 requires --precision int8')
        pct = self.int8_calib_pct if pct is None else float(pct)
        tiles = np.asarray(tiles_u8)[:max_tiles]
        scales = {}
        for i in range(0, len(tiles), batch):
            x = torch.from_numpy(np.ascontiguousarray(tiles[i:i + batch]))
            x = x.to(self.device).float() / 127.5 - 1.0
            dl.calibrate_act_scales(self.nets, x, self.d, out=scales,
                                    per_channel=per_channel, pct=pct)
        self.act_scales = {k: (v.tolist() if hasattr(v, 'tolist') else v)
                           for k, v in scales.items()}
        dl.quantize_nets(self.nets, self.int8_scope, self.act_scales)
        if save:
            quant.save_act_scales(self.model_dir, self.act_scales, pct,
                                  len(tiles))
        return self.act_scales

    def _dynamic_int8_active(self, th, tw):
        """True when every quantized conv runs the fused trunk kernel's
        per-chunk dynamic scales at (th, tw) tiles (the JAX session's
        ``_dynamic_int8_active``): scope 'resblocks', no static scales, and
        every translator's int8 trunk passes the fused gate, so calibration
        would serve nothing."""
        if not self.d.quant_int8 or self.int8_scope != 'resblocks':
            return False
        if self.act_scales is not None:
            return False
        h, w = th // 4, tw // 4
        return all(isinstance(g, ResnetGenerator)
                   and g.int8_mode == 'dynamic'
                   and g.model[7].weight.shape[0] % 128 == 0
                   and h % 16 == 0 and w % 16 == 0 for g in self.nets.G)

    def _load_nets(self, model_dir):
        nets_ = dl.DeepLIIFNets(self.d)
        ep = self.epoch
        if checkpoints.has_native_checkpoint(model_dir, ep):
            checkpoints.load_group_npz(
                os.path.join(model_dir, f'{ep}_net_G.npz'), nets_.G)
            if self.d.seg_gen:
                checkpoints.load_group_npz(
                    os.path.join(model_dir, f'{ep}_net_GS.npz'), nets_.GS)
            return nets_
        # reference torch model dir; seg nets are GS0..GSm, or G51..G55 in
        # legacy dirs (config.init_input_and_mod_id)
        mod_id_seg = getattr(self.opt, 'mod_id_seg', 'S') or 'S'
        input_id = int(getattr(self.opt, 'input_id', 0))
        names = [f'G{i + 1}' for i in range(len(nets_.G))]
        names += [f'G{mod_id_seg}{input_id + i}' for i in range(len(nets_.GS))]
        for name, net in zip(names, list(nets_.G) + list(nets_.GS)):
            path = checkpoints.find_net_file(model_dir, name, ep)
            if path is None:
                raise FileNotFoundError(f'missing checkpoint for {name} in '
                                        f'{model_dir}')
            checkpoints.load_reference_state_dict(net, path)
        return nets_

    def _mod_keys(self):
        return [f'G{i + 1}' for i in range(self.d.modalities_no)]

    def batch_size(self, n):
        """Tiles per forward for ``n`` waiting tiles (short batches are
        padded). On CUDA always ``max_batch``: cuDNN picks its conv
        algorithm, and so its summation order, by the shape of the call,
        so one batch shape per session keeps a tile's outputs independent
        of the batch it rides in (on one H100 this cost nothing at batch 16,
        where running each conv on one sample cost up to 41 %; a lone tile
        pays for a full batch: PERF.md). On the CPU the power-of-two
        bucket (there ``nets.layers`` runs each conv on one sample)."""
        if self.device.type == 'cuda':
            return self.max_batch
        return _bucket(n, self.max_batch)

    def forward(self, tiles_u8, seg_weights=None, mod_only=False):
        """One batch (B, s, s, 3) uint8 on any device -> dict of uint8
        outputs on the session's device: 'mods' (M, B, s, s, 3), 'seg'."""
        # normalized in float32, then cast to the compute dtype
        x = (tiles_u8.to(self.device).float() / 127.5 - 1.0).to(self.d.dtype)
        with torch.no_grad():
            res = dl.inference_forward(self.nets, x, self.d,
                                       seg_weights=seg_weights,
                                       seg_gen=self.d.seg_gen and not mod_only)
        return {k: _quantize_u8(v) for k, v in res.items()}

    def run_tiles(self, tiles_u8, seg_weights=None, seg_only=False,
                  mod_only=False, return_intermediate=False,
                  device_keys=()):
        """tiles_u8: (N, s, s, 3) uint8 -> dict of (N, s, s, 3) uint8 outputs
        keyed by net id (G1..Gm, GS). Empty tiles are detected on host and
        filled with background colors (reference run_wrapper).

        ``device_keys`` (only ``('GS',)``): outputs kept on the session's
        device, left out of the host dict and returned in a second dict of
        (N, s, s, 3) uint8 tensors (zeros for empty tiles), for the device
        stitch and quantifier; the return value is then ``(host_out,
        device_out)``."""
        if seg_only:
            raise roadmap.not_ported('--seg-only', roadmap.SEG_ONLY)
        if return_intermediate:
            raise roadmap.not_ported('--seg-intermediate', roadmap.SEG_ONLY)
        if any(k != 'GS' for k in device_keys):
            raise ValueError(f'device_keys {device_keys}: only GS can stay '
                             'on the device')
        n = tiles_u8.shape[0]
        m = self.d.modalities_no
        # empty-tile detection: luma variance excluding pure 0/255 pixels
        # (reference image_variance_gray)
        gray = luma_u8(tiles_u8).astype(np.float32)
        valid = (gray != 0) & (gray != 255)
        cnt = valid.sum(axis=(1, 2))
        s = np.where(valid, gray, 0).sum(axis=(1, 2))
        s2 = np.where(valid, gray * gray, 0).sum(axis=(1, 2))
        with np.errstate(divide='ignore', invalid='ignore'):
            mean = s / cnt
            variance = np.where(cnt > 0, s2 / cnt - mean * mean, 0.0)
        nonempty = np.where(variance >= 9.0)[0]

        out = {}
        th, tw = tiles_u8.shape[1:3]
        mod_keys = self._mod_keys()
        bg = getattr(self.opt, 'background_colors',
                     [(10, 10, 10)] * m) or [(10, 10, 10)] * m
        for i, mk in enumerate(mod_keys):
            color = tuple(bg[i]) if i < len(bg) else (10, 10, 10)
            out[mk] = np.tile(np.asarray(color, np.uint8)[None, None, None, :],
                              (n, th, tw, 1))
        want_seg = self.d.seg_gen and not mod_only
        dev_out = {}
        if want_seg and 'GS' in device_keys:
            dev_out['GS'] = torch.zeros((n, th, tw, 3), dtype=torch.uint8,
                                        device=self.device)
        elif want_seg:
            out['GS'] = np.zeros((n, th, tw, 3), np.uint8)

        if (self.d.quant_int8 and self.act_scales is None
                and self.int8_calibrate and len(nonempty)
                and not self._dynamic_int8_active(th, tw)):
            # the first real tiles an uncalibrated int8 session sees
            self.calibrate_int8(tiles_u8[nonempty[:32]])
        pos = 0
        while pos < len(nonempty):
            b = self.batch_size(len(nonempty) - pos)
            chunk = tiles_u8[nonempty[pos:pos + b]]
            nvalid = chunk.shape[0]
            if nvalid < b:
                chunk = np.concatenate([chunk, np.zeros(
                    (b - nvalid,) + chunk.shape[1:], chunk.dtype)])
            res = self.forward(torch.from_numpy(np.ascontiguousarray(chunk)),
                               seg_weights, mod_only)
            idx = nonempty[pos:pos + nvalid]
            mods = res['mods'].cpu().numpy()
            for i, mk in enumerate(mod_keys):
                out[mk][idx] = mods[i][:nvalid]
            if 'GS' in dev_out:
                dev_out['GS'][torch.from_numpy(idx).to(self.device)] = \
                    res['seg'][:nvalid]
            elif want_seg:
                out['GS'][idx] = res['seg'].cpu().numpy()[:nvalid]
            pos += nvalid
        return (out, dev_out) if device_keys else out


def _quantize_u8(y):
    """tanh range -> uint8 with a truncating cast (reference tensor2im),
    through float32."""
    return ((y.float() + 1.0) * 127.5).to(torch.uint8)


def init_nets(model_dir, phase='test', epoch='latest', max_batch=None,
              precision=None, device='cuda', int8_scope=None,
              fuse_stages=None, int8_calibrate=True, int8_calib_pct=100.0):
    """Cached session construction, one per (model dir, options, device)."""
    return _init_nets_cached(model_dir, phase, str(epoch), max_batch,
                             precision, str(device), int8_scope, fuse_stages,
                             bool(int8_calibrate), float(int8_calib_pct))


@functools.lru_cache(maxsize=8)
def _init_nets_cached(model_dir, phase, epoch, max_batch, precision, device,
                      int8_scope, fuse_stages, int8_calibrate,
                      int8_calib_pct):
    return InferenceSession(model_dir, phase=phase, epoch=epoch,
                            max_batch=max_batch, precision=precision,
                            device=device, int8_scope=int8_scope,
                            fuse_stages=fuse_stages,
                            int8_calibrate=int8_calibrate,
                            int8_calib_pct=int8_calib_pct)


def find_marker_key(d):
    for k in d:
        if k is not None and 'Marker' in k:
            return k
    return None


def inference(img, tile_size, overlap_size, model_path, use_torchserve=False,
              eager_mode=False, color_dapi=False, color_marker=False, opt=None,
              return_seg_intermediate=False, seg_only=False, mod_only=False,
              seg_weights=None, opt_args=None, session=None, max_batch=None,
              precision=None, device='cuda', int8_scope=None,
              fuse_stages=None, int8_calibrate=True, int8_calib_pct=100.0,
              _device_seg=False):
    """Tiled ensemble inference on a PIL image; returns {name: PIL.Image}
    with the reference output key names: 'mod{i}-{Name}' per modality plus
    'Seg'.

    ``_device_seg`` (truthy): the seg tiles stay on the session's device and
    are stitched there with the tiler's ownership maps (the bytes of the
    host stitch); returns ``(images, seg_canvas)``, the canvas a (H, W, 3)
    uint8 tensor on the device, or None where the device stitch does not
    apply (resized tiles, padding, no seg). 'Seg' is one fetch of it."""
    from PIL import Image

    if session is None:
        session = init_nets(model_path,
                            epoch=str(getattr(opt, 'epoch', 'latest') if opt
                                      is not None else 'latest'),
                            max_batch=max_batch, precision=precision,
                            device=device, int8_scope=int8_scope,
                            fuse_stages=fuse_stages,
                            int8_calibrate=int8_calibrate,
                            int8_calib_pct=int8_calib_pct)
    opt = session.opt if opt is None else opt
    if opt_args:
        for k, v in opt_args.items():
            setattr(opt, k, v)

    if getattr(opt, 'seg_gen', True) is False:
        seg_only = False
        return_seg_intermediate = False
    if getattr(opt, 'input_no', 1) > 1:
        raise roadmap.not_ported('multi-input models', roadmap.FAMILIES)

    orig = np.asarray(img.convert('RGB'))
    scale_size = getattr(opt, 'scale_size', tile_size)
    tiler = InferenceTiler(orig, tile_size, overlap_size)
    tiles = tiler.tiles()

    def _resize(batch, size):
        if batch.shape[1] == size:
            return batch
        return np.stack([np.asarray(Image.fromarray(t).resize(
            (size, size), Image.BICUBIC)) for t in batch])

    use_device_seg = (
        _device_seg and getattr(opt, 'seg_gen', True) and not mod_only
        and not return_seg_intermediate
        and tiler.pad_size == 0 and scale_size == tile_size)
    seg_canvas = None
    if use_device_seg:
        results_net, dev = session.run_tiles(
            tiles, seg_weights=seg_weights, seg_only=seg_only,
            mod_only=mod_only, device_keys=('GS',))
        tile_idx, ty, tx = (torch.from_numpy(a).to(session.device)
                            for a in tiler.ownership_maps())
        seg_canvas = dev['GS'][tile_idx, ty[:, None], tx[None, :]]
        seg_canvas = seg_canvas[:tiler.orig_height,
                                :tiler.orig_width].contiguous()
    else:
        results_net = session.run_tiles(
            _resize(tiles, scale_size), seg_weights=seg_weights,
            seg_only=seg_only, mod_only=mod_only,
            return_intermediate=return_seg_intermediate)
    for key, batch in results_net.items():
        tiler.stitch_batch(key, _resize(batch, tile_size))
    results = {k: Image.fromarray(v) for k, v in tiler.results().items()}
    if seg_canvas is not None:
        results['GS'] = Image.fromarray(seg_canvas.cpu().numpy())

    # output naming (reference models/__init__.py:502-565)
    m = opt.modalities_no
    input_no = getattr(opt, 'input_no', 1)
    modality_names = getattr(opt, 'modalities_names',
                             [f'mod{i}' for i in range(m + 1)])
    l_modname = [f'mod{i + 1}' for i in range(m)]
    if l_modname != list(modality_names[input_no:]):
        l_modname = [f'mod{i + 1}-{nm}' for i, nm in
                     enumerate(modality_names[input_no:])]
    d_modname2id = {nm: f'G{i + 1}' for i, nm in enumerate(l_modname)}
    if not mod_only and getattr(opt, 'seg_gen', True):
        d_modname2id['Seg'] = 'GS'
    images = {nm: results[mid] for nm, mid in d_modname2id.items()
              if mid in results}
    return (images, seg_canvas) if _device_seg else images


# The 'auto' rule's constants, measured on one NVIDIA H100 80GB HBM3 at
# 700.00 W (experiments/torch_devquant_sweep.py, medians of 3 after a
# warm-up; PERF.md section 5). Crossover: the host quantifier wins at 128^2
# (4.6 ms against 15.1: the device pads every canvas to multiples of 256),
# the device from 256^2 (11.4 ms against 18.5) up to 8192^2 (0.55 s
# against 23.7 s); nothing between 128^2 and 256^2 was measured. Cap: the
# device quantifier peaks at 45.2 B/px of device memory; with the stitched
# seg canvas and its tiles (7 B/px) beside a batch-16 float32 session
# (5.15 GB) an 80 GB card holds 1.53 G px, below the 2^31 pixels of the
# labeling kernel's int32 flat indices. The JAX rule's device->host
# bandwidth bar has no counterpart: fetching the two result canvases would
# eat the device's gain below 55 MB/s, and the card copies at 8,866 MB/s.
_DEVICE_QUANT_MIN_PX = 256 * 256
_DEVICE_QUANT_MAX_PX = 1_500_000_000


def _device_quant_fits(h, w):
    return h * w <= _DEVICE_QUANT_MAX_PX


def _resolve_device_quant(device_quant, seg_device):
    """The 'auto' rule: the device quantifier when the seg canvas is already
    on a CUDA device (the device stitch ran; a CPU session takes the host
    path), at least the measured crossover, and fits the card. An explicit
    True/False always wins."""
    if device_quant == 'auto':
        if seg_device is None or seg_device.device.type != 'cuda':
            return False
        h, w = int(seg_device.shape[0]), int(seg_device.shape[1])
        return h * w >= _DEVICE_QUANT_MIN_PX and _device_quant_fits(h, w)
    return bool(device_quant)


def postprocess(orig, images, tile_size, model, seg_thresh=120,
                size_thresh='default', marker_thresh=None,
                size_thresh_upper=None, device_quant=False, seg_device=None,
                device=None):
    """Quantification: overlay/refined masks + IHC scoring dict. Resolution
    from tile size: >384 -> 40x, >192 -> 20x, else 10x.

    ``device_quant`` True runs the device quantifier
    (``ops.labeling.compute_final_results_device``) on ``seg_device`` (the
    canvas stitched on the device by ``inference``) or on ``images['Seg']``
    moved to ``device`` (default: seg_device's device, else cuda); False the
    host quantifier (``deepliif_tpu_torch.postprocessing``); 'auto' applies
    ``_resolve_device_quant``."""
    from PIL import Image
    from .. import postprocessing as pp

    if model not in _FAMILIES:
        raise roadmap.not_ported(f'postprocess for {model}', roadmap.FAMILIES)
    device_quant = _resolve_device_quant(device_quant, seg_device)
    resolution = '40x' if tile_size > 384 else ('20x' if tile_size > 192 else '10x')
    marker = images.get(find_marker_key(images))
    args = (
        np.asarray(orig.convert('RGB') if hasattr(orig, 'convert') else orig),
        np.asarray(images['Seg']),
        # reference grayscale convention: per-pixel max over RGB
        pp.to_array(marker, True) if marker is not None else None,
        resolution, size_thresh, marker_thresh, size_thresh_upper, seg_thresh)
    if device_quant:
        from ..ops.labeling import compute_final_results_device
        overlay, refined, scoring = compute_final_results_device(
            args[0], seg_device if seg_device is not None else args[1],
            args[2], resolution, size_thresh=size_thresh,
            marker_thresh=marker_thresh, size_thresh_upper=size_thresh_upper,
            seg_thresh=seg_thresh, device=device)
    else:
        overlay, refined, scoring = pp.compute_final_results(*args)
    return ({'SegOverlaid': Image.fromarray(overlay),
             'SegRefined': Image.fromarray(refined)}, scoring)


def infer_modalities(img, tile_size, model_dir, eager_mode=False,
                     color_dapi=False, color_marker=False, opt=None,
                     return_seg_intermediate=False, seg_only=False,
                     mod_only=False, seg_weights=None, max_batch=None,
                     device_quant=False, precision=None, device='cuda',
                     int8_scope=None, fuse_stages=None, int8_calibrate=True,
                     int8_calib_pct=100.0):
    """Full tile-to-scoring pipeline: inference, then postprocess (host
    quantifier, or with ``device_quant`` True / 'auto' the device stitch and
    the device quantifier, as in the JAX package). ``color_dapi`` /
    ``color_marker`` are accepted and inert, as in the reference and the JAX
    package."""
    session = init_nets(model_dir,
                        epoch=str(getattr(opt, 'epoch', 'latest') if opt
                                  is not None else 'latest'),
                        max_batch=max_batch, precision=precision,
                        device=device, int8_scope=int8_scope,
                        fuse_stages=fuse_stages,
                        int8_calibrate=int8_calibrate,
                        int8_calib_pct=int8_calib_pct)
    opt = session.opt if opt is None else opt
    images = inference(
        img, tile_size=tile_size, overlap_size=tile_size // 16,
        model_path=model_dir, opt=opt,
        return_seg_intermediate=return_seg_intermediate,
        seg_only=seg_only, mod_only=mod_only, seg_weights=seg_weights,
        session=session, _device_seg=device_quant)
    seg_device = None
    if device_quant:
        images, seg_device = images
    if getattr(opt, 'seg_gen', True) and not mod_only:
        post_images, scoring = postprocess(img, images, tile_size, opt.model,
                                           device_quant=device_quant,
                                           seg_device=seg_device,
                                           device=session.device)
        return {**images, **post_images}, scoring
    return images, None
