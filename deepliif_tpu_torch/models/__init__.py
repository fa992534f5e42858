"""The batched tile-inference engine: every model family of the JAX
package (DeepLIIF, DeepLIIFExt, SDG, CycleGAN), at float32, bfloat16 and
int8.

Port of deepliif_tpu/models/__init__.py:

  init_nets  -> InferenceSession (cached per model dir and options): options
                + the family's generators on ``device`` (native .npz or
                reference .pth/.pt weights) in the session's precision
  run_tiles  -> (N, ts, ts, C) uint8 tiles -> dict of uint8 outputs; empty
                tiles (gray variance < 9, on the first three channels) are
                skipped on host and filled with the model's background
                colors; for DeepLIIF ``seg_only`` (only the seg branches of
                weight other than 0 and the marker translator run) and
                ``return_intermediate`` (each seg net's output, GS0..GSm)
  inference / infer_modalities / postprocess -> same API surface and output
                key names as the JAX package; postprocess runs the port's
                host quantifier (``deepliif_tpu_torch.postprocessing``) or,
                with ``device_quant``, the device quantifier
                (``ops.labeling.compute_final_results_device``) on the seg
                canvas that ``inference`` stitched on the session's device
                (DeepLIIF); DeepLIIFExt and SDG score each seg output on the
                host

Families (the JAX session's switch): DeepLIIF and DeepLIIFKD
(``models.deepliif``), DeepLIIFExt (``models.deepliif_ext``), SDG
(``models.sdg``: multi-input, the image split into ``input_no`` strips by
width and their tiles concatenated by channel), CycleGAN
(``models.cyclegan``: GA, or GB with the model's ``BtoA`` option; a dir
may hold one direction). The JAX family definitions other than DeepLIIF
take no compute dtype from ``precision``: those sessions compute in
float32 whatever it says, as the JAX ones do.

Precision (DeepLIIF): ``precision=`` (or the model dir's ``precision``
option) is float32, bfloat16 or int8. int8 quantizes within ``int8_scope``:
'all' (the default, as in the JAX package: every conv with C_in and C_out
>= 16; at the flagship the 72 ResNet-trunk convs run the fused int8 kernel
and 96 others the ``conv_s8`` kernel) or 'resblocks' (the trunk only;
every other conv runs bf16). Activation scales are static when the model
dir holds act_scales.json; else the session calibrates them on the first
non-empty tiles it sees (up to 32, in batches of 4) and writes
act_scales.json there (kept for the session alone when the dir cannot be
written), unless ``int8_calibrate`` is False or the fused trunk's
per-chunk dynamic scales serve every quantized conv (scope 'resblocks');
then the scales are dynamic.
``fuse_stages=True`` (or the model dir's ``fuse_stages`` option; bfloat16
only) runs the translators through their fused stages, the counterpart of
the JAX package's ``DEEPLIIF_FUSE_STAGES=1``.

The engine (the JAX session's ``run_tiles``): a short batch runs in a
power-of-two bucket (``batch_size``), and two batches are in flight at a
time: batch i+1 is uploaded and launched before batch i's outputs are
collected, and those outputs come to the host on a copy stream behind
batch i's forward (``_Pipeline``). On CUDA a bucket below ``max_batch``
is used only where a probe on random tiles shows its outputs bitwise
equal to the same tiles' in a batch of ``max_batch`` (``probe_bucket``),
each float32 cuDNN call whose bits at the bucket's batch differ from the
full batch's, and the seg sum's BLAS call in bf16, run zero-padded to the
full batch (``_BatchFloors``; bf16 convs run one sample at a time,
``nets.layers._per_sample``), so a tile's outputs depend neither on the
batch it rides in nor on its place there.

The device is always explicit (``device='cuda'`` by default, never chosen
by what is available). Not ported yet (ROADMAP.md): the TPU engine's mesh
(mesh-sharded labeling included; ``DEEPLIIF_INFER_DEVICES`` above 1 raises
NotImplementedError, "Serving").
"""

from __future__ import annotations

import collections
import contextlib
import copy
import functools
import os
import time

import numpy as np
import torch

from ..config import get_opt
from ..nets import ResnetGenerator, layers as L
from ..ops import quant
from ..utils import checkpoints, luma_u8
from ..utils.tiler import InferenceTiler
from . import (cyclegan as cg, deepliif as dl, deepliif_ext as ext,
               deepliif_kd as kd, sdg)

# the model option -> the family (the JAX session's switch) and its module
_FAMILIES = {'DeepLIIF': 'deepliif', 'DeepLIIFKD': 'deepliif',
             'DeepLIIFExt': 'ext', 'SDG': 'sdg', 'CycleGAN': 'cyclegan'}
_FAMILY_MODULES = {'deepliif': dl, 'ext': ext, 'sdg': sdg, 'cyclegan': cg}


def family_module(model):
    """The module that trains ``model`` (``def_from_opt``,
    ``create_train_state``, its steps and losses): its family's, but
    ``models.deepliif_kd`` for DeepLIIFKD, whose student serves as a
    DeepLIIF model."""
    return kd if model == 'DeepLIIFKD' else _FAMILY_MODULES[
        _FAMILIES.get(model, 'deepliif')]


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
# batch. (The JAX package's 128 for bf16 is a TPU v5e figure.)
DEFAULT_MAX_BATCH = 16

# the batch axis of each output of InferenceSession.forward
_BATCH_AXIS = {'mods': 1, 'segs': 1, 'seg': 0, 'marker': 0}


def configure_device(device):
    """Numerics settings of a session on a CUDA device, process-wide:
    cuDNN would run f32 convs in TF32 (about 3 significant digits) by
    default, so TF32 is turned off for convs and matmuls; cuDNN picks
    deterministic algorithms and no autotuning, so outputs are byte-equal
    run to run, and its algorithm (so its summation order) is a function
    of the call's shape (``InferenceSession.batch_size`` probes each batch
    shape)."""
    if device.type == 'cuda':
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False


class InferenceSession:
    """A loaded model of any family on ``device``, ready for batched tile
    inference. Output keys by family (the reference net ids):
    DeepLIIF G1..Gm and GS (+ GS0..GSm, the intermediates); DeepLIIFExt
    G_1..G_m and GS_1..GS_m; SDG G_1..G_m; CycleGAN GA_1..GA_m (GB_* with
    the model's ``BtoA`` option).

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
        n_devices = os.environ.get('DEEPLIIF_INFER_DEVICES')
        if n_devices and int(n_devices) > 1:
            # the JAX session's mesh over N chips (its n_devices)
            from .. import roadmap
            raise roadmap.not_ported(f'DEEPLIIF_INFER_DEVICES={n_devices} '
                                     '(replicas on several devices)',
                                     roadmap.SERVING)
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
            raise NotImplementedError(f'unknown model family {self.model}')
        self.family = _FAMILIES[self.model]
        if self.family != 'deepliif' and getattr(self.opt, 'fuse_stages',
                                                 False):
            raise ValueError(f'fuse_stages runs the DeepLIIF translators in '
                             f'bfloat16; a {self.model} session computes in '
                             f'float32')
        self.int8_scope = int8_scope or 'all'
        quant.int8_scope_predicate(self.int8_scope)   # validates the name
        self.int8_calibrate = bool(int8_calibrate)
        self.int8_calib_pct = float(int8_calib_pct)
        self.epoch = str(epoch)
        self.device = torch.device(device)
        configure_device(self.device)
        self.d = _FAMILY_MODULES[self.family].def_from_opt(self.opt)
        self.max_batch = DEFAULT_MAX_BATCH if max_batch is None else max_batch
        # {(tile shape, forward path): {bucket: probe}}, batch_size's probes,
        # and per (tile shape, forward path) the probe's full batch
        self.bucket_probes, self._probe_refs = {}, {}
        nets_ = self._load_nets(model_dir)
        self.act_scales = None
        if self.d.quant_int8:
            self.act_scales = quant.load_act_scales(model_dir)
            dl.quantize_nets(nets_, self.int8_scope, self.act_scales)
        self.nets = nets_.to(self.device).eval()

    def build_kernels(self):
        """Build and load now (nvcc, once per process and source hash) the
        CUDA libraries that this session's forward launches: the trunk and
        norm statistics kernels, the fused stages' with ``fuse_stages``,
        ``conv_s8`` at int8 scope 'all'. A server calls this before it
        answers, so that no request waits on a build. Nothing to build on
        the CPU; returns {name: ctypes handle}."""
        if self.device.type != 'cuda':
            return {}
        from ..labs import fused_stages
        from ..nets import layers
        from ..ops import conv_int8, cuda_build, fused_resblock
        libs = {**fused_resblock._LIBS, **layers._LIBS}
        if getattr(self.opt, 'fuse_stages', False):
            libs.update(fused_stages._LIBS)
        if self.d.quant_int8 and self.int8_scope == 'all':
            libs.update(conv_int8._LIBS)
        return cuda_build.build(libs)

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
        self.bucket_probes.clear()       # the nets changed: probe again
        self._probe_refs.clear()
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

    def _make_nets(self, model_dir, native):
        if self.family == 'deepliif':
            return dl.DeepLIIFNets(self.d)
        if self.family != 'cyclegan':
            return _FAMILY_MODULES[self.family].make_nets(self.d)
        # a CycleGAN dir may hold one direction only
        m, ep = self.d.modalities_no, self.epoch
        if native:
            found = [k for k in ('GA', 'GB') if os.path.exists(
                os.path.join(model_dir, f'{ep}_net_{k}.npz'))]
        else:
            found = [k for k in ('GA', 'GB') if all(
                checkpoints.find_net_file(model_dir, f'{k}_{i + 1}', ep)
                for i in range(m))]
            if not found:
                raise FileNotFoundError(f'no GA_*/GB_* checkpoints in '
                                        f'{model_dir}')
        return cg.make_nets(self.d, found)

    def _load_nets(self, model_dir):
        ep = self.epoch
        native = checkpoints.has_native_checkpoint(model_dir, ep)
        nets_ = self._make_nets(model_dir, native)
        groups = [(name, group) for name, group in nets_.named_groups()
                  if len(group)]
        if native:
            for name, group in groups:
                checkpoints.load_group_npz(
                    os.path.join(model_dir, f'{ep}_net_{name}.npz'), group)
            return nets_
        # reference torch model dir: DeepLIIF nets G1..Gm and GS0..GSm, or
        # G51..G55 in legacy dirs (config.init_input_and_mod_id); the other
        # families {group}_1..{group}_m
        for name, group in groups:
            if self.family != 'deepliif':
                names = [f'{name}_{i + 1}' for i in range(len(group))]
            elif name == 'G':
                names = [f'G{i + 1}' for i in range(len(group))]
            else:
                mod_id_seg = getattr(self.opt, 'mod_id_seg', 'S') or 'S'
                input_id = int(getattr(self.opt, 'input_id', 0))
                names = [f'G{mod_id_seg}{input_id + i}'
                         for i in range(len(group))]
            for net_name, net in zip(names, group):
                path = checkpoints.find_net_file(model_dir, net_name, ep)
                if path is None:
                    raise FileNotFoundError(f'missing checkpoint for '
                                            f'{net_name} in {model_dir}')
                checkpoints.load_reference_state_dict(net, path)
        return nets_

    def _mod_keys(self):
        m = self.d.modalities_no
        if self.family == 'deepliif':
            return [f'G{i + 1}' for i in range(m)]
        if self.family == 'cyclegan':
            prefix = 'GB' if getattr(self.opt, 'BtoA', False) else 'GA'
            return [f'{prefix}_{i + 1}' for i in range(m)]
        return [f'G_{i + 1}' for i in range(m)]

    def _marker_index(self):
        """The modality whose name holds 'Marker' (seg-only keeps it)."""
        names = getattr(self.opt, 'modalities_names', []) or []
        input_no = getattr(self.opt, 'input_no', 1)
        for i, nm in enumerate(names[input_no:]):
            if 'Marker' in nm:
                return i
        return None

    # the devices whose buckets are probed: cuDNN picks a conv algorithm
    # per call shape; on the CPU ``nets.layers`` runs each conv on one
    # sample, so every bucket holds there
    _PROBED_DEVICES = ('cuda',)

    def batch_size(self, n, shape, path):
        """Tiles per forward for ``n`` waiting tiles of ``shape`` (s, s, C)
        on forward ``path`` (``forward``'s keywords; short batches are
        padded): the JAX engine's power-of-two bucket, clamped to
        ``max_batch``. On CUDA the smallest such bucket at or above it
        that holds (``probe_bucket``), else ``max_batch``."""
        b = _bucket(n, self.max_batch)
        if self.device.type not in self._PROBED_DEVICES:
            return b
        while b < self.max_batch and not self.probe_bucket(shape, path,
                                                           b)['holds']:
            b *= 2
        return min(b, self.max_batch)

    def probe_bucket(self, shape, path, b):
        """Whether bucket ``b`` (below ``max_batch``) gives a tile of
        ``shape`` the bytes it gets in a batch of ``max_batch`` on forward
        ``path``, probed once per session: ``max_batch`` seeded random
        tiles run at once (once per shape and path), then their first b
        and their last b in forwards of b, each float32 library call of
        them run both as it is and zero-padded to ``max_batch``, the padded
        result kept where the two differ (those calls, and every bf16
        library call, run padded in that bucket from then on:
        ``_BatchFloors``); the
        bucket holds where every output (in the compute dtype, before the
        uint8 cast) is bitwise that of the same tiles in the full batch,
        at its first and at its last positions. Returns {'holds',
        'differs' (the outputs that did not hold), 'padded' (the keys of
        the padded calls, ``layers.cudnn_hook``), 'seconds',
        'reference_seconds' (the full batch's forward)}, kept in
        ``bucket_probes[(shape, path key)][b]``."""
        key = (tuple(int(v) for v in shape), _path_key(path))
        probes = self.bucket_probes.setdefault(key, {})
        if b in probes:
            return probes[b]
        if key not in self._probe_refs:
            t0 = time.perf_counter()
            tiles = torch.from_numpy(np.random.default_rng(0).integers(
                0, 256, (self.max_batch,) + key[0], dtype=np.uint8))
            full = self.forward(tiles, raw=True, **path)
            self._probe_refs[key] = (tiles, full, time.perf_counter() - t0)
        tiles, full, ref_seconds = self._probe_refs[key]
        t0 = time.perf_counter()
        floors, differs = _BatchFloors(self.max_batch, check=True), set()
        for start in (0, self.max_batch - b):
            with L.cudnn_hook(floors):
                part = self.forward(tiles[start:start + b], raw=True, **path)
            differs |= {k for k, v in part.items() if not _bitwise_equal(
                v, full[k].narrow(_BATCH_AXIS[k], start, b))}
        probes[b] = {'holds': not differs, 'differs': sorted(differs),
                     'padded': list(floors.keys),
                     'seconds': time.perf_counter() - t0,
                     'reference_seconds': ref_seconds}
        return probes[b]

    def _bucket_hook(self, shape, path, b):
        """The ``layers.cudnn_hook`` of a forward of ``b`` tiles: the
        bucket's padded cuDNN calls (None where there are none)."""
        probes = self.bucket_probes.get((tuple(int(v) for v in shape),
                                         _path_key(path)), {})
        padded = probes.get(b, {}).get('padded')
        return _BatchFloors(self.max_batch, padded) if padded else None

    def forward(self, tiles_u8, seg_weights=None, mod_only=False,
                seg_only=False, return_intermediate=False, marker_index=None,
                raw=False):
        """One batch (B, s, s, C) uint8 on any device -> dict of uint8
        outputs on the session's device: 'mods' (M, B, s, s, 3), 'seg',
        'segs' (the DeepLIIF intermediates, or DeepLIIFExt's seg per
        modality); with ``seg_only`` (DeepLIIF) 'seg' and 'marker' (the
        modality ``marker_index``) alone. ``raw``: the outputs in the
        compute dtype, before the uint8 cast (``probe_bucket``)."""
        # normalized in float32, then cast to the compute dtype
        x = (tiles_u8.to(self.device).float() / 127.5 - 1.0).to(self.d.dtype)
        seg_gen = self.d.seg_gen and not mod_only
        with torch.no_grad():
            if self.family == 'deepliif' and seg_only:
                seg, marker = dl.seg_only_forward(
                    self.nets, x, self.d, seg_weights=seg_weights,
                    marker_index=marker_index)
                res = {'seg': seg}
                if marker is not None:
                    res['marker'] = marker
            elif self.family == 'deepliif':
                res = dl.inference_forward(
                    self.nets, x, self.d, seg_weights=seg_weights,
                    seg_gen=seg_gen, return_intermediate=return_intermediate)
            elif self.family == 'ext':
                mods, segs = ext.generator_forward(self.nets, x, self.d,
                                                   seg_gen=seg_gen)
                res = {'mods': mods} if segs is None else {'mods': mods,
                                                           'segs': segs}
            elif self.family == 'sdg':
                res = {'mods': sdg.generator_forward(self.nets, x, self.d)}
            else:
                res = {'mods': cg.inference_forward(
                    self.nets, x, self.d,
                    bto_a=getattr(self.opt, 'BtoA', False))}
        if raw:
            return res
        return {k: _quantize_u8(v) for k, v in res.items()}

    def run_tiles(self, tiles_u8, seg_weights=None, seg_only=False,
                  mod_only=False, return_intermediate=False,
                  device_keys=()):
        """tiles_u8: (N, s, s, C) uint8 -> dict of (N, s, s, 3) uint8
        outputs keyed by net id (``InferenceSession``). Empty tiles are
        detected on host and filled with background colors (reference
        run_wrapper).

        DeepLIIF: ``seg_only`` runs ``seg_only_forward`` (where every
        translator and every seg net share one architecture; else the full
        forward) and fills only GS and the marker modality; the other
        modalities keep their background colors. ``return_intermediate``
        adds GS0..GSm (filled where the nets share one architecture, else
        left at their zero background, as in the JAX package).

        ``device_keys`` (only ``('GS',)``, DeepLIIF): outputs kept on the
        session's device, left out of the host dict and returned in a
        second dict of (N, s, s, 3) uint8 tensors (zeros for empty tiles),
        for the device stitch and quantifier; the return value is then
        ``(host_out, device_out)``."""
        if any(k != 'GS' for k in device_keys) or (
                device_keys and self.family != 'deepliif'):
            raise ValueError(f'device_keys {device_keys}: only a DeepLIIF '
                             'GS can stay on the device')
        n = tiles_u8.shape[0]
        m = self.d.modalities_no
        # empty-tile detection: luma variance excluding pure 0/255 pixels
        # (reference image_variance_gray), on the first three channels
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
        deepliif = self.family == 'deepliif'
        want_seg = self.d.seg_gen and not mod_only
        intermediate = deepliif and want_seg and return_intermediate
        # the seg outputs' background: zeros
        seg_keys = []
        dev_out = {}
        if want_seg and deepliif and 'GS' in device_keys:
            dev_out['GS'] = torch.zeros((n, th, tw, 3), dtype=torch.uint8,
                                        device=self.device)
        elif want_seg and deepliif:
            seg_keys.append('GS')
        if intermediate:
            seg_keys += [f'GS{i}' for i in range(m + 1)]
        if want_seg and self.family == 'ext':
            seg_keys += [f'GS_{i + 1}' for i in range(m)]
        out.update({k: np.zeros((n, th, tw, 3), np.uint8) for k in seg_keys})
        use_seg_only = (deepliif and seg_only and want_seg
                        and not return_intermediate and self.d.uniform_g
                        and self.d.uniform_gs)
        marker_idx = self._marker_index() if use_seg_only else None

        if (self.d.quant_int8 and self.act_scales is None
                and self.int8_calibrate and len(nonempty)
                and not self._dynamic_int8_active(th, tw)):
            # the first real tiles an uncalibrated int8 session sees
            self.calibrate_int8(tiles_u8[nonempty[:32]])
        path = dict(seg_weights=seg_weights, mod_only=mod_only,
                    seg_only=use_seg_only, return_intermediate=intermediate,
                    marker_index=marker_idx)
        # the batches (tiles, bucket), every bucket probed before the first
        # batch is launched
        plan, left = [], len(nonempty)
        while left:
            b = self.batch_size(left, tiles_u8.shape[1:], path)
            plan.append((min(b, left), b))
            left -= plan[-1][0]

        def collect(idx, host):
            """Batch ``idx``'s outputs, on the host, into ``out``."""
            nvalid = len(idx)
            if 'mods' in host:
                for i, mk in enumerate(mod_keys):
                    out[mk][idx] = host['mods'][i][:nvalid]
            elif 'marker' in host:
                out[mod_keys[marker_idx]][idx] = host['marker'][:nvalid]
            if 'seg' in host:
                out['GS'][idx] = host['seg'][:nvalid]
            if 'segs' in host:
                for i in range(host['segs'].shape[0]):
                    key = f'GS{i}' if deepliif else f'GS_{i + 1}'
                    out[key][idx] = host['segs'][i][:nvalid]

        # two batches in flight (the JAX engine's pending deque): batch i+1
        # is launched before batch i is collected
        pipe = _Pipeline(self.device)
        pending = collections.deque()
        pos = 0
        try:
            for nvalid, b in plan:
                idx = nonempty[pos:pos + nvalid]
                x = pipe.upload(tiles_u8, idx, b)
                with L.cudnn_hook(self._bucket_hook(tiles_u8.shape[1:], path,
                                                    b)):
                    res = self.forward(x, **path)
                if 'GS' in dev_out:
                    # kept on the device: scattered there, never copied
                    dev_out['GS'][pipe.to_device(idx)] = \
                        res.pop('seg')[:nvalid]
                pending.append((idx, pipe.fetch(res)))
                if len(pending) == 2:
                    idx_i, fetched = pending.popleft()
                    collect(idx_i, pipe.wait(fetched))
                pos += nvalid
            while pending:
                idx_i, fetched = pending.popleft()
                collect(idx_i, pipe.wait(fetched))
        except BaseException:
            pipe.settle(fetched for _, fetched in pending)
            raise
        return (out, dev_out) if device_keys else out


class _Pipeline:
    """The copies of ``InferenceSession.run_tiles``'s batch pipeline. A
    batch's tiles are gathered into a host buffer and uploaded from it;
    its uint8 outputs are copied into host buffers on a copy stream that
    waits on an event recorded after the batch's forward, and are read
    after that copy's own event (``wait``). The host buffers (pinned on
    CUDA) form a ring of two, one per batch in flight, grown to the
    largest batch; a buffer is written again only after the batch that
    last used it was collected, and a batch's device outputs are held
    until its copy event has completed. On the CPU the outputs are on the
    host already and every step is synchronous."""

    def __init__(self, device):
        self.device = device
        self.cuda = device.type == 'cuda'
        self.stream = torch.cuda.Stream(device) if self.cuda else None
        self.ring = [{}, {}]
        self.turn = 0

    def _host(self, name, shape):
        n = int(np.prod(shape))
        slot = self.ring[self.turn]
        if name not in slot or slot[name].numel() < n:
            slot[name] = torch.empty(n, dtype=torch.uint8,
                                     pin_memory=self.cuda)
        return slot[name][:n].view(shape)

    def upload(self, tiles_u8, idx, b):
        """Tiles ``idx`` of ``tiles_u8``, zero-padded to ``b``, on the
        device (a copy that is not waited for)."""
        x = self._host('x', (b,) + tuple(tiles_u8.shape[1:]))
        xn = x.numpy()
        np.take(tiles_u8, idx, axis=0, out=xn[:len(idx)])
        xn[len(idx):] = 0
        return x.to(self.device, non_blocking=True)

    def to_device(self, a):
        """A small host array on the device without a host wait."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.cuda:
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def fetch(self, res):
        """Start copying ``res`` (a batch's outputs) to the host; the
        handle for ``wait``. Ends the batch's turn in the ring."""
        if not self.cuda:
            return res, None, None
        host = {k: self._host(k, tuple(v.shape)) for k, v in res.items()}
        self.turn ^= 1
        ready = torch.cuda.current_stream(self.device).record_event()
        done = torch.cuda.Event()
        with torch.cuda.stream(self.stream):
            self.stream.wait_event(ready)
            for k, v in res.items():
                host[k].copy_(v, non_blocking=True)
            done.record(self.stream)
        return host, done, res

    @staticmethod
    def wait(fetched):
        """A fetched batch's outputs as numpy arrays, once copied."""
        host, done, _ = fetched
        if done is not None:
            done.synchronize()
        return {k: v.numpy() for k, v in host.items()}

    @staticmethod
    def settle(fetched):
        """Wait out the copies still in flight (after a failed batch)."""
        for _, done, _ in fetched:
            if done is not None:
                with contextlib.suppress(Exception):
                    done.synchronize()


class _BatchFloors:
    """The ``layers.cudnn_hook`` of a bucket: a library call (a float32
    cuDNN conv, the seg sum's BLAS call) named by ``keys``, or in a
    low-precision dtype, runs its input zero-padded to the ``full`` batch
    (axis-0 inputs with their per-sample strides) and keeps its first
    results. ``check`` (the bucket probe): every other call also runs both
    ways, and where the bits differ its key is added and the padded result
    kept. Low-precision calls are padded without a check: two summation
    orders of a float32 accumulator often round to the same bf16 on one
    input and not on the next, so a bitwise check on probe tiles cannot
    clear them (bf16 convs run one sample at a time instead,
    ``layers._per_sample``)."""

    def __init__(self, full, keys=(), check=False):
        self.full, self.keys, self.check = full, list(keys), check

    def _padded(self, run, x, axis):
        n = x.shape[axis]
        if axis == 0:
            span = 1 + sum((d - 1) * st for d, st in zip(x.shape[1:],
                                                           x.stride()[1:]))
            t = torch.empty_strided((self.full,) + tuple(x.shape[1:]),
                                    (span,) + x.stride()[1:], dtype=x.dtype,
                                    device=x.device)
        else:
            shape = list(x.shape)
            shape[axis] = self.full
            t = x.new_empty(shape)
        t.narrow(axis, 0, n).copy_(x)
        t.narrow(axis, n, self.full - n).zero_()
        return run(t)[:n]

    def __call__(self, run, x, key, axis=0):
        if x.shape[axis] >= self.full:
            return run(x)
        if key in self.keys:
            return self._padded(run, x, axis)
        if x.dtype != torch.float32 and x.is_floating_point():
            if self.check:
                self.keys.append(key)
            return self._padded(run, x, axis)
        y = run(x)
        if self.check:
            padded = self._padded(run, x, axis)
            if not _bitwise_equal(y, padded):
                self.keys.append(key)
                return padded
        return y


def _path_key(path):
    """A hashable key of ``forward``'s keywords."""
    return tuple(sorted((k, tuple(v) if isinstance(v, list) else v)
                        for k, v in path.items()))


def _bitwise_equal(a, b):
    """Whether two tensors hold the same bits (NaNs included)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    a, b = a.contiguous(), b.contiguous()
    if a.is_floating_point():
        bits = {2: torch.int16, 4: torch.int32, 8: torch.int64}[
            a.element_size()]
        a, b = a.view(bits), b.view(bits)
    return torch.equal(a, b)


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

    multi_input = getattr(opt, 'input_no', 1) > 1 or opt.model == 'SDG'
    if multi_input:
        # the input modalities side by side: input_no strips by width
        w, h = img.width // opt.input_no, img.height
        orig = [np.asarray(img.crop((w * i, 0, w * (i + 1), h)))
                for i in range(opt.input_no)]
    else:
        orig = np.asarray(img.convert('RGB'))
    scale_size = getattr(opt, 'scale_size', tile_size)
    tiler = InferenceTiler(orig, tile_size, overlap_size)
    tiles = tiler.tiles()

    def _resize(batch, size):
        if batch.shape[1] == size:
            return batch
        return np.stack([np.asarray(Image.fromarray(t).resize(
            (size, size), Image.BICUBIC)) for t in batch])

    if multi_input:
        # the tiles of each input modality concatenated by channel
        net_in = np.concatenate([_resize(t, scale_size) for t in tiles],
                                axis=-1)
    else:
        net_in = _resize(tiles, scale_size)
    use_device_seg = (
        _device_seg and session.family == 'deepliif'
        and getattr(opt, 'seg_gen', True) and not mod_only
        and not return_seg_intermediate and not multi_input
        and tiler.pad_size == 0 and scale_size == tile_size)
    seg_canvas = None
    if use_device_seg:
        results_net, dev = session.run_tiles(
            net_in, seg_weights=seg_weights, seg_only=seg_only,
            mod_only=mod_only, device_keys=('GS',))
        tile_idx, ty, tx = (torch.from_numpy(a).to(session.device)
                            for a in tiler.ownership_maps())
        seg_canvas = dev['GS'][tile_idx, ty[:, None], tx[None, :]]
        seg_canvas = seg_canvas[:tiler.orig_height,
                                :tiler.orig_width].contiguous()
    else:
        results_net = session.run_tiles(
            net_in, seg_weights=seg_weights, seg_only=seg_only,
            mod_only=mod_only, return_intermediate=return_seg_intermediate)
    for key, batch in results_net.items():
        tiler.stitch_batch(key, _resize(batch, tile_size))
    results = {k: Image.fromarray(v) for k, v in tiler.results().items()}
    if seg_canvas is not None:
        results['GS'] = Image.fromarray(seg_canvas.cpu().numpy())

    # output naming (reference models/__init__.py:502-565)
    m = opt.modalities_no
    if opt.model in ('DeepLIIFExt', 'SDG'):
        images = {f'mod{i}': results[f'G_{i}'] for i in range(1, m + 1)}
        if (opt.model == 'DeepLIIFExt' and getattr(opt, 'seg_gen', True)
                and not mod_only):
            images.update({f'Seg{i}': results[f'GS_{i}']
                           for i in range(1, m + 1) if f'GS_{i}' in results})
        return (images, None) if _device_seg else images
    if opt.model == 'CycleGAN':
        # the net ids as the keys (the reference's behavior)
        return (results, None) if _device_seg else results
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
    if seg_only:
        images = {'Seg': results['GS']}
        marker_key = find_marker_key(d_modname2id)
        if marker_key is not None and d_modname2id[marker_key] in results:
            images[marker_key] = results[d_modname2id[marker_key]]
    else:
        images = {nm: results[mid] for nm, mid in d_modname2id.items()
                  if mid in results}
    if return_seg_intermediate and not seg_only and getattr(opt, 'seg_gen',
                                                            True):
        # each seg net's output as '{modality}_s' (reference
        # models/__init__.py:545-556)
        l_seg = [f'mod{i}' for i in range(m + 1)]
        if l_seg != list(modality_names):
            l_seg = [f'mod{i}-{nm}' for i, nm in enumerate(modality_names)]
        for i, nm in enumerate(l_seg):
            if f'GS{i}' in results:
                images[f'{nm}_s'] = results[f'GS{i}']
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
    from tile size: >384 -> 40x, >192 -> 20x, else 10x. DeepLIIFExt and
    SDG score each seg image on the host (``_postprocess_segs``; their
    resolution rule differs).

    ``device_quant`` True runs the device quantifier
    (``ops.labeling.compute_final_results_device``) on ``seg_device`` (the
    canvas stitched on the device by ``inference``) or on ``images['Seg']``
    moved to ``device`` (default: seg_device's device, else cuda); False the
    host quantifier (``deepliif_tpu_torch.postprocessing``); 'auto' applies
    ``_resolve_device_quant``."""
    from PIL import Image
    from .. import postprocessing as pp

    if model in ('DeepLIIFExt', 'SDG'):
        return _postprocess_segs(orig, images, tile_size, seg_thresh,
                                 size_thresh, marker_thresh,
                                 size_thresh_upper)
    if model not in ('DeepLIIF', 'DeepLIIFKD'):
        raise NotImplementedError(f'postprocess() not implemented for '
                                  f'{model}')
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


def _postprocess_segs(orig, images, tile_size, seg_thresh, size_thresh,
                      marker_thresh, size_thresh_upper):
    """DeepLIIFExt / SDG: every image named with 'Seg' scored on the host
    quantifier without a marker, giving '{name}_Overlaid' and
    '{name}_Refined' and the scoring under its name. Resolution from tile
    size: > 768 -> 40x, > 384 -> 20x, else 10x (the JAX package's rule for
    these families, twice the DeepLIIF thresholds)."""
    from PIL import Image
    from .. import postprocessing as pp

    resolution = '40x' if tile_size > 768 else ('20x' if tile_size > 384
                                                else '10x')
    orig = np.asarray(orig.convert('RGB') if hasattr(orig, 'convert')
                      else orig)
    processed, scoring = {}, {}
    for name, im in list(images.items()):
        if 'Seg' in name:
            overlay, refined, score = pp.compute_final_results(
                orig, np.asarray(im), None, resolution, size_thresh,
                marker_thresh, size_thresh_upper, seg_thresh)
            processed[name + '_Overlaid'] = Image.fromarray(overlay)
            processed[name + '_Refined'] = Image.fromarray(refined)
            scoring[name] = score
    return processed, scoring


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
        images = {**images, **post_images}
        if seg_only:
            images = {k: v for k, v in images.items() if 'Seg' in k}
        return images, scoring
    return images, None
