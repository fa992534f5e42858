"""Command-line interface of the PyTorch port: ``deepliif-tpu-torch test``,
``serialize``, ``serve``, ``test-wsi`` and ``wsi-cells``.

Same options, output file names and scoring JSON as the commands of
``deepliif-tpu`` (deepliif_tpu/cli.py), plus ``--device`` (default cuda;
``serialize`` uses it where the JAX command ignores it).
``--precision {float32,bfloat16,int8}`` picks the compute precision;
``--int8-scope`` (default all, as in the JAX package) which convs int8
quantizes. An int8 session calibrates static activation scales on its
first tiles and writes act_scales.json into the model dir, as the JAX
session does; the JAX package's environment settings of that step are read
here, and only here (``int8_options``): ``DEEPLIIF_INT8_CALIBRATE=0``
keeps per-sample dynamic scales, ``DEEPLIIF_INT8_CALIB_PCT`` the
percentile. ``--fuse-stages`` (bfloat16 only) runs the translators' fused
stages, the counterpart of the JAX package's ``DEEPLIIF_FUSE_STAGES=1``.
``--device-quant {auto,on,off}`` picks the quantifier: on runs it on the
session's device (``ops.labeling``), off on the host, auto stitches the seg
canvas on the device and quantifies there when it is a CUDA device and the
canvas is at least the measured crossover and fits the card
(``models._resolve_device_quant``).
``--seg-only`` writes the seg and the marker modality alone (only the
seg branches of weight other than 0 and the marker translator run);
``--seg-intermediate`` adds each seg net's output as '{modality}_s'.
Every model family of the JAX package runs (DeepLIIF, DeepLIIFExt, SDG,
CycleGAN); DeepLIIFExt, SDG and CycleGAN compute in float32 whatever
``--precision`` says, as in the JAX package, and, as there, ``--BtoA``
does not reach the session: a CycleGAN dir runs GB when its own options
say BtoA.
``serialize`` writes a model dir (reference torch or native) as native
npz files and holds the written dir to the source with the reference's
parity gate (sum |diff| <= 10 on a seeded random tile, both sessions on
``--device``). ``serve`` runs the REST server (``deepliif_tpu_torch.serve``)
with ``--device``, ``--precision``, ``--int8-scope`` and ``--fuse-stages``
as on ``test``. ``test-wsi`` and ``wsi-cells`` run whole slides region by
region (``utils.wsi``): TIFF-family slides through the tiled TIFF reader,
other images through PIL; the other slide formats of the JAX package raise
NotImplementedError (ROADMAP.md, "WSI"). The commands not ported yet are
listed under ROADMAP.md's "Training" and "Stats". click is imported when
the command line is built, not when this module is imported.

    python -m deepliif_tpu_torch.cli test --input-dir imgs --tile-size 512 \\
        --model-dir model --output-dir out --device cuda --precision int8
    python -m deepliif_tpu_torch.cli serve --model-dir model --port 8080
    python -m deepliif_tpu_torch.cli test-wsi --input-dir slides \\
        --filename slide.svs --output-dir out --model-dir model
"""

from __future__ import annotations

import glob
import json
import os


# the JAX package's switches of its fused int8 trunk kernel and their
# defaults (deepliif_tpu/nets/resnet.py :91-96, :110; ops/fused_resblock.py
# :150, the bf16 chunk of 16 rows that the dynamic scales run on): the port
# runs the defaults and refuses another setting rather than ignore it
_INT8_KERNEL_SWITCHES = {'DEEPLIIF_INT8_DYN': '1', 'DEEPLIIF_FUSED_INT8': '1',
                         'DEEPLIIF_FUSED_CHUNK': '16'}


def int8_options(environ, precision):
    """The int8 session arguments from the JAX package's environment
    settings (deepliif_tpu/models/__init__.py :170, :414):
    ``DEEPLIIF_INT8_CALIBRATE`` (default '1'; '0' skips calibration) and
    ``DEEPLIIF_INT8_CALIB_PCT`` (default 100). At ``precision`` int8 a
    kernel switch set to anything but its default raises
    NotImplementedError."""
    from . import roadmap

    for name, default in _INT8_KERNEL_SWITCHES.items():
        value = environ.get(name)
        if precision == 'int8' and value not in (None, default):
            raise roadmap.not_ported(f'{name}={value}', roadmap.INT8_ALL)
    return {'int8_calibrate': environ.get('DEEPLIIF_INT8_CALIBRATE', '1')
            != '0',
            'int8_calib_pct': float(environ.get('DEEPLIIF_INT8_CALIB_PCT',
                                                '100'))}


def allowed_file(filename):
    excluding = ['Hema', 'DAPI', 'DAPILap2', 'Ki67', 'Seg', 'Marked',
                 'SegRefined', 'SegOverlaid', 'Marker', 'Lap2']
    name, ext = os.path.splitext(filename)
    return ext in ('.png', '.jpg', '.tif', '.jpeg') and \
        name.split('_')[-1] not in excluding


def run_test(input_dir, output_dir, tile_size, model_dir, filename_pattern='*',
             epoch='latest', seg_intermediate=False, seg_only=False,
             mod_only=False, btoa=False, max_batch=None, precision=None,
             int8_scope=None, device_quant='auto', device='cuda',
             fuse_stages=None, echo=print):
    """Tiled inference + quantification over a directory of images."""
    from PIL import Image
    from .config import get_opt, print_options
    from .models import infer_modalities

    if mod_only:
        seg_only = seg_intermediate = False
    elif seg_intermediate and seg_only:
        seg_intermediate = False

    output_dir = output_dir or input_dir
    os.makedirs(output_dir, exist_ok=True)
    if filename_pattern == '*':
        image_files = [fn for fn in os.listdir(input_dir) if allowed_file(fn)]
    else:
        image_files = [os.path.basename(f) for f in
                       glob.glob(os.path.join(input_dir, filename_pattern))]
    echo(f'{len(image_files)} image files')

    opt = get_opt(model_dir, mode='test')
    int8 = int8_options(os.environ, precision or getattr(opt, 'precision',
                                                         None))
    opt.BtoA = btoa
    opt.epoch = epoch
    seg_weights = getattr(opt, 'seg_weights', None)
    print_options(opt)

    for filename in image_files:
        img = Image.open(os.path.join(input_dir, filename)).convert('RGB')
        images, scoring = infer_modalities(
            img, tile_size, model_dir, opt=opt,
            return_seg_intermediate=seg_intermediate, seg_only=seg_only,
            mod_only=mod_only, seg_weights=seg_weights, max_batch=max_batch,
            device_quant={'on': True, 'off': False}.get(device_quant, 'auto'),
            precision=precision, device=device, int8_scope=int8_scope,
            fuse_stages=fuse_stages, **int8)
        stem = filename.rsplit('.', 1)[0]
        for name, im in images.items():
            im.save(os.path.join(output_dir, f'{stem}_{name}.png'))
        if scoring is not None:
            with open(os.path.join(output_dir, f'{stem}.json'), 'w') as f:
                json.dump(scoring, f, indent=2)
        echo(f'processed {filename}')


def run_serialize(model_dir, output_dir=None, do_verify=True, epoch='latest',
                  tile_size=None, device='cuda', verbose=False, echo=print):
    """Write the nets of ``model_dir`` (torch or native) as native npz files
    into ``output_dir`` (default: ``model_dir``), copy train_opt.txt and
    config.json, and with ``do_verify`` hold a session of the written dir
    to one of the source on one seeded random tile (the model's
    scale_size, else 512; both on ``device``): sum |diff| over the uint8
    outputs at most 10 (reference util/__init__.py:718-741), else
    AssertionError. Returns that sum (None without ``do_verify``)."""
    import shutil

    import numpy as np
    from .models import InferenceSession
    from .utils import checkpoints

    output_dir = output_dir or model_dir
    os.makedirs(output_dir, exist_ok=True)
    session = InferenceSession(model_dir, epoch=epoch, device=device)
    checkpoints.save_networks(output_dir, session.nets)
    if verbose:
        for name, group in session.nets.named_groups():
            if len(group):
                echo(f'serialized net {name}')
    for fn in ('train_opt.txt', 'config.json'):
        src = os.path.join(model_dir, fn)
        if os.path.exists(src) and (os.path.abspath(model_dir)
                                    != os.path.abspath(output_dir)):
            shutil.copy(src, os.path.join(output_dir, fn))
    echo(f'serialized networks -> {output_dir}')
    if not do_verify:
        return None
    size = tile_size or getattr(session.opt, 'scale_size', 512)
    nc = 3 * getattr(session.opt, 'input_no', 1)
    rng = np.random.default_rng(0)
    tile = rng.integers(0, 255, (1, size, size, nc), np.uint8)
    reloaded = InferenceSession(output_dir, device=device)
    out1 = session.run_tiles(tile)
    out2 = reloaded.run_tiles(tile)
    diff = sum(float(np.abs(out1[k].astype(np.int64)
                            - out2[k].astype(np.int64)).sum()) for k in out1)
    if diff > 10:
        raise AssertionError(f'serialized-vs-original parity failed: {diff}')
    echo(f'parity check passed (sum|diff| = {diff:.1f} <= 10)')
    return diff


def _resolve_wsi_tile_size(tile_size, input_dir, filename, echo=print):
    """The tile size from the slide's objective magnification when
    --tile-size is omitted (reference get_wsi_resolution,
    models/__init__.py:730-782); 512 (40x) without metadata."""
    if tile_size is not None:
        return tile_size
    from .utils.wsi import get_wsi_resolution
    detected = get_wsi_resolution(os.path.join(input_dir, filename))
    if detected:
        echo(f'tile size {detected} from slide magnification metadata')
        return detected
    echo('no magnification metadata; using tile size 512 (40x)')
    return 512


def make_cli():
    import click

    @click.group()
    def cli():
        """DeepLIIF on PyTorch and CUDA (port of deepliif-tpu)."""

    @cli.command()
    @click.option('--input-dir', default='./Sample_Large_Tissues/',
                  help='reads images from here')
    @click.option('--output-dir', help='saves results here')
    @click.option('--tile-size', type=click.IntRange(min=1), required=True)
    @click.option('--model-dir', default='./model-server/DeepLIIF_Latest_Model/')
    @click.option('--filename-pattern', default='*')
    @click.option('--eager-mode', is_flag=True,
                  help='kept for CLI parity; there is one eager path')
    @click.option('--epoch', default='latest')
    @click.option('--seg-intermediate', is_flag=True)
    @click.option('--seg-only', is_flag=True)
    @click.option('--mod-only', is_flag=True)
    @click.option('--color-dapi', is_flag=True)
    @click.option('--color-marker', is_flag=True)
    @click.option('--btoa', '--BtoA', 'btoa', is_flag=True)
    @click.option('--max-batch', default=None, type=int,
                  help='tile-batch bucket cap (default 16, measured on '
                       'one H100: models.DEFAULT_MAX_BATCH)')
    @click.option('--precision', default=None,
                  type=click.Choice(['float32', 'bfloat16', 'int8']),
                  help='override the model dir compute precision; int8 '
                       'runs the convs with >= 16 channels in and out on '
                       'the int8 kernels, calibrating static scales on the '
                       'first tiles into act_scales.json')
    @click.option('--int8-scope', default=None,
                  type=click.Choice(['all', 'resblocks']),
                  help='which convs --precision int8 quantizes: all '
                       '(default) or resblocks only, the fused-kernel '
                       'trunk path that keeps every other conv in bf16')
    @click.option('--device-quant', type=click.Choice(['auto', 'on', 'off']),
                  default='auto', is_flag=False, flag_value='on',
                  help='quantification engine: on = labeling, thresholds '
                       'and overlays on the session\'s device (the CUDA '
                       'labeling kernel on a card), off = host path, auto = '
                       'device when the seg canvas is on a CUDA device, '
                       'at least 256x256 (the crossover measured on one '
                       'H100) and fits the card '
                       '(models._resolve_device_quant). The '
                       'device counts equal the host\'s up to 16384 cells; '
                       'past that its default size threshold comes from '
                       'the 16384 largest cells, as in the JAX package, '
                       'and can differ. Bare --device-quant means on.')
    @click.option('--gpu-ids', default=None, help='ignored (torch compat)')
    @click.option('--device', default='cuda',
                  help='torch device to run on, e.g. cuda, cuda:1 or cpu')
    @click.option('--fuse-stages', is_flag=True, default=None,
                  help='run the translators\' fused stages (the hand '
                       'kernels for the down convs and up conv-transposes); '
                       'needs --precision bfloat16')
    def test(input_dir, output_dir, tile_size, model_dir, filename_pattern,
             eager_mode, epoch, seg_intermediate, seg_only, mod_only,
             color_dapi, color_marker, btoa, max_batch, precision, int8_scope,
             device_quant, gpu_ids, device, fuse_stages):
        """Run tiled inference + quantification over a directory of images."""
        run_test(input_dir, output_dir, tile_size, model_dir, filename_pattern,
                 epoch, seg_intermediate, seg_only, mod_only, btoa, max_batch,
                 precision, int8_scope, device_quant, device,
                 fuse_stages=fuse_stages, echo=click.echo)

    @cli.command()
    @click.option('--model-dir', default='./model-server/DeepLIIF_Latest_Model/',
                  help='reads models from here')
    @click.option('--output-dir', help='saves results here', default=None)
    @click.option('--verify/--no-verify', 'do_verify', default=True,
                  help='run the eager-vs-serialized parity check')
    @click.option('--epoch', default='latest',
                  help='checkpoint suffix to serialize (reference --epoch)')
    @click.option('--tile-size', default=None, type=int,
                  help='parity-check tile size (default: model scale_size)')
    @click.option('--device', default='cuda',
                  help='torch device of both parity sessions, e.g. cuda or '
                       'cpu')
    @click.option('--verbose', is_flag=True, help='print serialized net names')
    def serialize(model_dir, output_dir, do_verify, epoch, tile_size, device,
                  verbose):
        """Convert a model dir (torch or native) to the native npz artifact.

        Parity contract as the reference serialize (cli.py:763-830): the
        serialized model's output on a random tile must match the source
        within sum|diff| <= 10 over the uint8 outputs.
        """
        run_serialize(model_dir, output_dir, do_verify, epoch, tile_size,
                      device, verbose, echo=click.echo)

    @cli.command()
    @click.option('--model-dir', required=True, help='model directory to serve')
    @click.option('--host', default='0.0.0.0')
    @click.option('--port', default=8080, type=int)
    @click.option('--max-batch', default=None, type=int,
                  help='tile-batch cap of a device call (default 16, '
                       'models.DEFAULT_MAX_BATCH)')
    @click.option('--precision', default=None,
                  type=click.Choice(['float32', 'bfloat16', 'int8']),
                  help='override the model dir compute precision')
    @click.option('--int8-scope', default=None,
                  type=click.Choice(['all', 'resblocks']),
                  help='which convs --precision int8 quantizes (see `test`)')
    @click.option('--max-image-dim', default=4096, type=int,
                  help='reject larger request images with 400 (the reference '
                       'cloud client bound, DeepliifClient.java:23-24); larger '
                       'inputs belong on test-wsi')
    @click.option('--request-timeout', default=60.0, type=float,
                  help='per-request budget in seconds -> 504 (the reference '
                       'cloud contract, README.md:406); 0 disables')
    @click.option('--device', default='cuda',
                  help='torch device to run on, e.g. cuda, cuda:1 or cpu')
    @click.option('--fuse-stages', is_flag=True, default=None,
                  help='run the translators\' fused stages; needs '
                       '--precision bfloat16')
    def serve(model_dir, host, port, max_batch, precision, int8_scope,
              max_image_dim, request_timeout, device, fuse_stages):
        """Run the REST API server (POST /api/infer, /api/postprocess) —
        the reference cloud contract, so the ImageJ plugin works unchanged."""
        from .config import get_opt
        from .serve import serve as run_server
        int8 = int8_options(os.environ, precision or getattr(
            get_opt(model_dir, mode='test'), 'precision', None))
        run_server(model_dir, host, port, max_batch, precision=precision,
                   max_image_dim=max_image_dim,
                   request_timeout=request_timeout or None, device=device,
                   int8_scope=int8_scope, fuse_stages=fuse_stages, **int8)

    @cli.command(name='test-wsi')
    @click.option('--input-dir', required=True)
    @click.option('--filename', required=True)
    @click.option('--output-dir', required=True)
    @click.option('--tile-size', type=click.IntRange(min=1), default=None,
                  help='default: from slide magnification metadata, else 512')
    @click.option('--model-dir', default='./model-server/DeepLIIF_Latest_Model/')
    @click.option('--region-size', default=20000, type=int)
    @click.option('--seg-intermediate', is_flag=True)
    @click.option('--seg-only', is_flag=True)
    @click.option('--color-dapi', is_flag=True,
                  help='color the DAPI modality (reference test_wsi flag)')
    @click.option('--color-marker', is_flag=True,
                  help='color the marker modality (reference test_wsi flag)')
    @click.option('--device', default='cuda',
                  help='torch device to run on, e.g. cuda, cuda:1 or cpu')
    def test_wsi(input_dir, filename, output_dir, tile_size, model_dir,
                 region_size, seg_intermediate, seg_only, color_dapi,
                 color_marker, device):
        """Whole-slide inference: region streaming + stitched pyramid
        output."""
        from .utils.wsi import infer_results_for_wsi
        tile_size = _resolve_wsi_tile_size(tile_size, input_dir, filename,
                                           echo=click.echo)
        infer_results_for_wsi(input_dir, filename, output_dir, model_dir,
                              tile_size, region_size, seg_only=seg_only,
                              seg_intermediate=seg_intermediate,
                              color_dapi=color_dapi,
                              color_marker=color_marker, device=device)

    @cli.command(name='wsi-cells')
    @click.option('--input-dir', required=True)
    @click.option('--filename', required=True)
    @click.option('--output-dir', required=True)
    @click.option('--tile-size', type=click.IntRange(min=1), default=None,
                  help='default: from slide magnification metadata, else 512')
    @click.option('--model-dir', default='./model-server/DeepLIIF_Latest_Model/')
    @click.option('--region-size', default=20000, type=int)
    @click.option('--version', default='4',
                  type=click.Choice(['3', '4', '5', '6']))
    @click.option('--device', default='cuda',
                  help='torch device to run on, e.g. cuda, cuda:1 or cpu')
    def wsi_cells(input_dir, filename, output_dir, tile_size, model_dir,
                  region_size, version, device):
        """Per-cell encoded data for a WSI (global coordinates, averaged
        auto-thresholds) — the reference infer_cells_for_wsi path."""
        from .utils.wsi import infer_cells_for_wsi
        tile_size = _resolve_wsi_tile_size(tile_size, input_dir, filename,
                                           echo=click.echo)
        results = infer_cells_for_wsi(input_dir, filename, output_dir,
                                      model_dir, tile_size, region_size,
                                      version=int(version), device=device)
        click.echo(f'{len(results["cells"])} cells -> {output_dir}')

    return cli


def main():
    make_cli()()


if __name__ == '__main__':
    main()
