"""Command-line interface of the PyTorch port: ``deepliif-tpu-torch test``.

Same options, output file names and scoring JSON as ``deepliif-tpu test``
(deepliif_tpu/cli.py), plus ``--device`` (default cuda).
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
The other commands are not ported yet (ROADMAP.md: "Serving", "WSI",
"Training", "Stats"). click is imported when the command line is built,
not when this module is imported.

    python -m deepliif_tpu_torch.cli test --input-dir imgs --tile-size 512 \\
        --model-dir model --output-dir out --device cuda --precision int8
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
    from . import roadmap
    from .config import get_opt, print_options
    from .models import infer_modalities

    if mod_only:
        seg_only = seg_intermediate = False
    elif seg_intermediate and seg_only:
        seg_intermediate = False
    if seg_only:
        raise roadmap.not_ported('--seg-only', roadmap.SEG_ONLY)
    if seg_intermediate:
        raise roadmap.not_ported('--seg-intermediate', roadmap.SEG_ONLY)

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
            img, tile_size, model_dir, opt=opt, mod_only=mod_only,
            seg_weights=seg_weights, max_batch=max_batch,
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

    return cli


def main():
    make_cli()()


if __name__ == '__main__':
    main()
