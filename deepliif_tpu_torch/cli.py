"""Command-line interface of the PyTorch port: ``deepliif-tpu-torch train``,
``test``, ``serialize``, ``serve``, ``test-wsi``, ``wsi-cells``, ``eval``,
``prepare-training-data``, ``prepare-testing-data``, ``register`` and
``visualize``.

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
NotImplementedError (ROADMAP.md, "WSI"). ``train`` trains a model of any
family (DeepLIIF, DeepLIIFExt, SDG, CycleGAN, DeepLIIFKD) at float32 on
one device (``train_loop``) with the JAX command's options, names and
defaults: the card unless ``--device cpu``, one ``--gpu-ids`` entry picks
the card, background colors inferred from the train dir; bfloat16,
spectral norm, the attention U-Net, orbax checkpoints and several cards
raise NotImplementedError ("Training"), as does
``trainlaunch`` (``compute-statistics``: "Stats"). ``eval`` runs the A
tile of each aligned row through the engine (``--device``, default cuda)
and writes the images and an HTML gallery; ``prepare-training-data``,
``prepare-testing-data``, ``register`` and ``visualize`` are the JAX
package's host-only commands. click is imported when the command line is
built, not when this module is imported.

    python -m deepliif_tpu_torch.cli train --dataroot data --name run \\
        --batch-size 2 --device cuda
    python -m deepliif_tpu_torch.cli test --input-dir imgs --tile-size 512 \\
        --model-dir model --output-dir out --device cuda --precision int8
    python -m deepliif_tpu_torch.cli serve --model-dir model --port 8080
    python -m deepliif_tpu_torch.cli test-wsi --input-dir slides \\
        --filename slide.svs --output-dir out --model-dir model
"""

from __future__ import annotations

import copy
import glob
import json
import os

from . import roadmap


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


# torch-compat and display flags of the JAX ``train`` that change nothing
_IGNORED_TRAIN_FLAGS = ('display_server', 'display_port', 'display_env',
                        'display_id', 'display_ncols', 'display_winsize',
                        'update_html_freq', 'local_rank')

# the JAX package's commands that the port does not run yet, by ROADMAP item
_NOT_PORTED_COMMANDS = {'trainlaunch': roadmap.TRAINING,
                        'compute-statistics': roadmap.STATS}


def ensure_exists(d):
    os.makedirs(d, exist_ok=True)


def run_eval(dataroot, model_dir, phase='test', output_dir=None,
             num_test=50, seg_weights='', device='cuda', echo=print):
    """``eval`` (deepliif_tpu/cli.py:436-486, the reference's legacy
    test.py): the A tile of each of the first ``num_test`` aligned rows of
    ``dataroot/phase`` through the session's ``run_tiles``; real_A and
    fake_B_* images written by ``save_images`` (GS as fake_B_5), then an
    index.html gallery. Returns the output dir."""
    import numpy as np
    from .config import get_opt
    from .data.aligned import AlignedDataset
    from .models import init_nets
    from .utils.visualizer import save_images

    opt = copy.copy(get_opt(model_dir, mode='test'))   # get_opt is cached
    opt.dataroot = dataroot
    opt.preprocess = 'none'
    opt.no_flip = True
    weights = ([float(x) for x in seg_weights.split(',')] if seg_weights
               else None)
    session = init_nets(model_dir, device=device)
    output_dir = output_dir or os.path.join(model_dir, f'eval_{phase}')
    ensure_exists(output_dir)

    ds = AlignedDataset(opt, phase=phase)
    n = min(num_test, len(ds))
    for i in range(n):
        item = ds[i]
        a_u8 = ((item['A'] + 1) * 127.5).astype(np.uint8)[None]
        res = session.run_tiles(a_u8, seg_weights=weights)
        visuals = {'real_A': a_u8[0]}
        for k, v in res.items():
            visuals['fake_B_5' if k == 'GS' else f'fake_B_{k[1:]}'] = v[0]
        save_images(output_dir, visuals, item['A_paths'])
        echo(f'processed {os.path.basename(item["A_paths"])}')
    files = sorted(os.listdir(output_dir))
    rows = ''.join(f'<div style="display:inline-block;margin:4px;'
                   f'text-align:center"><img src="{f}" width="200"/>'
                   f'<br/>{f}</div>' for f in files if f.endswith('.png'))
    with open(os.path.join(output_dir, 'index.html'), 'w') as f:
        f.write(f'<html><body><h1>eval {phase}</h1>{rows}</body></html>')
    echo(f'wrote {n} results to {output_dir}')
    return output_dir


def run_prepare_training_data(input_dir, output_dir, validation_ratio=0.2,
                              seed=0, echo=print):
    """``prepare-training-data`` (deepliif_tpu/cli.py:554-584): each IHC
    image and its Hematoxylin, DAPI, Lap2, Marker and Seg files resized to
    512^2 and side by side in one row, into train/ or val/ by a seeded
    draw."""
    import random

    import numpy as np
    from PIL import Image
    rng = random.Random(seed)
    train_dir = os.path.join(output_dir, 'train')
    val_dir = os.path.join(output_dir, 'val')
    ensure_exists(train_dir)
    ensure_exists(val_dir)
    stains = ['IHC', 'Hematoxylin', 'DAPI', 'Lap2', 'Marker', 'Seg']
    n = 0
    for img in sorted(os.listdir(input_dir)):
        if 'IHC' not in img:
            continue
        tiles = []
        for stain in stains:
            p = os.path.join(input_dir, img.replace('IHC', stain))
            tiles.append(np.asarray(
                Image.open(p).convert('RGB').resize((512, 512), Image.BICUBIC)))
        row = np.concatenate(tiles, axis=1)
        save_dir = val_dir if rng.random() < validation_ratio else train_dir
        Image.fromarray(row).save(os.path.join(save_dir, img))
        n += 1
    echo(f'wrote {n} training rows')


def run_prepare_testing_data(input_dir, dataset_dir, echo=print):
    """``prepare-testing-data`` (deepliif_tpu/cli.py:587-604): each IHC
    image resized to 512^2 and repeated six times in one test row."""
    import numpy as np
    from PIL import Image
    test_dir = os.path.join(dataset_dir, 'test')
    ensure_exists(test_dir)
    n = 0
    for img in sorted(os.listdir(input_dir)):
        if 'IHC' not in img:
            continue
        a = np.asarray(Image.open(os.path.join(input_dir, img))
                       .convert('RGB').resize((512, 512), Image.BICUBIC))
        Image.fromarray(np.concatenate([a] * 6, axis=1)).save(
            os.path.join(test_dir, img))
        n += 1
    echo(f'wrote {n} test rows')


def run_register(fixed, moving, output, translate=None, scale=1.0, rotate=0.0,
                 echo=print):
    """``register`` (deepliif_tpu/cli.py:709-743): the moving image
    aligned onto the fixed one, by FFT phase correlation or by the manual
    transform; echoes the transform as JSON and returns it."""
    from PIL import Image
    from .utils.registration import apply_affine, register_pair
    fixed_img = Image.open(fixed).convert('RGB')
    moving_img = Image.open(moving).convert('RGB')
    if translate is None and scale == 1.0 and rotate == 0.0:
        aligned, info = register_pair(fixed_img, moving_img)
    else:
        dx, dy = (0, 0)
        if translate is not None:
            dx, dy = (int(v) for v in translate.split(','))
        aligned = apply_affine(moving_img, translate=(dx, dy), scale=scale,
                               rotate_deg=rotate, output_size=fixed_img.size)
        info = {'dx': dx, 'dy': dy, 'scale': scale, 'rotate_deg': rotate}
    ensure_exists(os.path.dirname(os.path.abspath(output)))
    aligned.save(output)
    echo(json.dumps(info))
    return info


def run_visualize(pickle_dir, echo=print):
    """``visualize`` (deepliif_tpu/cli.py:745-785): polls the training
    loop's pickled snapshots every 3 s until interrupted; each new loss
    record is appended to live_losses.json, each new image snapshot
    replayed into a PNG and HTML gallery under web/."""
    import pickle
    import time
    path_plot = os.path.join(pickle_dir, 'plot_current_losses.pickle')
    path_disp = os.path.join(pickle_dir, 'display_current_results.pickle')
    echo(f'watching {pickle_dir} (ctrl-c to stop)')
    mtimes = {path_plot: 0, path_disp: 0}
    history = []
    while True:
        try:
            if os.path.exists(path_plot):
                mtime = os.path.getmtime(path_plot)
                if mtime > mtimes[path_plot]:
                    mtimes[path_plot] = mtime
                    with open(path_plot, 'rb') as f:
                        rec = pickle.load(f)
                    history.append(rec)
                    out = os.path.join(pickle_dir, 'live_losses.json')
                    with open(out, 'w') as f:
                        json.dump(history, f)
                    echo(f'update @ x={rec["x"]:.3f}: ' + ' '.join(
                        f'{k}={v:.3f}' for k, v in rec['losses'].items()))
            if os.path.exists(path_disp):
                mtime = os.path.getmtime(path_disp)
                if mtime > mtimes[path_disp]:
                    mtimes[path_disp] = mtime
                    with open(path_disp, 'rb') as f:
                        disp = pickle.load(f)
                    replay_display_snapshot(pickle_dir, disp)
                    echo(f'image grid @ epoch {disp.get("epoch")}: '
                         + ', '.join(disp.get('visuals', {})))
            time.sleep(3)
        except KeyboardInterrupt:
            break


def replay_display_snapshot(pickle_dir, disp):
    """Write a display_current_results snapshot as PNGs + HTML gallery
    (deepliif_tpu/cli.py:788-805)."""
    import numpy as np
    from PIL import Image
    web = os.path.join(pickle_dir, 'web')
    img_dir = os.path.join(web, 'images')
    ensure_exists(img_dir)
    epoch = disp.get('epoch', 0)
    for label, arr in disp.get('visuals', {}).items():
        Image.fromarray(np.asarray(arr)).save(
            os.path.join(img_dir, f'epoch{epoch:03d}_{label}.png'))
    files = sorted(os.listdir(img_dir), reverse=True)
    rows = ''.join(
        f'<div style="display:inline-block;margin:4px;text-align:center">'
        f'<img src="images/{f}" width="256"/><br/>{f}</div>'
        for f in files[:200])
    with open(os.path.join(web, 'index.html'), 'w') as f:
        f.write(f'<html><body><h1>replay</h1>{rows}</body></html>')


def train_device(device, gpu_ids):
    """The torch device of ``train``: ``device`` (default cuda), where one
    ``--gpu-ids`` entry N makes it cuda:N. Several ids raise
    NotImplementedError ("Training"), anything else (a negative or
    non-integer id, ids beside a CPU device) ValueError."""
    device = device or 'cuda'
    if gpu_ids is None or str(gpu_ids).strip() == '':
        return device
    ids = [s.strip() for s in str(gpu_ids).split(',') if s.strip()]
    if not all(i.isdigit() for i in ids):
        raise ValueError(f'--gpu-ids takes card numbers, got {gpu_ids!r} '
                         '(train on the CPU with --device cpu)')
    if len(ids) > 1:
        raise roadmap.not_ported(f'training on {len(ids)} cards (--gpu-ids '
                                 f'{gpu_ids})', roadmap.TRAINING)
    if not device.startswith('cuda'):
        raise ValueError(f'--gpu-ids {gpu_ids} picks a card, but --device is '
                         f'{device}')
    return f'cuda:{ids[0]}'


def train_options(kwargs, echo=print):
    """The training ``Options`` from the ``train`` command's arguments, as
    the JAX command builds them (weights, names, dataset mode, the inferred
    background colors), plus ``device``."""
    from .config import Options, TRAIN_DEFAULTS

    d_params = dict(TRAIN_DEFAULTS)
    d_params.update({k: v for k, v in kwargs.items() if v is not None})
    m = d_params['modalities_no']
    model = d_params['model']
    for ignored in _IGNORED_TRAIN_FLAGS:
        if d_params.pop(ignored, None) is not None:
            echo(f'note: --{ignored.replace("_", "-")} is ignored')
    d_params['device'] = train_device(d_params.get('device'),
                                      d_params.pop('gpu_ids', None))
    lr = d_params.pop('lr', None)
    if lr is not None:
        d_params['lr_g'] = d_params['lr_d'] = lr
    d_params['n_layers_D'] = d_params.pop('n_layers_d', 4)
    names = d_params.pop('modalities_names', None)
    if names:
        d_params['modalities_names'] = [s.strip() for s in names.split(',')]
    load_iter = d_params.pop('load_iter', 0)
    if load_iter:
        d_params['epoch'] = f'iter_{load_iter}'
        d_params['continue_train'] = True

    def default_weights(default):
        if model in ('DeepLIIF', 'DeepLIIFKD') and m == 4:
            return default
        if model in ('DeepLIIF', 'DeepLIIFKD'):
            return [1 / (m + 1)] * (m + 1)
        return [1 / m] * m

    for key, default in (('seg_weights', [0.25, 0.15, 0.25, 0.1, 0.25]),
                         ('loss_weights_g', [0.2] * 5),
                         ('loss_weights_d', [0.2] * 5)):
        val = d_params.get(key, '')
        d_params[key] = ([float(x) for x in val.split(',')] if val
                         else default_weights(default))
    d_params['loss_G_weights'] = d_params.pop('loss_weights_g')
    d_params['loss_D_weights'] = d_params.pop('loss_weights_d')
    d_params['netG'] = d_params['net_g']
    d_params['netD'] = d_params['net_d']
    d_params['phase'] = 'train'
    if not d_params.get('dataset_mode'):
        d_params['dataset_mode'] = ('unaligned' if model == 'CycleGAN'
                                    else 'aligned')

    # per-modality background colors from empty training tiles (reference
    # cli.py:326-331), used by the inference empty-tile fill
    if model in ('DeepLIIF', 'DeepLIIFKD', 'DeepLIIFExt'):
        from .utils.background import infer_background_colors
        train_dir = os.path.join(d_params['dataroot'], 'train')
        if os.path.isdir(train_dir):
            colors = infer_background_colors(
                train_dir, input_no=d_params.get('input_no', 1),
                modalities_no=m, seg_no=d_params.get('seg_no', 1),
                return_list=True)
            if colors is not None:
                d_params['background_colors'] = colors
    return Options(d_params=d_params, mode='train')


def run_train(kwargs, echo=print):
    """``train``: the options, printed, then ``train_loop.train_model``;
    returns its (state, metrics)."""
    from .config import print_options
    from .train_loop import check_trainable, train_model

    opt = train_options(kwargs, echo)
    check_trainable(opt)
    print_options(opt)
    return train_model(opt)


def make_cli():
    import click

    @click.group()
    def cli():
        """DeepLIIF on PyTorch and CUDA (port of deepliif-tpu)."""

    _train_command(cli, click)
    for name, item in _NOT_PORTED_COMMANDS.items():
        _not_ported_command(cli, click, name, item)

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

    _host_commands(cli, click)
    return cli


def _host_commands(cli, click):
    """``eval``, ``prepare-training-data``, ``prepare-testing-data``,
    ``register`` and ``visualize``, with the JAX commands' options
    (``eval`` also ``--device``)."""
    @cli.command(name='eval')
    @click.option('--dataroot', required=True,
                  help='dataset root containing the phase subfolder of '
                       'aligned rows')
    @click.option('--model-dir', required=True)
    @click.option('--phase', default='test')
    @click.option('--output-dir', default=None,
                  help='default: <model-dir>/eval_<phase>')
    @click.option('--num-test', default=50, type=int,
                  help='how many rows to process')
    @click.option('--seg-weights', default='',
                  help='comma-separated; default: training weights')
    @click.option('--device', default='cuda',
                  help='torch device to run on, e.g. cuda, cuda:1 or cpu')
    def eval_dataset(dataroot, model_dir, phase, output_dir, num_test,
                     seg_weights, device):
        """Dataset-driven eval over aligned rows: runs the generator
        ensemble on the A tile of each row and writes real_A / fake_B_*
        images + an HTML gallery."""
        run_eval(dataroot, model_dir, phase, output_dir, num_test,
                 seg_weights, device, echo=click.echo)

    @cli.command(name='prepare-training-data')
    @click.option('--input-dir', required=True, help='path to input images')
    @click.option('--output-dir', required=True, help='path to output images')
    @click.option('--validation-ratio', default=0.2, type=float)
    @click.option('--seed', default=0, type=int)
    def prepare_training_data(input_dir, output_dir, validation_ratio, seed):
        """Stitch paired stains (IHC/Hematoxylin/DAPI/Lap2/Marker/Seg) into
        training rows and split train/val."""
        run_prepare_training_data(input_dir, output_dir, validation_ratio,
                                  seed, echo=click.echo)

    @cli.command(name='prepare-testing-data')
    @click.option('--input-dir', required=True, help='path to input images')
    @click.option('--dataset-dir', required=True,
                  help='path to output dataset directory')
    def prepare_testing_data(input_dir, dataset_dir):
        """Stitch IHC-only test rows."""
        run_prepare_testing_data(input_dir, dataset_dir, echo=click.echo)

    @cli.command()
    @click.option('--fixed', required=True,
                  help='reference image the moving image is aligned to (IHC)')
    @click.option('--moving', required=True,
                  help='image to align (mpIF); resampled onto the fixed frame')
    @click.option('--output', required=True,
                  help='path for the aligned image')
    @click.option('--translate', default=None,
                  help='manual dx,dy (skips auto estimation)')
    @click.option('--scale', default=1.0, type=float,
                  help='manual scale factor')
    @click.option('--rotate', default=0.0, type=float,
                  help='manual rotation, degrees')
    def register(fixed, moving, output, translate, scale, rotate):
        """Co-register an IHC/mpIF image pair; prints the applied
        transform as JSON."""
        run_register(fixed, moving, output, translate, scale, rotate,
                     echo=click.echo)

    @cli.command()
    @click.option('--pickle-dir', required=True,
                  help='directory where the pickled snapshots are stored')
    @click.option('--display-env', default=None, help='ignored (no visdom)')
    def visualize(pickle_dir, display_env):
        """Poll pickled training snapshots and regenerate the loss history
        (JSON) and the image gallery under <pickle-dir>/web/."""
        run_visualize(pickle_dir, echo=click.echo)


def _not_ported_command(cli, click, name, item):
    @cli.command(name=name, add_help_option=False,
                 help=f'Not ported yet (ROADMAP.md, "{item}").',
                 context_settings=dict(ignore_unknown_options=True,
                                       allow_extra_args=True))
    def command():
        raise roadmap.not_ported(f'the {name} command', item)


def _train_command(cli, click):
    """``train``, with the options of the JAX package's command
    (deepliif_tpu/cli.py:51-152) and ``--device``."""
    options = [
        ('--dataroot', dict(required=True, help='path to images (should have subfolders train, val, etc.)')),
        ('--name', dict(default='experiment_name', help='name of the experiment, where to store samples and models')),
        ('--checkpoints-dir', dict(default='./checkpoints', help='models are saved here')),
        ('--model', dict(default='DeepLIIF', type=click.Choice(['DeepLIIF', 'DeepLIIFExt', 'SDG', 'CycleGAN', 'DeepLIIFKD']),
                         help='the model family to train (DeepLIIFKD needs --model-dir-teacher)')),
        ('--modalities-no', dict(default=4, type=int, help='number of targets')),
        ('--input-no', dict(default=1, type=int, help='number of input modalities (SDG multi-input)')),
        ('--seg-no', dict(default=1, type=int, help='number of seg tiles per row')),
        ('--seg-gen', dict(default=True, type=bool, help='enable segmentation generators')),
        ('--net-g', dict(default='resnet_9blocks', help='generator architecture')),
        ('--net-gs', dict(default='unet_512', help='segmentation generator architecture')),
        ('--net-d', dict(default='n_layers', help='discriminator architecture')),
        ('--ngf', dict(default=64, type=int)),
        ('--ndf', dict(default=64, type=int)),
        ('--norm', dict(default='batch', help='batch | instance | none (spectral raises)')),
        ('--no-dropout', dict(is_flag=True)),
        ('--padding', dict(default='zero', help='reflect | replicate | zero')),
        ('--upsample', dict(default='convtranspose', help='convtranspose | resize_conv | pixel_shuffle')),
        ('--batch-size', dict(default=1, type=int)),
        ('--load-size', dict(default=512, type=int)),
        ('--crop-size', dict(default=512, type=int)),
        ('--scale-size', dict(default=512, type=int)),
        ('--preprocess', dict(default='resize_and_crop')),
        ('--no-flip', dict(is_flag=True)),
        ('--gan-mode', dict(default='vanilla', help='vanilla | lsgan | wgangp')),
        ('--gan-mode-s', dict(default='lsgan', help='GAN mode for seg branch')),
        ('--optimizer', dict(default='adam', help='adam | adamw | sgd | rmsprop | adagrad (optax semantics)')),
        ('--beta1', dict(default=0.5, type=float)),
        ('--lr-g', dict(default=0.0002, type=float)),
        ('--lr-d', dict(default=0.0002, type=float)),
        ('--lr-policy', dict(default='linear', help='linear | step | cosine | plateau')),
        ('--lr-decay-iters', dict(default=50, type=int)),
        ('--n-epochs', dict(default=100, type=int)),
        ('--n-epochs-decay', dict(default=100, type=int)),
        ('--epoch-count', dict(default=1, type=int)),
        ('--continue-train', dict(is_flag=True)),
        ('--epoch', dict(default='latest')),
        ('--seg-weights', dict(default='', help='comma-separated seg weights')),
        ('--loss-weights-g', dict(default='', help='comma-separated G loss weights')),
        ('--loss-weights-d', dict(default='', help='comma-separated D loss weights')),
        ('--seed', dict(default=None, type=int)),
        ('--with-val', dict(is_flag=True, help='compute val losses + cell count metrics')),
        ('--print-freq', dict(default=100, type=int)),
        ('--display-freq', dict(default=400, type=int)),
        ('--save-latest-freq', dict(default=500, type=int)),
        ('--save-by-iter', dict(is_flag=True, help='save iter_<N> snapshots instead of overwriting latest')),
        ('--save-epoch-freq', dict(default=100, type=int)),
        ('--max-dataset-size', dict(default=None, type=int)),
        ('--precision', dict(default='float32', type=click.Choice(['float32', 'bfloat16']),
                             help='float32 trains; bfloat16 raises NotImplementedError')),
        ('--remote', dict(default=False, type=bool, help='pickle plot snapshots for `visualize`')),
        ('--remote-transfer-cmd', dict(default=None, help='module.function invoked with each saved checkpoint path')),
        ('--model-dir-teacher', dict(default=None, help='teacher model dir (DeepLIIFKD)')),
        ('--pool-size', dict(default=50, type=int, help='CycleGAN image pool size')),
        ('--lr', dict(default=None, type=float, help='sets both --lr-g and --lr-d (reference single-lr flag)')),
        ('--init-type', dict(default='normal', help='normal | xavier | kaiming | orthogonal')),
        ('--init-gain', dict(default=0.02, type=float)),
        ('--n-layers-d', dict(default=4, type=int, help='PatchGAN depth (reference n_layers_D)')),
        ('--net-ds', dict(default='n_layers', help='Ext seg discriminator architecture')),
        ('--input-nc', dict(default=3, type=int)),
        ('--output-nc', dict(default=3, type=int)),
        ('--label-smoothing', dict(default=0.0, type=float, help='CycleGAN GAN-loss label smoothing')),
        ('--modalities-names', dict(default=None, help='comma-separated modality names')),
        ('--num-threads', dict(default=2, type=int, help='loader prefetch depth')),
        ('--serial-batches', dict(is_flag=True)),
        ('--dataset-mode', dict(default=None, help='aligned (paired rows) | unaligned (CycleGAN: trainA, trainB1..) | single (one-sided images); default unaligned for CycleGAN, else aligned')),
        ('--direction', dict(default='AtoB', help='CycleGAN direction')),
        ('--debug', dict(is_flag=True, help='cap each epoch at --debug-data-size iterations')),
        ('--debug-data-size', dict(default=10, type=int)),
        ('--verbose', dict(is_flag=True, help='print parameter counts per net')),
        ('--load-iter', dict(default=0, type=int, help='resume from the iter_<N> checkpoint (with --save-by-iter)')),
        ('--gpu-ids', dict(default=None, help='one card number: train on cuda:<n> (several raise NotImplementedError)')),
        ('--display-server', dict(default=None, help='ignored (no visdom)')),
        ('--display-port', dict(default=None, help='ignored (no visdom)')),
        ('--display-env', dict(default=None, help='ignored (no visdom)')),
        ('--display-id', dict(default=None, help='ignored (no visdom)')),
        ('--display-ncols', dict(default=None, help='ignored (no visdom)')),
        ('--display-winsize', dict(default=None, help='ignored (no visdom)')),
        ('--no-html', dict(is_flag=True, help='skip HTML epoch galleries')),
        ('--update-html-freq', dict(default=None, type=int, help='ignored (galleries follow --display-freq)')),
        ('--local-rank', dict(default=None, help='ignored (torch DDP compat)')),
        ('--checkpoint-format', dict(default='npz', type=click.Choice(['npz', 'orbax']),
                                     help='npz (orbax raises NotImplementedError)')),
        ('--monitor-image', dict(default=None, help='only display visuals for rows whose path ends with this')),
        ('--device', dict(default='cuda', help='torch device to train on, e.g. cuda, cuda:1 or cpu')),
    ]

    def train(**kwargs):
        """Train a model of any family at float32 on one device."""
        run_train(kwargs, echo=click.echo)

    for flag, kw in reversed(options):
        train = click.option(flag, **kw)(train)
    cli.command()(train)


def main():
    make_cli()()


if __name__ == '__main__':
    main()
