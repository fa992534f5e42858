"""Configuration system: the port's own copy of deepliif_tpu/config.py
(the port imports nothing of the JAX package).

Mirrors the behavior of the reference options package
(reference deepliif/options/__init__.py:8-217) with two deliberate
changes:
  * values parsed from ``train_opt.txt`` use ``ast.literal_eval`` instead of
    ``eval`` (the reference's eval of config values is a noted hazard);
  * options are held in a single ``Options`` bag that can round-trip to JSON
    as well as the reference's human-readable ``train_opt.txt`` format, so
    model directories written by either framework stay self-describing.
"""

from __future__ import annotations

import ast
import json
import os
import re
from pathlib import Path

# Training-schedule defaults follow the reference CLI (reference cli.py:94-180).
TRAIN_DEFAULTS = dict(
    model='DeepLIIF',
    modalities_no=4,
    seg_no=1,
    seg_gen=True,
    input_no=1,
    input_nc=3,
    output_nc=3,
    ngf=64,
    ndf=64,
    net_g='resnet_9blocks',
    net_gs='unet_512',
    net_d='n_layers',
    n_layers_D=4,
    norm='batch',
    init_type='normal',
    init_gain=0.02,
    no_dropout=False,
    padding='zero',
    upsample='convtranspose',
    direction='AtoB',
    batch_size=1,
    load_size=512,
    crop_size=512,
    scale_size=512,
    preprocess='resize_and_crop',
    no_flip=False,
    max_dataset_size=None,
    num_threads=4,
    serial_batches=False,
    gan_mode='vanilla',
    gan_mode_s='lsgan',
    lr=2e-4,
    lr_g=2e-4,
    lr_d=2e-4,
    beta1=0.5,
    optimizer='adam',
    lr_policy='linear',
    lr_decay_iters=50,
    n_epochs=100,
    n_epochs_decay=100,
    epoch_count=1,
    lambda_L1=100.0,
    lambda_feat=100.0,
    pool_size=50,
    dataset_mode='aligned',
    phase='train',
    is_train=True,
    continue_train=False,
    epoch='latest',
    load_iter=0,
    verbose=False,
    seed=None,
    # additions of the JAX package, kept so config files round-trip
    precision='float32',        # float32 | bfloat16 for the compute path
    mesh_shape=None,            # e.g. {'data': 8}; None = all local devices on 'data'
    checkpoint_format='npz',  # npz | orbax (orbax mirrors npz saves)
)

# Legacy modality names for the flagship 4-modality model
# (reference options/__init__.py:110-113).
DEFAULT_MODALITY_NAMES = ['IHC', 'Hema', 'DAPI', 'Lap2', 'Marker']


def _literal(val: str):
    """Parse a value string safely (reference uses eval; we use literal_eval)."""
    val = val.strip()
    try:
        return ast.literal_eval(val)
    except (ValueError, SyntaxError):
        lowered = val.lower()
        if lowered == 'true':
            return True
        if lowered == 'false':
            return False
        if lowered == 'none':
            return None
        return val


def read_model_params(file_addr):
    """Parse a reference-format ``train_opt.txt`` into a dict.

    Format (reference options/__init__.py:8-36): ``key: value [default: x]``
    lines between dashed header/footer lines; the bracketed default note is
    stripped before parsing.
    """
    with open(file_addr) as f:
        lines = f.readlines()
    param_dict = {}
    for line in lines:
        if ':' not in line:
            continue
        key = line.split(':')[0].strip()
        val = ':'.join(line.split(':')[1:])
        str_default = [x for x in re.findall(r"\[.+?\]", val) if x.startswith('[default')]
        if len(str_default) == 1:
            val = val.replace(str_default[0], '')
        elif len(str_default) > 1:
            raise ValueError(f'multiple default markers on one line: {str_default}')
        if key == 'phase':
            param_dict[key] = val.strip()
        else:
            param_dict[key] = _literal(val)
    return param_dict


class Options:
    """A bag of experiment options.

    Construct from a dict (``d_params``) or from a model-dir config file
    (``path_file``: either the reference's ``train_opt.txt`` or our
    ``config.json``). ``mode='test'`` backfills the same legacy defaults the
    reference backfills (reference options/__init__.py:69-181) so PyTorch-era
    model directories remain loadable.
    """

    def __init__(self, d_params=None, path_file=None, mode='train'):
        assert (d_params is None) != (path_file is None), \
            'provide exactly one of d_params / path_file'
        assert mode in ('train', 'test')

        if path_file:
            if str(path_file).endswith('.json'):
                with open(path_file) as f:
                    d_params = json.load(f)
            else:
                d_params = read_model_params(path_file)

        # train_opt.txt values arrive as strings and need literal parsing;
        # JSON configs are already typed — re-parsing would corrupt
        # literal-looking strings (an experiment named '2014' or 'none')
        parse_literals = path_file is not None \
            and not str(path_file).endswith('.json')
        for k, v in d_params.items():
            if parse_literals and isinstance(v, str) and k != 'phase':
                v = _literal(v)
            setattr(self, k, v)

        if not hasattr(self, 'optimizer'):
            self.optimizer = 'adam'

        if mode == 'train':
            self.is_train = True
            if hasattr(self, 'net_g') and not hasattr(self, 'netG'):
                self.netG = self.net_g
            if hasattr(self, 'net_d') and not hasattr(self, 'netD'):
                self.netD = self.net_d
            # n_layers_D / lambda_L1 / lambda_feat come from TRAIN_DEFAULTS
            # below ONLY when absent — hard assignments here clobbered the
            # CLI's --n-layers-d and lambda flags
            for k, v in TRAIN_DEFAULTS.items():
                if not hasattr(self, k):
                    setattr(self, k, v)
            if not hasattr(self, 'netG'):
                self.netG = self.net_g
            if not hasattr(self, 'netD'):
                self.netD = self.net_d
            if not hasattr(self, 'net_gs'):
                self.net_gs = 'unet_512'
        else:
            self._backfill_test_defaults(path_file)

    # -- test-mode legacy backfill (mirrors reference options/__init__.py:84-181)
    def _backfill_test_defaults(self, path_file):
        self.phase = 'test'
        self.is_train = False
        self.continue_train = False
        # the reference hardcodes these in test mode (options/__init__.py:
        # 87-90); we respect explicit config values and only backfill
        self.input_nc = getattr(self, 'input_nc', 3)
        self.output_nc = getattr(self, 'output_nc', 3)
        self.ngf = getattr(self, 'ngf', 64)
        self.norm = getattr(self, 'norm', 'batch')
        self.use_dropout = False

        if getattr(self, 'model', None) == 'CycleGAN':
            self.BtoA = getattr(self, 'BtoA', False)

        if not hasattr(self, 'modalities_no') and hasattr(self, 'targets_no'):
            self.modalities_no = self.targets_no - 1
            del self.targets_no

        if getattr(self, 'model', None) in ('DeepLIIF', 'DeepLIIFKD'):
            self.mod_id_seg, self.input_id = init_input_and_mod_id(
                self, os.path.dirname(path_file) if path_file else None)
            if getattr(self, 'seg_gen', True) is False:
                self.mod_id_seg = None
            self.input_id = int(self.input_id)

            if getattr(self, 'modalities_no', None) == 4 and not hasattr(self, 'modalities_names'):
                self.modalities_names = list(DEFAULT_MODALITY_NAMES)
                # the reference overwrites seg_weights unconditionally here
                # (options/__init__.py:110-113) — legacy 4-modality dirs
                # without modalities_names infer with IHC+Marker only
                self.seg_weights = [0.5, 0, 0, 0, 0.5]
            if not hasattr(self, 'modalities_names') or len(self.modalities_names) == 0:
                self.modalities_names = (
                    [f'input{i+1}' for i in range(getattr(self, 'input_no', 1))]
                    + [f'mod{i+1}' for i in range(self.modalities_no)])
        else:
            self.modalities_names = getattr(
                self, 'modalities_names',
                [f'mod{i}' for i in range(getattr(self, 'modalities_no', 1) + 1)])

        if not hasattr(self, 'background_colors'):
            if getattr(self, 'model', None) in ('DeepLIIF', 'DeepLIIFKD'):
                self.background_colors = [(201, 211, 208), (10, 10, 10), (0, 0, 0), (10, 10, 10)]
            else:
                self.background_colors = [(10, 10, 10)] * getattr(self, 'modalities_no', 1)

        if path_file:
            model_dir = Path(path_file).parent
            self.checkpoints_dir = str(model_dir.parent)
            self.name = str(model_dir.name)

        if isinstance(getattr(self, 'gpu_ids', None), int):
            self.gpu_ids = (self.gpu_ids,)

        if not hasattr(self, 'seg_no'):
            if self.model == 'DeepLIIF':
                self.seg_no = 1
                self.seg_gen = True
            elif self.model == 'DeepLIIFExt':
                self.seg_no = self.modalities_no if self.seg_gen else 0
            elif self.model == 'SDG':
                self.seg_no = 0
                self.seg_gen = False
            else:
                raise ValueError(f'seg_no cannot be determined for {self.model}')

        if not hasattr(self, 'input_no'):
            self.input_no = 1

        if not hasattr(self, 'scale_size'):
            if self.model in ('DeepLIIF', 'SDG'):
                self.scale_size = 512
            elif self.model == 'DeepLIIFExt':
                self.scale_size = 1024
            else:
                raise ValueError(f'scale_size cannot be determined for {self.model}')

        if not hasattr(self, 'seg_weights'):
            if self.model == 'DeepLIIF':
                self.seg_weights = [0.25, 0.15, 0.25, 0.1, 0.25]
            else:
                self.seg_weights = [1 / self.modalities_no] * self.modalities_no

        n = getattr(self, 'modalities_no', 1)
        self.loss_G_weights = getattr(self, 'loss_G_weights', [1 / n] * n)
        self.loss_D_weights = getattr(self, 'loss_D_weights', [1 / n] * n)
        self.upsample = getattr(self, 'upsample', 'convtranspose')
        self.precision = getattr(self, 'precision', 'float32')


def init_input_and_mod_id(opt, model_dir=None):
    """Determine the seg-net naming scheme.

    New checkpoints use 'S' with input index 0 (GS0..GS4); legacy pretrained
    checkpoints use '5' with input index 1 (G51..G55). Detected from
    checkpoint filenames when a model dir is given (reference
    util/util.py:208-269), else from opt, else the new scheme.
    """
    mod_id_seg = getattr(opt, 'mod_id_seg', None)
    input_id = getattr(opt, 'input_id', None)
    if mod_id_seg is not None and input_id is not None:
        return mod_id_seg, str(input_id)

    if model_dir and os.path.isdir(model_dir):
        names = os.listdir(model_dir)
        # legacy scheme: files like latest_net_G51.pth / G51.pt
        legacy = any(re.search(r'net_G5\d\.(pth|pt)$', n) or re.fullmatch(r'G5\d\.pt', n)
                     for n in names)
        new = any(re.search(r'net_GS\d\.(pth|pt)$', n) or re.fullmatch(r'GS\d\.pt', n)
                  for n in names)
        if legacy and not new:
            return '5', '1'
        if new:
            return 'S', '0'
    return ('S' if mod_id_seg is None else mod_id_seg,
            '0' if input_id is None else str(input_id))


def format_options(opt):
    message = '----------------- Options ---------------\n'
    for k, v in sorted(vars(opt).items()):
        message += '{:>25}: {:<30}\n'.format(str(k), str(v))
    message += '----------------- End -------------------'
    return message


def print_options(opt, save=False):
    message = format_options(opt)
    print(message)
    if save:
        save_options(opt)


def save_options(opt):
    """Write both the reference-compatible train_opt.txt and config.json."""
    expr_dir = os.path.join(opt.checkpoints_dir, opt.name)
    os.makedirs(expr_dir, exist_ok=True)
    phase = getattr(opt, 'phase', 'train')
    with open(os.path.join(expr_dir, f'{phase}_opt.txt'), 'wt') as f:
        f.write(format_options(opt) + '\n')
    serializable = {}
    for k, v in vars(opt).items():
        try:
            json.dumps(v)
            serializable[k] = v
        except TypeError:
            serializable[k] = str(v)
    with open(os.path.join(expr_dir, 'config.json'), 'wt') as f:
        json.dump(serializable, f, indent=2, sort_keys=True)


def get_opt(model_dir, mode='test'):
    """Load options for a model directory (train_opt.txt or config.json)."""
    txt = os.path.join(model_dir, 'train_opt.txt')
    js = os.path.join(model_dir, 'config.json')
    if os.path.exists(txt):
        return Options(path_file=txt, mode=mode)
    if os.path.exists(js):
        return Options(path_file=js, mode=mode)
    raise FileNotFoundError(f'no train_opt.txt or config.json in {model_dir}')
