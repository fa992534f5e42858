"""The port imports neither jax nor anything of the JAX package
``deepliif_tpu``, not even through an import chain: a fresh interpreter
imports the port, runs a tiny run_tiles on the CPU from a native model dir
(bfloat16, int8 and the fused translator stages too, seg-only and the seg
intermediates), the other families (DeepLIIFExt, SDG, CycleGAN) and the
attention U-Net, the host postprocess (the port's own config, tiler,
quantifier and native helper) and the device quantifier on the CPU
(``ops.labeling``, the device stitch), then answers one request on the REST
server and runs ``serialize``, ``test-wsi`` and ``wsi-cells`` through the
CLI, trains a tiny DeepLIIF model one step through the CLI's ``train``
(the losses, discriminators, VGG, optimizers, loader, visualizer and
background modules of training; the default VGG19 drawn by
``utils.jax_random``), then a tiny DeepLIIFExt, SDG, CycleGAN (its host
image pools and the unaligned loader) and DeepLIIFKD (the DeepLIIF run as
its teacher) one step each, runs ``eval``, ``prepare-training-data``,
``prepare-testing-data``, ``register`` and ``visualize`` through the CLI,
traces a call with ``utils.profiling``, and finds no ``jax``, ``jaxlib`` or
``deepliif_tpu`` / ``deepliif_tpu.*`` module loaded."""

import json
import os
import subprocess
import sys

from conftest import cpu_subprocess_env

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r'''
import json, os, sys
import numpy as np
import torch
torch.set_num_threads(1)   # beside the suite's other workers
from PIL import Image
import deepliif_tpu_torch
from deepliif_tpu_torch import cli, config, models, native, nets, postprocessing
from deepliif_tpu_torch.labs import fused_stages
from deepliif_tpu_torch.models import cyclegan, deepliif as dl
from deepliif_tpu_torch.models import deepliif_ext, family, sdg
from deepliif_tpu_torch.nets import att_unet
from deepliif_tpu_torch.ops import fused_resblock, labeling, quant
from deepliif_tpu_torch.utils import checkpoints as ck, tiler

md = sys.argv[1]
cfg = {'model': 'DeepLIIF', 'modalities_no': 1, 'netG': 'resnet_2blocks',
       'net_gs': 'unet_32', 'ngf': 32, 'padding': 'zero', 'scale_size': 64,
       'seg_weights': [0.5, 0.5], 'modalities_names': ['IHC', 'Marker']}
with open(os.path.join(md, 'config.json'), 'w') as f:
    json.dump(cfg, f)
d = dl.DeepLIIFDef(modalities_no=1, net_g=('resnet_2blocks',),
                   net_gs=('unet_32',) * 2, ngf=32, seg_weights=(0.5, 0.5))
ens = dl.DeepLIIFNets(d)
for group, mods in (('G', ens.G), ('GS', ens.GS)):
    flat = [ck.flatten_tree(ck.params_to_jax(n)) for n in mods]
    np.savez(os.path.join(md, f'latest_net_{group}.npz'),
             **{k: np.stack([f[k] for f in flat]) for k in flat[0]})
tiles = np.random.default_rng(0).integers(0, 255, (2, 64, 64, 3), np.uint8)
for precision, fused in (('float32', None), ('bfloat16', None),
                        ('int8', None), ('bfloat16', True)):
    out = models.InferenceSession(
        md, device='cpu', precision=precision, fuse_stages=fused,
        int8_scope='resblocks' if precision == 'int8' else None).run_tiles(tiles)
    assert sorted(out) == ['G1', 'GS'], sorted(out)
for kw in ({'seg_only': True}, {'return_intermediate': True}):
    out2 = models.InferenceSession(md, device='cpu').run_tiles(tiles, **kw)
    assert 'GS' in out2, sorted(out2)


def write_family(path, model, nets_, **cfg):
    os.makedirs(path)
    for group, mods in nets_.named_groups():
        flat = [ck.flatten_tree(ck.params_to_jax(n)) for n in mods]
        np.savez(os.path.join(path, f'latest_net_{group}.npz'),
                 **{k: np.stack([f[k] for f in flat]) for k in flat[0]})
    with open(os.path.join(path, 'config.json'), 'w') as f:
        json.dump(dict(model=model, modalities_no=1, netG='resnet_2blocks',
                       ngf=8, padding='zero', scale_size=64, **cfg), f)
    return path


ext_d = deepliif_ext.DeepLIIFExtDef(modalities_no=1, net_g=('resnet_2blocks',),
                                    net_gs=('unet_32',), ngf=8)
for model, nets_, cfg, c, want in (
        ('DeepLIIFExt', deepliif_ext.make_nets(ext_d),
         dict(seg_gen=True, seg_no=1, net_gs='unet_32'), 3, ['GS_1', 'G_1']),
        ('SDG', sdg.make_nets(sdg.SDGDef(modalities_no=1, input_no=2,
                                         net_g=('resnet_2blocks',), ngf=8)),
         dict(input_no=2), 6, ['G_1']),
        ('CycleGAN', cyclegan.make_nets(cyclegan.CycleGANDef(
            net_g=('resnet_2blocks',), ngf=8), ('GA',)),
         dict(seg_gen=False, seg_no=0), 3, ['GA_1'])):
    fmd = write_family(os.path.join(md, model), model, nets_, **cfg)
    x = np.random.default_rng(1).integers(0, 255, (1, 64, 64, c), np.uint8)
    out3 = models.InferenceSession(fmd, device='cpu').run_tiles(x)
    assert sorted(out3) == want, sorted(out3)
with torch.no_grad():
    att_unet.AttUnetGenerator().eval()(torch.zeros(1, 3, 256, 256))

images = {'Seg': Image.fromarray(out['GS'][0]),
          'mod1-Marker': Image.fromarray(out['G1'][0])}
_, scoring = models.postprocess(Image.fromarray(tiles[0]), images, 64,
                                'DeepLIIF')
assert 'num_total' in scoring, scoring
_, dev_scoring = models.postprocess(Image.fromarray(tiles[0]), images, 64,
                                    'DeepLIIF', device_quant=True,
                                    device='cpu')
assert dev_scoring == scoring, (dev_scoring, scoring)
images, dev_scoring = models.infer_modalities(
    Image.fromarray(tiles[0]), 64, md, device_quant=True, device='cpu')
assert 'SegOverlaid' in images and 'num_total' in dev_scoring
assert native.label8(np.ones((4, 4), np.uint8)) is not None

import io, threading, urllib.request
from deepliif_tpu_torch import serve
from deepliif_tpu_torch.utils import tiff
srv = serve.make_server(md, '127.0.0.1', 0, device='cpu')
threading.Thread(target=srv.serve_forever, daemon=True).start()
buf = io.BytesIO()
Image.fromarray(tiles[0]).save(buf, 'PNG')
body = (b'--b\r\nContent-Disposition: form-data; name="img"; '
        b'filename="a.png"\r\n\r\n' + buf.getvalue() + b'\r\n--b--\r\n')
req = urllib.request.Request(
    f'http://127.0.0.1:{srv.server_address[1]}/api/infer?resolution=10x',
    data=body, method='POST',
    headers={'Content-Type': 'multipart/form-data; boundary=b'})
with urllib.request.urlopen(req, timeout=120) as r:
    assert 'SegRefined' in json.loads(r.read())['images']
srv.shutdown()
run = cli.make_cli().main
run(['serialize', '--model-dir', md, '--output-dir', os.path.join(md, 'ser'),
     '--device', 'cpu'], standalone_mode=False)
slides = os.path.join(md, 'slides')
os.makedirs(slides)
tiff.write_pyramid_tiff(os.path.join(slides, 's.svs'),
                        np.tile(tiles[0], (2, 3, 1)), description='|AppMag = 5|')
for cmd in ('test-wsi', 'wsi-cells'):
    run([cmd, '--input-dir', slides, '--filename', 's.svs', '--output-dir',
         os.path.join(md, 'wsi'), '--model-dir', md, '--region-size', '96',
         '--device', 'cpu'], standalone_mode=False)
assert {'s.json', 's_cells.json', 's_Seg.ome.tiff'} <= set(
    os.listdir(os.path.join(md, 'wsi')))
from deepliif_tpu_torch import data, train_loop
from deepliif_tpu_torch.nets import discriminators, losses, optim, vgg
from deepliif_tpu_torch.utils import background, visualizer
rows = os.path.join(md, 'rows', 'train')
os.makedirs(rows)
Image.fromarray(np.tile(tiles[0], (1, 3, 1))).save(os.path.join(rows, 'r.png'))
run(['train', '--dataroot', os.path.dirname(rows), '--checkpoints-dir',
     os.path.join(md, 'ckpt'), '--modalities-no', '1', '--net-g',
     'resnet_2blocks', '--net-gs', 'unet_32', '--ngf', '8', '--ndf', '8',
     '--load-size', '64', '--crop-size', '64', '--n-epochs', '1',
     '--n-epochs-decay', '0', '--device', 'cpu'], standalone_mode=False)
assert os.path.exists(os.path.join(md, 'ckpt', 'experiment_name',
                                   'latest_optim.npz'))
# the other families, one step each (Ext rows A | B1 | BS1, SDG A | B1 |
# B2, KD A | B1 | B_seg: the same 3-tile rows); the DeepLIIF run above is
# the KD teacher
cg_root = os.path.join(md, 'unaligned')
for sub in ('trainA', 'trainB1'):
    os.makedirs(os.path.join(cg_root, sub))
    Image.fromarray(tiles[0]).save(os.path.join(cg_root, sub, 'a.png'))
for model, root, extra in (
        ('DeepLIIFExt', os.path.dirname(rows), []),
        ('SDG', os.path.dirname(rows), []),
        ('CycleGAN', cg_root, ['--pool-size', '2']),
        ('DeepLIIFKD', os.path.dirname(rows), [
            '--model-dir-teacher', os.path.join(md, 'ckpt',
                                                'experiment_name')])):
    run(['train', '--dataroot', root, '--checkpoints-dir',
         os.path.join(md, 'ckpt'), '--name', model, '--model', model,
         '--modalities-no', '1', '--net-g', 'resnet_2blocks', '--net-gs',
         'unet_32', '--ngf', '8', '--ndf', '8', '--load-size', '64',
         '--crop-size', '64', '--n-epochs', '1', '--n-epochs-decay', '0',
         '--device', 'cpu'] + extra, standalone_mode=False)
    with np.load(os.path.join(md, 'ckpt', model, 'latest_optim.npz')) as f:
        assert int(f['step']) == 1, model
import pickle, time
from deepliif_tpu_torch.utils import (augmentation, jax_random, profiling,
                                      registration)
run(['eval', '--dataroot', os.path.dirname(rows), '--model-dir', md,
     '--phase', 'train', '--output-dir', os.path.join(md, 'eval'),
     '--device', 'cpu'], standalone_mode=False)
assert 'index.html' in os.listdir(os.path.join(md, 'eval'))
stains = os.path.join(md, 'stains')
os.makedirs(stains)
for stain in ('IHC', 'Hematoxylin', 'DAPI', 'Lap2', 'Marker', 'Seg'):
    Image.fromarray(tiles[0]).save(os.path.join(stains, f'a_{stain}.png'))
run(['prepare-training-data', '--input-dir', stains, '--output-dir',
     os.path.join(md, 'prep')], standalone_mode=False)
run(['prepare-testing-data', '--input-dir', stains, '--dataset-dir',
     os.path.join(md, 'prep')], standalone_mode=False)
run(['register', '--fixed', os.path.join(stains, 'a_IHC.png'), '--moving',
     os.path.join(stains, 'a_DAPI.png'), '--output',
     os.path.join(md, 'aligned.png')], standalone_mode=False)
with open(os.path.join(md, 'display_current_results.pickle'), 'wb') as f:
    pickle.dump({'epoch': 1, 'visuals': {'real_A': tiles[0]}}, f)
def interrupt(seconds):
    raise KeyboardInterrupt
time.sleep = interrupt
run(['visualize', '--pickle-dir', md], standalone_mode=False)
assert os.path.exists(os.path.join(md, 'web', 'index.html'))
with profiling.trace(cuda=False) as tr:
    models.InferenceSession(md, device='cpu').run_tiles(tiles)
assert tr.window is not None
print(json.dumps(sorted(m for m in sys.modules
                        if m in ('jax', 'deepliif_tpu')
                        or m.startswith(('jax.', 'jaxlib', 'deepliif_tpu.')))))
'''


def test_port_imports_no_jax(tmp_path):
    res = subprocess.run([sys.executable, '-c', SCRIPT, str(tmp_path)],
                         capture_output=True, text=True, cwd=REPO, timeout=300,
                         env=cpu_subprocess_env())
    assert res.returncode == 0, res.stderr[-2000:]
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []
