"""Training observability: the port's own copy of
deepliif_tpu/utils/visualizer.py.

Replaces the reference's visdom/dominate Visualizer
(reference deepliif/util/visualizer.py:47-388) with dependency-free
equivalents:
  * loss_log.txt with the same line format,
  * metrics.json time series (train/val losses + cell-count RMSE),
  * per-epoch PNG image grids + a static index.html gallery,
  * matplotlib loss curves regenerated on each plot call,
  * remote snapshot mode: pickles of the plot inputs under <ckpt>/pickle/
    consumed by `deepliif-tpu visualize` (reference remote mode,
    visualizer.py:90-161).
"""

from __future__ import annotations

import json
import os
import pickle
import time

import numpy as np


class Visualizer:
    def __init__(self, opt):
        self.opt = opt
        self.name = opt.name
        self.save_dir = os.path.join(opt.checkpoints_dir, opt.name)
        os.makedirs(self.save_dir, exist_ok=True)
        self.img_dir = os.path.join(self.save_dir, 'web', 'images')
        os.makedirs(self.img_dir, exist_ok=True)
        self.log_name = os.path.join(self.save_dir, 'loss_log.txt')
        self.metrics_path = os.path.join(self.save_dir, 'metrics_log.json')
        self.remote = getattr(opt, 'remote', False)
        self.no_html = getattr(opt, 'no_html', False)
        self.pickle_dir = os.path.join(self.save_dir, 'pickle')
        if self.remote:
            os.makedirs(self.pickle_dir, exist_ok=True)
        self.history = {'train': [], 'val': [], 'metrics': []}
        with open(self.log_name, 'a') as f:
            f.write(f'================ Training Loss ({time.strftime("%c")}) ================\n')
        self.saved = False

    def reset(self):
        self.saved = False

    # -- console/file loss logging (same format as reference :372-388) ------
    def print_current_losses(self, epoch, iters, losses, t_comp, t_data):
        message = '(epoch: %d, iters: %d, time: %.3f, data: %.3f) ' % (
            epoch, iters, t_comp, t_data)
        for k, v in losses.items():
            message += '%s: %.3f ' % (k, float(v))
        print(message)
        with open(self.log_name, 'a') as f:
            f.write(message + '\n')

    def plot_current_losses(self, epoch, counter_ratio, losses):
        rec = {'x': epoch + counter_ratio,
               'losses': {k: float(v) for k, v in losses.items()}}
        self.history['train'].append(rec)
        self._dump_metrics()
        if self.remote:
            self._snapshot('plot_current_losses', rec)

    def plot_current_losses_val(self, epoch, losses):
        rec = {'x': epoch, 'losses': {k: float(v) for k, v in losses.items()}}
        self.history['val'].append(rec)
        self._dump_metrics()

    def plot_current_metrics(self, epoch, metrics):
        rec = {'x': epoch, 'metrics': {k: float(v) for k, v in metrics.items()}}
        self.history['metrics'].append(rec)
        self._dump_metrics()

    def _dump_metrics(self):
        with open(self.metrics_path, 'w') as f:
            json.dump(self.history, f)

    def _snapshot(self, kind, payload):
        # atomic (temp + os.replace): the `visualize` watcher polls mtime
        # and loads concurrently — an in-place truncate+write would hand
        # it a partial pickle mid-write
        path = os.path.join(self.pickle_dir, f'{kind}.pickle')
        tmp = f'{path}.tmp-{os.getpid()}'
        with open(tmp, 'wb') as f:
            pickle.dump(payload, f)
        os.replace(tmp, path)

    # -- image grids ---------------------------------------------------------
    def display_current_results(self, visuals, epoch, save_result,
                                filename=None):
        """visuals: dict name -> uint8 HWC array (or [-1,1] float array)."""
        from PIL import Image
        if not (save_result or not self.saved):
            return
        self.saved = True
        u8 = {}
        for label, img in visuals.items():
            a = _to_u8(img)
            u8[label] = a
            Image.fromarray(a).save(
                os.path.join(self.img_dir, f'epoch{epoch:03d}_{label}.png'))
        if not self.no_html:
            self._write_html()
        if self.remote:
            # pickle the actual images so `deepliif-tpu visualize` can replay
            # the grid on another machine (reference visualizer.py:90-107)
            self._snapshot('display_current_results',
                           {'epoch': epoch, 'visuals': u8})

    def _write_html(self):
        files = sorted(os.listdir(self.img_dir), reverse=True)
        rows = ''.join(
            f'<div style="display:inline-block;margin:4px;text-align:center">'
            f'<img src="images/{f}" width="256"/><br/>{f}</div>'
            for f in files[:200])
        with open(os.path.join(self.save_dir, 'web', 'index.html'), 'w') as f:
            f.write(f'<html><head><title>{self.name}</title></head>'
                    f'<body><h1>{self.name}</h1>{rows}</body></html>')

    def plot_to_png(self, out_path=None):
        """Render loss curves with matplotlib (called at epoch ends)."""
        try:
            import matplotlib
            matplotlib.use('Agg')
            import matplotlib.pyplot as plt
        except Exception:
            return None
        out_path = out_path or os.path.join(self.save_dir, 'loss_plot.png')
        fig, axes = plt.subplots(1, 3, figsize=(15, 4))
        for ax, key, title in zip(axes, ('train', 'val', 'metrics'),
                                  ('train loss', 'val loss', 'val metrics')):
            recs = self.history[key]
            if not recs:
                ax.set_title(f'{title} (none)')
                continue
            field = 'metrics' if key == 'metrics' else 'losses'
            names = sorted({k for r in recs for k in r[field]})
            xs = [r['x'] for r in recs]
            for name in names:
                ax.plot(xs, [r[field].get(name, np.nan) for r in recs],
                        label=name, linewidth=0.8)
            ax.set_title(title)
            ax.legend(fontsize=5)
        fig.tight_layout()
        fig.savefig(out_path, dpi=100)
        plt.close(fig)
        return out_path


def _to_u8(img):
    """Visual -> uint8 HWC via the ONE conversion (utils.tensor2im
    semantics); uint8 passes through, batch dim dropped, single channel
    tiled to RGB."""
    a = np.asarray(img)
    if a.dtype == np.uint8:
        if a.ndim == 4:
            a = a[0]
        if a.ndim == 3 and a.shape[-1] == 1:
            a = np.repeat(a, 3, axis=-1)
        return a
    from . import tensor2im
    return tensor2im(a)


def save_images(save_dir, visuals, image_path, aspect_ratio=1.0):
    """Save test visuals next to an HTML gallery (reference visualizer.py:
    17-44)."""
    from PIL import Image
    os.makedirs(save_dir, exist_ok=True)
    short_path = os.path.splitext(os.path.basename(image_path))[0]
    for label, img in visuals.items():
        Image.fromarray(_to_u8(img)).save(
            os.path.join(save_dir, f'{short_path}_{label}.png'))
