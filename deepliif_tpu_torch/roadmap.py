"""The error for what the port does not run yet. Each message names the
ROADMAP.md heading of the item that ports it (by title, so the message
stays right when the queue is renumbered)."""

from __future__ import annotations

SERVING = 'Serving'
WSI = 'WSI'
TRAINING = 'Training'
STATS = 'Stats'
# what is left of the item: the JAX package's int8 trunk-kernel switches
INT8_ALL = 'int8 scope all'

# in the order of ROADMAP.md's Queue 1
ITEMS = (SERVING, TRAINING, WSI, STATS, INT8_ALL)


def not_ported(what, item):
    """NotImplementedError for ``what``, naming ROADMAP.md item ``item``."""
    if item not in ITEMS:
        raise ValueError(f'unknown ROADMAP item {item!r}')
    return NotImplementedError(f'{what} is not ported to deepliif_tpu_torch '
                               f'yet (ROADMAP.md, "{item}")')
