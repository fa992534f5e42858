"""``python -m deepliif_tpu_torch.serve``: the REST server."""

from . import main

main()
