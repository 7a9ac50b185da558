"""The port's counterparts of the repo's ``examples/*.py``: the same
problems, sizes, dtypes, seeds and oracles.  Each module has a
``main(device=None)`` that returns the numbers its script prints (on the
card unless ``device="cpu"``) and runs as

    python -m lobpcg_tpu_torch.examples.<name> [--device cpu]

``laplacian_1d``, ``bdg_indefinite``, ``checkpoint_resume``,
``sparse_3d_laplacian``, ``complex_on_gpu`` (the counterpart of
``complex_on_tpu.py``), ``fft_matrix_free`` and ``sharded_solve``.
"""

import argparse
import json


def run(main, description: str, **options) -> None:
    """The command line of an example: ``--device``, then ``main``'s
    record printed as one JSON line.  ``options``: extra integer flags
    with their defaults."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default=None, help="cpu, or the card")
    for name, default in options.items():
        ap.add_argument(f"--{name}", type=int, default=default)
    a = vars(ap.parse_args())
    print(json.dumps(main(**a)), flush=True)
