"""Synthetic multi-resolution training data (port of
``threepu/data/synthetic.py``).

Each shape is a unit sphere modulated by a low-frequency radial field of
its own; every resolution of a shape samples the same surface, the
property the multi-resolution labels rely on.  The file follows the
training-data convention :func:`threepu_torch.data.load_h5_data` reads:
one ``<tag>_<n>`` dataset per resolution, the resolutions encoded in the
file name ``train_<tag>_<n1>_..._<tag>_<nK>``.  For the same seed the
arrays equal the JAX package's bit for bit.

The file is HDF5 (through ``h5py``) unless its name ends in ``.npz``: then
the same datasets go into a numpy archive, which a machine without
``h5py`` can write and read::

    python -m threepu_torch.data.synthetic data --shapes 20 --filename \\
        train_poisson_5000_poisson_10000_poisson_20000_poisson_40000_poisson_80000.npz
    python -m threepu_torch.cli --phase train --h5_data data/train_*.npz \\
        --num_shape_point 5000 --num_point 312 --id demo
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np

DEFAULT_RESOLUTIONS: Tuple[int, ...] = (5000, 10000, 20000, 40000, 80000)


def synthetic_surface(n: int, coef: np.ndarray,
                      rng: np.random.Generator) -> np.ndarray:
    """Sample ``n`` points of the modulated-sphere surface defined by a
    ``(4, 4)`` coefficient field: ``r(x, y) = 1 + sum_ij c_ij
    sin(3.1 i x) cos(3.1 j y)`` over unit-sphere directions."""
    pts = rng.standard_normal((n, 3)).astype(np.float32)
    pts /= np.linalg.norm(pts, axis=-1, keepdims=True)
    mod = np.ones((n,), np.float32)
    for i in range(4):
        for j in range(4):
            mod += (coef[i, j] * np.sin(i * pts[:, 0] * 3.1)
                    * np.cos(j * pts[:, 1] * 3.1))
    return pts * mod[:, None]


def write_synthetic_h5(out_dir: str, n_shapes: int = 20, seed: int = 7,
                       resolutions: Sequence[int] = DEFAULT_RESOLUTIONS,
                       tag: str = "poisson",
                       filename: Optional[str] = None) -> str:
    """Write ``train_{tag}_{n1}_..._{nK}.hdf5`` (or ``filename``) under
    ``out_dir`` and return its path.  A ``filename`` ending in ``.npz``
    writes the same datasets with ``np.savez``; any other name needs
    ``h5py``."""
    resolutions = tuple(sorted(int(r) for r in resolutions))
    if filename is None:
        filename = "train_" + "_".join(
            f"{tag}_{r}" for r in resolutions) + ".hdf5"
    path = os.path.join(out_dir, filename)
    os.makedirs(out_dir, exist_ok=True)

    rng = np.random.default_rng(seed)
    coef = rng.standard_normal((n_shapes, 4, 4)).astype(np.float64) * 0.12
    datasets = {f"{tag}_{res}": np.stack([synthetic_surface(res, coef[s], rng)
                                          for s in range(n_shapes)])
                for res in resolutions}
    if filename.endswith(".npz"):
        np.savez(path, **datasets)
        return path
    from threepu_torch.data.h5_dataset import import_h5py
    h5py = import_h5py(path)
    with h5py.File(path, "w") as f:
        for key, arr in datasets.items():
            f.create_dataset(key, data=arr)
    return path


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(
        "threepu_torch.data.synthetic",
        description="generate a synthetic training file in the reference "
                    "format (.hdf5, or .npz with --filename *.npz)")
    ap.add_argument("out_dir", help="directory to write the file into")
    ap.add_argument("--shapes", type=int, default=20)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--resolutions", type=int, nargs="+",
                    default=list(DEFAULT_RESOLUTIONS))
    ap.add_argument("--tag", default="poisson")
    ap.add_argument("--filename",
                    help="file name (default train_<tag>_<n1>_..._<tag>_<nK>"
                         ".hdf5); one ending in .npz writes a numpy archive")
    args = ap.parse_args(argv)
    path = write_synthetic_h5(args.out_dir, n_shapes=args.shapes,
                              seed=args.seed, resolutions=args.resolutions,
                              tag=args.tag, filename=args.filename)
    print(path)


if __name__ == "__main__":
    main()
