"""The port's training data (``threepu_torch.data``: the synthetic
generator, ``load_h5_data``, ``DeviceDataset``, ``H5Dataset``,
``Prefetcher``) held against the JAX package's on the CPU.

Files are small: 4 shapes at 32..512 points (``tests/test_data.py``'s
layout), as ``.hdf5`` and as ``.npz`` with the same datasets.  Loads and
generated arrays must equal JAX's bit for bit; batches, cut from the same
draws (JAX's pinned by patching ``jax.random``), to 1e-6.
"""

import torch_threads  # noqa: F401  (first: sets torch's threads)
import contextlib
import io
import shutil
import sys
import unittest.mock as mock

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from threepu.data import DeviceDataset as JDeviceDataset
from threepu.data import H5Dataset as JH5Dataset
from threepu.data import Prefetcher as JPrefetcher
from threepu.data import load_h5_data as jload_h5_data
from threepu.data import synthetic as jsyn
from threepu.data.h5_dataset import _sample_impl

from threepu_torch.data import (DeviceDataset, H5Dataset, Prefetcher,
                                load_h5_data, sample_batch, step_generator)
from threepu_torch.data import synthetic as tsyn

RES = (32, 64, 128, 256, 512)
NAME = "train_" + "_".join(f"poisson_{r}" for r in RES)


def _write(root, name, datasets):
    """The datasets as ``name.hdf5`` and ``name.npz`` under ``root``."""
    h5 = root / f"{name}.hdf5"
    with h5py.File(h5, "w") as f:
        for k, v in datasets.items():
            f.create_dataset(k, data=v)
    npz = root / f"{name}.npz"
    np.savez(npz, **datasets)
    return {"hdf5": str(h5), "npz": str(npz)}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """4 shapes on offset unit spheres at 32..512 points, and a 2-D set
    (z = 0) of 3 shapes at 32..128, each as .hdf5 and .npz."""
    root = tmp_path_factory.mktemp("tdata")
    rng = np.random.default_rng(0)
    offset = rng.uniform(-2, 2, (4, 1, 3)).astype(np.float32)
    sets = {}
    for res in RES:
        pts = rng.standard_normal((4, res, 3)).astype(np.float32)
        pts /= np.linalg.norm(pts, axis=-1, keepdims=True)
        sets[f"poisson_{res}"] = pts + offset
    flat = {}
    for res in RES[:3]:
        pts = rng.standard_normal((3, res, 3)).astype(np.float32)
        pts[..., 2] = 0
        flat[f"flat_{res}"] = pts
    return {"3d": _write(root, NAME, sets),
            "2d": _write(root, "train_flat_32_flat_64_flat_128", flat)}


# ------------------------------------------------------------ synthetic
def test_synthetic_surface_matches_jax():
    assert tsyn.DEFAULT_RESOLUTIONS == jsyn.DEFAULT_RESOLUTIONS
    coef = np.random.default_rng(1).standard_normal((4, 4)) * 0.12
    got = tsyn.synthetic_surface(300, coef, np.random.default_rng(5))
    want = jsyn.synthetic_surface(300, coef, np.random.default_rng(5))
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("ext", ["hdf5", "npz"])
def test_write_synthetic_matches_jax(tmp_path, ext):
    """The port's file (HDF5, or .npz by its name) holds the JAX
    package's datasets bit for bit."""
    want = jsyn.write_synthetic_h5(str(tmp_path / "jax"), n_shapes=3,
                                   seed=11, resolutions=(128, 64, 256))
    filename = None if ext == "hdf5" else \
        "train_poisson_64_poisson_128_poisson_256.npz"
    got = tsyn.write_synthetic_h5(str(tmp_path / "port"), n_shapes=3,
                                  seed=11, resolutions=(128, 64, 256),
                                  filename=filename)
    assert got.endswith(f"train_poisson_64_poisson_128_poisson_256.{ext}")
    with h5py.File(want, "r") as w, (np.load(got) if ext == "npz"
                                     else h5py.File(got, "r")) as g:
        keys = sorted(g.keys() if ext == "hdf5" else g.files)
        assert keys == sorted(w.keys())
        for k in keys:
            assert g[k].dtype == w[k].dtype and np.array_equal(g[k][:],
                                                               w[k][:])


def test_synthetic_command_line(tmp_path):
    """``python -m threepu_torch.data.synthetic <dir> --filename x.npz``
    prints the path of a file that loads."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        tsyn.main([str(tmp_path), "--shapes", "2", "--resolutions", "32",
                   "64", "--filename", "train_poisson_32_poisson_64.npz"])
    path = buf.getvalue().strip()
    assert path.endswith("train_poisson_32_poisson_64.npz")
    data, labels, _ = load_h5_data(path, 32, 2, 2)
    assert data.shape == (2, 32, 3) and labels[2].shape == (2, 64, 3)


# ----------------------------------------------------------- load_h5_data
@pytest.mark.parametrize("ext", ["hdf5", "npz"])
@pytest.mark.parametrize("which,n,up", [("3d", 32, 16), ("3d", 30, 4),
                                        ("3d", 64, 8), ("2d", 32, 4)],
                         ids=["x16", "searchsorted", "x8", "2d"])
def test_load_h5_data_matches_jax(files, ext, which, n, up):
    """Input, every label and the 2-D flag equal JAX's on the .hdf5 file,
    bit for bit; 30 points take the next resolution, 32."""
    data, labels, is_2d = load_h5_data(files[which][ext], n, up, 2)
    want, want_labels, want_2d = jload_h5_data(files[which]["hdf5"], n, up,
                                               2)
    assert data.dtype == want.dtype and np.array_equal(data, want)
    assert sorted(labels) == sorted(want_labels)
    for r in labels:
        assert np.array_equal(labels[r], want_labels[r])
    assert is_2d == want_2d == (which == "2d")
    if n == 30:
        assert data.shape[1] == 32 and labels[4].shape[1] == 128


@pytest.mark.parametrize("ext", ["hdf5", "npz"])
def test_load_h5_data_bad_name(files, tmp_path, ext):
    """A name outside the convention fails as JAX's does, same text."""
    bad = str(tmp_path / f"held.{ext}")
    shutil.copy(files["3d"][ext], bad)
    jbad = str(tmp_path / "held.hdf5")
    if ext == "npz":
        shutil.copy(files["3d"]["hdf5"], jbad)
    with pytest.raises(ValueError, match="filename convention") as got:
        load_h5_data(bad, 32, 16, 2)
    with pytest.raises(ValueError) as want:
        jload_h5_data(jbad, 32, 16, 2)
    assert str(got.value).replace(".npz", ".hdf5") == str(want.value)


def test_hdf5_without_h5py_names_the_npz_route(files, tmp_path):
    """Without h5py an .hdf5 file raises ImportError naming .npz; the
    .npz file still loads and is still written."""
    with mock.patch.dict(sys.modules, {"h5py": None}):
        with pytest.raises(ImportError, match=r"\.npz"):
            load_h5_data(files["3d"]["hdf5"], 32, 4, 2)
        with pytest.raises(ImportError, match=r"\.npz"):
            tsyn.write_synthetic_h5(str(tmp_path), 1, resolutions=(32, 64))
        assert load_h5_data(files["3d"]["npz"], 32, 4, 2)[0].shape == \
            (4, 32, 3)
        tsyn.write_synthetic_h5(str(tmp_path), 1, resolutions=(32, 64),
                                filename="train_poisson_32_poisson_64.npz")


# ---------------------------------------------------------- DeviceDataset
@contextlib.contextmanager
def pinned_jax_draws(seeds, angles, noise, perm):
    """``jax.random`` returns these arrays for ``_sample_impl``'s draws."""
    fakes = {"randint": lambda *a, **kw: jnp.asarray(seeds, jnp.int32),
             "uniform": lambda *a, **kw: jnp.asarray(angles),
             "normal": lambda *a, **kw: jnp.asarray(noise),
             "permutation": lambda *a, **kw: jnp.asarray(perm)}
    with mock.patch.multiple(jax.random, **fakes):
        yield


@pytest.mark.parametrize("which,ratio,kw", [
    ("3d", 4, {}), ("3d", 16, dict(jitter=True, drop_out=0.75)),
    ("2d", 2, dict(jitter=True)), ("3d", 8, dict(phase="test"))],
    ids=["x4", "x16-jitter-drop", "2d-jitter", "test-phase"])
def test_device_dataset_sample_matches_jax(files, which, ratio, kw):
    """``DeviceDataset.sample`` (on the .npz) against ``_sample_impl`` on
    JAX's ``DeviceDataset`` (the .hdf5), called through ``__wrapped__``
    with its draws pinned to the port's: the shape at step % shapes,
    patches and labels to 1e-6."""
    k, bsz, step = 16, 3, 5
    cfg = dict(batch_size=bsz, up_ratio=16 if which == "3d" else 4,
               jitter_sigma=0.01, jitter_max=0.02, **kw)
    ds = DeviceDataset(files[which]["npz"], 32, k, device="cpu", **cfg)
    jds = JDeviceDataset(files[which]["hdf5"], 32, k, **cfg)
    draws = ds.draws(torch.Generator().manual_seed(step))
    assert set(draws) == {"seed_idx"} | ({"angles"} if ds.phase == "train"
                                         else set()) | \
        ({"noise"} if kw.get("jitter") else set()) | \
        ({"perm"} if "drop_out" in kw else set())
    got = ds.sample(step, ratio, **draws)
    with pinned_jax_draws(*(draws.get(n, torch.zeros(1)).numpy()
                            for n in ("seed_idx", "angles", "noise",
                                      "perm"))):
        want = _sample_impl.__wrapped__(
            jds.input_array, jds.label_arrays[ratio], jax.random.PRNGKey(0),
            jnp.asarray(step % jds.num_shapes), ratio=ratio, batch_size=bsz,
            num_patch_point=k, phase=jds.phase, jitter=jds.jitter,
            jitter_sigma=jds.jitter_sigma, jitter_max=jds.jitter_max,
            drop_out=jds.drop_out, is_2d=jds.is_2d)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)


def test_device_dataset_draws_in_sample_batch_order(files):
    """Drawing first (``draws``) and cutting from a generator directly give
    the same batch: the draws come in ``sample_batch``'s order."""
    ds = DeviceDataset(files["3d"]["npz"], 32, 16, batch_size=4,
                       jitter=True, drop_out=0.5, device="cpu")
    got = ds.sample(3, 8, torch.Generator().manual_seed(4))
    want = sample_batch(ds.input_array[3], ds.label_arrays[8][3], 8, 4, 16,
                        torch.Generator().manual_seed(4), jitter=True,
                        jitter_sigma=ds.jitter_sigma,
                        jitter_max=ds.jitter_max, drop_out=0.5)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert got[0].shape == (4, 8, 3) and got[1].shape == (4, 128, 3)


def test_device_dataset_defaults_to_the_card(files, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceDataset(files["3d"]["npz"], 32, 16)


# -------------------------------------------------------------- H5Dataset
def test_h5dataset_matches_jax(files):
    """Layout ``(B, 3, N)``, 300 batches an epoch, the mutators, and the
    combined ratio draw (the same numpy generator) as JAX's class."""
    args = (32, 16)
    kw = dict(batch_size=2, up_ratio=16, seed=3)
    ds = H5Dataset(files["3d"]["npz"], *args, device="cpu", **kw)
    jds = JH5Dataset(files["3d"]["hdf5"], *args, **kw)
    assert len(ds) == len(jds) == 600
    for op, arg in (("set_max_ratio", 4), ("add_next_ratio", None),
                    ("unset_combined", None), ("add_next_ratio", None),
                    ("set_combined", None), ("set_max_ratio", 8)):
        for d in (ds, jds):
            getattr(d, op)(*(() if arg is None else (arg,)))
        assert ds.curr_scales == jds.curr_scales
        assert ds._combined == jds._combined
    for i in range(4):
        inp, lab, ratio = ds[i]
        assert ratio == jds[i][2]
        assert inp.shape == (2, 3, 16) and lab.shape == (2, 3, 16 * ratio)
    ds.unset_combined()
    assert ds[0][2] == 8


@pytest.mark.parametrize("step,stage_steps,up", [
    (0, 100, None), (125, 100, None), (50, 100, None), (10_000, 100, 16),
    (10_000, 100, 4)])
def test_h5dataset_sync_to_step_matches_jax(files, step, stage_steps, up):
    ds = H5Dataset(files["3d"]["npz"], 32, 16, batch_size=2, device="cpu")
    jds = JH5Dataset(files["3d"]["hdf5"], 32, 16, batch_size=2)
    got = ds.sync_to_step(step, stage_steps=stage_steps, up_ratio=up)
    assert got == jds.sync_to_step(step, stage_steps=stage_steps,
                                   up_ratio=up)
    assert ds.curr_scales == jds.curr_scales
    assert ds._combined == jds._combined


# ------------------------------------------------------------- Prefetcher
def test_prefetcher_order_and_ratios_match_jax():
    """Steps in order and ratios from ``ratio_fn``, as JAX's, ``depth``
    batches issued ahead of the one returned."""
    ratios = [2, 4, 2, 4, 2]
    issued, jissued = [], []

    def sample(step, ratio, gen):
        issued.append(step)
        return ("batch", step)

    def jsample(key, step, ratio):
        jissued.append(step)
        return ("batch", step)

    pf = Prefetcher(sample, lambda s: ratios[s % 5], seed=0, depth=2)
    jpf = JPrefetcher(jsample, lambda s: ratios[s % 5],
                      jax.random.PRNGKey(0), depth=2)
    for _ in range(4):
        out, jout = next(pf), next(jpf)
        assert out == jout
        assert issued == jissued
    assert issued == [0, 1, 2, 3, 4]


def test_prefetcher_draws_depend_on_the_step_alone(files):
    """A prefetcher started at step 2 cuts the batches of steps 2 and 3
    exactly as one started at 0; each step draws from its own
    generator."""
    ds = DeviceDataset(files["3d"]["npz"], 32, 16, batch_size=2,
                       device="cpu")
    runs = []
    for start in (0, 2):
        pf = Prefetcher(ds.sample, lambda s: 4, seed=9, start_step=start)
        runs.append({step: batch for batch, _, step in
                     (next(pf) for _ in range(4 - start))})
    for step in (2, 3):
        assert all(torch.equal(a, b) for a, b in zip(runs[0][step],
                                                     runs[1][step]))
    assert not torch.equal(runs[0][2][0], runs[0][3][0])
    a, b = (torch.randint(0, 1 << 30, (4,), generator=step_generator(9, 5))
            for _ in range(2))
    assert torch.equal(a, b)
    assert not torch.equal(a, torch.randint(
        0, 1 << 30, (4,), generator=step_generator(10, 5)))
