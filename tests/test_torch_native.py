"""The port's native host library (``threepu_torch.native``, its own copy
of ``threepu/native/_native.cpp``) held against the JAX package's and the
numpy oracles; the port's text loader and host downsampling on it, and
their numpy fallback when the library cannot be built.  Skipped without a
C++ toolchain, as ``tests/test_native.py`` is."""

import shutil

import numpy as np
import pytest

from oracles import fps_oracle, nn_distance_oracle
from threepu import native as jnative
from threepu.utils import pc_utils as jpc

from threepu_torch import native
from threepu_torch.io import pointcloud as tpc_io
from threepu_torch.utils import pc_utils as tpc

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no C++ toolchain")


def test_fps_cpu_matches_jax_and_the_oracle(rng):
    pts = rng.standard_normal((500, 3)).astype(np.float32)
    got = native.fps_cpu(pts, 64)
    np.testing.assert_array_equal(got, fps_oracle(pts, 64))
    np.testing.assert_array_equal(got, jnative.fps_cpu(pts, 64))
    assert native.fps_cpu(pts, 5, seed=42)[0] == 42
    wide = rng.standard_normal((100, 6)).astype(np.float32)
    np.testing.assert_array_equal(native.fps_cpu(wide, 10),
                                  fps_oracle(wide[:, :3], 10))


def test_nn_dist2_and_chamfer_cpu_match_jax_and_the_oracle(rng):
    """Indices exactly the oracle's and JAX's native; distances to 1e-5
    relative of the oracle's (float64) and to 1e-6 relative of JAX's
    native, which builds with ``-march=native``: there the compiler may
    fuse the sum of squares into FMAs, rounding once less than the port's
    ``-ffp-contract=off`` (and numpy)."""
    a = rng.standard_normal((80, 3)).astype(np.float32)
    b = rng.standard_normal((60, 3)).astype(np.float32)
    got = native.nn_dist2_cpu(a, b)
    want = nn_distance_oracle(a, b)
    for i in (1, 3):
        np.testing.assert_array_equal(got[i], want[i])
    for i in (0, 2):
        np.testing.assert_allclose(got[i], want[i], rtol=1e-5)
    jgot = jnative.nn_dist2_cpu(a, b)
    for i in (1, 3):
        np.testing.assert_array_equal(got[i], jgot[i])
    for i in (0, 2):
        np.testing.assert_allclose(got[i], jgot[i], rtol=1e-6)
    assert native.chamfer_cpu(a, b) == pytest.approx(
        want[0].mean() + want[2].mean(), rel=1e-5)
    with pytest.raises(ValueError, match="empty"):
        native.nn_dist2_cpu(a[:0], b)


@pytest.mark.parametrize("fmt", ["%.18e", "%.6f", "%g"])
def test_parse_xyz_matches_jax_bit_for_bit(rng, tmp_path, fmt):
    """Float32 rows equal JAX's native parser's bit for bit, whatever the
    text's precision; with full-precision text they equal the float32
    values written."""
    pts = (rng.standard_normal((300, 3)) * 10).astype(np.float32)
    path = str(tmp_path / "a.xyz")
    np.savetxt(path, pts, fmt=fmt)
    got = native.parse_xyz(path)
    assert got.dtype == np.float32 and got.shape == (300, 3)
    np.testing.assert_array_equal(got.view(np.int32),
                                  jnative.parse_xyz(path).view(np.int32))
    if fmt == "%.18e":
        np.testing.assert_array_equal(got, pts)
    assert native.parse_xyz(path, max_points=7).shape == (7, 3)


def test_parse_xyz_refuses_comments_and_ragged_rows(tmp_path):
    (tmp_path / "c.xyz").write_text("# header\n1 2 3\n")
    (tmp_path / "r.xyz").write_text("1 2 3\n4 5\n")
    for name in ("c.xyz", "r.xyz"):
        with pytest.raises(ValueError):
            native.parse_xyz(str(tmp_path / name))
    # the loader reads the commented file through np.loadtxt
    np.testing.assert_array_equal(tpc_io.load(str(tmp_path / "c.xyz")),
                                  [[1, 2, 3]])


def test_load_and_downsample_match_jax(rng, tmp_path):
    """``io.load`` of an ``.xyz`` and ``downsample_points`` (native FPS
    from a random first point) give JAX's rows bit for bit from the same
    global-generator draws."""
    pts = rng.standard_normal((1000, 3)).astype(np.float32)
    path = str(tmp_path / "s.xyz")
    np.savetxt(path, pts)
    from threepu.io import load as jload
    np.random.seed(4)
    want = jload(path, 200)
    np.random.seed(4)
    got = tpc_io.load(path, 200)
    np.testing.assert_array_equal(got, want)
    np.random.seed(5)
    want = jpc.downsample_points(pts, 100)
    np.random.seed(5)
    got = tpc.downsample_points(pts, 100)
    np.testing.assert_array_equal(got, want)


def test_numpy_takes_over_when_the_build_fails(rng, tmp_path, monkeypatch,
                                               capsys):
    """With ``g++`` failing, ``load`` raises the compiler's message, every
    later call raises without building again, the loader and the
    downsampling warn once and give the numpy results: the same rows."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    monkeypatch.setattr(native, "_warned", False)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "FLAGS", native.FLAGS + ("-DTHREEPU_NONE",
                                                         "-fno-such-flag"))
    with pytest.raises(native.BuildError, match="no-such-flag"):
        native.load()
    monkeypatch.setattr(native, "_build", lambda out: pytest.fail("rebuilt"))
    with pytest.raises(native.BuildError, match="no-such-flag"):
        native.load()
    pts = rng.standard_normal((400, 3)).astype(np.float32)
    path = str(tmp_path / "s.xyz")
    np.savetxt(path, pts)
    capsys.readouterr()
    np.testing.assert_array_equal(tpc_io.load(path), pts)
    np.random.seed(2)
    got = tpc.downsample_points(pts, 50)
    np.random.seed(2)
    want = jpc.downsample_points(pts, 50)
    np.testing.assert_array_equal(got, want)
    assert capsys.readouterr().out.count("native host library unavailable") == 1
