"""The port's point-cloud IO (``threepu_torch.io``: PLY reader and writer,
``load`` / ``save``) and host-side downsampling held against the JAX
package's: the files the two write are byte-identical, each side reads
the other's, and ``load`` pads or downsamples alike when numpy's global
generator starts from the same seed on both sides."""

import torch_threads  # noqa: F401  (first: sets torch's threads)
import numpy as np
import pytest

from threepu import io as jio
from threepu.io import ply as jply
from threepu.utils import logger as jlogger
from threepu.utils import pc_utils as jpc

from threepu_torch import io as tio
from threepu_torch.io import ply as tply
from threepu_torch.utils import logger as tlogger
from threepu_torch.utils import pc_utils as tpc


def _cloud(rng, n=60):
    return rng.standard_normal((n, 3)).astype(np.float32)


def _both(tmp_path, name, write):
    """Write one file with each package; return ``(JAX's path, the
    port's path)`` after checking that the bytes are equal."""
    jpath, tpath = str(tmp_path / f"j_{name}"), str(tmp_path / f"t_{name}")
    write(jply, jpath)
    write(tply, tpath)
    with open(jpath, "rb") as a, open(tpath, "rb") as b:
        assert a.read() == b.read()
    return jpath, tpath


@pytest.mark.parametrize("normals,colors", [(False, None), (True, None),
                                            (False, "unit"), (True, "rgba")],
                         ids=["points", "normals", "colors", "normals-rgba"])
def test_save_ply_is_byte_identical_and_cross_readable(rng, tmp_path, normals,
                                                       colors):
    pts = _cloud(rng)
    kw = {}
    if normals:
        kw["normals"] = _cloud(rng)
    if colors == "unit":
        kw["colors"] = rng.uniform(0, 1, (60, 3))
    elif colors == "rgba":
        kw["colors"] = rng.integers(0, 256, (60, 4))
    jpath, tpath = _both(tmp_path, "a.ply",
                         lambda mod, path: mod.save_ply(pts, path, **kw))
    # each side reads the other's file
    got, want = tply.read_ply(jpath), jply.read_ply(tpath)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (60, 6 if normals else 3)
    np.testing.assert_array_equal(got[:, :3], pts)
    gp, gc = tply.read_ply_with_color(jpath)
    wp, wc = jply.read_ply_with_color(tpath)
    np.testing.assert_array_equal(gp, wp)
    if colors is None:
        assert gc is None and wc is None
    else:
        np.testing.assert_array_equal(gc, wc)
        assert gc.shape == (60, 3 if colors == "unit" else 4)


@pytest.mark.parametrize("colored", [False, True], ids=["plain", "colored"])
def test_save_ply_with_face_is_byte_identical(rng, tmp_path, colored):
    pts = _cloud(rng, 5)
    faces = np.array([[0, 1, 2], [1, 2, 3], [2, 3, 4]])
    colors = rng.uniform(0, 1, (3, 3)) if colored else None
    jpath, tpath = _both(
        tmp_path, "f.ply",
        lambda mod, path: mod.save_ply_with_face(pts, faces, path, colors))
    for read, path in ((tply.read_ply_data, jpath),
                       (jply.read_ply_data, tpath)):
        data = read(path)
        np.testing.assert_array_equal(data["face"]["vertex_indices"], faces)
        np.testing.assert_array_equal(data["vertex"]["x"], pts[:, 0])
        assert ("red" in data["face"]) == colored


def test_colormap_variants_are_byte_identical(rng, tmp_path):
    pytest.importorskip("matplotlib")
    pts = _cloud(rng, 8)
    faces = np.array([[0, 1, 2], [3, 4, 5]])
    _both(tmp_path, "p.ply", lambda mod, path: mod.save_ply_property(
        pts, np.arange(8), path))
    _both(tmp_path, "fp.ply",
          lambda mod, path: mod.save_ply_with_face_property(
              pts, faces, np.array([0.2, 0.9]), 1.0, path))


_ASCII = """ply
format ascii 1.0
comment made by hand
element vertex 3
property float x
property float y
property float z
property uchar red
property uchar green
property uchar blue
element face 1
property list uchar int vertex_indices
end_header
0 0 0 255 0 0
1 0.5 0 0 255 0
0 1 -2.25 0 0 255
3 0 1 2
"""


def test_reads_ascii_and_big_endian_like_jax(tmp_path):
    path = str(tmp_path / "ascii.ply")
    with open(path, "w") as f:
        f.write(_ASCII)
    got, want = tply.read_ply_data(path), jply.read_ply_data(path)
    for el in ("vertex", "face"):
        assert got[el].keys() == want[el].keys()
        for key in got[el]:
            np.testing.assert_array_equal(got[el][key], want[el][key])
            assert got[el][key].dtype == want[el][key].dtype
    np.testing.assert_array_equal(tply.read_ply(path)[2], [0, 1, -2.25])
    big = str(tmp_path / "big.ply")
    with open(big, "wb") as f:
        f.write(b"ply\nformat binary_big_endian 1.0\nelement vertex 2\n"
                b"property float x\nproperty float y\nproperty float z\n"
                b"end_header\n")
        f.write(np.arange(6, dtype=">f4").tobytes())
    np.testing.assert_array_equal(tply.read_ply(big), jply.read_ply(big))
    np.testing.assert_array_equal(tply.read_ply(big),
                                  np.arange(6, dtype=np.float32).reshape(2, 3))
    with open(big, "wb") as f:
        f.write(b"not a ply\n")
    with pytest.raises(ValueError, match="not a PLY"):
        tply.read_ply(big)


@pytest.mark.parametrize("ext", ["xyz", "ply"])
@pytest.mark.parametrize("count", [None, 60, 90, 45, 20],
                         ids=["as-is", "same", "pad", "choice", "fps"])
def test_load_dispatches_and_resizes_like_jax(rng, tmp_path, ext, count):
    """``load`` by extension, with ``count`` above (random repeats), just
    below (random choice) and far below (FPS from a random first point)
    the cloud's 60 points; numpy's global generator seeded alike."""
    pts = _cloud(rng)
    path = str(tmp_path / f"shape.{ext}")
    tio.save(pts, path)
    np.random.seed(11)
    want = jio.load(path, count)
    np.random.seed(11)
    got = tio.load(path, count)
    assert got.dtype == np.float32 and got.shape == (count or 60, 3)
    # the text parsers (numpy's here, a C++ one there) agree to 1e-6
    np.testing.assert_allclose(got, want, atol=1e-6)
    if count is None:
        np.testing.assert_allclose(got, pts, atol=1e-6)


def test_save_text_and_single_row(tmp_path):
    path = str(tmp_path / "one.xyz")
    tio.save(np.array([[1.0, 2.0, 3.0]]), path)
    got = tio.load(path)
    assert got.shape == (1, 3)
    np.testing.assert_array_equal(got, jio.load(path))


def test_downsampling_matches_jax(rng):
    """``FarthestSampler`` and ``downsample_points`` against JAX's, on
    clouds with normals (6 columns): the same rows."""
    pts = rng.standard_normal((80, 6)).astype(np.float32)
    np.random.seed(5)
    want = jpc.FarthestSampler()(pts, 12)
    np.random.seed(5)
    got = tpc.FarthestSampler()(pts, 12)
    np.testing.assert_array_equal(got, want)
    for k in (12, 50):
        np.random.seed(6)
        want = jpc.downsample_points(pts, k)
        np.random.seed(6)
        np.testing.assert_array_equal(tpc.downsample_points(pts, k), want)


def test_logger_is_jax_packages(capsys, monkeypatch):
    for mod in (jlogger, tlogger):
        mod.info("a", 1)
        mod.warn("b")
        mod.success("c")
    out = capsys.readouterr().out.splitlines()
    strip = [line.split("]", 1)[1] for line in out]
    assert strip[:3] == strip[3:] and "a 1" in strip[0]
    assert [line[:14] for line in out[:3]] == [line[:14] for line in out[3:]]
    with pytest.raises(SystemExit):
        tlogger.error("fatal")
    monkeypatch.setattr(tlogger, "exit_on_error", False)
    tlogger.error("not fatal")
    assert "not fatal" in capsys.readouterr().err
