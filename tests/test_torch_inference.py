"""The PyTorch port's whole-shape pipeline held against the JAX package on
the CPU, plus the port's build/launch plumbing and ``chip_smoke.py``'s
refusal to run without a GPU."""

import importlib.util
import os
import shutil
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from threepu import inference as jinf
from threepu.io.checkpoint import _flatten
from threepu.models import Net as JNet

from threepu_torch import _build, device
from threepu_torch import inference as tinf
from threepu_torch.io.weights import load_jax_checkpoint, state_dict_from_jax
from threepu_torch.models import Net as TNet
from threepu_torch.utils import pc_utils

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(max_up_ratio=4, step_ratio=2, knn=8, growth_rate=4, dense_n=2,
             max_num_point=32, fm_knn=3)


@pytest.fixture(scope="module")
def golden():
    """tests/test_golden.py's fixed-seed tiny net and 96-point shape, with
    float32 params, and the port's net on the same weights."""
    rng = np.random.default_rng(1234)
    net = JNet(**SMALL)
    pts = rng.standard_normal((96, 3)).astype(np.float32)
    pts /= np.linalg.norm(pts, axis=1, keepdims=True)
    ex = jnp.asarray(pts[None, :32])
    gt = jnp.asarray(rng.standard_normal((1, 128, 3)).astype(np.float32))
    init = jax.jit(lambda rngs, x, g: net.init(rngs, x, 4, g, train=True))
    params = init({"params": jax.random.PRNGKey(7),
                   "patch": jax.random.PRNGKey(8)}, ex, gt)["params"]
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), params)
    tnet = TNet(**SMALL)
    tnet.load_state_dict(state_dict_from_jax(_flatten(params)), strict=True)
    return net, params, tnet, pts


@pytest.mark.parametrize("groups", [None, 2], ids=["exact", "G2"])
def test_golden_pipeline_matches(golden, groups):
    """upsample_point_cloud at num_point=32, 4x, chunk 4: exact final FPS
    and the G=2 hierarchical re-stitch.  Selections agree on the CPU, so
    the outputs agree to float32 rounding: atol 1e-5."""
    net, params, tnet, pts = golden
    want = np.asarray(jinf.upsample_point_cloud(
        net, params, jnp.asarray(pts), 4, num_point=32, num_out=384, chunk=4,
        restitch_groups=groups))
    got = tinf.upsample_point_cloud(tnet, torch.from_numpy(pts), 4,
                                    num_point=32, num_out=384, chunk=4,
                                    restitch_groups=groups).numpy()
    assert got.shape == (384, 3)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_masked_pipeline_matches(golden):
    """valid_n / valid_patches: a shape zero-padded to 128 rows, masked
    through seed FPS, grouping and the final FPS (the bucketed call)."""
    net, params, tnet, pts = golden
    padded = np.zeros((128, 3), np.float32)
    padded[:96] = pts
    true_patches = int(96 / 32 * 3.0)
    want = np.asarray(jinf.upsample_point_cloud(
        net, params, jnp.asarray(padded), 4, num_point=32, num_out=512,
        chunk=4, valid_n=jnp.asarray(96, jnp.int32),
        valid_patches=jnp.asarray(true_patches, jnp.int32)))
    got = tinf.upsample_point_cloud(
        tnet, torch.from_numpy(padded), 4, num_point=32, num_out=512, chunk=4,
        valid_n=96, valid_patches=true_patches).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_upsample_shape_matches(golden):
    """Host flow with FPS drop-out (96 -> 72 points), normalize and
    denormalize in the original frame."""
    net, params, tnet, pts = golden
    shape = pts * 3.0 + 1.5
    jd, ju = jinf.upsample_shape(net, params, shape, 4, num_point=32, chunk=4,
                                 drop_out=0.75)
    td, tu = tinf.upsample_shape(tnet, shape, 4, num_point=32, chunk=4,
                                 drop_out=0.75)
    assert tu.shape == (72 * 4, 3)
    np.testing.assert_allclose(td, jd, atol=1e-6)
    np.testing.assert_allclose(tu, ju, atol=3e-5)


def test_upsample_shape_jitter_is_seeded(golden):
    _, _, tnet, pts = golden
    a = tinf.upsample_shape(tnet, pts, 4, num_point=32, chunk=4, jitter=True,
                            seed=3)
    b = tinf.upsample_shape(tnet, pts, 4, num_point=32, chunk=4, jitter=True,
                            seed=3)
    c = tinf.upsample_shape(tnet, pts, 4, num_point=32, chunk=4, jitter=True,
                            seed=4)
    np.testing.assert_array_equal(a[1], b[1])
    assert not np.array_equal(a[0], c[0])
    # jitter is clipped to 0.005 in the normalized frame
    furthest = pc_utils.normalize_point_cloud(pts)[2].item()
    assert np.abs(a[0] - pts).max() <= 0.005 * furthest + 1e-6


@pytest.mark.parametrize("n,num_point,chunk", [(5000, 312, 8), (96, 32, 4),
                                               (5000, 312, None), (300, 312, 8),
                                               (1000, 312, 3)])
def test_plan_patches_matches(n, num_point, chunk):
    assert tinf.plan_patches(n, num_point, 3.0, chunk) == jinf.plan_patches(
        n, num_point, 3.0, chunk)


def test_restitch_defaults_match():
    assert tinf.DEFAULT_RESTITCH_GROUPS == jinf.DEFAULT_RESTITCH_GROUPS == 8
    assert tinf.RESTITCH_AUTO_MIN_OUT == jinf.RESTITCH_AUTO_MIN_OUT
    for req, out in [(None, 80000), (None, 384), (1, 80000), (3, 100)]:
        assert tinf.resolve_restitch_groups(req, out) == \
            jinf.resolve_restitch_groups(req, out)


def test_fixture_is_consistent():
    """tests/fixtures/torch_port_ref.npz (the GPU end-to-end check's
    reference): shapes, and its recorded JAX Chamfer distance to gt."""
    fx = np.load(os.path.join(ROOT, "tests", "fixtures",
                              "torch_port_ref.npz"))
    assert fx["input"].shape == (5000, 3) and fx["gt"].shape == (80000, 3)
    assert fx["jax_out"].shape == (80000, 3)
    out, gt = fx["jax_out"].astype(np.float64), fx["gt"].astype(np.float64)
    cd = ((cKDTree(gt).query(out)[0] ** 2).mean()
          + (cKDTree(out).query(gt)[0] ** 2).mean())
    np.testing.assert_allclose(cd, float(fx["jax_cd_gt"]), rtol=1e-4)
    assert fx["jax_pert_cd"].shape == (2,)
    assert (fx["jax_pert_cd"] > 0).all()
    assert fx["cascade_in"].shape == (1, 312, 3)
    for l, n_sub in ((2, 10), (3, 20), (4, 40)):
        assert fx[f"cascade_xyz_{l}"].shape == (1, 312 * 2 ** (l - 1), 3)
        assert fx[f"cascade_sub_{l}"].shape == (n_sub, 312, 3)
        assert fx[f"cascade_out_{l}"].shape == (n_sub, 624, 3)
        assert 1 <= int(fx[f"cascade_true_sub_{l}"][0]) <= n_sub


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_cascade_replay_matches_fixture():
    """chip_smoke.py's phase 4a on the CPU: the trained 16x cascade of
    one patch, each step fed JAX's input, within the bands the GPU run
    is held to (>= 99% of each level's rows within 1e-4 of JAX's; the
    sub-patches JAX's).  On the CPU the extraction is exact."""
    smoke = _chip_smoke()
    net = TNet(**smoke.NET).eval()
    net.load_state_dict(load_jax_checkpoint(smoke.WEIGHTS), strict=True)
    stats = smoke.replay_cascade(net, np.load(smoke.FIXTURE),
                                 torch.device("cpu"))
    print(stats)
    assert [st["level"] for st in stats] == [1, 2, 3, 4]
    smoke.check_replay(stats)
    assert all(st["sub_points"] == 1.0 for st in stats[1:])


@pytest.mark.parametrize("field,value", [("rows_1e4", 0.98),
                                         ("sub_points", 0.9),
                                         ("true_sub", 7)])
def test_check_replay_rejects_a_level_off_band(field, value):
    smoke = _chip_smoke()
    good = [dict(level=1, rows_1e4=1.0, max_abs_err=0.0),
            dict(level=2, rows_1e4=0.995, max_abs_err=1e-3, sub_points=1.0,
                 true_sub=9, jax_true_sub=9)]
    smoke.check_replay(good)
    good[1][field] = value
    with pytest.raises(AssertionError, match="level 2"):
        smoke.check_replay(good)


# ---------------------------------------------------- device and build
def test_require_cuda_raises_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device.require_cuda()


def test_fp32_policy_turns_tf32_off():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        device.set_fp32_policy()
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def test_nvcc_missing_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()


_FAKE_NVCC = """#!/bin/sh
# writes its -o target; fails on a source that holds BROKEN
out=""; prev=""
for a in "$@"; do [ "$prev" = "-o" ] && out="$a"; prev="$a"; done
for a in "$@"; do
  case "$a" in *.cu) if grep -q BROKEN "$a"; then echo "bad $a" >&2; exit 2; fi;; esac
done
echo "$@" >> "$(dirname "$0")/calls"
echo built > "$out"
"""


@pytest.mark.parametrize("broken", [False, True], ids=["ok", "broken"])
def test_build_compiles_each_source_then_links(monkeypatch, tmp_path, broken):
    """One nvcc per source, then one link into the hashed library; a
    failing source raises with its command and output, and links
    nothing."""
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text(_FAKE_NVCC)
    nvcc.chmod(0o755)
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("a.cu", "b.cu"):
        (csrc / name).write_text("BROKEN" if broken and name == "b.cu" else "")
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(shutil, "which", lambda name: str(nvcc))
    if broken:
        with pytest.raises(RuntimeError, match="bad .*b.cu"):
            _build.build()
        assert not _build.library_path().exists()
    else:
        assert _build.build() == _build.library_path()
        calls = (nvcc.parent / "calls").read_text().splitlines()
        assert sum(" -c " in c for c in calls) == 2
        assert "-shared" in calls[-1] and "a.o" in calls[-1]
    assert [p.name for p in (tmp_path / "build").iterdir()] == (
        [] if broken else [_build.library_path().name])


def test_library_path_follows_the_sources():
    path = _build.library_path()
    assert path.parent == _build.BUILD_DIR
    assert path == _build.library_path()
    sources = {p.name for p in _build.CSRC_DIR.glob("*.cu")}
    assert {"select.cu", "fps.cu", "interlevel.cu", "chamfer.cu"} <= sources


class _FakeLib:
    def __init__(self, err):
        self.err = err
        self.calls = []

        def launch(*args):
            self.calls.append(args)
            return self.err

        self.threepu_fake = launch
        self.threepu_error_string = lambda e: b"fake failure"


@pytest.mark.parametrize("err", [0, 2], ids=["ok", "refused"])
def test_kernel_counts_only_accepted_launches(monkeypatch, err):
    """A launch adds one to the count; a refused one (cudaError_t != 0)
    raises and adds nothing."""
    lib = _FakeLib(err)
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=1234))
    k = _build.Kernel("threepu_fake", [], source="x.cu", replaces="y.py:1")
    if err:
        with pytest.raises(RuntimeError, match="fake failure"):
            k(7, 8)
        assert k.launches == 0
    else:
        k(7, 8)
        k(7, 8)
        assert k.launches == 2
    assert lib.calls[0] == (7, 8, 1234)


def test_wrappers_take_the_plain_path_on_cpu():
    """On CPU tensors each wrapper runs its plain version and launches
    nothing; the kernels' argument check refuses CPU tensors."""
    import threepu_torch.ops.chamfer as tcham
    import threepu_torch.ops.fps as tfps
    import threepu_torch.ops.interlevel as til
    with pytest.raises(ValueError, match="CUDA tensor"):
        _build.check_cuda_tensor("x", torch.zeros(2, 3), torch.float32, 2)
    before = (tfps.KERNEL.launches, til.KERNEL.launches, tcham.KERNEL.launches)
    g = torch.Generator().manual_seed(0)
    pts = torch.randn(1, 40, 3, generator=g)
    assert torch.equal(tfps.fps(pts, 5), tfps.fps_plain(pts, 5))
    args = (torch.randn(2, 40, 3, generator=g), torch.randn(2, 40, 6,
                                                          generator=g),
            pts, torch.randn(1, 40, 6, generator=g),
            torch.zeros(1, 40, dtype=torch.bool), 3)
    for a, b in zip(til.interlevel(*args), til.interlevel_plain(*args)):
        assert torch.equal(a, b)
    for a, b in zip(tcham.nn_one_way(pts, args[0][:1]),
                    tcham.nn_one_way_plain(pts, args[0][:1])):
        assert torch.equal(a, b)
    assert (tfps.KERNEL.launches, til.KERNEL.launches,
            tcham.KERNEL.launches) == before


# ------------------------------------------------------------ chip_smoke
def _run_smoke(cwd, env):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_a_gpu():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = _run_smoke(ROOT, env)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_chip_smoke_fails_alone(tmp_path):
    """Copied into a directory that holds nothing else of the repo, it
    must fail and print no result, whether or not a GPU is visible."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = _run_smoke(tmp_path, env)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
