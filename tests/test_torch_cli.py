"""The port's command line (``threepu_torch.cli``) held against the JAX
package's (``threepu.cli``): the same flags, the same result paths, and a
tiny file-to-file ``--phase test`` run on the CPU on the same checkpoint
and input file."""

import torch_threads  # noqa: F401  (first: sets torch's threads)
import argparse
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from threepu import cli as jcli
from threepu.io import load_checkpoint, load_opt_state
from threepu.io import read_ply as jread_ply
from threepu.io import save_checkpoint, save_pth
from threepu.models import Net as JNet
from threepu.train import model as jmodel

from threepu_torch import cli as tcli
from threepu_torch.data import synthetic as tsyn
from threepu_torch.io import read_ply
from threepu_torch.ops import knn as tknn

#: the configuration of tests/test_cli.py's end-to-end run
TINY = ["--num_shape_point", "64", "--num_point", "16", "--up_ratio", "4",
        "--knn", "4", "--growth_rate", "4", "--dense_n", "2", "--chunk", "4"]


def test_parser_has_every_flag_of_the_jax_cli():
    """Every action of ``threepu.cli.build_parser()`` has a counterpart
    with the same option strings, dest, default, type, choices and arity;
    the port adds one, ``--arch``, whose default is the JAX package's one
    net."""
    def actions(parser):
        return {a.dest: a for a in parser._actions
                if not isinstance(a, argparse._HelpAction)}

    want, got = actions(jcli.build_parser()), actions(tcli.build_parser())
    arch = got.pop("arch")
    assert (arch.option_strings, arch.default, arch.choices) == (
        ["--arch"], "3pu", ["3pu", "punet", "pugan"])
    assert list(got) == list(want)
    assert len(want) >= 40
    for dest, a in want.items():
        b = got[dest]
        assert (b.option_strings, b.default, b.type, b.choices, b.nargs,
                b.const, type(b)) == (a.option_strings, a.default, a.type,
                                      a.choices, a.nargs, a.const, type(a)), dest
    assert vars(tcli.build_parser().parse_args([])) == dict(
        vars(jcli.build_parser().parse_args([])), arch="3pu")


@pytest.mark.parametrize("argv", [
    ["--num_point", "312", "--num_shape_point", "5000", "--log_dir",
     "./model", "--id", "demo"],
    ["--num_shape_point", "5000", "--jitter", "--drop_out", "0.5"],
    ["--num_point", "10", "--result_dir", "/tmp/x"],
    [],
    ["--num_point", "312", "--jitter", "--jitter_sigma", "0.01",
     "--up_ratio", "4"]],
    ids=["clean", "jitter-dropout", "explicit", "whole", "sigma"])
def test_result_path_for_matches(argv):
    want = jcli.result_path_for(jcli.build_parser().parse_args(argv))
    assert tcli.result_path_for(tcli.build_parser().parse_args(argv)) == want
    if not argv:
        assert want.endswith(os.path.join("x16", "pWhole_sWhole_clean"))


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """One checkpoint written by ``threepu.io.save_checkpoint`` and one
    ``.xyz`` file in a folder of their own."""
    root = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(0)
    net = JNet(max_up_ratio=4, step_ratio=2, knn=4, growth_rate=4,
               dense_n=2, max_num_point=16)
    ex = jnp.asarray(rng.standard_normal((1, 16, 3)).astype(np.float32))
    gt = jnp.asarray(rng.standard_normal((1, 64, 3)).astype(np.float32))
    params = net.init({"params": jax.random.PRNGKey(0),
                       "patch": jax.random.PRNGKey(1)},
                      ex, 4, gt, train=True)["params"]
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), params)
    ckpt = str(root / "tiny.npz")
    save_checkpoint(ckpt, {"params": params}, step=0)
    data = root / "shapes"
    data.mkdir()
    np.savetxt(str(data / "shape.xyz"),
               rng.standard_normal((64, 3)).astype(np.float32))
    return root, ckpt, str(data / "*.xyz")


def test_cli_test_phase_matches_jax_file_to_file(tiny):
    """``main([...], device="cpu")`` in process against JAX's ``run_test``:
    both write ``<result_dir>/<parent folder>/shape.ply`` (256 points) and
    ``shape_input.ply`` (64 points).  The inputs agree to 1e-6; the
    outputs agree as point sets, Chamfer distance below 1e-9 (measured
    here: 9.4e-14, the same rows to float32 rounding; on the CPU no
    selection of this run flips)."""
    root, ckpt, pattern = tiny
    argv = ["--phase", "test", "--ckpt", ckpt, "--test_data", pattern] + TINY
    before = tknn.EXACT_SELECT_KERNEL
    tcli.main(argv + ["--result_dir", str(root / "t_out"), "--select_kernel",
                      "off"], device="cpu")
    assert tknn.EXACT_SELECT_KERNEL == before        # restored after the run
    jflags = jcli.build_parser().parse_args(
        argv + ["--result_dir", str(root / "j_out")])
    jcli.run_test(jflags, jcli.result_path_for(jflags))

    got = read_ply(str(root / "t_out" / "shapes" / "shape.ply"))
    got_in = read_ply(str(root / "t_out" / "shapes" / "shape_input.ply"))
    want = jread_ply(str(root / "j_out" / "shapes" / "shape.ply"))
    want_in = jread_ply(str(root / "j_out" / "shapes" / "shape_input.ply"))
    assert got.shape == want.shape == (256, 3)
    assert got_in.shape == want_in.shape == (64, 3)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got_in, want_in, atol=1e-6)
    d = np.sum((got[:, None].astype(np.float64) - want[None]) ** 2, -1)
    chamfer = d.min(1).mean() + d.min(0).mean()
    print("chamfer, port to JAX:", chamfer)
    assert chamfer < 1e-9


def test_cli_options_reach_the_pipeline(tiny, monkeypatch):
    """``--bucket``, ``--restitch_groups``, jitter, drop-out and the patch
    flags go to ``upsample_shape`` as the JAX CLI passes them; the derived
    ``num_point`` warns above 1024; ``--profile_dir`` wraps the first
    shape only and leaves a Chrome trace."""
    root, ckpt, _ = tiny
    two = root / "two"
    two.mkdir()
    np.savetxt(str(two / "shape.xyz"), np.ones((64, 3)))
    np.savetxt(str(two / "second.xyz"), np.eye(3))
    pattern = str(two / "*.xyz")
    calls, warned = [], []

    def fake(net, data, ratio, **kw):
        calls.append((data.shape, ratio, kw))
        return data[:, :3], np.zeros((4, 3), np.float32)

    monkeypatch.setattr(tcli, "upsample_shape", fake)
    monkeypatch.setattr(tcli.logger, "warn", lambda *m: warned.append(m))
    prof = root / "prof"
    tcli.main(["--phase", "test", "--ckpt", ckpt, "--test_data", pattern,
               "--num_shape_point", "2000", "--up_ratio", "4", "--knn", "4",
               "--growth_rate", "4", "--dense_n", "2", "--chunk", "3",
               "--bucket", "1024", "--restitch_groups", "2", "--jitter",
               "--jitter_sigma", "0.01", "--jitter_max", "0.02", "--drop_out",
               "0.75", "--patch_num_ratio", "2", "--result_dir",
               str(root / "opt_out"), "--profile_dir", str(prof)],
              device="cpu")
    assert [c[0] for c in calls] == [(2000, 3), (2000, 3)]  # padded by load
    assert calls[0][1] == 4
    assert calls[0][2] == dict(
        num_point=1500, patch_num_ratio=2.0, chunk=3, jitter=True,
        jitter_sigma=0.01, jitter_max=0.02, drop_out=0.75, bucket=1024,
        restitch_groups=2)
    assert len(warned) == 1 and "num_point=1500" in warned[0][0]
    assert (prof / "trace.json").stat().st_size > 0
    # sorted glob: second.xyz, then shape.xyz
    assert sorted(os.listdir(root / "opt_out" / "two")) == [
        "second.ply", "second_input.ply", "shape.ply", "shape_input.ply"]


def test_cli_no_match_warns_and_writes_nothing(tiny, capsys):
    root, ckpt, _ = tiny
    tcli.main(["--phase", "test", "--ckpt", ckpt, "--test_data",
               str(root / "none" / "*.xyz"), "--result_dir",
               str(root / "none_out")] + TINY, device="cpu")
    assert "no files match" in capsys.readouterr().out
    assert not (root / "none_out").exists()


@pytest.mark.parametrize("argv,error,match", [
    (["--phase", "vis", "--ckpt", ""], SystemExit, "--ckpt is required for vis"),
    (["--phase", "bogus"], SystemExit, "unknown phase"),
    (["--knn_method", "approx"], NotImplementedError, "approx"),
    (["--knn_method", "auto"], NotImplementedError, "auto"),
    (["--knn_method", "sort"], NotImplementedError, "sort"),
    (["--ckpt", ""], SystemExit, "--ckpt"),
    (["--num_point", "0", "--num_shape_point", "0"], SystemExit,
     "--num_point"),
    (["--test_data", ""], SystemExit, "--test_data"),
    (["--phase", "train"], SystemExit, "--h5_data")],
    ids=["vis", "bogus", "approx", "auto", "sort", "no-ckpt", "no-size",
         "no-data", "train-no-data"])
def test_cli_raises_on_what_is_not_ported_or_missing(tiny, argv, error, match):
    _, ckpt, pattern = tiny
    base = {"--phase": "test", "--ckpt": ckpt, "--test_data": pattern,
            "--num_point": "16", "--num_shape_point": "64"}
    base.update(zip(argv[::2], argv[1::2]))
    full = [x for k, v in base.items() if v not in ("", "0") for x in (k, v)]
    with pytest.raises(error, match=match):
        tcli.main(full, device="cpu")


def test_cli_runs_on_the_card_by_default(tiny, monkeypatch):
    """With no device named, ``main`` asks for the CUDA device ``--device``
    (else ``--gpu``) and raises where none is visible, in both phases."""
    root, ckpt, pattern = tiny
    argv = ["--phase", "test", "--ckpt", ckpt, "--test_data", pattern] + TINY
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(argv)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["--phase", "train", "--h5_data", train_file(root)] + TINY)
    asked = []

    def fake_load_net(weights, device, **cfg):
        asked.append((device, cfg))
        raise KeyboardInterrupt

    monkeypatch.setattr(tcli, "load_net", fake_load_net)
    for extra, ordinal in (([], 0), (["--gpu", "2"], 2),
                           (["--device", "1", "--gpu", "2"], 1)):
        with pytest.raises(KeyboardInterrupt):
            tcli.main(argv + extra)
        assert asked[-1][0] == torch.device("cuda", ordinal)
    assert asked[-1][1] == dict(max_up_ratio=4, step_ratio=2, knn=4,
                                growth_rate=4, dense_n=2, fm_knn=5)


def train_file(root) -> str:
    """A synthetic training file of 2 shapes at 64, 128 and 256 points,
    as ``.npz``."""
    return tsyn.write_synthetic_h5(
        str(root / "data"), n_shapes=2, seed=3, resolutions=(64, 128, 256),
        filename="train_poisson_64_poisson_128_poisson_256.npz")


def test_cli_train_phase_writes_the_epoch_checkpoint(tiny):
    """``--phase train`` on the CPU at the tiny size: one epoch of 300
    steps of batch 1 over curriculum stages 0-4 (``--stage_steps 40``)
    writes ``<log_dir>/<id>/model_1.npz`` at step 300, with the Adam
    state JAX's ``load_opt_state`` restores, and its weights serve
    ``--phase test``."""
    root, _, pattern = tiny
    log_dir = root / "train_log"
    tcli.main(["--phase", "train", "--h5_data", train_file(root),
               "--batch_size", "1", "--max_epoch", "1", "--stage_steps",
               "40", "--log_dir", str(log_dir), "--id", "smoke"] + TINY,
              device="cpu")
    ckpt = log_dir / "smoke" / "model_1.npz"
    assert sorted(os.listdir(log_dir / "smoke")) == ["model_1.npz"]
    params, step = load_checkpoint(str(ckpt))
    assert step == 300
    tx = jmodel.make_optimizer(5e-4)
    restored = load_opt_state(str(ckpt), tx.init(params["params"]))
    assert restored is not None and int(restored[1][0].count) == 300
    tcli.main(["--phase", "test", "--ckpt", str(ckpt), "--test_data",
               pattern, "--result_dir", str(root / "trained_out")] + TINY,
              device="cpu")
    out = read_ply(str(root / "trained_out" / "shapes" / "shape.ply"))
    assert out.shape == (256, 3) and np.isfinite(out).all()


def test_cli_pth_checkpoint_gives_the_npz_output(tiny):
    """``--ckpt x.pth`` (written by JAX's ``save_pth`` from the same
    weights) upsamples the file to the output of ``--ckpt x.npz``, bit for
    bit on the CPU."""
    root, ckpt, pattern = tiny
    params, _ = load_checkpoint(ckpt)
    pth = save_pth(str(root / "tiny.pth"), params, step=0)
    outs = []
    for weights in (ckpt, pth):
        out_dir = root / ("pth_out" if weights == pth else "npz_out")
        tcli.main(["--phase", "test", "--ckpt", weights, "--test_data",
                   pattern, "--result_dir", str(out_dir)] + TINY,
                  device="cpu")
        outs.append(read_ply(str(out_dir / "shapes" / "shape.ply")))
    assert outs[0].shape == (256, 3)
    assert np.array_equal(outs[0], outs[1])
