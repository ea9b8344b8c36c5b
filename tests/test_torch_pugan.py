"""PU-GAN's generator on the port's eval path (``threepu_torch.models.PUGAN``)
against its plain reference (``threepu_torch/reference/pugan.py``), on the
CPU at a small size: patches of 64 points (so 384 rows attend to each
other), seeded weights with a non-zero ``gamma``, every width as
published."""

import torch_threads  # noqa: F401  (first: sets torch's threads)
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from threepu_torch import cli as tcli
from threepu_torch.inference import upsample_shape
from threepu_torch.io import load
from threepu_torch.models import PUGAN, gen_rect_grid, load_net
from threepu_torch.models.pugan import UpBlock
from threepu_torch.ops.attention import attention
from threepu_torch.ops.normalize import normalize_point_batch_cl
from threepu_torch.reference import pugan as ref
from threepu_torch.utils.profiling import clear_spans, finished_spans

ROOT = Path(__file__).resolve().parent.parent
NUM_POINT = 64
FE, PU = "feature_extraction", "up_projection_unit"


def _dense_conv(scope, c_in):
    """Stage ``l<j>`` of a published dense conv is the port's ``mlps.<j>``."""
    return {f"{scope}.mlps.{j}": (24, w) for j, w in
            enumerate((2 * c_in, 24 + c_in, 48 + c_in))}


def _up(scope):
    att = scope + ".attention_unit"
    return {f"{att}.conv_f": (32, 130), f"{att}.conv_g": (32, 130),
            f"{att}.conv_h": (130, 130), f"{scope}.conv1": (256, 130),
            f"{scope}.conv2": (128, 256)}


#: every conv under its published scope, with its (out, in) shape
PUBLISHED = {
    f"{FE}.layer0": (24, 3), **_dense_conv(f"{FE}.layer1", 24),
    f"{FE}.layer2_prep": (48, 120), **_dense_conv(f"{FE}.layer2", 48),
    f"{FE}.layer3_prep": (48, 240), **_dense_conv(f"{FE}.layer3", 48),
    f"{FE}.layer4_prep": (48, 360), **_dense_conv(f"{FE}.layer4", 48),
    f"{PU}.conv0": (128, 480), **_up(f"{PU}.up_0"), **_up(f"{PU}.up_1"),
    f"{PU}.down_0.conv1": (256, 128), f"{PU}.down_0.conv2": (128, 256),
    "fc_layer1": (64, 128), "fc_layer2": (3, 64),
}
#: the kernel's trailing axes where it is not a 1x1 conv2d's (1, 1)
KERNEL_AXES = {f"{FE}.layer{i}_prep": (1,) for i in (2, 3, 4)}
KERNEL_AXES[f"{PU}.down_0.conv1"] = (1, 6)
GAMMAS = [f"{PU}.up_{j}.attention_unit.gamma" for j in (0, 1)]


def surface(n, seed):
    """``n`` points of a bumpy closed surface."""
    rng = np.random.default_rng(seed)
    p = rng.standard_normal((n, 3)).astype(np.float32)
    p /= np.linalg.norm(p, axis=-1, keepdims=True)
    return (p * (1 + 0.2 * np.sin(3 * p[:, :1]))).astype(np.float32)


def seeded_net(seed=0):
    torch.manual_seed(seed)
    net = PUGAN(num_point=NUM_POINT).eval()
    # non-zero biases, so that a bias taken from the wrong layer shows, and
    # a gamma that keeps the attention in the output
    with torch.no_grad():
        for name, p in net.named_parameters():
            if name.endswith("bias"):
                p.uniform_(-0.05, 0.05)
            elif name.endswith("gamma"):
                p.uniform_(0.5, 1.5)
    return net


def patches(seed, p=2):
    """``p`` normalized kNN patches of ``NUM_POINT`` points."""
    shape = torch.from_numpy(surface(400, seed))
    centres = shape[torch.randperm(400, generator=torch.Generator()
                                   .manual_seed(seed))[:p]]
    near = torch.cdist(centres, shape).argsort(-1)[:, :NUM_POINT]
    return normalize_point_batch_cl(shape[near])[0].contiguous()


@pytest.mark.parametrize("seed", [0, 1])
def test_pugan_follows_the_reference(seed):
    net = seeded_net(seed)
    x = patches(seed)
    got, want = {}, {}
    out = net.upsample(x, 4, capture=got)
    ref_out = ref.forward(net.state_dict(), x, record=want)
    assert out.shape == (2, 4 * NUM_POINT, 3)
    assert set(got) <= set(want)
    for i in (1, 2, 3, 4):
        assert got[f"extract.nn{i}"].shape == (2, NUM_POINT, 16)
        assert torch.equal(got[f"extract.nn{i}"], want[f"extract.nn{i}"]), i
    assert torch.equal(got["fps.picks"], want["fps.picks"])
    assert got["fps.picks"].dtype == torch.int32
    assert got["extract.features"].shape == (2, NUM_POINT, 480)
    assert got["coords"].shape == (2, 6 * NUM_POINT, 3)
    for key in ("extract.features", "up_down_up.features", "coords"):
        torch.testing.assert_close(got[key], want[key], rtol=0, atol=1e-5,
                                   msg=key)
    torch.testing.assert_close(out, ref_out, rtol=0, atol=1e-5)
    assert float(out.abs().max()) > 1e-3


@pytest.mark.parametrize("j", [0, 1])
def test_an_up_block_and_its_attention_follow_the_reference(j):
    """Each up block's parts on features of its own: its attention
    product alone and the block's output."""
    net = seeded_net(4)
    block = net.up_projection_unit[f"up_{j}"]
    feat = torch.randn(3, NUM_POINT, 128,
                       generator=torch.Generator().manual_seed(j))
    x, f, g, h = block.units(feat)
    o = attention(g, f, h)
    rec = {}
    want = ref.up_block(net.state_dict(), f"{PU}.up_{j}", feat, rec)
    torch.testing.assert_close(o, rec[f"{PU}.up_{j}.attention"], rtol=0,
                               atol=1e-6)
    torch.testing.assert_close(block.mlp(o, x), want, rtol=0, atol=1e-5)
    assert o.shape == (3, 6 * NUM_POINT, 130)


def test_the_attention_is_unscaled_softmax_attention():
    gen = torch.Generator().manual_seed(3)
    q, k = torch.randn(2, 40, 32, generator=gen), torch.randn(2, 40, 32,
                                                             generator=gen)
    v = torch.randn(2, 40, 130, generator=gen)
    s = q.double() @ k.double().transpose(1, 2)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    want = (e / e.sum(-1, keepdim=True)) @ v.double()
    torch.testing.assert_close(attention(q, k, v).double(), want, rtol=0,
                               atol=1e-5)


def test_the_code_grid_and_the_tile_row_order():
    """PU-GAN's ``gen_grid(6)``: 3 x 2, ``meshgrid`` in ``xy`` order, so
    row ``a`` is ``(gx[a % 3], gy[a // 3])``; an up block's row ``a N +
    i`` holds point ``i`` beside grid point ``a``."""
    gx, gy = [-0.2, 0.0, 0.2], [-0.2, 0.2]
    grid = gen_rect_grid(6)
    assert grid.shape == (6, 2) and grid.dtype == np.float32
    for a in range(6):
        np.testing.assert_allclose(grid[a], [gx[a % 3], gy[a // 3]],
                                   atol=1e-7)
    np.testing.assert_allclose(gen_rect_grid(4), [[-0.2, -0.2], [0.2, -0.2],
                                                  [-0.2, 0.2], [0.2, 0.2]])
    assert torch.equal(ref.grid(6), torch.from_numpy(grid))
    feat = torch.randn(2, 5, 128)
    x, *_ = UpBlock(6).units(feat)
    for a in range(6):
        for i in range(5):
            assert torch.equal(x[:, a * 5 + i, :128], feat[:, i])
            assert torch.equal(x[:, a * 5 + i, 128:],
                               torch.from_numpy(grid[a]).expand(2, 2))


@pytest.mark.parametrize("seed", [0, 5])
def test_a_zero_gamma_changes_the_output(seed):
    """The attention is live at seeded weights: with both ``gamma`` set
    to 0 (the published start) the candidates move."""
    net = seeded_net(seed)
    x = patches(seed)
    got = {}
    net.upsample(x, 4, capture=got)
    with torch.no_grad():
        for name in GAMMAS:
            net.get_parameter(name).zero_()
    dead = {}
    net.upsample(x, 4, capture=dead)
    assert float((got["coords"] - dead["coords"]).abs().max()) > 1e-3


def test_upsample_shape_follows_the_reference_pipeline():
    """The whole shape: seed FPS, kNN patches, chunks of 4 with padding,
    the net and the exact FPS re-stitch, against the reference's plain
    pipeline (one patch at a time, no padding)."""
    net = seeded_net(3)
    pts = surface(200, 3) * 2.5 + 0.4
    inp, up = upsample_shape(net, pts, 4, num_point=NUM_POINT, chunk=4)
    want, records = ref.pipeline(net.state_dict(), pts, NUM_POINT)
    assert len(records) == 9
    assert up.shape == want.shape == (800, 3)
    np.testing.assert_allclose(inp, pts, atol=1e-6)
    np.testing.assert_allclose(up, want, rtol=0, atol=1e-5)


def test_the_ratio_and_patch_size_are_the_nets():
    net = seeded_net()
    with pytest.raises(ValueError, match="4x"):
        net.upsample(patches(0), 16)
    with pytest.raises(ValueError, match="64 points"):
        net.upsample(patches(0)[:, :32], 4)
    with pytest.raises(ValueError, match="more than 16"):
        PUGAN(num_point=16)
    with pytest.raises(ValueError, match="4x"):
        PUGAN(up_ratio=16)


def test_load_net_takes_the_published_scopes_strictly(tmp_path):
    src = seeded_net(7)
    state = src.state_dict()
    assert {k.rsplit(".", 1)[0] for k in state if not k.endswith("gamma")} \
        == set(PUBLISHED)
    for scope, (c_out, c_in) in PUBLISHED.items():
        axes = KERNEL_AXES.get(scope, (1, 1))
        assert state[scope + ".weight"].shape == (c_out, c_in, *axes), scope
        assert state[scope + ".bias"].shape == (c_out,), scope
    for name in GAMMAS:
        assert state[name].shape == (1,)
        assert PUGAN(NUM_POINT).state_dict()[name].item() == 0.0
    path = str(tmp_path / "pugan.pth")
    torch.save(state, path)
    net = load_net(path, device="cpu", arch="pugan", num_point=NUM_POINT)
    assert isinstance(net, PUGAN)
    for k, v in net.state_dict().items():
        assert torch.equal(v, state[k]), k
    state.pop(GAMMAS[1])
    torch.save(state, str(tmp_path / "short.pth"))
    with pytest.raises(RuntimeError, match="gamma"):
        load_net(str(tmp_path / "short.pth"), device="cpu", arch="pugan",
                 num_point=NUM_POINT)


def test_the_reference_imports_nothing_of_the_port_or_jax():
    code = (
        "import importlib.util, sys\n"
        "spec = importlib.util.spec_from_file_location('pugan_ref', %r)\n"
        "mod = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(mod)\n"
        "top = {m.split('.')[0] for m in sys.modules}\n"
        "print(sorted(top & {'jax', 'jaxlib', 'flax', 'threepu',\n"
        "                    'threepu_torch'}))\n"
        % str(ROOT / "threepu_torch" / "reference" / "pugan.py"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    assert out.stdout.strip() == "[]"
    text = (ROOT / "threepu_torch" / "reference" / "pugan.py").read_text()
    assert "allow_tf32 = False" in text


def test_the_pugan_spans_nest_under_the_cascade():
    net = seeded_net()
    clear_spans()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            upsample_shape(net, surface(120, 1), 4, num_point=NUM_POINT,
                           chunk=4)
        recs = finished_spans()
    finally:
        clear_spans()
    by_id = {r["id"]: r for r in recs}
    names = [r["name"] for r in recs]
    parents = {"pugan.extract": "cascade", "pugan.up_down_up": "cascade",
               "pugan.coords": "cascade", "pugan.fps": "cascade",
               "pugan.up0": "pugan.up_down_up",
               "pugan.down": "pugan.up_down_up",
               "pugan.up1": "pugan.up_down_up",
               "pugan.up0.attention": "pugan.up0",
               "pugan.up1.attention": "pugan.up1"}
    for name, parent in parents.items():
        assert names.count(name) == 2, name            # two chunks
        assert all(by_id[r["parent"]]["name"] == parent
                   for r in recs if r["name"] == name), name
    annotations = {e.name for e in prof.events()}
    assert {"threepu." + s for s in parents} <= annotations


def test_cli_test_phase_runs_pugan(tmp_path):
    net = seeded_net(2)
    ckpt = str(tmp_path / "pugan.pth")
    torch.save(net.state_dict(), ckpt)
    data = tmp_path / "shapes"
    data.mkdir()
    np.savetxt(data / "a.xyz", surface(100, 4))
    out = tmp_path / "out"
    argv = ["--phase", "test", "--arch", "pugan", "--ckpt", ckpt,
            "--up_ratio", "4", "--num_point", str(NUM_POINT), "--chunk", "4",
            "--test_data", str(data / "*.xyz"), "--result_dir", str(out)]
    tcli.main(argv, device="cpu")
    got = load(str(out / "shapes" / "a.ply"))
    want, _ = ref.pipeline(net.state_dict(), load(str(data / "a.xyz")),
                           NUM_POINT)
    assert got.shape == (400, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    with pytest.raises(SystemExit, match="--arch pugan runs --phase test"):
        tcli.main(["--phase", "train"] + argv[2:], device="cpu")
    with pytest.raises(ValueError, match="4x"):
        tcli.main([a if a != "4" else "16" for a in argv], device="cpu")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_pugan_on_the_card_follows_the_reference(card):
    """The card's edge-conv, selection and FPS kernels and cuBLAS
    products, run as written at the first call, in the CUDA graphs the
    second call captures and in their replay at the third, on other
    patches each time, against the reference on the card: the same
    selections, coordinates within 1e-5, at the published 256 points a
    patch (1,536 rows in each attention)."""
    import threepu_torch.ops.edgeconv as ec_mod

    torch.manual_seed(0)
    net = PUGAN().to(card).eval()
    with torch.no_grad():
        for name in GAMMAS:
            net.get_parameter(name).fill_(0.75)
    shape = torch.from_numpy(surface(5000, 9))
    outs = []
    for first in (0, 8, 16):
        near = torch.cdist(shape[first:first + 8], shape).argsort(-1)
        x = normalize_point_batch_cl(shape[near[:, :256]])[0].to(card)
        got, want = {}, {}
        launches = ec_mod.KERNEL.launches
        out = net.upsample(x, 4, capture=got)
        assert ec_mod.KERNEL.launches == launches + 4
        outs.append(out)
        ref_out = ref.forward(net.state_dict(), x, record=want)
        for key in ("extract.nn1", "extract.nn2", "extract.nn3",
                    "extract.nn4", "fps.picks"):
            assert torch.equal(got[key], want[key]), key
        torch.testing.assert_close(got["coords"], want["coords"], rtol=0,
                                   atol=1e-5)
        torch.testing.assert_close(out, ref_out, rtol=0, atol=1e-5)
    # one set of graphs, and each call's output its own
    assert len(net._stages) == 1 and len(net._stages[next(
        iter(net._stages))].graphs) == 11
    assert not torch.equal(outs[0], outs[1])
    net.to("cpu")
    assert not net._stages
