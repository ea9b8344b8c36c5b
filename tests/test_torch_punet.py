"""PU-Net's generator on the port's eval path (``threepu_torch.models.PUNet``)
against its plain reference (``threepu_torch/reference/punet.py``), on the
CPU at a small size: patches of 64 points, seeded weights, every width as
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
from threepu_torch.models import PUNet, load_net
from threepu_torch.ops.normalize import normalize_point_batch_cl
from threepu_torch.ops.three_nn import three_interpolate, three_nn
from threepu_torch.reference import punet as ref
from threepu_torch.utils.profiling import clear_spans, finished_spans

ROOT = Path(__file__).resolve().parent.parent
NUM_POINT = 64

#: every parameter under its published scope, with its (out, in) shape
PUBLISHED = {
    "layer1.conv0": (32, 3), "layer1.conv1": (32, 32),
    "layer1.conv2": (64, 32),
    "layer2.conv0": (64, 67), "layer2.conv1": (64, 64),
    "layer2.conv2": (128, 64),
    "layer3.conv0": (128, 131), "layer3.conv1": (128, 128),
    "layer3.conv2": (256, 128),
    "layer4.conv0": (256, 259), "layer4.conv1": (256, 256),
    "layer4.conv2": (512, 256),
    "fa_layer1.conv_0": (64, 512), "fa_layer2.conv_0": (64, 256),
    "fa_layer3.conv_0": (64, 128),
    **{f"up_layer.fc_layer0_{i}": (256, 259) for i in range(4)},
    **{f"up_layer.conv_{i}": (128, 256) for i in range(4)},
    "fc_layer1": (64, 128), "fc_layer2": (3, 64),
}


def surface(n, seed):
    """``n`` points of a bumpy closed surface."""
    rng = np.random.default_rng(seed)
    p = rng.standard_normal((n, 3)).astype(np.float32)
    p /= np.linalg.norm(p, axis=-1, keepdims=True)
    return (p * (1 + 0.2 * np.sin(3 * p[:, :1]))).astype(np.float32)


def seeded_net(seed=0):
    torch.manual_seed(seed)
    net = PUNet(num_point=NUM_POINT).eval()
    # non-zero biases, so that a bias taken from the wrong layer shows
    with torch.no_grad():
        for name, p in net.named_parameters():
            if name.endswith("bias"):
                p.uniform_(-0.05, 0.05)
    return net


def patches(seed, p=2):
    """``p`` normalized kNN patches of ``NUM_POINT`` points."""
    shape = torch.from_numpy(surface(400, seed))
    centres = shape[torch.randperm(400, generator=torch.Generator()
                                   .manual_seed(seed))[:p]]
    near = torch.cdist(centres, shape).argsort(-1)[:, :NUM_POINT]
    return normalize_point_batch_cl(shape[near])[0].contiguous()


@pytest.mark.parametrize("seed", [0, 1])
def test_punet_follows_the_reference(seed):
    net = seeded_net(seed)
    x = patches(seed)
    got, want = {}, {}
    out = net.upsample(x, 4, capture=got)
    ref_out = ref.forward(net.state_dict(), x, record=want)
    assert out.shape == (2, 4 * NUM_POINT, 3)
    assert set(got) == set(want)
    for key in got:
        if key.endswith((".picks", ".ball", ".nn")):
            assert got[key].dtype == torch.int32, key
            assert torch.equal(got[key], want[key]), key
    for l in (1, 2, 3, 4):
        assert got[f"sa{l}.picks"].shape == (2, NUM_POINT // 2 ** (l - 1))
        assert got[f"sa{l}.ball"].shape[-1] == 32
    # SA1 picks every point once
    every = torch.arange(NUM_POINT, dtype=torch.int32).expand(2, -1)
    assert torch.equal(got["sa1.picks"].sort(-1).values, every)
    assert got["expand.features"].shape == (2, 4 * NUM_POINT, 128)
    torch.testing.assert_close(out, ref_out, rtol=0, atol=1e-5)
    assert float(out.abs().max()) > 1e-3


def test_three_nn_interpolation_against_a_loop():
    g = torch.Generator().manual_seed(5)
    xyz = torch.rand(2, 20, 3, generator=g)
    known = torch.rand(2, 7, 3, generator=g)
    known[1, 3] = xyz[1, 4]                  # a point on a known point
    feat = torch.randn(2, 7, 5, generator=g)
    d, idx = three_nn(xyz, known)
    out = three_interpolate(feat, idx, d)
    for b in range(2):
        for i in range(20):
            dist = [float(((xyz[b, i] - known[b, j]) ** 2).sum())
                    for j in range(7)]
            near = sorted(range(7), key=lambda j: (dist[j], j))[:3]
            assert idx[b, i].tolist() == near
            inv = [1.0 / max(dist[j], 1e-10) for j in near]
            want = sum(w / sum(inv) * feat[b, j] for w, j in zip(inv, near))
            torch.testing.assert_close(out[b, i], want, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(out[1, 4], feat[1, 3], rtol=0, atol=1e-6)


def test_upsample_shape_follows_the_reference_pipeline():
    """The whole shape: seed FPS, kNN patches, chunks of 4 with padding,
    the net and the exact FPS re-stitch, against the reference's plain
    pipeline (one patch at a time, no padding)."""
    net = seeded_net(3)
    pts = surface(200, 3) * 2.5 + 0.4
    inp, up = upsample_shape(net, pts, 4, num_point=NUM_POINT, chunk=4)
    want, _ = ref.pipeline(net.state_dict(), pts, NUM_POINT)
    assert up.shape == want.shape == (800, 3)
    np.testing.assert_allclose(inp, pts, atol=1e-6)
    np.testing.assert_allclose(up, want, rtol=0, atol=1e-5)


def test_the_ratio_and_patch_size_are_the_published_nets():
    net = seeded_net()
    with pytest.raises(ValueError, match="4x"):
        net.upsample(patches(0), 16)
    with pytest.raises(ValueError, match="64 points"):
        net.upsample(patches(0)[:, :32], 4)
    with pytest.raises(ValueError, match="4x"):
        PUNet(up_ratio=16)


def test_load_net_takes_the_published_scopes_strictly(tmp_path):
    src = seeded_net(7)
    state = src.state_dict()
    assert {k.rsplit(".", 1)[0] for k in state} == set(PUBLISHED)
    for scope, (c_out, c_in) in PUBLISHED.items():
        assert state[scope + ".weight"].shape == (c_out, c_in, 1, 1), scope
        assert state[scope + ".bias"].shape == (c_out,), scope
    path = str(tmp_path / "punet.pth")
    torch.save(state, path)
    net = load_net(path, device="cpu", arch="punet", num_point=NUM_POINT)
    assert isinstance(net, PUNet)
    for k, v in net.state_dict().items():
        assert torch.equal(v, state[k]), k
    state.pop("fc_layer2.bias")
    torch.save(state, str(tmp_path / "short.pth"))
    with pytest.raises(RuntimeError, match="fc_layer2.bias"):
        load_net(str(tmp_path / "short.pth"), device="cpu", arch="punet",
                 num_point=NUM_POINT)
    with pytest.raises(ValueError, match="no net"):
        load_net(None, device="cpu", arch="pugcn")


def test_the_reference_imports_nothing_of_the_port_or_jax():
    code = (
        "import importlib.util, sys\n"
        "spec = importlib.util.spec_from_file_location('punet_ref', %r)\n"
        "mod = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(mod)\n"
        "top = {m.split('.')[0] for m in sys.modules}\n"
        "print(sorted(top & {'jax', 'jaxlib', 'flax', 'threepu',\n"
        "                    'threepu_torch'}))\n"
        % str(ROOT / "threepu_torch" / "reference" / "punet.py"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    assert out.stdout.strip() == "[]"
    text = (ROOT / "threepu_torch" / "reference" / "punet.py").read_text()
    assert "allow_tf32 = False" in text


def test_the_punet_spans_nest_under_the_cascade():
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
    stages = ["punet.sa1", "punet.sa2", "punet.sa3", "punet.sa4",
              "punet.fp", "punet.expand"]
    for name in stages:
        assert names.count(name) == 2, name            # two chunks
        for r in recs:
            if r["name"] == name:
                assert by_id[r["parent"]]["name"] == "cascade"
    for l in (1, 2, 3, 4):
        for part in ("fps", "ball_query", "group_mlp"):
            kids = [r for r in recs if r["name"] == f"punet.sa{l}.{part}"]
            assert len(kids) == 2
            assert all(by_id[r["parent"]]["name"] == f"punet.sa{l}"
                       for r in kids)
    annotations = {e.name for e in prof.events()}
    assert {"threepu." + s for s in stages} <= annotations


def test_cli_test_phase_runs_punet(tmp_path):
    net = seeded_net(2)
    ckpt = str(tmp_path / "punet.pth")
    torch.save(net.state_dict(), ckpt)
    data = tmp_path / "shapes"
    data.mkdir()
    pts = surface(100, 4)
    np.savetxt(data / "a.xyz", pts)
    out = tmp_path / "out"
    argv = ["--phase", "test", "--arch", "punet", "--ckpt", ckpt,
            "--up_ratio", "4", "--num_point", str(NUM_POINT), "--chunk", "4",
            "--test_data", str(data / "*.xyz"), "--result_dir", str(out)]
    tcli.main(argv, device="cpu")
    got = load(str(out / "shapes" / "a.ply"))
    _, want = upsample_shape(net, load(str(data / "a.xyz")), 4,
                             num_point=NUM_POINT, chunk=4)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    with pytest.raises(SystemExit, match="--phase test only"):
        tcli.main(["--phase", "vis"] + argv[2:], device="cpu")
    with pytest.raises(ValueError, match="4x"):
        tcli.main([a if a != "4" else "16" for a in argv], device="cpu")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_punet_on_the_card_follows_the_reference(card):
    """The card's FPS kernel, selection kernel and cuBLAS products, run
    as written at the first call, in the CUDA graphs the second call
    captures and in their replay at the third, on other patches each
    time, against the reference on the card: the same selections,
    coordinates within 1e-5, at the published 1,024 points a patch."""
    torch.manual_seed(0)
    net = PUNet().to(card).eval()
    shape = torch.from_numpy(surface(5000, 9))
    outs = []
    for first in (0, 8, 16):
        near = torch.cdist(shape[first:first + 8], shape).argsort(-1)
        x = normalize_point_batch_cl(shape[near[:, :1024]])[0].to(card)
        got, want = {}, {}
        out = net.upsample(x, 4, capture=got)
        outs.append(out)
        ref_out = ref.forward(net.state_dict(), x, record=want)
        assert set(got) == set(want)
        for key in got:
            if key.endswith((".picks", ".ball", ".nn")):
                assert torch.equal(got[key], want[key]), key
        torch.testing.assert_close(out, ref_out, rtol=0, atol=1e-5)
    # one set of graphs, and each call's output its own
    assert len(net._stages) == 1 and len(net._stages[next(
        iter(net._stages))].graphs) == 14
    assert not torch.equal(outs[0], outs[1])
    net.to("cpu")
    assert not net._stages
