"""The plain reference against itself at tiny sizes: its selections
against brute force, its two duplicate tests against each other, its
grouped FPS against the plain one where they must agree, its TF32
rounding, and its cascades' determinism."""

import numpy as np
import pytest
import torch

from portbench import reference as R, weights
from portbench.tests import tiny


def cloud(n, seed=0, b=1):
    g = torch.Generator().manual_seed(seed)
    return torch.rand((b, n, 3), generator=g)


def test_fps_is_furthest_first():
    pts = cloud(60)
    idx = R.fps(pts, 10)[0].tolist()
    assert idx[0] == 0 and len(set(idx)) == 10
    p = pts[0].double()
    chosen = [0]
    for _ in range(9):
        d = torch.cdist(p, p[chosen]).min(1).values
        chosen.append(int(torch.argmax(d)))
    assert idx == chosen


def test_fps_skips_masked_points():
    pts = cloud(40)
    mask = torch.ones(1, 40, dtype=torch.bool)
    mask[0, :5] = False
    idx = R.fps(pts, 20, mask)[0]
    assert int(idx[0]) == 5 and bool(mask[0, idx.long()].all())


def test_hierarchical_fps_with_one_group_is_fps_of_the_sorted_cloud():
    pts = cloud(300, 1)
    one = R.fps_hierarchical(pts, 50, group_max=300)
    assert len(set(one[0].tolist())) == 50
    four = R.fps_hierarchical(pts, 50, group_max=75)
    assert len(set(four[0].tolist())) == 50


def test_knn_matches_brute_force_and_ranks_duplicates_last():
    pts = cloud(50, 2)
    pts[0, 7] = pts[0, 3]
    q = pts[:, :5]
    _, idx = R.knn(R.Arith(), q, pts, 6, unique=True)
    d = torch.cdist(q[0].double(), pts[0].double())
    d[:, 7] = float("inf")
    want = torch.sort(d, dim=-1, stable=True).indices[:, :6]
    assert torch.equal(idx[0].long(), want)


def test_duplicate_mask_paths_agree():
    pts = torch.randint(0, 4, (2, 300, 3)).float()
    direct = R.duplicate_mask(pts)
    old = R.DIRECT_MAX_N
    try:
        R.DIRECT_MAX_N = 10
        sorted_path = R.duplicate_mask(pts)
    finally:
        R.DIRECT_MAX_N = old
    assert torch.equal(direct, sorted_path)
    assert not bool(direct[:, 0].any())


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 3 * 2**-11, 3.14159265])
    y = R.round_tf32(x)
    assert y[0] == 1.0 and y[1] == 1.0            # ties to even
    assert y[2] == 1.0 + 2**-9
    assert abs(float(y[3]) - 3.14159265) < 2**-9
    a = torch.randn(5, 7, requires_grad=True)
    b = torch.randn(7, 3, requires_grad=True)
    out = R.Arith(tf32=True).mm(a, b)
    out.sum().backward()
    assert a.grad.shape == a.shape and b.grad.shape == b.shape
    assert float((out - a @ b).detach().abs().max()) > 0


def test_replayed_decisions_count_agreement():
    d = torch.tensor([[3.0, 1.0, 2.0]])
    record = {}
    R.select(R.Arith(record=record), d, 2)
    A = R.Arith(replay={"select": [torch.tensor([[2, 1]])]})
    vals, idx = R.select(A, d, 2)
    assert idx.tolist() == [[2, 1]] and vals.tolist() == [[2.0, 1.0]]
    assert A.agree["select"] == [0, 2] and record["select"][0].tolist() \
        == [[1, 2]]
    with pytest.raises(ValueError):
        R.select(A, d, 2)


def test_eval_cascade_is_deterministic_and_sized():
    params = R.pairs_of(weights.seeded(tiny.NET, 3, "cpu"))
    spec = R.NetSpec(**tiny.NET)
    x, _, _ = R.normalize_batch(cloud(32, 4, b=2))

    def level(l, args, kw):
        return R.level_forward(R.Arith(), params, spec, l, *args, **kw)

    with torch.no_grad():
        a = R.eval_cascade(R.Arith(), spec, x, 4, level)
        b = R.eval_cascade(R.Arith(), spec, x, 4, level)
    assert a.shape == (2, 128, 3) and torch.equal(a, b)


def test_adam_matches_torch():
    p = {"w": torch.randn(4, 3)}
    g = {"w": torch.randn(4, 3) * 3}
    ref = torch.nn.Parameter(p["w"].clone())
    opt = torch.optim.Adam([ref], lr=1e-2)
    ref.grad = g["w"].clamp(-1, 1)
    opt.step()
    R.Adam(1e-2, {"w": torch.zeros(4, 3)}, {"w": torch.zeros(4, 3)},
           0).step(p, g)
    assert torch.allclose(p["w"], ref.detach(), atol=1e-7)


def test_normalize_cloud():
    pts = np.random.default_rng(0).standard_normal((100, 3)).astype(
        np.float32)
    data, centroid, furthest = R.normalize_cloud(pts)
    assert np.allclose(data * furthest + centroid, pts, atol=1e-6)
    assert abs(np.linalg.norm(data, axis=-1).max() - 1) < 1e-6
