"""The port's CUDA kernels against their plain PyTorch versions, on the GPU.

Every test here needs an NVIDIA GPU and nvcc (the kernels are built at
first use); without a visible GPU each one skips.  Run them on a GPU
machine with ``python -m pytest tests/test_torch_kernels_cuda.py -q
--noconftest`` (the suite's conftest imports JAX; this file needs none).
``chip_smoke.py`` repeats the comparisons at the pipeline's full shapes.
"""

import torch_threads  # noqa: F401  (first: sets torch's threads)
import numpy as np
import pytest
import torch

import threepu_torch.ops.chamfer as tcham
import threepu_torch.ops.edgeconv as tec
import threepu_torch.ops.fps as tfps
import threepu_torch.ops.interlevel as til
import threepu_torch.ops.select as tsel
from threepu_torch.ops.distances import duplicate_mask

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from threepu_torch import require_cuda
    return require_cuda()


@pytest.fixture
def gen(dev):
    return torch.Generator(device=dev).manual_seed(0)


#: (k, N) for k in {1, 5, 33, 64} and N in {1, 40, 312, 2000}, k <= N
_SELECT_GRID = [(k, n) for n in (1, 40, 312, 2000) for k in (1, 5, 33, 64)
                if k <= n]


@pytest.mark.parametrize(
    "b,m,n,k,signed",
    [(4, 37, 312, 33, False), (3, 8, 200, 5, False), (2, 9, 2000, 64, False),
     (1, 1, 1, 1, False), (2, 5, 100, 64, False), (2, 3, 64, 64, False),
     (2, 3, 700, 33, False), (4, 37, 312, 33, True), (2, 9, 2000, 64, True)]
    + [(2, 5, n, k, False) for k, n in _SELECT_GRID],
    ids=["conv", "ragged", "multi-tile", "one", "r4", "r2-full", "r16",
         "conv-signed", "multi-tile-signed"]
        + [f"k{k}-n{n}" for k, n in _SELECT_GRID])
def test_select_kernel_matches_plain(dev, gen, b, m, n, k, signed):
    """Bit for bit: values and indices; integer-valued rows dense with
    ties, 1e30 penalty columns, rows with fewer than k unpenalized
    columns; every run length the kernel is built for (N = 40, 100, 200,
    312, 700) and rows longer than one tile (N = 2000).  ``signed`` rows
    hold negative values and -0.0 beside +0.0, which compare equal."""
    d = torch.randint(0, 9, (b, m, n), generator=gen, device=dev).float()
    if signed:
        d = d * (2.0 * torch.randint(0, 2, d.shape, generator=gen,
                                     device=dev) - 1.0)
    d[..., torch.randperm(n, generator=gen, device=dev)[:n // 5]] = 1e30
    d[0, 0, : max(n - 3, 0)] = 1e30
    before = tsel.KERNEL.launches
    v, i = tsel.select(d, k)
    pv, pi = tsel.select_plain(d, k)
    assert tsel.KERNEL.launches == before + 1
    assert torch.equal(v, pv) and torch.equal(i, pi)
    # verbatim values: the signs of zeros as well
    assert torch.equal(torch.signbit(v), torch.signbit(pv))


def test_select_kernel_rejects_what_it_does_not_take(dev):
    d = torch.zeros(2, 8, 100, device=dev)
    with pytest.raises(ValueError):
        tsel.select(d, 65)
    with pytest.raises(ValueError):
        tsel.select(d.double(), 5)


@pytest.mark.parametrize("b,n,m,cluster,repeated", [
    (2, 700, 150, 1, False), (3, 5000, 64, 4, False),
    (1, 3000, 3000, 2, False), (8, 2496, 40, 2, False),
    (8, 12480, 300, 8, False), (8, 24960, 200, 8, False),
    (8, 40000, 200, 8, False), (1, 250000, 32, 8, False),
    (1, 100000, 64, 8, False), (2, 8192, 500, 4, True),
    (1, 40000, 300, 8, True), (48, 312, 48, 1, False),
    (48, 48, 16, 1, False)],
    ids=["small", "wide", "all-points", "cluster-2", "cluster-8",
         "cluster-8-16-a-thread", "large-cloud", "device-memory",
         "shared-memory", "repeated-4", "repeated-8", "adaptive-312",
         "adaptive-48"])
def test_fps_kernel_matches_plain(dev, gen, b, n, m, cluster, repeated):
    """Bit for bit at every cluster size the plan chooses, with the slice
    in registers (8 and 16 points a thread), in shared memory (N =
    100,000) and in device memory (N = 250,000), m = N, the seed off
    index 0, NaN and inf points.
    ``repeated``: 7 distinct points repeated over the cloud, so every pick
    ties across the blocks of a cluster and the lowest index must win."""
    if repeated:
        pts = torch.randn((b, 7, 3), generator=gen, device=dev).repeat(
            1, -(-n // 7), 1)[:, :n].contiguous()
    else:
        pts = torch.randn((b, n, 3), generator=gen, device=dev)
    valid = torch.rand((b, n), generator=gen, device=dev) > 0.1
    valid[0, :17] = False                            # seed moves off 0
    pts[:, 5] = float("nan")
    pts[-1, 9] = float("inf")
    assert tfps.fps_plan(b, n, m).cluster == cluster
    before = tfps.KERNEL.launches
    got = tfps.fps(pts, m, valid)
    assert tfps.KERNEL.launches == before + 1
    assert torch.equal(got, tfps.fps_plain(pts, m, valid))
    assert torch.equal(tfps.fps(pts, m), tfps.fps_plain(pts, m))


@pytest.mark.parametrize("n", [50, 4096], ids=["one-block", "cluster-4"])
def test_fps_kernel_no_valid_point(dev, gen, n):
    """Cloud 0 has no valid point (index 0 forever), cloud 1 two."""
    pts = torch.randn((2, n, 3), generator=gen, device=dev)
    valid = torch.zeros((2, n), dtype=torch.bool, device=dev)
    valid[1, [4, 30]] = True
    before = tfps.KERNEL.launches
    got = tfps.fps(pts, 6, valid)
    assert tfps.KERNEL.launches == before + 1
    assert torch.equal(got, tfps.fps_plain(pts, 6, valid))


def test_fps_kernel_at_every_cluster_size(dev, gen):
    """One (8, 4096) call laid out by hand at cluster sizes 1 to 8 (down
    to 512 points a block), in each storage that holds the slice: all
    equal the plain version; a layout the kernel does not take (a
    cluster of 16, a slice larger than the registers hold) raises."""
    pts = torch.randn((8, 4096, 3), generator=gen, device=dev)
    valid = torch.rand((8, 4096), generator=gen, device=dev) > 0.2
    want = tfps.fps_plain(pts, 300, valid)
    for cluster in (1, 2, 4, 8):
        for storage in tfps.STORAGE:
            plan = tfps.FpsPlan(cluster, storage, -(-4096 // cluster))
            if storage == "registers-8" and plan.slice > 2048:
                continue
            out = torch.empty_like(want)
            tfps._launch(pts, valid, out, plan)
            assert torch.equal(out, want), (cluster, storage)
    for cluster, storage in ((16, "shared"), (1, "registers-8")):
        with pytest.raises(RuntimeError, match="threepu_fps launch failed"):
            tfps._launch(pts, valid, torch.empty_like(want),
                         tfps.FpsPlan(cluster, storage, 128))


def test_fps_hierarchical_on_gpu_matches_cpu(dev, gen):
    pts = torch.randn((2, 3000, 3), generator=gen, device=dev)
    valid = torch.rand((2, 3000), generator=gen, device=dev) > 0.3
    got = tfps.fps_hierarchical(pts, 500, valid, group_max=800)
    want = tfps.fps_hierarchical(pts.cpu(), 500, valid.cpu(), group_max=800)
    assert torch.equal(got.cpu(), want)


def _interlevel_prev(gen, dev, p, m, kind):
    """``(prev_xyz, prev_dup)``.  ``random``: copies of earlier points
    (flagged by duplicate_mask) and two phantom rows.  ``ties``: integer
    coordinates with many exact copies at indices that fall in different
    lanes' shares, none flagged, so equal ranks must go to the lowest index
    across the team.  ``share``: one lane's whole share (every index 3 mod
    8) flagged, with the ``random`` points.  ``nonfinite``: the ``random``
    points with the first 8 flagged, two of them at infinite coordinates:
    a flagged point ranks 1e30 whatever its coordinates, so the picks
    that reach the flagged points take the lowest indices."""
    if kind == "ties":
        prev = torch.randint(-2, 3, (p, m, 3), generator=gen,
                             device=dev).float()
        prev[:, 5::13] = prev[:, 0:1]
        return prev, torch.zeros((p, m), dtype=torch.bool, device=dev)
    prev = torch.randn((p, m, 3), generator=gen, device=dev) * 0.3
    prev[:, 1::7] = prev[:, 0::7][:, :prev[:, 1::7].shape[1]]
    dup = duplicate_mask(prev)
    dup[:, -2:] = True                               # phantom rows
    if kind == "share":
        dup[:, 3::til.TEAM] = True
    if kind == "nonfinite":
        dup[:, :8] = True
        prev[:, 0] = float("inf")
        prev[:, 2, 1] = -float("inf")
    return prev, dup


#: (P, group, N, M, C, k, kind); the level shapes at P = 1
_INTERLEVEL_CASES = {
    "grouped": (2, 3, 40, 300, 24, 5, "random"),
    "group1": (3, 1, 312, 312, 264, 5, "random"),
    "max-n": (1, 2, 1024, 5000, 8, 8, "random"),
    "tiny": (2, 2, 7, 6, 5, 1, "random"),
    "ties": (2, 3, 40, 301, 24, 5, "ties"),
    "ties-k8": (2, 2, 33, 200, 16, 8, "ties"),
    "share-penalised": (2, 3, 40, 300, 24, 5, "share"),
    "m-not-multiple-of-team": (2, 2, 50, 301, 12, 5, "random"),
    "m-below-team-x-k": (2, 2, 50, 20, 12, 5, "random"),
    "m-below-team-x-k8": (2, 2, 17, 9, 12, 8, "ties"),
    "k1": (2, 3, 40, 300, 24, 1, "random"),
    "k8": (2, 3, 40, 300, 24, 8, "random"),
    "n1": (3, 2, 1, 40, 24, 5, "random"),
    "n9": (2, 2, 9, 40, 24, 5, "random"),
    "flagged-nonfinite": (2, 2, 30, 13, 24, 8, "nonfinite"),
    "level2": (1, 10, 312, 312, 264, 5, "random"),
    "step4-level2": (8, 20, 312, 312, 264, 5, "random"),
    "level3": (1, 20, 312, 3120, 264, 5, "random"),
    "level4": (1, 40, 312, 6240, 264, 5, "random")}


@pytest.mark.parametrize("p,group,n,m,c,k,kind",
                         list(_INTERLEVEL_CASES.values()),
                         ids=list(_INTERLEVEL_CASES))
def test_interlevel_kernel_matches_plain(dev, gen, p, group, n, m, c, k,
                                         kind):
    """Picks exact; values to 1e-5 (sums over C and over the queries run
    in another order than PyTorch's).  Exact rank ties across the lanes of
    a query's team, a share all penalised, M not a multiple of the team,
    fewer candidates than team x k (lanes with short or empty lists), k =
    1 and 8, N = 1, 9 (a cluster of 5) and 1024, flagged points at
    infinite coordinates among the picks, the level shapes."""
    prev, dup = _interlevel_prev(gen, dev, p, m, kind)
    q = torch.randn((p * group, n, 3), generator=gen, device=dev) * 0.3
    if kind == "ties":
        q = torch.randint(-2, 3, q.shape, generator=gen, device=dev).float()
    xq = torch.randn((p * group, n, c), generator=gen, device=dev)
    feat = torch.randn((p, m, c), generator=gen, device=dev)
    before = til.KERNEL.launches
    out, idx = til.interlevel(q, xq, prev, feat, dup, k)
    assert til.KERNEL.launches == before + 1
    pout, pidx = til.interlevel_plain(q, xq, prev, feat, dup, k)
    assert torch.equal(idx, pidx)
    torch.testing.assert_close(out, pout, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("cluster,n", [(1, 1), (2, 2), (4, 4), (8, 100)],
                         ids=["1", "2", "4", "8"])
def test_interlevel_kernel_at_every_cluster_size(dev, gen, cluster, n):
    """Calls that :func:`interlevel_plan` lays out on clusters of 1 to 8
    blocks, with the weights output: the same picks and values as the
    plain version at each."""
    prev, dup = _interlevel_prev(gen, dev, 2, 300, "random")
    q = torch.randn((6, n, 3), generator=gen, device=dev) * 0.3
    xq = torch.randn((6, n, 24), generator=gen, device=dev)
    feat = torch.randn((2, 300, 24), generator=gen, device=dev)
    assert til.interlevel_plan(n).cluster == cluster
    out, idx, w = til._launch(q, xq, prev, feat, dup, 5)
    pout, pidx, pw = til._plain(q, xq, prev, feat, dup, 5)
    assert torch.equal(idx, pidx)
    torch.testing.assert_close(out, pout, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(w, pw, atol=1e-5, rtol=1e-5)


def test_interlevel_kernel_rejects_what_it_does_not_take(dev):
    args = [torch.zeros(4, 8, 3, device=dev), torch.zeros(4, 8, 6, device=dev),
            torch.zeros(2, 10, 3, device=dev), torch.zeros(2, 10, 6, device=dev),
            torch.zeros(2, 10, dtype=torch.bool, device=dev)]
    with pytest.raises(ValueError):
        til.interlevel(*args, 9)                     # k above 8
    with pytest.raises(ValueError):
        til.interlevel(args[0][:3], *args[1:], 3)    # P does not divide B
    with pytest.raises(ValueError):
        til.interlevel(args[0].transpose(1, 2).contiguous().transpose(1, 2),
                       *args[1:], 3)                 # not contiguous


@pytest.mark.parametrize("p,group,n,m,c,k", [(2, 3, 40, 300, 24, 5),
                                             (16, 1, 312, 312, 264, 5),
                                             (3, 1, 40, 300, 24, 8),
                                             (2, 1, 1, 20, 24, 1)],
                         ids=["grouped", "train", "group1-k8", "group1-n1"])
def test_interlevel_backward_on_gpu_matches_plain(dev, gen, p, group, n, m,
                                                  c, k):
    """The kernel's weights (its third output) equal the plain version's
    to 1e-5 and drive the same prev_feat gradient, to 1e-5 (the kernel's
    weights differ by float32 rounding; index_add_ sums with atomics on
    the card); no other input gets one.  "train" is the train step's
    shape: one sub-patch per previous set."""
    prev = torch.randn((p, m, 3), generator=gen, device=dev) * 0.3
    dup = duplicate_mask(prev)
    q = torch.randn((p * group, n, 3), generator=gen, device=dev) * 0.3
    xq = torch.randn((p * group, n, c), generator=gen, device=dev)
    feat = torch.randn((p, m, c), generator=gen, device=dev)
    cot = torch.randn((p * group, n, c), generator=gen, device=dev)
    got = til._launch(q, xq, prev, feat, dup, k, with_w=True)
    want = til._plain(q, xq, prev, feat, dup, k)
    assert torch.equal(got[1], want[1])
    torch.testing.assert_close(got[2], want[2], atol=1e-5, rtol=1e-5)
    grads = []
    for fn in (til.interlevel, til.interlevel_plain):
        args = [a.clone().requires_grad_() for a in (q, xq, prev, feat)]
        out, _ = fn(*args, dup, k)
        out.backward(cot)
        assert all(a.grad is None for a in args[:3])
        grads.append(args[3].grad)
    torch.testing.assert_close(grads[0], grads[1], atol=1e-5, rtol=1e-5)


def _nn_inputs(gen, dev, b, n, m):
    """Integer-grid points (exact distance ties), duplicate reference
    points, queries on reference points."""
    a = torch.randint(-4, 5, (b, n, 3), generator=gen, device=dev).float()
    r = torch.randint(-4, 5, (b, m, 3), generator=gen, device=dev).float()
    r[:, 1::9] = r[:, 0::9][:, :r[:, 1::9].shape[1]]
    a[:, : min(n, m)] = r[:, : min(n, m)]
    return a, r


@pytest.mark.parametrize("b,n,m", [(16, 624, 624), (2, 300, 2500),
                                   (3, 129, 1), (1, 5000, 4099),
                                   (3, 1, 700), (2, 2500, 300),
                                   (16, 1248, 1248)],
                         ids=["train", "ragged-tile", "one-candidate",
                              "three-tiles", "one-query", "n-above-m",
                              "step4-train"])
def test_nn_kernel_matches_plain(dev, gen, b, n, m):
    """Bit for bit, values and indices, one way and both ways in one
    launch: ties to the lowest index, duplicate points, M not a multiple
    of the tile, M = 1, N = 1, N != M either way."""
    a, r = _nn_inputs(gen, dev, b, n, m)
    before = tcham.KERNEL.launches
    got = tcham.nn_one_way(a, r)
    assert tcham.KERNEL.launches == before + 1
    want = tcham.nn_one_way_plain(a, r)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    both = tcham.nn_both_ways(a, r)
    assert tcham.KERNEL.launches == before + 2
    want += tcham.nn_one_way_plain(r, a)
    assert all(torch.equal(g, w) for g, w in zip(both, want))
    x = torch.randn((b, n, 3), generator=gen, device=dev)
    y = torch.randn((b, m, 3), generator=gen, device=dev)
    got, want = tcham.nn_one_way(x, y), tcham.nn_one_way_plain(x, y)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    want += tcham.nn_one_way_plain(y, x)
    assert all(torch.equal(g, w)
               for g, w in zip(tcham.nn_both_ways(x, y), want))


@pytest.mark.parametrize("cluster", range(1, tcham.MAX_CLUSTER + 1))
@pytest.mark.parametrize("threads", [32, 96, 128])
def test_nn_kernel_splits_ties_across_slices(dev, gen, threads, cluster):
    """Every layout the kernel takes, forced: duplicate candidates on
    both sides of every slice boundary (the lower slice must win the
    tie), empty slices (M < cluster and M = 1), every candidate equal,
    and every distance +inf (index 0)."""
    plan = tcham.ChamferPlan(threads, cluster, tcham.STAGE * threads)

    def check(a, r):
        got = tcham._launch(a, r, True, plan)
        want = (*tcham.nn_one_way_plain(a, r), *tcham.nn_one_way_plain(r, a))
        assert all(torch.equal(g, w) for g, w in zip(got, want))

    a, r = _nn_inputs(gen, dev, 2, 700, 2000)
    for lo, _ in tcham.chamfer_slices(2000, cluster)[1:]:
        r[:, lo] = r[:, lo - 1]
        a[:, lo % 700] = r[:, lo]
    check(a, r)
    check(a, r[:, :5].contiguous())
    check(a, r[:, :1].contiguous())
    check(a, r[:, :1].expand(2, 900, 3).contiguous())
    far = torch.full((2, 300, 3), 1e20, device=dev)
    check(far, -far[:, :40].contiguous())


def test_chamfer_plan_fits_the_card(dev):
    """The plan on the card's own occupancy: at the train shape both ways
    every cluster of a split candidate axis fits at once; at 80k, where
    none of 2 or more would, clusters still pack the SMs as fully as
    single blocks."""
    active = tcham.active_clusters(dev.index)
    assert active(128, 1) >= \
        torch.cuda.get_device_properties(dev).multi_processor_count
    plan = tcham.chamfer_plan(16, 624, 624, active)
    assert plan.cluster > 1
    assert 2 * 16 * -(-624 // plan.threads) <= active(plan.threads,
                                                      plan.cluster)
    plan = tcham.chamfer_plan(1, 80000, 80000, active)
    assert plan.cluster > 1
    assert plan.cluster * active(plan.threads, plan.cluster) >= \
        active(plan.threads, 1)


def test_nn_distance_launches_once_and_repeats_bitwise(dev, gen):
    """One nn_distance call is one launch, at the train shape; three runs
    on the same inputs give bitwise equal outputs."""
    a, r = _nn_inputs(gen, dev, 16, 624, 624)
    before = tcham.KERNEL.launches
    runs = [tcham.nn_distance(a, r)]
    assert tcham.KERNEL.launches == before + 1
    runs += [tcham.nn_distance(a, r) for _ in range(2)]
    assert all(torch.equal(x, y) for run in runs[1:]
               for x, y in zip(run, runs[0]))


def test_nn_kernel_rejects_what_it_does_not_take(dev):
    a = torch.zeros(2, 8, 3, device=dev)
    for fn in (tcham.nn_one_way, tcham.nn_both_ways):
        with pytest.raises(ValueError, match="CUDA tensor"):
            fn(a, torch.zeros(2, 8, 3))
        with pytest.raises(ValueError, match="float32"):
            fn(a, a.double())
        with pytest.raises(ValueError, match="contiguous"):
            fn(a, torch.zeros(2, 3, 8, device=dev).transpose(1, 2))
        with pytest.raises(ValueError, match="need a"):
            fn(a, torch.zeros(3, 8, 3, device=dev))
        with pytest.raises(ValueError, match="need a"):
            fn(a, torch.zeros(2, 0, 3, device=dev))
    for plan in ((48, 1, 4 * 48), (512, 1, 2048), (128, 9, 512),
                 (128, 0, 512), (0, 1, 0), (128, 2, 64)):
        with pytest.raises(RuntimeError, match="launch failed"):
            tcham._launch(a, a, True, tcham.ChamferPlan(*plan))


def test_nn_distance_backward_on_gpu_matches_cpu(dev, gen):
    """The saved-argmin backward on the card (index_add with atomics)
    against the CPU's: to 1e-6 (sum order)."""
    x1 = torch.randn((4, 300, 3), generator=gen, device=dev)
    x2 = torch.randn((4, 500, 3), generator=gen, device=dev)
    grads = []
    for d in (dev, "cpu"):
        a = x1.to(d).detach().requires_grad_()
        b = x2.to(d).detach().requires_grad_()
        d1, _, d2, _ = tcham.nn_distance(a, b)
        (d1.sum() + 2.0 * d2.sum()).backward()
        grads.append((a.grad.cpu(), b.grad.cpu()))
    for g, c in zip(*grads):
        torch.testing.assert_close(g, c, atol=1e-6, rtol=1e-6)


def _chain_inputs(gen, dev, b, num_n, k, n, g, layout="lists"):
    """``lists``: separate tensors, an int32 index view.  ``layer``: the
    arguments as ``DenseEdgeConv`` passes them, separate products for z
    and the stages' terms, the chain blocks as row blocks of transposed
    weights.  ``product-int32`` / ``product-int64``: z and the stages'
    terms as views of one ``(B, N, (n + 1) G)`` product instead."""
    dtype = torch.int64 if layout == "product-int64" else torch.int32
    # one column more than k, cut off as the edge conv drops the self
    # neighbour: a view that is not contiguous
    idx = torch.randint(0, num_n, (b, num_n, k + 1), generator=gen,
                        device=dev, dtype=dtype)[..., 1:]
    if layout != "lists":
        prod = torch.randn((b, num_n, (n + 1) * g), generator=gen, device=dev)
        w = [0.3 * torch.randn((g, g * i + 3), generator=gen, device=dev).t()
             for i in range(1, n)]
        chain_w = [w[i - 1][g * j:g * (j + 1)] for i in range(1, n)
                   for j in range(i)]
        if layout == "layer":
            return (prod[..., :g].contiguous(), idx,
                    [t.contiguous() for t in prod[..., g:].split(g, -1)],
                    chain_w)
        return prod[..., :g], idx, list(prod[..., g:].split(g, -1)), chain_w
    z = torch.randn((b, num_n, g), generator=gen, device=dev)
    pts = [torch.randn((b, num_n, g), generator=gen, device=dev)
           for _ in range(n)]
    chain_w = [0.3 * torch.randn((g, g), generator=gen, device=dev)
               for _ in range(n * (n - 1) // 2)]
    return z, idx, pts, chain_w


#: (B, N, k, n, G, layout)
_CHAIN_CASES = {
    "level1": (8, 312, 32, 3, 12, "lists"),
    "n1": (3, 40, 5, 1, 4, "lists"),
    "n2": (3, 40, 5, 2, 4, "lists"),
    "odd-g": (2, 33, 7, 3, 5, "lists"),
    "k-over-warp": (2, 50, 40, 4, 20, "lists"),
    "widest": (2, 17, 1, 4, 32, "lists"),
    "ones": (1, 1, 1, 2, 1, "lists"),
    "g24": (70, 9, 33, 3, 24, "lists"),
    "level4-views": (320, 312, 32, 3, 12, "product-int32"),
    "level1-layer": (8, 312, 32, 3, 12, "layer"),
    "level4-layer": (320, 312, 32, 3, 12, "layer"),
    "int64-view": (8, 312, 32, 3, 12, "product-int64"),
    "k-below-warp-views": (3, 40, 17, 3, 12, "product-int64"),
    "k-over-warp-views": (2, 50, 70, 2, 8, "product-int32"),
    "odd-g-views": (2, 33, 7, 3, 5, "product-int64"),
    "g6-views": (4, 40, 32, 4, 6, "product-int32")}


@pytest.mark.parametrize("b,num_n,k,n,g,layout", list(_CHAIN_CASES.values()),
                         ids=list(_CHAIN_CASES))
def test_edge_conv_chain_kernel_matches_plain(dev, gen, b, num_n, k, n, g,
                                              layout):
    """Every stage count and padded width the kernel is instantiated for,
    widths that are no multiple of 4 (scalar loads), k above, at and below
    a warp, a sliced index view: max abs 1e-5 against the plain version (the
    kernel sums its products in another order than cuBLAS).  In the
    layer's layout and in views of one product (an int32 or int64 index
    view, chain blocks that are views of weights) the call launches the
    kernel and nothing else: no copy runs before it."""
    z, idx, pts, chain_w = _chain_inputs(gen, dev, b, num_n, k, n, g, layout)
    assert idx.numel() == 1 or not idx.is_contiguous()
    before = tec.KERNEL.launches
    got = tec.edge_conv_chain(z, idx, pts, chain_w, n, g)
    assert tec.KERNEL.launches == before + 1
    want = tec.edge_conv_chain_plain(z, idx, pts, chain_w, n, g)
    assert got.shape == (b, num_n, n * g)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    if layout == "lists":
        # int64 indices and stacked tensors are the same call
        again = tec.edge_conv_chain(z, idx.long(), torch.stack(pts, 1),
                                    torch.stack(chain_w) if chain_w
                                    else z.new_zeros((0, g, g)), n, g)
        assert torch.equal(again, got)
        return
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        again = tec.edge_conv_chain(z, idx, pts, chain_w, n, g)
        torch.cuda.synchronize()
    ran = [ev.name for ev in prof.events()
           if ev.device_type == DeviceType.CUDA and not ev.is_user_annotation]
    assert len(ran) == 1 and "edgeconv_kernel" in ran[0], ran
    assert torch.equal(again, got)


@pytest.mark.parametrize("b", [8, 80, 160, 320])
def test_edge_conv_chain_kernel_is_the_plain_chain_bit_for_bit(dev, gen, b):
    """At the eval cascade's shapes (N = 312, k = 32, G = 12, n = 3, in the
    layer's layout) the kernel gives the plain chain's output bit for
    bit: it sums each weight block's products apart and adds the blocks
    in order, as cuBLAS and the plain chain round, so a later conv's kNN
    flips no near-tie against the plain route (the benchmark's check
    replays every level on it)."""
    z, idx, pts, chain_w = _chain_inputs(gen, dev, b, 312, 32, 3, 12,
                                         "layer")
    got = tec.edge_conv_chain(z, idx, pts, chain_w, 3, 12)
    want = tec.edge_conv_chain_plain(z, idx, pts, chain_w, 3, 12)
    assert torch.equal(got, want)


def test_edge_conv_chain_kernel_at_the_pugan_shape_is_the_plain_chain(dev,
                                                                     gen):
    """PU-GAN's edge convs (B = 8 patches, N = 256, k = 16, G = 24, n = 3,
    in the layer's layout) run the kernel's ``<3, 24>`` instance, whose
    72 channels a lane leave it without the floor of blocks an SM that
    the G = 12 instance keeps: bit for bit the plain chain, as at 3PU's
    shapes."""
    z, idx, pts, chain_w = _chain_inputs(gen, dev, 8, 256, 16, 3, 24,
                                         "layer")
    before = tec.KERNEL.launches
    got = tec.edge_conv_chain(z, idx, pts, chain_w, 3, 24)
    assert tec.KERNEL.launches == before + 1
    want = tec.edge_conv_chain_plain(z, idx, pts, chain_w, 3, 24)
    assert torch.equal(got, want)


def test_edge_conv_chain_kernel_rejects_what_it_does_not_take(dev, gen):
    z, idx, pts, chain_w = _chain_inputs(gen, dev, 2, 10, 3, 2, 4)
    before = tec.KERNEL.launches
    with pytest.raises(ValueError, match="n=5"):
        tec.edge_conv_chain(z, idx, pts, chain_w, 5, 4)
    with pytest.raises(ValueError, match="g=33"):
        tec.edge_conv_chain(z, idx, pts, chain_w, 2, 33)
    with pytest.raises(ValueError, match="float32"):
        tec.edge_conv_chain(z.double(), idx, pts, chain_w, 2, 4)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tec.edge_conv_chain(z, idx.cpu(), pts, chain_w, 2, 4)
    with pytest.raises(RuntimeError, match="forward-only"):
        tec.edge_conv_chain(z.clone().requires_grad_(), idx, pts, chain_w, 2,
                            4)
    assert tec.KERNEL.launches == before


def test_pipeline_with_the_chain_kernel_on_gpu(dev, monkeypatch):
    """The golden-scale pipeline on the GPU: the edge-conv kernel, 8
    chain launches per chunk (2 levels x 4 convs), and the output of the
    run routed to the plain chain (its graphs dropped) to float32
    rounding."""
    from threepu_torch.inference import upsample_point_cloud
    from threepu_torch.models import Net
    torch.manual_seed(0)
    net = Net(max_up_ratio=4, step_ratio=2, knn=8, growth_rate=4, dense_n=2,
              max_num_point=32, fm_knn=3).eval().to(dev)
    pts = np.random.default_rng(1234).standard_normal((96, 3)).astype(
        np.float32)
    pts /= np.linalg.norm(pts, axis=1, keepdims=True)
    xyz = torch.from_numpy(pts).to(dev)
    before = tec.KERNEL.launches
    got = upsample_point_cloud(net, xyz, 4, 32, 384, chunk=4)
    assert tec.KERNEL.launches == before + 8 * 3      # 9 patches pad to 12
    monkeypatch.setattr(tec, "takes_kernel", lambda x, n, g: False)
    net._stages.clear()
    want = upsample_point_cloud(net, xyz, 4, 32, 384, chunk=4)
    assert tec.KERNEL.launches == before + 8 * 3
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               atol=1e-4)


def test_default_16x_upsample_takes_the_chain_kernel(dev, monkeypatch):
    """A default 16x net's ``Net.upsample`` of one chunk (8 patches of 312
    points): 16 edge-conv launches (4 levels x 4 convs), and the same
    call routed to the plain chain within the benchmark's row band: at
    most 1% of the rows off by more than 1e-4.  The kernel sums as the
    plain chain does, so no kNN or FPS pick of a later stage flips
    against it."""
    from threepu_torch.models import Net
    torch.manual_seed(0)
    net = Net().eval().to(dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    xyz = torch.randn((8, 312, 3), generator=gen, device=dev)
    xyz = xyz / xyz.norm(dim=-1, keepdim=True)
    before = tec.KERNEL.launches
    got = net.upsample(xyz)
    assert tec.KERNEL.launches == before + 16
    monkeypatch.setattr(tec, "takes_kernel", lambda x, n, g: False)
    want = net.upsample(xyz)
    assert tec.KERNEL.launches == before + 16
    assert got.shape == want.shape == (8, 312 * 16, 3)
    rows_off = ((got - want).abs().amax(-1) > 1e-4).float().mean().item()
    assert rows_off <= 0.01, rows_off


def test_train_step_on_gpu_matches_cpu(dev):
    """One train step of a small net (random weights from a seed) at its
    top ratio, re-patch seeds pinned: the card's loss against the CPU's
    to 1e-5 relative, and every kernel of the path launched."""
    from threepu_torch.models import Net
    from threepu_torch.train import make_optimizer, train_step
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((3, 32, 3)).astype(np.float32))
    gt = torch.from_numpy(rng.standard_normal((3, 256, 3)).astype(np.float32))
    seeds = [torch.from_numpy(rng.integers(0, 64, (3, 1))) for _ in range(2)]
    losses = []
    for d in ("cpu", dev):
        torch.manual_seed(0)
        net = Net(max_up_ratio=8, knn=8, growth_rate=12, dense_n=3,
                  max_num_point=32, fm_knn=5).to(d)
        opt = make_optimizer(net.parameters())
        counts = [k.launches for k in (tsel.KERNEL, til.KERNEL, tcham.KERNEL)]
        losses.append(train_step(net, opt, x.to(d), gt.to(d), 8,
                                 seed_idx=seeds).item())
        after = [k.launches for k in (tsel.KERNEL, til.KERNEL, tcham.KERNEL)]
    assert all(a > c for a, c in zip(after, counts))
    assert losses[1] == pytest.approx(losses[0], rel=1e-5)


def test_pipeline_on_gpu_matches_cpu(dev):
    """The golden-scale pipeline (random weights from a seed) on the GPU
    against the same port on the CPU, to float32 rounding."""
    from threepu_torch.inference import upsample_point_cloud
    from threepu_torch.models import Net
    torch.manual_seed(0)
    net = Net(max_up_ratio=4, step_ratio=2, knn=8, growth_rate=4, dense_n=2,
              max_num_point=32, fm_knn=3).eval()
    pts = np.random.default_rng(1234).standard_normal((96, 3)).astype(
        np.float32)
    pts /= np.linalg.norm(pts, axis=1, keepdims=True)
    want = upsample_point_cloud(net, torch.from_numpy(pts), 4, 32, 384,
                                chunk=4)
    counts = [k.launches for k in (tsel.KERNEL, tfps.KERNEL, til.KERNEL)]
    got = upsample_point_cloud(net.to(dev), torch.from_numpy(pts).to(dev), 4,
                               32, 384, chunk=4)
    after = [k.launches for k in (tsel.KERNEL, tfps.KERNEL, til.KERNEL)]
    assert all(a > c for a, c in zip(after, counts))
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-4)


def test_sharded_upsampler_at_world_size_1_equals_serial(dev):
    """``make_sharded_upsampler`` in one spawned rank under ``nccl`` (one
    card takes one rank) on the golden-scale shape: bit for bit the
    serial pipeline in this process, with one all-gather and the select,
    FPS and interlevel kernels launched in the rank."""
    import torch_parallel_workers as workers
    from threepu_torch import _build
    from threepu_torch.inference import upsample_point_cloud
    from threepu_torch.models import Net
    from threepu_torch.parallel.launch import spawn
    config = dict(max_up_ratio=4, step_ratio=2, knn=8, growth_rate=4,
                  dense_n=2, max_num_point=32, fm_knn=3)
    torch.manual_seed(0)
    net = Net(**config).eval()
    weights = {k: v.numpy() for k, v in net.state_dict().items()}
    pts = np.random.default_rng(1234).standard_normal((96, 3)).astype(
        np.float32)
    pts /= np.linalg.norm(pts, axis=1, keepdims=True)
    case = dict(kind="cloud", points=pts, ratio=4, num_point=32,
                num_patches=None, num_out=384)
    want = upsample_point_cloud(net.to(dev), torch.from_numpy(pts).to(dev),
                                4, 32, 384).cpu().numpy()
    _build.library()                  # built once, before the rank starts
    [(got, counts, launches)] = spawn(workers.sharded_upsample, 1, config,
                                      weights, case)
    assert counts == {"all_gather": 1}
    assert all(launches[name] > 0 for name in ("select", "fps",
                                               "interlevel"))
    np.testing.assert_array_equal(got, want)
