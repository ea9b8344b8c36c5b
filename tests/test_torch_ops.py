"""The PyTorch port's ops held against the JAX package, on the CPU.

Inputs are made with a seeded numpy generator and handed to both
packages.  Where the JAX function runs a Pallas kernel, it runs it in
interpret mode, as the JAX package's own tests do.  On CPU tensors the
port's kernel wrappers run their plain PyTorch versions, so these tests
hold those plain versions (the CUDA kernels' references) against JAX.
Selections (indices) must match exactly; each value tolerance is stated
where it is used.
"""

import torch_threads  # noqa: F401  (first: sets torch's threads)
import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import threepu.ops.chamfer_pallas as jcp
import threepu.ops.fps_pallas as jfp
import threepu.ops.interlevel_pallas as jil
from threepu.io.checkpoint import _flatten, export_reference_state
from threepu.ops import chamfer as jchamfer
from threepu.ops import distances as jdist
from threepu.ops import fps as jfps
from threepu.ops import knn as jknn
from threepu.ops import normalize as jnorm
from threepu.ops.select_pallas import select_pallas
from test_interlevel import _xla_reference

import threepu_torch.ops.fps as tfps
import threepu_torch.ops.interlevel as til
import threepu_torch.ops.select as tsel
from threepu_torch.io.weights import load_jax_checkpoint, state_dict_from_jax
from threepu_torch.ops import chamfer as tchamfer
from threepu_torch.ops import distances as tdist
from threepu_torch.ops import gather as tgather
from threepu_torch.ops import knn as tknn
from threepu_torch.ops import normalize as tnorm

WEIGHTS = "artifacts/prod_clean_final.npz"


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def interpret(module):
    """Run ``module``'s Pallas calls in interpret mode (CPU)."""
    orig = pl.pallas_call
    return mock.patch.object(module.pl, "pallas_call",
                             lambda *a, **kw: orig(*a, interpret=True, **kw))


# ------------------------------------------------------------- select
def _select_cases(rng):
    n = 312
    d = rng.integers(0, 40, (4, 37, n)).astype(np.float32)
    d[..., rng.permutation(n)[:64]] = 1e30          # dedup penalty block
    yield "ties+penalty", d, 33
    d = rng.integers(0, 40, (2, 9, n)).astype(np.float32)
    d[..., : n - 20] = 1e30                          # < k unpenalized columns
    yield "few-real-columns", d, 33
    yield "all-ties", np.ones((2, 5, n), np.float32), 7
    yield "2d-ragged", rng.standard_normal((8, 200)).astype(np.float32), 5
    pts = rng.standard_normal((2, n, 3)).astype(np.float32)
    pts[:, 1::7] = pts[:, 0::7]                      # duplicate points
    pj = jnp.asarray(pts)
    yield "dup-points", np.asarray(jdist.pairwise_dist2(pj, pj)), 33


def test_select_plain_matches_select_pallas(rng):
    """select_plain == select_pallas (interpret): identical values and
    indices, ties to the lowest index, penalty fall-back in index order."""
    for name, d, k in _select_cases(rng):
        want_v, want_i = select_pallas(jnp.asarray(d), k, interpret=True)
        got_v, got_i = tsel.select_plain(t(d), k)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i),
                                      err_msg=name)
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v),
                                      err_msg=name)
        assert got_i.dtype == torch.int32


def test_select_on_cpu_runs_the_plain_version(rng):
    d = t(rng.standard_normal((3, 8, 40)).astype(np.float32))
    before = tsel.KERNEL.launches
    v, i = tsel.select(d, 5)
    pv, pi = tsel.select_plain(d, 5)
    assert torch.equal(v, pv) and torch.equal(i, pi)
    assert tsel.KERNEL.launches == before
    with pytest.raises(ValueError, match="exceeds"):
        tsel.select(d, 41)


def test_select_vjp_matches_select_pallas(rng):
    """The value cotangent scatters back to the selected columns, as
    select_pallas's custom VJP does; exact (each row's picks are
    distinct, so no two cotangents meet), through both versions."""
    for name, d, k in _select_cases(rng):
        g = rng.standard_normal(d.shape[:-1] + (k,)).astype(np.float32)
        _, vjp = jax.vjp(lambda x: select_pallas(x, k, interpret=True)[0],
                         jnp.asarray(d))
        (want,) = vjp(jnp.asarray(g))
        for fn in (tsel.select_plain, tsel.select):
            dt = t(d).requires_grad_()
            v, i = fn(dt, k)
            assert not i.requires_grad
            v.backward(t(g))
            np.testing.assert_array_equal(dt.grad.numpy(), np.asarray(want),
                                          err_msg=name)


# ---------------------------------------------------------------- fps
def _fps_inputs(rng, b, n):
    pts = rng.standard_normal((b, n, 3)).astype(np.float32)
    valid = np.ones((b, n), bool)
    valid[0, :30] = False                            # seed moves off 0
    valid[1, n // 2:] = False
    pts[0, 5] = np.nan                               # masked and non-finite
    pts[1, 40] = np.inf                              # valid but non-finite
    pts[1, 41] = -np.inf
    return pts, valid


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_fps_plain_matches_fps_indices_and_pallas(rng, masked):
    pts, valid = _fps_inputs(rng, 2, 700)
    if not masked:
        pts = np.nan_to_num(pts, nan=0.5, posinf=0.5, neginf=0.5)
        valid = None
    jv = None if valid is None else jnp.asarray(valid)
    want = np.asarray(jfps.fps_indices(jnp.asarray(pts), 150, valid_mask=jv))
    with interpret(jfp):
        want_pallas = np.asarray(jfp.fps_pallas(jnp.asarray(pts), 150,
                                                valid_mask=jv))
    tv = None if valid is None else t(valid)
    got = tfps.fps_plain(t(pts), 150, tv)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), want_pallas)
    np.testing.assert_array_equal(tfps.fps(t(pts), 150, tv).numpy(), want)


def test_fps_all_invalid_and_overpick(rng):
    """No valid point: seed 0 and index 0 forever (jnp.argmax of an
    all-False mask / all -inf carry); more picks than valid points repeat
    the lowest index with a zero carry, as fps_indices does."""
    pts = rng.standard_normal((2, 20, 3)).astype(np.float32)
    valid = np.zeros((2, 20), bool)
    valid[1, [3, 9, 11]] = True
    want = np.asarray(jfps.fps_indices(jnp.asarray(pts), 6,
                                       valid_mask=jnp.asarray(valid)))
    np.testing.assert_array_equal(
        tfps.fps_plain(t(pts), 6, t(valid)).numpy(), want)


def test_morton_codes_match(rng):
    pts = rng.standard_normal((2, 500, 3)).astype(np.float32)
    mask = rng.random((2, 500)) > 0.2
    for vm in (None, mask):
        want = jfps.morton_codes(jnp.asarray(pts), valid_mask=None if vm is None
                                 else jnp.asarray(vm))
        got = tfps.morton_codes(t(pts), valid_mask=None if vm is None
                                else t(vm))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_fps_hierarchical_matches(rng, masked):
    """Grouped Morton FPS: exact indices against the JAX function on its
    XLA scan and with the Pallas kernel (interpret) inside."""
    b, n, m, group_max = 2, 1503, 300, 400   # 4 groups, 1 padded row
    pts = rng.standard_normal((b, n, 3)).astype(np.float32)
    valid = None
    if masked:
        valid = np.ones((b, n), bool)
        valid[0, 1000:] = False                      # heavily padded cloud
        valid[1, ::7] = False
    jv = None if valid is None else jnp.asarray(valid)
    want = np.asarray(jfps.fps_hierarchical(
        jnp.asarray(pts), m, valid_mask=jv, group_max=group_max,
        use_pallas=False))
    with interpret(jfp):
        want_pallas = np.asarray(jfps.fps_hierarchical(
            jnp.asarray(pts), m, valid_mask=jv, group_max=group_max,
            use_pallas=True))
    got = tfps.fps_hierarchical(t(pts), m, None if valid is None else t(valid),
                                group_max=group_max).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, want_pallas)


def test_dispatch_fps_goes_hierarchical_above_the_cap(rng, monkeypatch):
    pts = t(rng.standard_normal((1, 50, 3)).astype(np.float32))
    monkeypatch.setattr(tfps, "PALLAS_MAX_N", 20)
    got = tfps._dispatch_fps(pts, 10).numpy()
    np.testing.assert_array_equal(got, tfps.fps_hierarchical(pts, 10).numpy())
    assert not np.array_equal(got, tfps.fps(pts, 10).numpy())


@pytest.mark.parametrize("b,n,m,sms,cluster,storage", [
    (1, 5000, 48, 132, 4, "registers-8"),
    (8, 624, 10, 132, 1, "registers-8"),
    (8, 1248, 20, 132, 1, "registers-8"),
    (8, 2496, 40, 132, 2, "registers-8"),
    (8, 6240, 1248, 132, 4, "registers-8"),
    (8, 12480, 2496, 132, 8, "registers-8"),
    (8, 24960, 4992, 132, 8, "registers-16"),
    (8, 29952, 10000, 132, 8, "registers-16"),
    (8, 40000, 10000, 132, 8, "shared"),
    (17, 24960, 4992, 132, 4, "shared"),
    (2, 480000, 5000, 132, 8, "device"),
    (1, 250000, 32, 132, 8, "device"),
    (1, 100000, 32, 132, 8, "shared"),
    (1, 5000, 48, 1, 1, "shared"),
    (48, 6240, 1248, 132, 2, "registers-16"),
], ids=["seed", "sub-seeds-2", "sub-seeds-3", "sub-seeds-4", "merge-2",
        "merge-3", "merge-4", "final-restitch", "large-cloud",
        "more-clouds-than-clusters-of-8", "hierarchical-group",
        "above-shared-memory", "shared-memory", "one-sm", "many-clouds"])
def test_fps_plan_at_main_path_shapes(b, n, m, sms, cluster, storage):
    """The FPS kernel's launch plan at each FPS shape of a 16x shape (the
    seed picks, each level's sub-patch seeds and merge re-stitch, a group
    of the G = 8 final re-stitch), at a cloud above 32,768 points, with
    more clouds than clusters of 8 or of 4 fit on 132 SMs, at a group of
    the hierarchical FPS's largest size, above a block's shared memory,
    and on a card of one SM."""
    plan = tfps.fps_plan(b, n, m, sms)
    assert (plan.cluster, plan.storage) == (cluster, storage)
    assert plan.slice == -(-n // cluster)
    assert plan.cluster <= tfps.MAX_CLUSTER and b * plan.cluster <= max(sms, b)
    regs = {"registers-8": 8, "registers-16": 16}.get(plan.storage)
    if regs is None:
        assert plan.slice > 16 * tfps.BLOCK_THREADS
        assert (plan.storage == "shared") == (
            plan.slice * 16 <= tfps.MAX_STAGED_BYTES)
    else:
        assert plan.slice <= regs * tfps.BLOCK_THREADS
        assert regs == 8 or plan.slice > 8 * tfps.BLOCK_THREADS


@pytest.mark.parametrize("b,n,m,sms", [
    (0, 100, 5, 132), (1, 0, 5, 132), (1, 100, 0, 132), (1, 2**31, 5, 132),
    (1, 100, 5, 0), (2, -5, 5, 132)],
    ids=["no-cloud", "no-point", "no-pick", "n-over-int32", "no-sm",
         "negative-points"])
def test_fps_plan_rejects_bad_calls(b, n, m, sms):
    with pytest.raises(ValueError, match="fps: "):
        tfps.fps_plan(b, n, m, sms)


# ---------------------------------------------------------- interlevel
@pytest.mark.parametrize("n,want", [
    (312, (8, 39, 320)), (1024, (8, 128, 1024)), (1, (1, 1, 32)),
    (7, (7, 1, 32)), (9, (5, 2, 32)), (40, (8, 5, 64)), (100, (8, 13, 128)),
    (2, (2, 1, 32))],
    ids=["sub-patch", "max-n", "one-query", "fewer-than-8", "cluster-of-5",
         "small", "hundred", "two-queries"])
def test_interlevel_plan(n, want):
    """The interlevel kernel's layout: the main path's sub-patches of 312
    queries on clusters of 8 blocks of 320 threads (a team of 8 lanes a
    query), the largest N, fewer queries than blocks, and clusters cut so
    that every block holds a query."""
    plan = til.interlevel_plan(n)
    assert tuple(plan) == want
    assert (plan.cluster - 1) * plan.queries < n <= plan.cluster * plan.queries
    assert plan.cluster <= til.MAX_CLUSTER
    assert plan.queries * til.TEAM <= plan.threads <= 1024
    assert plan.threads % 32 == 0


@pytest.mark.parametrize("n", [0, 1025], ids=["no-query", "n-over-1024"])
def test_interlevel_plan_rejects_bad_layouts(n):
    with pytest.raises(ValueError, match="interlevel: "):
        til.interlevel_plan(n)


def _interlevel_inputs(rng, p, g, n, m, c):
    """Previous sets with duplicate and phantom columns; queries well
    apart from every tie (the JAX kNN ranks in matmul form, the port by
    direct subtraction)."""
    pxyz = rng.standard_normal((p, m, 3)).astype(np.float32)
    pxyz[0, 7] = pxyz[0, 3]                          # duplicate pair
    pxyz[0, 20:24] = pxyz[0, 10:14]
    pf = rng.standard_normal((p, m, c)).astype(np.float32)
    pf[0, 7] = pf[0, 3]
    pf[0, 20:24] = pf[0, 10:14]
    dup = np.array(jdist.duplicate_mask(jnp.asarray(pxyz)))
    dup[:, m - 6:] = True                            # phantom rows
    q = rng.standard_normal((p * g, n, 3)).astype(np.float32)
    xq = rng.standard_normal((p * g, n, c)).astype(np.float32)
    return q, xq, pxyz, pf, dup


@pytest.mark.parametrize("p,g,n,m,c,k", [(2, 3, 16, 40, 12, 4),
                                         (2, 1, 24, 60, 20, 5),
                                         (1, 2, 10, 9, 6, 5)],
                         ids=["grouped", "group1", "few-distinct"])
def test_interlevel_plain_matches_xla_path(rng, p, g, n, m, c, k):
    """Against the XLA branch of the Level (tests/test_interlevel.py's
    reference): picks exact, values to atol = rtol = 1e-5 (float32
    rounding of the distance and weight sums)."""
    q, xq, pxyz, pf, dup = _interlevel_inputs(rng, p, g, n, m, c)
    if m == 9:      # fewer distinct candidates than k: duplicates fill in
        pxyz[0, 3:] = pxyz[0, :6]
        pf[0, 3:] = pf[0, :6]
        dup = np.array(jdist.duplicate_mask(jnp.asarray(pxyz)))
    res = jknn.knn_group(jnp.asarray(q).reshape(p, g * n, 3),
                         jnp.asarray(pxyz), k, unique=True,
                         dup_mask=jnp.asarray(dup), method="exact")
    want = _xla_reference(jnp.asarray(q), jnp.asarray(xq), jnp.asarray(pxyz),
                          jnp.asarray(pf), jnp.asarray(dup), k)
    got, idx = til.interlevel_plain(t(q), t(xq), t(pxyz), t(pf), t(dup), k)
    np.testing.assert_array_equal(
        idx.numpy(), np.asarray(res.idx).reshape(p * g, n, k))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)
    got2, idx2 = til.interlevel(t(q), t(xq), t(pxyz), t(pf), t(dup), k)
    assert torch.equal(got2, got) and torch.equal(idx2, idx)


def test_interlevel_plain_matches_select_pallas(rng):
    """Against the TPU selection kernel (interpret), multi-chunk M with
    duplicates: identical picks."""
    p, g, n, m, k = 1, 2, 8, 2560, 5
    q, _, pxyz, _, _ = _interlevel_inputs(rng, p, g, n, m, 4)
    pxyz[0, 100:110] = pxyz[0, 0:10]
    dup = np.array(jdist.duplicate_mask(jnp.asarray(pxyz)))
    with interpret(jil):
        _, want = jil.interlevel_select_pallas(
            jnp.asarray(q), jnp.asarray(pxyz), jnp.asarray(dup), k)
    xq = np.zeros((p * g, n, 4), np.float32)
    pf = np.zeros((p, m, 4), np.float32)
    _, idx = til.interlevel_plain(t(q), t(xq), t(pxyz), t(pf), t(dup), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want))


@pytest.mark.parametrize("p,g", [(2, 3), (3, 1)], ids=["grouped", "group1"])
def test_interlevel_gradient_matches_xla_path(rng, p, g):
    """Against jax.vjp of the Level's XLA branch (tests/test_interlevel.py's
    reference): only prev_feat receives a gradient (JAX stops the
    gradient of both weight factors), to 1e-5 (float32 sums of w * g in
    another order)."""
    n, m, c, k = 16, 40, 12, 5
    q, xq, pxyz, pf, dup = _interlevel_inputs(rng, p, g, n, m, c)
    cot = rng.standard_normal((p * g, n, c)).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: _xla_reference(*a, jnp.asarray(dup), k),
                     *map(jnp.asarray, (q, xq, pxyz, pf)))
    want = vjp(jnp.asarray(cot))
    for w in want[:3]:
        assert not np.asarray(w).any()
    args = [t(a).requires_grad_() for a in (q, xq, pxyz, pf)]
    for fn in (til.interlevel_plain, til.interlevel):
        for a in args:
            a.grad = None
        out, idx = fn(*args, t(dup), k)
        assert not idx.requires_grad
        out.backward(t(cot))
        assert all(a.grad is None for a in args[:3])
        np.testing.assert_allclose(args[3].grad.numpy(), np.asarray(want[3]),
                                   rtol=1e-5, atol=1e-6)


# ------------------------------------------------------ knn and friends
@pytest.mark.parametrize("k", [5, 40], ids=["select-gate", "sort"])
def test_knn_group_matches(rng, k):
    """unique + valid_mask + dup_mask, through the selection gate (k <= 64,
    M >= 8) and the sort path; indices exact, values to 1e-5."""
    q = rng.standard_normal((2, 16, 6)).astype(np.float32)
    pts = rng.standard_normal((2, 80, 6)).astype(np.float32)
    pts[:, 11] = pts[:, 2]                           # duplicates
    valid = rng.random((2, 80)) > 0.15
    for kw in (dict(unique=True), dict(valid_mask=True),
               dict(unique=True, valid_mask=True), dict()):
        jkw = dict(kw)
        tkw = dict(kw)
        if kw.get("valid_mask"):
            jkw["valid_mask"] = jnp.asarray(valid)
            tkw["valid_mask"] = t(valid)
        want = jknn.knn_group(jnp.asarray(q), jnp.asarray(pts), k, **jkw)
        got = tknn.knn_group(t(q), t(pts), k, **tkw)
        np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
        np.testing.assert_allclose(got.dist2.numpy(), np.asarray(want.dist2),
                                   atol=1e-5, rtol=1e-5)
        np.testing.assert_array_equal(got.neighbors.numpy(),
                                      np.asarray(want.neighbors))
    dup = np.asarray(jdist.duplicate_mask(jnp.asarray(pts)))
    got = tknn.knn_group(t(q), t(pts), k, unique=True, dup_mask=t(dup),
                         with_neighbors=False)
    assert got.neighbors is None
    want = jknn.knn_group(jnp.asarray(q), jnp.asarray(pts), k, unique=True)
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))


def test_knn_k_exceeds_n_raises(rng):
    pts = t(rng.standard_normal((1, 4, 3)).astype(np.float32))
    with pytest.raises(ValueError, match="exceeds"):
        tknn.knn_group(pts, pts, 5)


@pytest.mark.parametrize("b,n", [(3, 200), (8, 3000)],
                         ids=["direct", "sort"])
def test_duplicate_mask_matches(rng, b, n):
    """Both branches (direct compare; three stable sorts once b*n*n*3
    exceeds the budget), keep-first semantics, -0.0 equal to +0.0."""
    pts = rng.integers(-3, 4, (b, n, 3)).astype(np.float32)  # many repeats
    pts[0, 1] = [0.0, -0.0, 1.0]
    pts[0, 2] = [-0.0, 0.0, 1.0]
    want = np.asarray(jdist.duplicate_mask(jnp.asarray(pts)))
    got = tdist.duplicate_mask(t(pts)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0, 2] and not got[0, 1]


def test_distances_match(rng):
    a = rng.standard_normal((2, 30, 5)).astype(np.float32)
    b = rng.standard_normal((2, 40, 5)).astype(np.float32)
    np.testing.assert_allclose(
        tdist.pairwise_dist2(t(a), t(b)).numpy(),
        np.asarray(jdist.pairwise_dist2(jnp.asarray(a), jnp.asarray(b))),
        atol=1e-5)
    np.testing.assert_allclose(
        tdist.direct_dist2(t(a), t(b)).numpy(),
        np.asarray(jdist.direct_dist2(jnp.asarray(a), jnp.asarray(b))),
        rtol=1e-6)


def test_self_nn_dist2_matches(rng):
    """Chunked masked min, chunk edges included; to 1e-6 (matmul form)."""
    pts = rng.standard_normal((2, 300, 3)).astype(np.float32)
    want = np.asarray(jchamfer.self_nn_dist2(jnp.asarray(pts), chunk=128))
    for chunk in (128, 2048):
        got = tchamfer.self_nn_dist2(t(pts), chunk=chunk).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-5)


def _nn_tie_inputs(rng, b, n, m):
    """Integer-grid points: many exact distance ties, duplicate
    reference points, and queries that sit on reference points."""
    a = rng.integers(-4, 5, (b, n, 3)).astype(np.float32)
    r = rng.integers(-4, 5, (b, m, 3)).astype(np.float32)
    r[:, 1::9] = r[:, 0::9][:, :r[:, 1::9].shape[1]]     # duplicates
    a[:, :20] = r[:, 100:120]                              # zero distances
    return a, r


@pytest.mark.parametrize("b,n,m", [(2, 300, 2500), (1, 27, 1)],
                         ids=["two-tiles", "one-candidate"])
def test_nn_one_way_plain_matches_pallas(rng, b, n, m):
    """Against nn_one_way_pallas in interpret mode: ties everywhere,
    duplicate reference points, a ragged last tile; indices exact (ties
    to the lowest index), values to 1e-7 relative (both subtract
    directly)."""
    a, r = _nn_tie_inputs(rng, b, n, max(m, 120))
    r = r[:, :m]
    with interpret(jcp):
        wd, wi = jcp.nn_one_way_pallas(jnp.asarray(a), jnp.asarray(r))
    gd, gi = tchamfer.nn_one_way_plain(t(a), t(r))
    assert gi.dtype == torch.int32
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=1e-7)
    kd, ki = tchamfer.nn_one_way(t(a), t(r))
    assert torch.equal(kd, gd) and torch.equal(ki, gi)


@pytest.mark.parametrize("b,n,m", [(16, 624, 624), (2, 300, 2500)],
                         ids=["train", "n-below-m"])
def test_nn_both_ways_matches_pallas(rng, b, n, m):
    """nn_both_ways on CPU tensors against nn_one_way_pallas in interpret
    mode, in both directions, on tie-heavy data: indices exact, values to
    1e-7 relative."""
    a, r = _nn_tie_inputs(rng, b, n, m)
    got = tchamfer.nn_both_ways(t(a), t(r))
    for (x, y), (gd, gi) in (((a, r), got[:2]), ((r, a), got[2:])):
        with interpret(jcp):
            wd, wi = jcp.nn_one_way_pallas(jnp.asarray(x), jnp.asarray(y))
        assert gi.dtype == torch.int32
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=1e-7)


#: clusters of 1-8 blocks an H100 SXM (132 SMs) holds at once, the same
#: for blocks of 32 to 128 threads, as ``chip_smoke.py`` phase 3 prints
#: them: a cluster's blocks share a GPC, so from 3 blocks up fewer than
#: 132 SMs' worth fit
_H100_ACTIVE = (1056, 528, 327, 248, 193, 163, 139, 124)


def _h100_active(threads, cluster):
    assert threads % 32 == 0 and 32 <= threads <= 128
    return _H100_ACTIVE[cluster - 1]


@pytest.mark.parametrize("b,n,m,both,want", [
    (16, 624, 624, True, (128, 6, 512)),
    (16, 624, 624, False, (128, 8, 512)),
    (1, 80000, 80000, True, (128, 2, 512)),
    (1, 80000, 80000, False, (128, 2, 512)),
    (3, 129, 1, True, (96, 1, 384)),
    (3, 1, 700, True, (128, 1, 512)),
    (3, 1, 700, False, (32, 8, 128)),
    (1, 80000, 1, True, (128, 1, 512)),
    (8, 80000, 80000, True, (128, 2, 512)),
], ids=["train", "train-one-way", "80k", "80k-one-way", "one-candidate",
        "one-query", "one-query-one-way", "80k-one-candidate",
        "above-one-wave"])
def test_chamfer_plan(b, n, m, both, want):
    """The Chamfer kernel's layout on an H100 at the train shape, at 80k x
    80k, at M = 1, at N = 1 and where the query tiles alone overflow the
    card: the queries of the longest cloud (a's alone, one way) in whole
    warps of as few tiles as blocks of 128 threads hold; a cluster of at
    most 8 blocks, the largest of which the card holds every cluster at
    once, or where none of 2 or more fits, the largest that packs the SMs
    as fully as single blocks; its slices cover each direction's
    candidates exactly once."""
    plan = tchamfer.chamfer_plan(b, n, m, _h100_active, both)
    assert tuple(plan) == want
    assert 1 <= plan.cluster <= tchamfer.MAX_CLUSTER
    assert plan.threads % 32 == 0 and plan.threads <= tchamfer.MAX_THREADS
    assert plan.tile == tchamfer.STAGE * plan.threads
    longest = max(n, m) if both else n
    tiles = -(-longest // tchamfer.MAX_THREADS)
    assert -(-longest // plan.threads) == tiles
    assert longest > (plan.threads - 32) * tiles
    clusters = b * (-(-n // plan.threads)
                    + (-(-m // plan.threads) if both else 0))
    one_wave = clusters <= _h100_active(plan.threads, plan.cluster)
    packed = (plan.cluster * _h100_active(plan.threads, plan.cluster)
              == _H100_ACTIVE[0])
    assert plan.cluster == 1 or one_wave or (
        packed and clusters > _H100_ACTIVE[1])
    for count in (n, m):
        covered = [j for lo, hi in tchamfer.chamfer_slices(
            count, plan.cluster) for j in range(lo, hi)]
        assert covered == list(range(count))


@pytest.mark.parametrize("b,n,m", [
    (0, 5, 5), (1, 0, 5), (1, 5, 0), (1, 2**31, 5)],
    ids=["no-cloud", "no-query", "no-candidate", "n-over-int32"])
def test_chamfer_plan_rejects_bad_calls(b, n, m):
    with pytest.raises(ValueError, match="chamfer: "):
        tchamfer.chamfer_plan(b, n, m, _h100_active)


@pytest.mark.parametrize("cluster", range(1, 9))
def test_chamfer_split_merges_to_the_unsplit_result(rng, cluster):
    """The kernel's split of the candidate axis, modelled on the CPU: the
    plain version on each slice of a cluster, merged in slice order as the
    kernel merges (the smaller distance wins, the lower slice on equal
    distances), equals the unsplit result bit for bit on tie-heavy data,
    with duplicates straddling the slice boundaries."""
    a, r = _nn_tie_inputs(rng, 2, 300, 700)
    for lo, _ in tchamfer.chamfer_slices(700, cluster)[1:]:
        r[:, lo] = r[:, lo - 1]
    want = tchamfer.nn_one_way_plain(t(a), t(r))
    best = torch.full(want[0].shape, float("inf"))
    best_i = torch.zeros(want[1].shape, dtype=torch.int32)
    for lo, hi in tchamfer.chamfer_slices(700, cluster):
        if lo == hi:
            continue
        d, i = tchamfer.nn_one_way_plain(t(a), t(r[:, lo:hi]))
        take = d < best
        best = torch.where(take, d, best)
        best_i = torch.where(take, i + lo, best_i)
    assert torch.equal(best, want[0]) and torch.equal(best_i, want[1])


def test_nn_one_way_plain_chunks_rows(rng, monkeypatch):
    """Row chunks of the plain version (1 row and 7 rows at a time) give
    the unchunked result."""
    a, r = _nn_tie_inputs(rng, 2, 40, 150)
    want = tchamfer.nn_one_way_plain(t(a), t(r))
    for chunk in (150, 7 * 2 * 150):
        monkeypatch.setattr(tchamfer, "_PLAIN_CHUNK", chunk)
        got = tchamfer.nn_one_way_plain(t(a), t(r))
        assert all(torch.equal(x, y) for x, y in zip(got, want))


def test_nn_one_way_plain_matches_xla_path(rng):
    """Against the JAX package's chunked matmul-form _nn_one_way on
    tie-free data: indices exact, values to 1e-5 absolute (the matmul
    form cancels |a|^2 + |b|^2 - 2ab in float32: an error of a few
    float32 epsilons of |a|^2 + |b|^2, up to ~20 here)."""
    a = rng.standard_normal((2, 200, 3)).astype(np.float32)
    r = rng.standard_normal((2, 170, 3)).astype(np.float32)
    wd, wi = jchamfer._nn_one_way(jnp.asarray(a), jnp.asarray(r), 64)
    gd, gi = tchamfer.nn_one_way_plain(t(a), t(r))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), atol=1e-5)


def test_nn_distance_matches_jax(rng):
    """Values, indices and the saved-argmin VJP against
    threepu.ops.chamfer.nn_distance (tie-free data, cotangents on both
    distance outputs): distances to 1e-5 absolute (JAX's matmul form),
    gradients to 1e-5 relative (the scatter-adds sum in another
    order)."""
    x1 = rng.standard_normal((2, 60, 3)).astype(np.float32)
    x2 = rng.standard_normal((2, 45, 3)).astype(np.float32)
    g1 = rng.standard_normal((2, 60)).astype(np.float32)
    g2 = rng.standard_normal((2, 45)).astype(np.float32)
    out, vjp = jax.vjp(lambda a, b: jchamfer.nn_distance(a, b),
                       jnp.asarray(x1), jnp.asarray(x2))
    i_zero = [np.zeros(o.shape, jax.dtypes.float0) for o in (out[1], out[3])]
    want = vjp((jnp.asarray(g1), i_zero[0], jnp.asarray(g2), i_zero[1]))
    a, b = t(x1).requires_grad_(), t(x2).requires_grad_()
    d1, i1, d2, i2 = tchamfer.nn_distance(a, b)
    for got, w in ((i1, out[1]), (i2, out[3])):
        np.testing.assert_array_equal(got.numpy(), np.asarray(w))
        assert not got.requires_grad
    for got, w in ((d1, out[0]), (d2, out[2])):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(w),
                                   atol=1e-5)
    torch.autograd.backward([d1, d2], [t(g1), t(g2)])
    for got, w in ((a.grad, want[0]), (b.grad, want[1])):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)


def test_normalize_and_gather_match(rng):
    pc = rng.standard_normal((3, 50, 3)).astype(np.float32) * 4 + 1
    want = jnorm.normalize_point_batch_cl(jnp.asarray(pc))
    got = tnorm.normalize_point_batch_cl(t(pc))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)
    idx = rng.integers(0, 50, (3, 7, 4))
    np.testing.assert_array_equal(
        tgather.batched_gather(t(pc), t(idx)).numpy(), pc[np.arange(3)[:, None,
                                                                      None], idx])
    idx2 = rng.integers(0, 50, (3, 9)).astype(np.int32)
    np.testing.assert_array_equal(tgather.gather_nd(t(pc), t(idx2)).numpy(),
                                  np.take_along_axis(pc, idx2[..., None], 1))


# ------------------------------------------------------------- weights
def test_state_dict_matches_export_reference_state():
    """The port's numpy mapping == threepu.io.checkpoint's, key for key
    and array for array, on the trained checkpoint."""
    with np.load(WEIGHTS) as z:
        flat = {k: z[k] for k in z.files}
    got = state_dict_from_jax(flat)
    tree = {}
    for key, value in flat.items():
        if key.startswith("params/"):
            node = tree
            *path, leaf = key[len("params/"):].split("/")
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = value
    want = export_reference_state({"params": tree})["states"]
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    loaded = load_jax_checkpoint(WEIGHTS)
    assert set(loaded) == set(got)
    assert _flatten(tree).keys() == {k[len("params/"):] for k in flat
                                     if k.startswith("params/")}
