"""The eval cascade as CUDA graphs (:class:`threepu_torch.models.graphs.Stages`
in :meth:`threepu_torch.models.Net.upsample`).

On the CPU the cascade builds no graph; the graphed path is exercised with
an emulation of CUDA graphs (:class:`FakeStages`): a capture runs the
stage once, and a replay runs it again and writes its results into the
tensors the capture returned, as a graph's replay overwrites its outputs.
A copy that is missing, or a graph tensor handed to a caller, then shows
as it would on a card.  A net captures a key when two calls in a row ask
for it (:class:`threepu_torch.models.graphs.StageSets`), so the first
chunk of a shape runs as written and the second captures.  The pipeline
runs a shape's chunks in turn on two stream slots, each with its set of
graphs; on the CPU :class:`FakeSlotStreams` emulates the slots' streams
(the slot changes, the stream does not).  The ``cuda`` cases run the real
graphs and streams and skip without a card (``python -m pytest
tests/test_torch_cascade_graphs.py -q --noconftest`` on a GPU machine).
"""

import torch_threads  # noqa: F401  (first: sets torch's threads)
import collections
from functools import partial

import numpy as np
import pytest
import torch

import threepu_torch.inference as inference
import threepu_torch.ops.edgeconv as tec
import threepu_torch.ops.fps as tfps
import threepu_torch.ops.interlevel as til
import threepu_torch.ops.select as tsel
from threepu_torch._build import Kernel
from threepu_torch.inference import (cut_patches, plan_patches,
                                     upsample_point_cloud, upsample_shape)
from threepu_torch.models import Net, PUNet, load_net
from threepu_torch.models.graphs import (EAGER, GraphedNet, SlotSets,
                                         SlotStreams, Stages, StageSets,
                                         slot)
from threepu_torch.ops.fps import fps_hierarchical
from threepu_torch.ops.gather import gather_nd
from threepu_torch.ops.normalize import normalize_point_batch_cl
from threepu_torch.utils import pc_utils

ROOT = __import__("pathlib").Path(__file__).resolve().parents[1]
WEIGHTS = ROOT / "artifacts" / "prod_clean_final.npz"
FIXTURE = ROOT / "tests" / "fixtures" / "torch_port_ref.npz"

#: small nets for the CPU: three levels of 2x and two of 4x
SMALL = {"step2": dict(max_up_ratio=8, step_ratio=2, knn=8, growth_rate=4,
                       dense_n=2, max_num_point=32, fm_knn=3),
         "step4": dict(max_up_ratio=16, step_ratio=4, knn=8, growth_rate=4,
                       dense_n=2, max_num_point=32, fm_knn=3)}
#: the 16x nets at full width
FULL = dict(max_up_ratio=16, knn=32, growth_rate=12, dense_n=3,
            max_num_point=312, fm_knn=5)


def n_stages(net):
    """Stages a chunk replays: level 1; each re-patching level's extract,
    level and merge FPS."""
    return 1 + 3 * (len(net.levels) - 1)


#: launches of one 16x shape of 5,000 points (48 patches, 6 chunks)
SHAPE_LAUNCHES = {2: {"select": 96, "fps": 38, "interlevel": 18,
                      "edgeconv": 96},
                  4: {"select": 48, "fps": 14, "interlevel": 6,
                      "edgeconv": 48}}
KERNELS = {"select": tsel.KERNEL, "fps": tfps.KERNEL,
           "interlevel": til.KERNEL, "edgeconv": tec.KERNEL}


def surface(n, seed):
    """``n`` points of a bumpy closed surface."""
    rng = np.random.default_rng(seed)
    p = rng.standard_normal((n, 3)).astype(np.float32)
    p /= np.linalg.norm(p, axis=-1, keepdims=True)
    return (p * (1 + 0.2 * np.sin(3 * p[:, :1]))).astype(np.float32)


def chunks(points, num_point, chunk, device="cpu"):
    """The pipeline's normalized patches of ``points``, cut into chunks."""
    xyz = torch.from_numpy(points).to(device)
    n, padded, chunk = plan_patches(xyz.shape[0], num_point, chunk=chunk)
    patches = cut_patches(xyz[None], n, num_point)
    norm = normalize_point_batch_cl(patches)[0]
    return [norm[i:i + chunk] for i in range(0, n - chunk + 1, chunk)]


class _Replay:
    """An emulated graph: :meth:`replay` runs the stage again and writes
    its results into the first run's tensors."""

    def __init__(self, fn, args, out):
        self.fn, self.args, self.out = fn, args, out

    def replay(self):
        # a replay makes no Python call of a kernel
        counts = {k: k.launches for k in Kernel.instances}
        got = self.fn(*self.args)
        for k, n in counts.items():
            k.launches = n
        outs = self.out if isinstance(self.out, tuple) else (self.out,)
        news = got if isinstance(got, tuple) else (got,)
        for o, g in zip(outs, news):
            o.copy_(g)


class FakeStages(Stages):
    """:class:`Stages` on the CPU with emulated graphs."""

    @staticmethod
    def graphed(t):
        return True

    def __init__(self, device, slot=0):
        super().__init__(device, slot)
        self.cuda = True

    def _warm(self, fn, args):
        fn(*args)

    def _record(self, fn, args):
        out = fn(*args)
        return _Replay(fn, args, out), out


class FakeSlotStreams(SlotStreams):
    """:class:`SlotStreams` on the CPU: a chunk runs in its slot, on the
    one stream there is; :attr:`calls` records the pipeline's calls."""

    @staticmethod
    def streamed(t):
        return True

    @classmethod
    def of(cls, device):
        cls.made.append(cls(device))
        return cls.made[-1]

    def __init__(self, device):
        self.device, self.calls = device, []

    def fork(self):
        self.calls.append("fork")

    def run(self, i):
        self.calls.append(i)
        return slot(i)

    def join(self, outs):
        self.calls.append(("join", len(outs)))


def emulate(monkeypatch):
    """Graphs and slot streams emulated on the CPU from here on, and the
    pipeline's slot counter reset; returns the list of the slot streams
    the pipeline makes."""
    monkeypatch.setattr(GraphedNet, "stage_class", FakeStages)
    monkeypatch.setattr(inference, "SlotStreams", FakeSlotStreams)
    monkeypatch.setattr(FakeSlotStreams, "made", [], raising=False)
    inference.SLOT_CHUNKS.clear()
    return FakeSlotStreams.made


def small_net(step, seed=0):
    torch.manual_seed(seed)
    net = Net(**SMALL[step]).eval()
    with torch.no_grad():
        for name, p in net.named_parameters():
            if name.endswith("bias"):
                p.uniform_(-0.05, 0.05)
    return net


def small_chunks(step):
    return chunks(surface(400, 3), SMALL[step]["max_num_point"], 4)[:3]


def keep_level_calls(net):
    """Wraps each level's ``forward`` on the instance, as callers that keep
    a level's inputs and outputs across chunks do; returns the records:
    ``[(level, args, kwargs, outputs)]`` with clones taken at the call."""
    rec = []

    def clone(x):
        if isinstance(x, torch.Tensor):
            return x.clone()
        if isinstance(x, tuple):
            return tuple(clone(t) for t in x)
        return x

    for name, lvl in net.levels.items():
        forward = lvl.forward

        def level(*args, _forward=forward, _name=name, **kw):
            out = _forward(*args, **kw)
            rec.append((_name, args, kw, out,
                        clone((args, {k: kw[k] for k in ("prev_dup",)
                                      if k in kw}, out))))
            return out

        lvl.forward = level
    return rec


def tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (tuple, list)):
        for t in x:
            yield from tensors(t)
    elif isinstance(x, dict):
        for t in x.values():
            yield from tensors(t)


def assert_kept(rec):
    """Every kept argument and result still equals its clone."""
    for name, args, kw, out, (c_args, c_kw, c_out) in rec:
        for got, want in zip(tensors((args, {k: kw[k] for k in c_kw}, out)),
                             tensors((c_args, c_kw, c_out))):
            assert torch.equal(got, want), name


# ------------------------------------------------------------------ CPU


def test_a_cpu_upsample_builds_no_graph_and_counts_no_replay():
    net = small_net("step2")
    before = {k: k.launches for k in Kernel.instances}
    for x in small_chunks("step2")[:2]:
        out = net.upsample(x, 8)
        assert out.shape == (4, 32 * 8, 3)
    assert net._stages == {}
    assert {k: k.launches for k in Kernel.instances} == before
    assert not EAGER.graphs and not EAGER.captures and not EAGER.replays


@pytest.mark.parametrize("step", [2, 4], ids=["step2", "step4"])
def test_emulated_graphs_equal_the_eager_cascade(monkeypatch, step):
    """Four chunks through the graphed path equal the eager cascade bit
    for bit: the first runs as written, the second captures every stage
    and each later one replays it."""
    net = small_net(f"step{step}")
    xs = small_chunks(f"step{step}")
    xs = xs + xs[:1]
    want = [net.upsample(x) for x in xs]
    monkeypatch.setattr(GraphedNet, "stage_class", FakeStages)
    got = [net.upsample(x) for x in xs]
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    (run,) = net._stages.values()
    assert len(run.graphs) == n_stages(net)
    assert set(run.captures.values()) == {1}
    assert run.replays == collections.Counter(
        {name: len(xs) - 1 for name in run.graphs})
    assert {"level1", "level2", "level2.extract",
            "level2.merge_fps"} <= set(run.graphs)
    assert "level1.conv1" not in run.graphs
    # a capture asked for runs eagerly and leaves the graphs alone
    assert torch.equal(net.upsample(xs[0], capture={}), want[0])
    assert set(run.replays.values()) == {len(xs) - 1}


@pytest.mark.parametrize("step", [2, 4], ids=["step2", "step4"])
def test_emulated_graphs_leave_what_callers_keep(monkeypatch, step):
    """A caller that keeps a level's arguments and results, and each
    chunk's output, across later chunks finds them unchanged; no output
    shares storage with another or with the graphs."""
    net = small_net(f"step{step}")
    monkeypatch.setattr(GraphedNet, "stage_class", FakeStages)
    rec = keep_level_calls(net)
    xs = small_chunks(f"step{step}")
    xs = xs + xs[:1]
    outs, kept = [], []
    for x in xs:
        out = net.upsample(x)
        outs.append(out)
        kept.append(out.clone())
    assert len(rec) == len(xs) * len(net.levels)
    assert_kept(rec)
    for out, k in zip(outs, kept):
        assert torch.equal(out, k)
    (run,) = net._stages.values()
    assert set(run.replays.values()) == {len(xs) - 1}
    graph_ptrs = {t.data_ptr() for g in run.graphs.values()
                  for t in tensors(g.out)}
    graph_ptrs |= {t.data_ptr() for t in run._inputs.values()}
    handed = [t for r in rec for t in tensors((r[1], r[2], r[3]))
              if t.numel()]
    handed = [t for t in handed if all(t is not x for x in xs)]
    ptrs = [t.data_ptr() for t in handed + outs]
    assert not graph_ptrs & set(ptrs)
    assert len({o.data_ptr() for o in outs}) == len(outs)


def test_a_stage_replayed_on_other_tensors_raises():
    """A replay whose arguments stage elsewhere than the capture's (here
    a stage's output in place of a copy), come in another number or in
    another shape raises."""
    run = FakeStages("cpu")
    a, b = torch.ones(3), torch.ones(3)
    run("double", lambda t: 2 * t, a)
    out = run("half", lambda t: t / 2, b)
    with pytest.raises(RuntimeError, match="captured on other tensors"):
        run("double", lambda t: 2 * t, out)
    with pytest.raises(RuntimeError, match="captured on other tensors"):
        run("double", lambda t, u: 2 * t, a, b)
    with pytest.raises(RuntimeError, match="graph input 0 of double"):
        run("double", lambda t: 2 * t, torch.ones(4))


def test_a_stage_copies_an_outside_tensor_once_and_passes_graph_outputs():
    """A tensor from outside the graphs is copied into a static input
    once a set: a later stage given it, unchanged, reads that copy, and
    one given it changed copies it anew.  A stage's output, or a view of
    one, passes into the next stage as it is."""
    run = FakeStages("cpu")
    x = torch.arange(6.0)
    y = run("add", lambda t: t + 1, x)
    (staged,) = run.graphs["add"].args
    assert staged.data_ptr() != x.data_ptr() and torch.equal(staged, x)
    assert list(run._inputs) == [("add", 0)]
    z = run("mul", lambda t, u, v: t * u.sum() + v.sum(), y, y[3:], x[3:])
    args = run.graphs["mul"].args
    assert args[0] is y and args[1].data_ptr() == y[3:].data_ptr()
    assert args[2] is run._inputs[("mul", 2)] and len(run._inputs) == 2
    w = run("sub", lambda t, u: t - u, z, x)
    assert run.graphs["sub"].args[1] is staged and len(run._inputs) == 2
    assert torch.equal(w, z - x)
    x.add_(1)
    run("neg", lambda t: -t, x)
    assert run.graphs["neg"].args[0] is run._inputs[("neg", 0)]
    assert torch.equal(run._inputs[("neg", 0)], x)
    assert torch.equal(staged, torch.arange(6.0))


def test_replays_count_the_captured_launches():
    """The run before a capture and the capture count nothing; each
    replay adds what the capture launched, also when the stage launched
    a kernel twice; a failed capture leaves the counts as they were."""
    k1, k2 = Kernel("a", [], "a.cu", "a"), Kernel("b", [], "b.cu", "b")
    try:
        def stage(t):
            k1.launches += 2
            k2.launches += 1
            return t + 1

        run = FakeStages("cpu")
        x = torch.zeros(2)
        for i in range(3):
            assert torch.equal(run("stage", stage, x), torch.ones(2))
            assert (k1.launches, k2.launches) == (2 * (i + 1), i + 1)
        assert run.captures == {"stage": 1} and run.replays == {"stage": 3}

        def broken(t):
            k1.launches += 5
            raise ValueError("no")

        with pytest.raises(ValueError):
            run("broken", broken, x)
        assert (k1.launches, k2.launches) == (6, 3)
        assert "broken" not in run.graphs
    finally:
        Kernel.instances.remove(k1)
        Kernel.instances.remove(k2)


def test_every_kernel_is_registered():
    assert set(KERNELS.values()) <= set(Kernel.instances)


def test_a_net_holds_one_set_captured_on_a_key_asked_for_twice_in_a_row():
    """A key asked for once gets the pass-through; twice in a row, a set
    of its own in place of the one held; alternating keys capture
    nothing new; ``clear`` forgets the set and the last key."""
    sets = StageSets()
    made = []

    def make():
        made.append(FakeStages("cpu"))
        return made[-1]

    assert sets.take("a", make) is EAGER and not made
    a = sets.take("a", make)
    assert made == [a] and dict(sets) == {"a": a}
    assert sets.take("a", make) is a
    for key in ("b", "a", "b", "a", "b"):
        got = sets.take(key, make)
        assert got is (a if key == "a" else EAGER)
    b = sets.take("b", make)
    assert made == [a, b] and dict(sets) == {"b": b}
    assert sets.take("a", make) is EAGER and dict(sets) == {"b": b}
    sets.clear()
    assert sets == {} and sets.take("a", make) is EAGER
    assert len(made) == 2


def _punet_chunks():
    torch.manual_seed(0)
    pts = torch.from_numpy(surface(400, 3))
    near = torch.cdist(pts[:12], pts).argsort(-1)[:, :64]
    x = normalize_point_batch_cl(pts[near])[0].contiguous()
    return [x[:4], x[4:8], x[8:12], x[:2], x[2:4], x[:3]]


@pytest.mark.parametrize("arch", ["3pu", "punet"])
def test_chunk_shapes_keep_one_set_and_a_shape_seen_once_runs_as_written(
        monkeypatch, arch):
    """Chunks of several shapes through either net, graphs emulated: a
    shape that comes once is never captured, one that comes twice in a
    row is, and the net holds only the set of the latest such shape; the
    outputs equal the eager ones bit for bit."""
    if arch == "3pu":
        net = small_net("step2")
        a, b, c = small_chunks("step2")
        xs = [a, b, a[:3], c, a[:2], b[:2], a[:1], c[:2]]
    else:
        torch.manual_seed(0)
        net = PUNet(num_point=64).eval()
        a, b, c, d, e, f = _punet_chunks()
        xs = [a, b, f, c, d, e, a[:1], d]
    want = [net.upsample(x) for x in xs]
    monkeypatch.setattr(GraphedNet, "stage_class", FakeStages)
    held = []
    for x, w in zip(xs, want):
        assert torch.equal(net.upsample(x), w)
        held.append([key[0][0] for _, key in net._stages])
    # chunks of 4 patches are captured at the second chunk and replayed
    # at the fourth; chunks of 2 take their place at the sixth and replay
    # at the eighth; the chunks of 3 and 1 come once and run as written
    assert held == [[], [4], [4], [4], [4], [2], [2], [2]]
    (run,) = net._stages.values()
    assert set(run.captures.values()) == {1}
    assert set(run.replays.values()) == {2}


@pytest.mark.parametrize("arch", ["3pu", "punet"])
def test_to_drops_the_graphs_and_the_next_call_captures_anew(monkeypatch,
                                                             arch):
    if arch == "3pu":
        net, x = small_net("step2"), small_chunks("step2")[0]
    else:
        torch.manual_seed(0)
        net, x = PUNet(num_point=64).eval(), _punet_chunks()[0]
    monkeypatch.setattr(GraphedNet, "stage_class", FakeStages)
    first = net.upsample(x)
    assert torch.equal(net.upsample(x), first)
    (old,) = net._stages.values()
    net.to("cpu")
    assert net._stages == {}
    # the key the last call asked for is forgotten too
    assert torch.equal(net.upsample(x), first) and net._stages == {}
    assert torch.equal(net.upsample(x), first)
    (new,) = net._stages.values()
    assert new is not old and set(new.captures.values()) == {1}


def test_the_train_cascade_takes_no_graphs(monkeypatch):
    net = small_net("step2").train()
    monkeypatch.setattr(GraphedNet, "stage_class", FakeStages)
    x = small_chunks("step2")[0]
    gt = torch.from_numpy(surface(4 * 256, 5).reshape(4, 256, 3))
    with torch.no_grad():
        for _ in range(2):
            net(x, 8, gt, seed_idx=[torch.zeros(4, 1, dtype=torch.long)] * 2)
    assert net._stages == {}


#: (ratio, points a patch, chunk) of the pipeline's CPU cases: 256 points
#: make 24 patches, six chunks
PIPELINE = {"step2": (8, 32, 4), "step4": (16, 32, 4), "punet": (4, 64, 2)}


def pipeline_net(arch):
    if arch == "punet":
        torch.manual_seed(0)
        return PUNet(num_point=64).eval()
    return small_net(arch)


def unit_shape(n, seed, device="cpu"):
    """``n`` points of :func:`surface` in the unit sphere."""
    p = surface(n, seed)
    return torch.from_numpy(p / np.linalg.norm(p, axis=1).max()).to(device)


def one_stream(net, xyz, ratio, num_point, num_out, chunk):
    """The pipeline as it ran before its chunks took two stream slots,
    written out: the seed, every chunk in turn on the caller's stream, and
    the re-stitch (masked where the patches were padded)."""
    n, padded, chunk = plan_patches(xyz.shape[0], num_point, chunk=chunk)
    patches = cut_patches(xyz[None], n, num_point)
    patches = torch.cat([patches, patches[:1].expand(padded - n, -1, -1)])
    norm, centroid, radius = normalize_point_batch_cl(patches)
    up = torch.cat([net.upsample(norm[i:i + chunk], ratio)
                    for i in range(0, padded, chunk)])
    merged = (up * radius + centroid).reshape(1, -1, 3)
    valid = (torch.arange(padded, device=xyz.device)[:, None] < n).expand(
        padded, num_point * ratio).reshape(1, -1)
    groups = inference.resolve_restitch_groups(None, num_out)
    if groups > 1:
        idx = fps_hierarchical(merged, num_out, valid_mask=valid,
                               group_max=-(-merged.shape[1] // groups))
    else:
        idx = tfps._dispatch_fps(merged, num_out, valid)
    return gather_nd(merged, idx)[0]


def sets_by_slot(net):
    """The net's sets of graphs, ``{slot: Stages}``."""
    return {i: net._stages[i, key] for i, key in net._stages}


def test_two_slots_each_capture_once_at_their_own_second_call(monkeypatch):
    """Four chunks of one shape in turn in slots 0 and 1, graphs
    emulated: each slot runs its first chunk as written and captures at
    its own second, into a set of its own; the outputs equal the eager
    ones bit for bit, and a call outside any slot takes slot 0's set."""
    net = small_net("step2")
    a, b, c = small_chunks("step2")
    xs = [a, b, c, a]
    want = [net.upsample(x) for x in xs]
    monkeypatch.setattr(GraphedNet, "stage_class", FakeStages)
    held = []
    for j, x in enumerate(xs):
        with slot(j % 2):
            assert torch.equal(net.upsample(x), want[j])
        held.append(sorted(sets_by_slot(net)))
    assert held == [[], [], [0], [0, 1]]
    sets = sets_by_slot(net)
    assert sets[0] is not sets[1]
    assert [sets[i].slot for i in (0, 1)] == [0, 1]
    for run in sets.values():
        assert len(run.graphs) == n_stages(net)
        assert set(run.captures.values()) == {1}
        assert set(run.replays.values()) == {1}
    assert torch.equal(net.upsample(b), want[1])
    assert set(sets[0].replays.values()) == {2}
    assert set(sets[1].replays.values()) == {1}


def test_slot_sets_map_each_slot_and_key_to_its_set():
    """:class:`SlotSets` keeps each slot's rule apart and reads as the
    mapping ``(slot, key) -> set``; ``clear`` forgets every slot's set
    and last key."""
    sets = SlotSets()
    made = []

    def make():
        made.append(FakeStages("cpu"))
        return made[-1]

    assert sets.take(0, "a", make) is EAGER
    assert sets.take(1, "a", make) is EAGER
    a0 = sets.take(0, "a", make)
    assert dict(sets) == {(0, "a"): a0} and len(sets) == 1
    a1 = sets.take(1, "a", make)
    assert made == [a0, a1] and dict(sets) == {(0, "a"): a0, (1, "a"): a1}
    assert sets[1, "a"] is a1 and sets.take(0, "a", make) is a0
    sets.clear()
    assert sets == {} and not sets
    assert sets.take(0, "a", make) is EAGER and len(made) == 2


@pytest.mark.parametrize("arch", ["step2", "step4", "punet"])
def test_an_overlapped_shape_equals_the_one_stream_loop(monkeypatch, arch):
    """Two shapes of six chunks through ``upsample_point_cloud``, the
    chunks in turn in slots 0 and 1 (graphs and streams emulated: each
    slot runs its first chunk as written, captures at its second and
    replays after), equal the one-stream loop bit for bit.  The slots
    fork once a shape and join once, on all six chunks' outputs."""
    net = pipeline_net(arch)
    ratio, num_point, chunk = PIPELINE[arch]
    shapes = [unit_shape(256, 3), unit_shape(256, 4)]
    want = [one_stream(net, x, ratio, num_point, 256 * ratio, chunk)
            for x in shapes]
    made = emulate(monkeypatch)
    for x, w in zip(shapes, want):
        got = upsample_point_cloud(net, x, ratio, num_point, 256 * ratio,
                                   chunk=chunk)
        assert torch.equal(got, w)
    assert [s.calls for s in made] == [
        ["fork", 0, 1, 0, 1, 0, 1, ("join", 6)]] * 2
    sets = sets_by_slot(net)
    assert sorted(sets) == [0, 1]
    for run in sets.values():
        assert set(run.captures.values()) == {1}
        # a capture, then one replay at it and one more on the first
        # shape, three on the second
        assert set(run.replays.values()) == {5}


@pytest.mark.parametrize("chunk,slots", [(24, {}), (8, {0: 2, 1: 1}),
                                         (6, {0: 2, 1: 2}),
                                         (5, {0: 3, 1: 2}),
                                         (4, {0: 3, 1: 3})],
                         ids=["1", "3", "4", "5-padded", "6"])
def test_the_slot_counter_counts_each_chunk_by_its_slot(monkeypatch, chunk,
                                                        slots):
    """24 patches in chunks of ``chunk`` (5 pads them to 25): the slot
    counter counts each chunk in its slot, and a shape of one chunk
    counts nothing; the output is the one-stream loop's."""
    net = small_net("step2")
    x = unit_shape(256, 3)
    want = one_stream(net, x, 8, 32, 2048, chunk)
    emulate(monkeypatch)
    got = upsample_point_cloud(net, x, 8, 32, 2048, chunk=chunk)
    assert torch.equal(got, want)
    assert inference.SLOT_CHUNKS == collections.Counter(slots)


def test_a_single_chunk_rank_uses_one_slot_and_no_second_set(monkeypatch):
    """A rank of one chunk runs it on the caller's stream, in slot 0: no
    slot streams, nothing counted, and after three shapes one set."""
    net = small_net("step2")
    x = unit_shape(256, 3)
    want = one_stream(net, x, 8, 32, 2048, None)
    made = emulate(monkeypatch)
    for _ in range(3):
        assert torch.equal(upsample_point_cloud(net, x, 8, 32, 2048), want)
    assert not made and not inference.SLOT_CHUNKS
    (run,) = sets_by_slot(net).values()
    assert run.slot == 0 and set(run.replays.values()) == {2}


def test_a_cpu_shape_runs_its_chunks_as_before():
    """On CPU tensors the pipeline runs every chunk in turn as written:
    no slot streams, nothing counted, no graphs."""
    net = small_net("step2")
    x = unit_shape(256, 3)
    made = dict(SlotStreams._made)
    inference.SLOT_CHUNKS.clear()
    got = upsample_point_cloud(net, x, 8, 32, 2048, chunk=4)
    assert torch.equal(got, one_stream(net, x, 8, 32, 2048, 4))
    assert SlotStreams._made == made and not inference.SLOT_CHUNKS
    assert net._stages == {}


@pytest.mark.parametrize("arch", ["step2", "punet"])
def test_to_drops_both_slots_sets(monkeypatch, arch):
    """After an overlapped shape each slot holds a set; ``.to()`` drops
    both, and the next shape captures anew in each slot, at that slot's
    second chunk, with the same output."""
    net = pipeline_net(arch)
    ratio, num_point, chunk = PIPELINE[arch]
    x = unit_shape(256, 3)
    emulate(monkeypatch)
    first = upsample_point_cloud(net, x, ratio, num_point, 256 * ratio,
                                 chunk=chunk)
    old = sets_by_slot(net)
    assert sorted(old) == [0, 1]
    net.to("cpu")
    assert net._stages == {}
    assert torch.equal(upsample_point_cloud(net, x, ratio, num_point,
                                            256 * ratio, chunk=chunk), first)
    new = sets_by_slot(net)
    assert sorted(new) == [0, 1]
    for i in (0, 1):
        assert new[i] is not old[i]
        assert set(new[i].captures.values()) == {1}
        assert set(new[i].replays.values()) == {2}


# ----------------------------------------------------------------- card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


def full_net(step, dev):
    """The step-2 net with the trained weights, or the step-4 net with
    weights drawn from a seed."""
    if step == 2:
        return load_net(str(WEIGHTS), device=dev, step_ratio=2,
                        **FULL).eval()
    torch.manual_seed(0)
    return Net(step_ratio=4, **FULL).eval().to(dev)


def fixture_points():
    return np.load(FIXTURE)["input"].astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("step", [2, 4], ids=["s2-trained", "s4-seeded"])
def test_graphed_upsample_equals_eager_bit_for_bit(card, step):
    """Three consecutive chunks of a 5,000-point shape, replayed after a
    capture on the first, against the eager cascade (a capture asked for
    runs it), bit for bit; every stage captured once."""
    net = full_net(step, card)
    xs = chunks(fixture_points(), 312, 8, card)[:3]
    net.upsample(xs[0])
    net.upsample(xs[0])
    got = [net.upsample(x) for x in xs]
    want = [net.upsample(x, capture={}) for x in xs]
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    (run,) = net._stages.values()
    assert len(run.graphs) == n_stages(net)
    assert set(run.captures.values()) == {1}
    assert set(run.replays.values()) == {4}


@pytest.mark.cuda
@pytest.mark.parametrize("step", [2, 4], ids=["s2-trained", "s4-seeded"])
def test_kept_level_calls_and_outputs_survive_later_chunks(card, step):
    """Four chunks (as written, capture, two replays), every level call
    and output kept: none changes, none shares storage with the graphs."""
    net = full_net(step, card)
    rec = keep_level_calls(net)
    xs = chunks(fixture_points(), 312, 8, card)[:4]
    outs = [net.upsample(x) for x in xs]
    kept = [o.clone() for o in outs]
    torch.cuda.synchronize(card)
    assert_kept(rec)
    assert all(torch.equal(o, k) for o, k in zip(outs, kept))
    assert len({o.data_ptr() for o in outs}) == len(outs)
    (run,) = net._stages.values()
    assert set(run.replays.values()) == {3}
    graph_ptrs = {t.data_ptr() for g in run.graphs.values()
                  for t in tensors(g.out)}
    assert not graph_ptrs & {t.data_ptr() for r in rec
                             for t in tensors(r[3])}
    assert not graph_ptrs & {o.data_ptr() for o in outs}


@pytest.mark.cuda
def test_to_after_a_run_recaptures(card):
    net = full_net(4, card)
    x = chunks(fixture_points(), 312, 8, card)[0]
    net.upsample(x)
    first = net.upsample(x)
    net.to("cpu")
    assert net._stages == {}
    net.to(card)
    net.upsample(x)
    assert torch.equal(net.upsample(x), first)
    (run,) = net._stages.values()
    assert set(run.captures.values()) == {1}
    assert set(run.replays.values()) == {1}


# The overlap's card cases come before the profiler's: after a profiler
# session, the reference check of a shape left every later session of the
# process without device events (the edge-conv cases of
# test_torch_kernels_cuda.py; H100, torch 2.11), though neither alone did.


def card_pipeline_net(arch, dev):
    """``(net, ratio, points a patch)`` of a card case: the trained step-2
    net, the seeded step-4 net or PU-Net at its published widths."""
    if arch == "punet":
        torch.manual_seed(0)
        return PUNet().to(dev).eval(), 4, 1024
    return full_net(2 if arch == "s2-trained" else 4, dev), 16, 312


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["s2-trained", "s4-seeded", "punet"])
def test_an_overlapped_shape_on_the_card_equals_the_one_stream_loop(card,
                                                                    arch):
    """The fixture's 5,000-point shape through ``upsample_shape`` (16x:
    six chunks; PU-Net: 14 patches padded to two chunks), its chunks on
    the two slots' streams, against the one-stream loop on the caller's
    stream: bit for bit, on the first shape (which captures in each slot)
    and on the second (which replays); each chunk counted in its slot."""
    net, ratio, num_point = card_pipeline_net(arch, card)
    pts = fixture_points()
    data, centroid, furthest = pc_utils.normalize_point_cloud(pts)
    inference.SLOT_CHUNKS.clear()
    got = [upsample_shape(net, pts, ratio, num_point=num_point, chunk=8)[1]
           for _ in range(2)]
    chunks_a_shape = 6 if ratio == 16 else 2
    assert inference.SLOT_CHUNKS == {0: chunks_a_shape,
                                     1: chunks_a_shape}
    assert sorted(sets_by_slot(net)) == [0, 1]
    xyz = torch.from_numpy(np.ascontiguousarray(data)).to(card)
    want = one_stream(net, xyz, ratio, num_point, pts.shape[0] * ratio, 8)
    want = want.cpu().numpy() * furthest + centroid
    for g in got:
        np.testing.assert_array_equal(g, want)


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["3pu-s2-16x", "3pu-s4-16x"])
def test_a_shape_recorded_under_overlap_checks_to_zero(card, config):
    """The benchmark's recorder on the benchmark's net, a pool shape run
    with its chunks on the two slots' streams after two shapes that
    capture: ``portbench.evalcheck.check_shape`` follows every chunk's
    level calls and reads 0 everywhere."""
    import json

    from portbench import evalcheck, reference as R, surface, weights
    from portbench.drivers.eval import Probe

    bench = ROOT / "portbench"
    cfg = json.loads((bench / "configs" / f"{config}.json").read_text())
    traffic = json.loads((bench / "traffic" / "closed-5k.json").read_text())
    job = dict(config=cfg, seed=(1 << 31) + 20)
    net, params = weights.eval_net(job, card)
    probe = Probe(net, None, None)
    pool = surface.pool(job["seed"], 3, traffic["points"])
    kwargs = dict(num_point=traffic["num_point"], chunk=traffic["chunk"],
                  patch_num_ratio=traffic["patch_num_ratio"])
    for points in pool[:2]:
        upsample_shape(net, points, traffic["ratio"], **kwargs)
    inference.SLOT_CHUNKS.clear()
    probe.rec = rec = dict(chunks=[], levels=[], gathered=None)
    rec["output"] = upsample_shape(net, pool[2], traffic["ratio"],
                                   **kwargs)[1]
    probe.rec = None
    assert inference.SLOT_CHUNKS == {0: 3, 1: 3} and len(rec["chunks"]) == 6
    readings = evalcheck.check_shape(R.Arith(), params,
                                     R.NetSpec(**cfg["net"]), traffic,
                                     pool[2], rec)
    assert readings == {"start": 0.0, "glue": 0.0, "level_rows": 0.0,
                        "restitch": 0.0}


@pytest.mark.cuda
def test_the_overlap_holds_at_most_two_sets_of_memory(card):
    """The peak of a warm 16x shape with its chunks on two slots (two
    sets of graphs, two chunks in flight) is at most twice the peak of
    the one-stream loop's warm shape (one set, one chunk)."""
    net = full_net(2, card)
    pts = fixture_points()
    data = pc_utils.normalize_point_cloud(pts)[0]
    xyz = torch.from_numpy(np.ascontiguousarray(data)).to(card)

    def peak(fn):
        for _ in range(2):
            fn()
        torch.cuda.synchronize(card)
        torch.cuda.reset_peak_memory_stats(card)
        fn()
        torch.cuda.synchronize(card)
        return torch.cuda.max_memory_allocated(card)

    one = peak(lambda: one_stream(net, xyz, 16, 312, 80000, 8))
    two = peak(lambda: upsample_point_cloud(net, xyz, 16, 312, 80000,
                                            chunk=8))
    assert sorted(sets_by_slot(net)) == [0, 1]
    assert one < two <= 2 * one, (one, two)


def _profiled_launches(fn):
    """``fn()`` under ``torch.profiler``: how many device operations of
    each of :data:`KERNELS` the profiler saw (by the kernel's name)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]):
        torch.ones(1, device="cuda").add_(1)     # the profiler's start-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    seen = collections.Counter()
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA or ev.is_user_annotation:
            continue
        for name in KERNELS:
            if f"{name}_kernel" in ev.name.lower():
                seen[name] += 1
    return {name: seen[name] for name in KERNELS}


@pytest.mark.cuda
@pytest.mark.parametrize("step", [2, 4], ids=["s2", "s4"])
def test_launches_per_shape_equal_the_eager_counts(card, step):
    """``Kernel.launches`` over a 16x shape: the first shape (a chunk as
    written, a capture, replays) and the second (replays) each count the
    eager launches, and on the second the profiler sees as many of each
    kernel run on the card as ``Kernel.launches`` counts."""
    net = full_net(step, card)
    pts = fixture_points()
    for shape in range(2):
        for k in KERNELS.values():
            k.launches = 0
        run = partial(upsample_shape, net, pts, 16, num_point=312, chunk=8)
        ran = _profiled_launches(run) if shape else (run(), None)[1]
        counted = {n: k.launches for n, k in KERNELS.items()}
        assert counted == SHAPE_LAUNCHES[step]
        if ran is not None:
            assert ran == counted
    # six chunks a shape in turn in two slots: each slot's first chunk
    # runs as written, its second captures and replays, each later
    # chunk replays
    sets = sets_by_slot(net)
    assert sorted(sets) == [0, 1]
    assert all(set(run.replays.values()) == {5} for run in sets.values())


@pytest.mark.cuda
def test_a_capture_under_the_profiler_records_spans_outside_it(card):
    """A net's first chunks under a recording profiler: the capture's own
    work records no span, and the spans of the replays read back."""
    from torch.profiler import ProfilerActivity, profile

    from threepu_torch.utils.profiling import clear_spans, finished_spans

    net = full_net(4, card)
    x = chunks(fixture_points(), 312, 8, card)[0]
    clear_spans()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        outs = [net.upsample(x) for _ in range(3)]
        torch.cuda.synchronize()
    spans = finished_spans()
    names = collections.Counter(s["name"] for s in spans)
    # conv spans come from the chunk run as written and the run before
    # the capture; none from the capture; the level spans from all three
    assert names["level1.conv1"] == 2 and names["level1"] == 3
    assert names["level2.merge_fps"] == 3
    assert all(s["device_end_ms"] is not None for s in spans)
    assert torch.equal(outs[1], outs[2]) and torch.equal(outs[0], outs[1])

