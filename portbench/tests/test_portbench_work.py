"""The work counts and the readers' arithmetic, against counts made by
other means: ``torch.utils.flop_counter.FlopCounterMode`` on the
program's decomposed path (77.5 GFLOP a step-2 chunk, 35.3 a step-4
chunk, 23.7 a ratio-16 step forward and backward) and the launch counts
the program's counters read on the card (FPS 38 and 14 a shape, select
96 and 48, select 16 a step)."""

import pytest

from portbench import readers, trace, work
from portbench.work import Bound

S2 = {"max_up_ratio": 16, "step_ratio": 2, "knn": 32, "growth_rate": 12,
      "dense_n": 3, "max_num_point": 312, "fm_knn": 5}
S4 = dict(S2, step_ratio=4)
EVAL = {"points": 5000, "num_point": 312, "ratio": 16, "chunk": 8,
        "patch_num_ratio": 3}


def products(net, levels):
    """The GEMM and distance-matrix operations (what FlopCounterMode
    counts of the forward)."""
    return sum(f["gemm"] + f["dist"]
               for f in (work.level_flops(net, lv) for lv in levels))


@pytest.mark.parametrize("net,want", [(S2, 77.5e9), (S4, 35.3e9)])
def test_chunk_products_match_the_flop_counter(net, want):
    got = products(net, work.eval_levels(net, 8, 312, 16))
    assert abs(got - want) / want < 0.01


def test_train_step_products_match_the_flop_counter():
    levels = work.train_levels(S2, 16, 312, 16)
    fwd = products(S2, levels)
    back = 2 * sum(work.level_flops(S2, lv)["gemm"] for lv in levels)
    assert abs(fwd + back - 23.7e9) / 23.7e9 < 0.01
    assert work.train_step_flops(S2, 16, 312, 16) > fwd + back


@pytest.mark.parametrize("net,fps,select", [(S2, 38, 96), (S4, 14, 48)])
def test_call_counts_match_the_launch_counters(net, fps, select):
    assert len(work.eval_fps_bounds(net, EVAL)) == fps
    assert len(work.eval_select_bounds(net, EVAL)) == select


def test_sub_patch_plan():
    lv = work.eval_levels(S2, 8, 312, 16)
    assert [x.b for x in lv] == [8, 80, 160, 320]
    assert [x.m_prev for x in lv] == [0, 312, 3120, 6240]
    assert [x.b for x in work.eval_levels(S4, 8, 312, 16)] == [8, 160]
    assert len(work.train_select_bounds(S2, dict(batch_size=16,
                                                 num_point=312,
                                                 ratio=16))) == 16


def test_four_ranks_split_the_chunks_and_mask_the_padding():
    one = work.eval_fps_bounds(S2, EVAL, 1)
    four = work.eval_fps_bounds(S2, EVAL, 4)
    assert len(four) == 1 + 2 * 6 + 1          # 64 patches, 16 a rank
    assert four[-1].ops == one[-1].ops           # the same valid points
    assert work.eval_shape_flops(S2, EVAL, 4) == \
        work.eval_shape_flops(S2, EVAL, 1)


def test_bound_takes_the_larger_of_the_two_times():
    b = work.bound(67e12, 1.0)
    assert b.seconds == pytest.approx(1.0) and b.by == "operations"
    b = work.bound(1.0, 3.35e12)
    assert b.seconds == pytest.approx(1.0) and b.by == "bytes"
    t = work.total([work.bound(67e12, 0), work.bound(0, 2 * 3.35e12)])
    assert t.seconds == pytest.approx(3.0) and t.by == "bytes"


def test_readers():
    ctx = dict(unit="shape", units_profiled=2, window_units=100,
               window_s=25.0, chips=1, spans={"cascade": [1.0, 3.0]},
               rules=[["fps_kernel", "fps"]],
               profile=dict(busy_s=0.375, window_s=1.0, n_ops=200,
                            by_name={"void fps_kernel<3>(x)": 0.04,
                                     "gemm": 0.5}),
               work=dict(fps=Bound(0.001, "operations", 0, 0),
                         flops=67e12 * 0.25 * 0.03))
    assert readers.span_mean(ctx, "cascade") == 2.0
    assert readers.span_mean(ctx, "restitch") is None
    assert readers.ops_per_unit(ctx, "shape") == 100
    assert readers.ops_per_unit(ctx, "step") is None
    assert readers.roofline(ctx, "fps", "shape") == pytest.approx(5.0)
    assert readers.roofline(ctx, "select", "shape") is None
    assert readers.idle_share(ctx, "shape") == pytest.approx(25.0)
    assert readers.mfu(ctx, "shape") == pytest.approx(3.0)
    assert readers.mfu(dict(ctx, chips=4), "shape") == pytest.approx(0.75)


def test_union_and_gaps():
    assert trace.union_us([(0, 2), (1, 3), (5, 6)]) == 4
    assert trace.merged([(5, 6), (0, 2), (1, 3)]) == [(0, 3), (5, 6)]
    host = [("outer", 0, 10), ("inner", 2, 4), ("later", 6, 7)]
    assert trace.host_at(3, host) == "inner"
    assert trace.host_at(5, host) == "outer"
    assert trace.host_at(11, host) == "host (no op)"
