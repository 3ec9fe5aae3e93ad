"""The trace arithmetic on synthetic event lists."""
import pytest

from bench import trace as tr


def _trace(kernels, host=(), start=0.0, end=10.0, steps=2, copies=()):
    return tr.Trace(kernels=list(kernels), host=list(host), start=start,
                    end=end, steps=steps, copies=list(copies))


def test_classes():
    assert tr.kernel_class("ncclDevKernel_AllReduce_Sum_bf16") == "nccl"
    assert tr.kernel_class("repro_gather_bulk_kernel") == "port"
    assert tr.kernel_class("void scatter_fused<...>") == "port"
    assert tr.kernel_class("sm90_xmma_gemm_bf16bf16_bf16f32") == "gemm"
    assert tr.kernel_class("nvjet_tst_128x256_64x4") == "gemm"
    assert tr.kernel_class("void at::native::vectorized_elementwise_kernel"
                           "<4, at::native::CUDAFunctor_add<float>>") \
        == "other"


def test_union_overlap_and_gaps():
    assert tr.length([(0, 2), (1, 3), (5, 6)]) == 4
    assert tr.overlap([(0, 4)], [(1, 2), (3, 5)]) == 2
    assert tr.gaps([(1, 2), (1.5, 3), (6, 7)], 0, 10) == \
        [[0, 1], [3, 6], [7, 10]]
    assert tr.gaps([(-1, 11)], 0, 10) == []


def test_idle_share_over_every_stream():
    # two streams overlap on [2, 3]; a copy on [8, 9]
    t = _trace([("a", 1, 3), ("b", 2, 4)], copies=[("Memcpy HtoD", 8, 9)])
    assert t.busy_s() == 4
    assert t.idle_share() == pytest.approx(0.6)


def test_exposed_exchange():
    k = [("gemm_a", 0, 4), ("ncclKernel_AllReduce", 3, 6),
         ("elementwise", 5, 5.5), ("ncclKernel_AllReduce", 8, 9)]
    t = _trace(k)
    # nccl [3,6] + [8,9] = 4 s; compute covers [3,4] and [5,5.5]
    assert t.exposed_nccl_s() == pytest.approx(2.5)
    assert t.class_seconds("nccl") == 4


def test_idle_gaps_named_by_the_innermost_host_op():
    k = [("k1", 0, 1), ("k2", 4, 5)]
    host = [("Trainer.step", 0, 10), ("aten::item", 1.5, 3.8),
            ("cudaStreamSynchronize", 2, 3.5)]
    gaps = _trace(k, host=host, end=6).idle_gaps()
    assert gaps[0] == ["cudaStreamSynchronize", 3]
    assert gaps[1] == ["Trainer.step", 1]


def test_top_ops_and_launches():
    k = [("x", 0, 1), ("y", 1, 4), ("x", 5, 7), ("gather_bulk", 8, 8.5)]
    t = _trace(k)
    assert t.top_ops()[:2] == [["x", 3], ["y", 3]] or \
        t.top_ops()[:2] == [["y", 3], ["x", 3]]
    assert [k[1] for k in t.launches(("gather_bulk",))] == [8]


def test_a_gap_no_host_op_covers_is_named_by_its_neighbours():
    k = [("k1", 0, 1), ("k2", 4, 5)]
    host = [("bench.step", 0, 6), ("aten::mm", 0.5, 1.2),
            ("aten::add", 3.9, 4.1)]
    assert _trace(k, host=host, end=5).idle_gaps()[0] == \
        ["after aten::mm / before aten::add", 3]
