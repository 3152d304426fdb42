"""The trace reduction: interval union, attribution of kernels to host
ranges by correlation id, the breakdown."""

import pytest

from perfbench.harness.trace import Trace, inside, merged, union_length


@pytest.mark.parametrize("spans, length", [
    ([(0, 2), (1, 3)], 3),                 # overlapping
    ([(0, 10), (2, 3), (4, 5)], 10),       # nested
    ([(0, 1), (2, 3), (5, 9)], 6),         # disjoint
    ([(5, 9), (0, 1), (0, 1)], 5),         # unsorted, repeated
    ([], 0),
])
def test_union_length(spans, length):
    assert union_length(spans) == length


def test_merged_and_inside():
    spans = merged([(4, 6), (0, 2), (1, 3), (6, 7)])
    assert spans == [(0, 3), (4, 7)]
    assert inside(2.5, spans) and inside(4, spans) and inside(7, spans)
    assert not inside(3.5, spans) and not inside(-1, spans) and not inside(8, spans)


def _x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": args}


def _trace():
    return Trace([
        _x("user_annotation", "perfbench::gn_block", 0, 10),
        _x("cpu_op", "aten::mm", 1, 2),
        _x("cuda_runtime", "cudaLaunchKernel", 2, 1, correlation=1),
        _x("cuda_runtime", "cudaLaunchKernelExC", 5, 1, correlation=2),
        _x("cpu_op", "aten::add", 20, 5),
        _x("cuda_runtime", "cudaLaunchKernel", 21, 1, correlation=3),
        _x("cuda_runtime", "cudaMemcpyAsync", 30, 1, correlation=4),
        _x("kernel", "gemm", 4, 6, correlation=1),
        _x("kernel", "gfd::k3", 8, 4, correlation=2),     # overlaps gemm
        _x("kernel", "add", 40, 2, correlation=3),
        _x("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 50, 3,
           correlation=4, bytes=4096),
        _x("kernel", "orphan", 60, 1, correlation=99),
        {"ph": "i", "cat": "kernel", "name": "instant", "ts": 3},
    ])


def test_trace_readings():
    tr = _trace()
    assert tr.busy_us() == 8 + 2 + 3 + 1        # gemm and k3 overlap: 4..12
    gn = tr.launched_in("perfbench::gn_block")
    assert sorted(k["name"] for k in gn) == ["gemm", "gfd::k3"]
    assert union_length(Trace.span(k) for k in gn) == 8
    assert tr.unlaunched() == 1
    assert tr.h2d_bytes() == 4096
    assert len(tr.kernels) == 4


def test_breakdown():
    b = _trace().breakdown(top=2)
    assert b["device_ops"][0] == ["gemm", pytest.approx(6e-6)]
    assert len(b["device_ops"]) == 2
    # the gap 12..40 ends at "add", launched inside aten::add
    assert b["idle_gaps"][0] == ["aten::add", pytest.approx(28e-6)]
