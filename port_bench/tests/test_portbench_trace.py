"""The trace readers on a synthetic event list."""

import re

from port_bench import trace as T


def synthetic():
    # stretch 0..100 us; device busy 10-20, 15-30, 50-60; launches on
    # thread 1 inside host op "aten::convolution" (0-40) for corr 1, 2 and
    # inside "aten::mul" (45-55) for corr 3
    device = [("void qsc::onebit_fwd_kernel<2>(...)", 10.0, 20.0, 1),
              ("cudnn_conv", 15.0, 30.0, 2),
              ("elementwise", 50.0, 60.0, 3),
              ("late", 150.0, 160.0, 4)]
    host = [("aten::convolution", 0.0, 40.0, 1),
            ("aten::cudnn_convolution", 5.0, 35.0, 1),
            ("aten::mul", 45.0, 55.0, 1),
            ("aten::linalg_qr", 60.0, 90.0, 1),
            ("aten::linalg_qr", 70.0, 80.0, 1),
            ("aten::linalg_qr", 60.0, 70.0, 2)]
    launches = [(1, 8.0, 1), (2, 12.0, 1), (3, 46.0, 1)]
    return T.Trace(span=(0.0, 100.0), device=device, host=host,
                   launches=launches)


def test_union_and_complement():
    assert T.union([(3, 4), (0, 2), (1, 3)]) == [(0, 4)]
    assert T.complement([(10, 30), (50, 60)], (0, 100)) == [
        (0, 10), (30, 50), (60, 100)]


def test_busy_and_window():
    t = synthetic()
    assert t.window_s == 1e-4
    assert t.busy_s() == (20.0 + 10.0) / 1e6    # 10-30 and 50-60
    assert t.launch_count() == 3


def test_device_and_host_sums():
    t = synthetic()
    assert t.device_s(T.LIKELIHOOD) == 10.0 / 1e6
    # nested calls counted once per thread, threads summed
    assert t.host_s(("aten::linalg_qr",)) == (30.0 + 10.0) / 1e6
    s, n = t.device_s_under(("aten::convolution",))
    assert n == 2 and s == (10.0 + 15.0) / 1e6


def test_breakdown_labels_gaps_by_innermost_host_op():
    b = synthetic().breakdown()
    ops = dict(b["device_ops"])
    assert ops["cudnn_conv"] == 15.0 / 1e6
    gaps = dict(b["idle_gaps"])
    # gaps 0-10 (mid 5: inside cudnn_convolution, which starts at 5),
    # 30-50 (mid 40: aten::convolution ends at 40, so still inside it),
    # 60-100 (mid 80: the outer linalg_qr of thread 1)
    assert gaps["aten::cudnn_convolution"] == 10.0 / 1e6
    assert gaps["aten::convolution"] == 20.0 / 1e6
    assert gaps["aten::linalg_qr"] == 40.0 / 1e6


def test_likelihood_pattern():
    for name in ("void qsc::qnll_fwd_kernel<qsc::Bounds, 2, false, true>",
                 "onebit_bwd_kernel<2>", "sum_partials_kernel"):
        assert T.LIKELIHOOD.search(name)
    assert not T.LIKELIHOOD.search("cudnn::dgrad_engine")
    assert isinstance(T.LIKELIHOOD, re.Pattern)
