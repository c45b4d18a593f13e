"""The reductions of the profiler's trace, on a synthetic Chrome trace:
busy time as a union, device time by the spans open at each launch, idle
gaps by what the host was doing, and the per-layer readers on them."""

import pytest
from bench_helpers import ROOT  # noqa: F401  (puts the benchmark on sys.path)

from benchlib import cli, spec, trace

MAIN = 7


def X(cat, name, ts, dur, tid=MAIN, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def synthetic():
    """Host: kkt.factorize [0, 50) launching k1 (corr 1) at 10 and the
    T=1 factor (corr 2) at 20; oracle.fx [60, 90) launching k3 (corr 3) at
    70; differentiation.sensitivity [100, 140) holding kkt.solve_with
    [105, 130) that launches k4 (corr 4) at 110. Device: k1 [30, 40), the
    factor [40, 60), k3 [80, 85), a copy [85, 86), k4 [120, 150)."""
    return [
        X("user_annotation", "kkt.factorize", 0, 50),
        X("cuda_runtime", "cudaLaunchKernel", 10, 1, corr=1),
        X("cuda_driver", "cuLaunchKernel", 20, 1, corr=2),
        X("cpu_op", "aten::fill_", 60, 25),
        X("user_annotation", "oracle.fx", 60, 30),
        X("cuda_runtime", "cudaLaunchKernel", 70, 1, corr=3),
        X("user_annotation", "differentiation.sensitivity", 100, 40),
        X("user_annotation", "kkt.solve_with", 105, 25),
        X("cuda_runtime", "cudaLaunchKernel", 110, 1, corr=4),
        X("kernel", "void gemv_kernel<float>", 30, 10, tid=0, corr=1),
        X("kernel", "void factor_t1_reg_kernel<float, 32>(float const*)", 40, 20, tid=0, corr=2),
        X("kernel", "void add_kernel", 80, 5, tid=0, corr=3),
        X("gpu_memcpy", "Memcpy DtoH", 85, 1, tid=0),
        X("kernel", "void mul_kernel", 120, 30, tid=0, corr=4),
    ]


def test_device_summary():
    d = trace.DeviceSummary(synthetic(), wall=150e-6)
    assert d.ops == 5
    assert d.busy_s == pytest.approx((30 + 5 + 1 + 30) * 1e-6)
    assert d.seconds(("factor_t1_",)) == (pytest.approx(20e-6), 1)
    assert d.top(1)[0][0].startswith("void mul_kernel")


def test_host_attribution():
    h = trace.HostAttribution(synthetic())
    assert (h.linked, h.unlinked) == (4, 1)
    assert h.seconds("kkt.", outside=("differentiation.",)) == pytest.approx(30e-6)
    assert h.seconds("kkt.") == pytest.approx(60e-6)
    assert h.seconds("oracle.") == pytest.approx(5e-6)
    assert h.seconds("differentiation.") == pytest.approx(30e-6)
    # idle: [60, 80) opened while the host ran aten::fill_ in oracle.fx,
    # [86, 120) at 86, the host in Python inside oracle.fx after the fill
    assert h.gaps == [["oracle.fx/python", pytest.approx(34e-6)], ["oracle.fx/aten::fill_", pytest.approx(20e-6)]]


class FakeBatch:
    def __init__(self, iters, syncs):
        self.lockstep_iters, self.host_syncs = iters, syncs


def test_per_layer_readers_on_the_synthetic_trace():
    events = synthetic()
    device = trace.DeviceSummary(events, wall=200e-6)
    calls = [("factor_t1", (131072, 32, 32), "float32")]
    r = cli.Readings([FakeBatch(3, 40), FakeBatch(2, 44)], 1.0, 10.0, device=device, calls=calls,
                     host=trace.HostAttribution(events))
    cell = spec.Cell("pendulum-t11.b262144.sens")
    read = lambda name: cell.reader(name)(r)
    assert read("lockstep_iters") == 3 and read("host_syncs") == 42
    assert read("kernels_per_iter") == pytest.approx(5 / 3)
    assert read("kkt_ms_per_iter") == pytest.approx(1e3 * 30e-6 / 2)
    assert read("oracle_ms_per_iter") == pytest.approx(1e3 * 5e-6 / 2)
    assert read("diff_ms_per_batch") == pytest.approx(1e3 * 30e-6)
    assert read("device_idle") == pytest.approx(100 * (1 - 66 / 200))
    # 813.7 MB in 20 us would pass the bandwidth: the share shows it
    assert read("t1_roofline") == pytest.approx(100 * (813694976 / 3.35e12) / 20e-6)
    assert read("lanes_roofline") is None
    assert cell.reader("diff_ms_per_batch")(cli.Readings([], 1.0, 1.0, host=trace.HostAttribution(events[:6]))) is None
