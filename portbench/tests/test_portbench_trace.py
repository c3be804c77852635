"""The reduction of a profiler trace: device rows to the innermost host
range open at their launch, busy time over the window, idle gaps by the
range open when the device went idle."""

import pytest

from portbench import trace


def _x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": args}


def test_reduce_attributes_rows_to_ranges():
    events = [
        _x("user_annotation", "pb.step", 0, 100),
        _x("user_annotation", "pb.encode", 5, 10),
        _x("user_annotation", "pb.decode", 20, 30),
        _x("user_annotation", "pb.counters", 50, 50),
        _x("user_annotation", "pb.step", 100, 50),
        _x("cuda_runtime", "cudaLaunchKernel", 2, 1, correlation=1),  # the draw
        _x("cuda_runtime", "cudaLaunchKernel", 6, 1, correlation=2),
        _x("cuda_runtime", "cudaLaunchKernel", 21, 1, correlation=3),
        _x("cuda_runtime", "cudaLaunchKernel", 60, 1, correlation=4),
        _x("cuda_runtime", "cudaLaunchKernel", 101, 1, correlation=5),
        _x("kernel", "randint", 3, 2, correlation=1),
        _x("kernel", "enc", 10, 10, correlation=2),
        _x("kernel", "dec", 25, 40, correlation=3),
        _x("gpu_memcpy", "Memcpy DtoH", 70, 5, correlation=4),
        _x("kernel", "draw2", 140, 20, correlation=5),  # runs past the window
        _x("kernel", "unlaunched", 90, 2),
        _x("gpu_user_annotation", "pb.decode", 25, 40),
    ]
    s = trace.reduce({"traceEvents": events})
    assert s.window_s == pytest.approx(150e-6)
    assert s.device_s["step"] == pytest.approx(12e-6)  # 2 + the 10 inside the window
    assert s.device_s["encode"] == pytest.approx(10e-6)
    assert s.device_s["decode"] == pytest.approx(40e-6)
    assert s.device_s["counters"] == pytest.approx(5e-6)
    assert s.device_s["outside"] == pytest.approx(2e-6)
    assert s.busy_s == pytest.approx((2 + 10 + 45 + 2 + 10) * 1e-6)
    assert s.device_ops[0] == ["dec", pytest.approx(40e-6)]
    idle = dict(s.idle_gaps)
    # 0-3 in the draw, 5-10 in encode, 20-25 in decode, then 65-70, 75-90
    # and 92-140 in the counters
    assert idle == {"step: 1 gaps": pytest.approx(3e-6), "encode: 1 gaps": pytest.approx(5e-6),
                    "decode: 1 gaps": pytest.approx(5e-6),
                    "counters: 3 gaps": pytest.approx(68e-6)}
    assert sum(v for _, v in s.idle_gaps) == pytest.approx(s.window_s - s.busy_s)


def test_reduce_of_an_empty_trace():
    s = trace.reduce({"traceEvents": []})
    assert s.busy_s == 0 and s.window_s == 0
