"""The trace reduction on a hand-made Kineto trace: busy time as the union
of device activity inside the stretch, launches counted once, device time
of the kernels launched inside a span, idle gaps named by the host
operation at their middle."""

from portbench import trace


def ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_summarize_a_hand_made_trace():
    events = [
        ev("user_annotation", trace.STRETCH, 0, 100),
        ev("user_annotation", "portbench.guidance", 10, 20),
        ev("cpu_op", "aten::conv2d", 12, 5),
        ev("cpu_op", "aten::mm", 60, 30),
        ev("cuda_runtime", "cudaLaunchKernel", 13, 1, corr=1),
        ev("cuda_driver", "cuLaunchKernel", 13.5, 0.2, corr=9),     # inside the runtime call
        ev("cuda_runtime", "cudaLaunchKernel", 61, 1, corr=2),
        ev("cuda_driver", "cuLaunchKernel", 70, 1, corr=3),          # a launch of its own
        ev("cuda_runtime", "cudaMemcpyAsync", 80, 1, corr=4),
        ev("kernel", "conv_kernel", 20, 10, tid=7, corr=1),
        ev("kernel", "gemm_kernel", 25, 15, tid=7, corr=2),          # overlaps the first
        ev("kernel", "small_kernel", 72, 3, tid=7, corr=3),
        ev("gpu_memcpy", "Memcpy HtoD", 95, 10, tid=7, corr=4),      # runs past the end
    ]
    s = trace.summarize(events, spans=("portbench.guidance",))
    assert abs(s["window_s"] - 100e-6) < 1e-12
    assert abs(s["busy_s"] - (20 + 3 + 5) * 1e-6) < 1e-12
    assert s["launches"] == 3
    assert abs(s["span_kernel_s"]["portbench.guidance"] - 10e-6) < 1e-12
    gaps = dict(s["breakdown"]["idle_gaps"])
    # [0, 20] mid 10: the guidance span; [40, 72] mid 56: nothing;
    # [75, 95] mid 85: aten::mm.
    assert abs(gaps["portbench.guidance"] - 20e-6) < 1e-12
    assert abs(gaps["host (no operation)"] - 32e-6) < 1e-12
    assert abs(gaps["aten::mm"] - 20e-6) < 1e-12
    assert s["breakdown"]["device_ops"][0][0] == "gemm_kernel"
