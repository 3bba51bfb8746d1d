"""The reduction of a profiler trace on small synthetic event lists: the
union of intervals, the attribution of device activity to ranges (by
thread and time, and in the backward by autograd sequence number), and
each metric's arithmetic."""
import pytest
from torch.autograd import DeviceType

from lsgd_bench import peaks, trace
from lsgd_bench import run as R

MAIN, AUTOGRAD = 1, 2


class Ev:
    """A stand-in for one of ``kineto_results.events()``."""

    def __init__(self, name, start, end, *, cpu=True, thread=MAIN, corr=0,
                 link=0, seq=-1):
        self._d = dict(name=name, start=start, end=end, cpu=cpu, thread=thread,
                       corr=corr, link=link, seq=seq)

    def name(self): return self._d["name"]
    def device_type(self): return DeviceType.CPU if self._d["cpu"] else DeviceType.CUDA
    def start_ns(self): return self._d["start"]
    def end_ns(self): return self._d["end"]
    def duration_ns(self): return self._d["end"] - self._d["start"]
    def correlation_id(self): return self._d["corr"]
    def linked_correlation_id(self): return self._d["link"]
    def start_thread_id(self): return self._d["thread"]
    def sequence_nr(self): return self._d["seq"]
    def is_user_annotation(self): return False


def kernel(name, start, end, link):
    return Ev(name, start, end, cpu=False, link=link)


# one local step: a forward matmul inside "attention" (seq 7), another
# outside it (seq 8); their backward on autograd's thread; a bucket
# kernel launched by ctypes under no op; then a sync
EVENTS = [
    Ev("bench.local_step", 0, 1000),
    Ev("attention", 10, 100),
    Ev("aten::mm", 20, 30, corr=1, seq=7),
    Ev("aten::mm", 120, 130, corr=2, seq=8),
    Ev(trace.EVAL_FN + "MmBackward0", 200, 300, thread=AUTOGRAD, seq=7),
    Ev("aten::mm", 210, 220, thread=AUTOGRAD, corr=3),
    Ev(trace.EVAL_FN + "MmBackward0", 400, 500, thread=AUTOGRAD, seq=8),
    Ev("aten::mm", 410, 420, thread=AUTOGRAD, corr=4),
    Ev("cudaLaunchKernel", 600, 610, corr=5),
    Ev("bench.sync", 1100, 1200),
    Ev("aten::mean", 1110, 1120, corr=6),
    kernel("sgemm_fwd_attn", 1000, 3000, 1),
    kernel("sgemm_fwd", 3000, 4000, 2),
    kernel("sgemm_bwd_attn", 5000, 6000, 3),
    kernel("sgemm_bwd", 5500, 7000, 4),
    kernel("void update_kernel<true>(float*)", 8000, 9000, 5),
    kernel("mean_kernel", 10000, 10500, 6),
]
RANGES = {"bench.local_step", "bench.sync", "attention"}


def acts():
    return {a.name: a for a in trace.reduce(EVENTS, RANGES)}


def test_union_of_intervals():
    assert trace.union_s([]) == 0
    assert trace.union_s([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == pytest.approx(4)


def test_attribution_by_thread_time_and_sequence_number():
    a = acts()
    assert a["sgemm_fwd_attn"].ranges == {"bench.local_step", "attention"}
    assert a["sgemm_fwd"].ranges == {"bench.local_step"}
    # the backward on autograd's thread: its node was made inside attention
    assert a["sgemm_bwd_attn"].ranges == {"bench.local_step", "attention"}
    assert a["sgemm_bwd"].ranges == {"bench.local_step"}
    assert a["void update_kernel<true>(float*)"].ranges == {"bench.local_step"}
    assert a["mean_kernel"].ranges == {"bench.sync"}


def window(**kw):
    d = dict(acts=list(acts().values()), window_s=15000e-9, wall_s=12000e-9,
             steps=1, syncs=1,
             workers=4, step_flops=1e6, bucket_elements=1000)
    d.update(kw)
    return trace.Window(**d)


def reader(name):
    return R.metric_reader(name).read


def test_metrics_arithmetic():
    w = window()
    # busy: 1000-4000, 5000-7000, 8000-9000, 10000-10500 ns
    assert w.busy_s() == pytest.approx(6500e-9)
    # against the untraced wall seconds of the same steps, not the traced
    assert reader("device_idle_pct")(w) == pytest.approx(100 * (1 - 6500 / 12000))
    assert reader("local_step_ms")(w) == pytest.approx(6000e-6)
    assert reader("sync_ms")(w) == pytest.approx(500e-6)
    # forward 1000-3000, backward 5000-6000, once each
    assert reader("attention_ms")(w) == pytest.approx(3000e-6)
    assert reader("moe_route_ms")(w) is None
    assert reader("mfu")(w) == pytest.approx(100 * 1e6 / (12000e-9 * peaks.FLOPS_BF16))
    assert reader("sync_ms")(window(syncs=0)) is None


def test_roofline_counts_twenty_bytes_an_element_a_worker():
    w = window()
    need = 20 * 4 * 1000 / peaks.HBM_BYTES_PER_S
    assert reader("sgd_update_roofline")(w) == pytest.approx(100 * need / 1000e-9)
    no_kernel = window(acts=[a for a in w.acts if "update" not in a.name])
    assert reader("sgd_update_roofline")(no_kernel) is None


def test_breakdown_names_the_top_operations_and_gaps():
    b = trace.breakdown(list(acts().values()))
    assert b["device_ops"][0] == ["sgemm_fwd_attn", pytest.approx(2000e-9)]
    gaps = dict(b["idle_gaps"])
    assert gaps["aten::mean"] == pytest.approx(1000e-9)
    assert sum(gaps.values()) == pytest.approx(3000e-9)
