"""Each metric reader on a small timeline and mesh record made by hand,
whose values are known."""

from __future__ import annotations

import pytest

from portbench import readers, tracing
from portbench.loader import Bench

MS = 1_000_000  # ns

CFG = {"height": 512, "width": 512, "images_per_call": 49,
       "precision": "exact"}
STREAM = 904_045


def _record(kind="encode", timeline=None, counters=None, calls=None):
    calls = calls or [(0.0, 0.010, 0, True), (0.010, 0.030, 1, True),
                      (0.030, 0.040, 0, True), (0.040, 0.100, 1, False)]
    return {"kind": kind, "calls": calls, "window_s": 0.1, "setup_s": 7.5,
            "megapixels": 12.845056, "config": CFG,
            "card": "NVIDIA H100 80GB HBM3", "stream_bytes": [STREAM] * 2,
            "bench": Bench(), "timeline": timeline,
            "counters": counters or []}


def _timeline(cards=(0,)):
    # a 10 ms window, one span; on card 0 a kernel 1-2 ms, a memset 2-2.5,
    # a host copy 4-6, a kernel 5-7 (overlapping the copy), a copy between
    # cards 9-9.5: busy 1-2.5, 4-7, 9-9.5 = 5 ms, idle 5 ms
    ops = [(0, 1 * MS, 2 * MS, "encode2_kernel", "kernel"),
           (0, 2 * MS, 2.5 * MS, "Memset (Device)", "memset"),
           (0, 4 * MS, 6 * MS, "Memcpy HtoD (Pageable -> Device)",
            "host_copy"),
           (0, 5 * MS, 7 * MS, "place_kernel", "kernel"),
           (0, 9 * MS, 9.5 * MS, "Memcpy PtoP (Device -> Device)",
            "card_copy")]
    host = [(0, 3 * MS, "aten::copy_"), (int(0.5 * MS), int(0.8 * MS),
                                         "cudaMemcpyAsync"),
            (int(7.2 * MS), int(8.8 * MS), "aten::cat")]
    return {"window": (0, 10 * MS), "device_ops": ops,
            "spans": [(0, 10 * MS, "api.compress_batch")],
            "host_ops": sorted(host), "cards": list(cards)}


def test_the_rate_counts_every_call_that_returned_over_the_window():
    r = _record()
    assert readers.rate_mp_s(r, "encode") == pytest.approx(
        3 * 12.845056 / 0.1)
    assert readers.rate_mp_s(r, "decode") is None


def test_the_tail_is_the_95th_percentile_of_all_calls():
    r = _record()
    # 10, 20, 10, 60 ms: linear interpolation between 20 and 60
    assert readers.p95_ms(r, "encode") == pytest.approx(54.0)


def test_setup_is_the_records():
    assert Bench().e2e_metric("setup_s").read(_record()) == 7.5


def test_busy_and_gaps_merge_overlapping_operations():
    busy, gaps = tracing.busy_and_gaps(_timeline())
    assert busy == {0: 5 * MS}
    assert gaps[0] == [(0, 1 * MS), (2.5 * MS, 4 * MS), (7 * MS, 9 * MS),
                       (9.5 * MS, 10 * MS)]


def test_idle_share_from_the_gaps_and_a_card_with_nothing():
    r = _record(timeline=_timeline())
    assert readers.idle_pct(r, "encode") == pytest.approx(50.0)
    r2 = _record(timeline=_timeline(cards=(0, 1)))
    assert readers.idle_pct(r2, "encode") == pytest.approx(75.0)
    assert readers.idle_pct(r, "decode") is None
    assert readers.idle_pct(_record(), "encode") is None


def test_copy_ms_is_the_host_copies_a_call():
    r = _record(timeline=_timeline())
    assert readers.copy_ms(r, "encode") == pytest.approx(2.0 / 4)


def test_the_roofline_share_names_its_bound():
    r = _record(timeline=_timeline())
    got = readers.roofline(r, "encode", "encode_pass")
    # three calls returned; each 411 041 792 operations at 67 TFLOP/s
    # (6.135 us) against 13 749 297 bytes at 3.35 TB/s (4.104 us); device
    # time of the pass: kernels 1 + 2, memset 0.5, on-card copy 0.5 = 4 ms
    least = 3 * 411_041_792 / 6.7e13
    assert got["bound"] == "operations"
    assert got["value"] == pytest.approx(100 * least / 4e-3)
    assert readers.roofline(r, "decode", "decode_pass") is None


def test_a_roofline_with_no_device_time_reads_nothing():
    tl = _timeline()
    tl["device_ops"] = [op for op in tl["device_ops"]
                        if op[4] == "host_copy"]
    assert readers.roofline(_record(timeline=tl), "encode",
                            "encode_pass") is None


def test_a_pass_bound_by_bytes_says_so():
    b = Bench()
    w = b.work("decode_pass").work({**CFG, "images_per_call": 1,
                                    "height": 8, "width": 8}, 10**9)
    peaks = b.peaks("NVIDIA H100 80GB HBM3")
    assert w["bytes"] / peaks["hbm_bytes_s"] > w["flops"] / peaks[w["rate"]]


def _last_run(walls, colls):
    return {"last_run": [{"device": f"cuda:{i}", "s": s, "cpu_s": s / 2,
                          "collective_s": c}
                         for i, (s, c) in enumerate(zip(walls, colls))]}


def test_mesh_readers_sum_over_the_window():
    counters = [_last_run([0.020, 0.010, 0.010, 0.010],
                          [0.001, 0.002, 0.002, 0.002]),
                _last_run([0.030, 0.010, 0.010, 0.010],
                          [0.002, 0.003, 0.003, 0.003])]
    r = _record(counters=counters)
    share = Bench().layer_metric("mesh_collective_share").read(r)
    skew = Bench().layer_metric("mesh_shard_skew").read(r)
    assert share == pytest.approx(100 * 0.018 / 0.110)
    assert skew == pytest.approx(100 * 0.050 / (0.110 / 4))
    assert Bench().layer_metric("mesh_shard_skew").read(_record()) is None


def test_the_breakdown_labels_idle_time_by_span_and_host_operation():
    bd = tracing.breakdown(_timeline())
    assert bd["device_ops"][0] == ["Memcpy HtoD (Pageable -> Device)", 0.002]
    idle = dict(bd["idle_gaps"])
    # 0-1 ms (middle 0.5: aten::copy_ and, inside it, cudaMemcpyAsync),
    # 2.5-4 (aten::copy_ has ended at 3: python), 7-9 (aten::cat),
    # 9.5-10 (python)
    assert idle == pytest.approx({
        "api.compress_batch > cudaMemcpyAsync": 0.001,
        "api.compress_batch > python": 0.002,
        "api.compress_batch > aten::cat": 0.002})


class _Event:
    """A kineto event, told apart by its device and name."""

    def __init__(self, name, device, start, dur, annotation=False, card=0):
        self._n, self._d, self._s, self._t = name, device, start, dur
        self._a, self._c = annotation, card

    def name(self):
        return self._n

    def device_type(self):
        return f"DeviceType.{self._d}"

    def device_index(self):
        return self._c

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._t

    def is_user_annotation(self):
        return self._a

    def start_thread_id(self):
        return 7


@pytest.mark.parametrize("flag_device_span", [False, True])
def test_events_make_one_timeline(flag_device_span):
    """A profiler may or may not flag the device-side copy of a span as a
    user annotation; either way it is left out."""
    rows = [("api.compress", "CPU", 0, 100, True),
            ("api.compress", "CUDA", 5, 90, True),
            ("aten::copy_", "CPU", 10, 20, False),
            ("cudaMemcpyAsync", "CPU", 12, 5, False),
            ("encode2_kernel", "CUDA", 40, 10, False),
            ("Memset (Device)", "CUDA", 55, 1, False),
            ("Memcpy DtoH (Device -> Pageable)", "CUDA", 60, 5, False),
            ("Memcpy DtoD (Device -> Device)", "CUDA", 70, 2, False)]
    events = [_Event(n, d, s, t, ann and (flag_device_span or d == "CPU"))
              for n, d, s, t, ann in rows]
    tl = tracing.timeline(events, {"api.compress"}, [0])
    assert tl["window"] == (0, 100)
    assert tl["spans"] == [(0, 100, "api.compress")]
    assert [op[4] for op in tl["device_ops"]] == [
        "kernel", "memset", "host_copy", "card_copy"]
    assert [op[2] for op in tl["host_ops"]] == ["aten::copy_",
                                                "cudaMemcpyAsync"]
    assert tracing.timeline(events, {"other"}, [0]) is None
