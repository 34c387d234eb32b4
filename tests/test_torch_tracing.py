"""The port's spans (``profiling.span``) on the CPU: nothing recorded with
no profiler on; under ``torch.profiler`` the call and stage spans of encode,
decode and a local mesh, their counts, their ids, their clock against the
profiler's events, the bounded buffer, and the benchmark's reduction of the
profiler's timeline naming them."""

import json
from collections import deque

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from tinyimgcodec_tpu_torch import api, profiling
from tinyimgcodec_tpu_torch import container as tcontainer
from tinyimgcodec_tpu_torch.engine import Engine
from tinyimgcodec_tpu_torch.ops import transform
from tinyimgcodec_tpu_torch.ops.exact_inverse import exact_inverse_plain
from tinyimgcodec_tpu_torch.ops.exact_transform import exact_transform
from tinyimgcodec_tpu_torch.parallel import batch, make_mesh
from tinyimgcodec_tpu_torch.tables import CodecTables, DecodeTables

from conftest import synthetic_image

ENCODE_STAGES = ["upload", "transform", "entropy", "place", "pull",
                 "assemble"]


def _images(n=2, h=16, w=24, seed=3) -> np.ndarray:
    out = np.stack([synthetic_image(h, w, seed=seed + i) for i in range(n)])
    # a flat block of an odd level: its DC is a rounding tie at q=50
    out[0, :8, :8] = 101
    return out


def _traced(fn):
    """``fn()`` under a CPU profiler: (its result, the records it left,
    the profiler's events)."""
    before = {r.span_id for r in profiling.spans()[0]}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    recs = [r for r in profiling.spans()[0] if r.span_id not in before]
    return out, recs, list(prof.profiler.kineto_results.events())


def _one(recs, name):
    got = [r for r in recs if r.name == name]
    assert len(got) == 1, (name, [r.name for r in recs])
    return got[0]


def test_with_no_profiler_nothing_is_recorded():
    before = profiling.spans()
    streams = api.compress_batch(_images(), device="cpu")
    api.decompress_batch(streams, device="cpu")
    assert profiling.spans() == before
    assert profiling.span("codec.x") is profiling.span("codec.y")
    assert not profiling.active()


def test_encode_records_its_stages_in_order_inside_one_call():
    images = _images()
    out, recs, _ = _traced(lambda: api.compress_batch(images, device="cpu"))
    assert out == api.compress_batch(images, device="cpu")
    call = _one(recs, "codec.compress_batch")
    assert call.parent_id is None and call.call_id == call.span_id
    stages = sorted((r for r in recs if r is not call),
                    key=lambda r: r.start_ns)
    assert [r.name for r in stages] == [f"codec.encode.{s}"
                                        for s in ENCODE_STAGES]
    for r in stages:
        assert (r.call_id, r.parent_id) == (call.call_id, call.span_id)
        assert call.start_ns <= r.start_ns <= r.end_ns <= call.end_ns
        assert (r.shard, r.device) == (0, None)
    for a, b in zip(stages, stages[1:]):
        assert a.end_ns <= b.start_ns
    assert _one(recs, "codec.encode.place").counts == {"retried": 0}


def test_flagged_counts_the_blocks_exact_transform_flags():
    images = _images()
    tables = CodecTables.build(50, "cpu")
    blocks = transform.blockify(torch.from_numpy(images)).reshape(-1, 64)
    want = int(exact_transform(blocks, tables)[1].sum())
    assert want >= 1
    _, recs, _ = _traced(lambda: api.compress_batch(images, device="cpu"))
    assert _one(recs, "codec.encode.transform").counts == {"flagged": want}
    assert not any(r.name == "codec.encode.recompute" for r in recs)


def test_an_exact_encode_opens_no_nonzero_and_no_recompute():
    """The flagged blocks are settled inside ``exact_transform``, their
    count rides the status pull: no ``aten::nonzero`` (a host sync on a
    card), no host recompute stage."""
    images = _images()
    _, recs, events = _traced(lambda: api.compress_batch(images,
                                                         device="cpu"))
    names = {e.name() for e in events}
    assert "aten::nonzero" not in names
    assert "codec.encode.transform" in names
    assert "codec.encode.recompute" not in names
    assert _one(recs, "codec.encode.transform").counts["flagged"] >= 1


@pytest.mark.parametrize("block_index", [True, False],
                         ids=["kernel_leg", "host_entropy_leg"])
def test_decode_spans_count_each_leg_as_decode_stats(block_index):
    streams = api.compress_batch(_images(), block_index=block_index,
                                 device="cpu")
    eng = Engine("exact", "cpu")
    want = eng.decompress_batch(streams)
    got, recs, _ = _traced(lambda: api.decompress_batch(streams,
                                                        device="cpu"))
    assert np.array_equal(got, want)
    call = _one(recs, "codec.decompress_batch")
    assert call.counts == eng.decode_stats
    assert eng.decode_stats["kernel" if block_index else "host_entropy"] == 2
    stages = ({"prepare", "upload", "entropy"} if block_index
              else {"prepare", "host_entropy"})
    stages |= {"transform", "pull"}
    assert {r.name for r in recs if r is not call} == {
        f"codec.decode.{s}" for s in stages}
    assert all(r.call_id == call.call_id for r in recs)
    # the blocks exact_inverse settled, as its plain version counts them
    zz = torch.from_numpy(np.stack([
        np.concatenate([a.dc[:, None], a.ac], axis=1)
        for a in map(tcontainer.decompress_to_arrays, streams)
    ]).astype(np.int32))
    _, want_flagged = exact_inverse_plain(
        zz, 16, 24, DecodeTables.build(50, False, "cpu"))
    assert _one(recs, "codec.decode.transform").counts == {
        "flagged": int(want_flagged)}
    assert int(want_flagged) >= 1


@pytest.mark.parametrize("custom", [False, True],
                         ids=["standard_table", "custom_table"])
def test_prepare_counts_the_streams_and_the_payloads_it_realigned(custom):
    images = _images(n=3)
    if custom:  # one image three times: one table for the batch
        streams = [tcontainer.compress(images[0], 50, True, block_index=True)
                   ] * 3
    else:
        streams = api.compress_batch(images, block_index=True, device="cpu")
    _, recs, _ = _traced(lambda: api.decompress_batch(streams,
                                                      device="cpu"))
    assert _one(recs, "codec.decompress_batch").counts["kernel"] == 3
    assert _one(recs, "codec.decode.prepare").counts == {
        "streams": 3, "realigned": 3 if custom else 0}


def test_a_local_mesh_records_each_shard_in_the_callers_call():
    images = _images(n=3)
    mesh = make_mesh(devices=["cpu", "cpu"])
    out, recs, _ = _traced(lambda: batch.compress_batch(
        images, mesh=mesh, block_index=True))
    assert out == api.compress_batch(images, device="cpu")
    call = _one(recs, "codec.mesh.compress_batch")
    stages = [r for r in recs if r is not call]
    assert {r.shard for r in stages} == {0, 1}
    assert {r.device for r in stages} == {"cpu"}
    assert len({r.thread for r in stages}) == 2
    for shard in (0, 1):
        mine = [r for r in stages if r.shard == shard]
        assert len({r.thread for r in mine}) == 1
        assert {r.name for r in mine} == {f"codec.encode.{s}"
                                          for s in ENCODE_STAGES}
        assert all((r.call_id, r.parent_id) == (call.call_id, call.span_id)
                   for r in mine)
    assert sum(r.counts["flagged"] for r in stages
               if r.name == "codec.encode.transform") >= 1


def test_a_record_lies_on_the_profilers_clock():
    _, recs, events = _traced(lambda: api.compress_batch(_images(),
                                                         device="cpu"))
    starts = {e.name(): e.start_ns() for e in events
              if e.name().startswith("codec.")}
    assert len(starts) == len(recs) == 1 + len(ENCODE_STAGES)
    for r in recs:
        assert abs(r.start_ns - starts[r.name]) < 1_000_000, r.name


def test_the_buffer_is_bounded_and_counts_what_it_dropped(monkeypatch):
    monkeypatch.setattr(profiling, "_BUFFER", deque(maxlen=3))
    monkeypatch.setattr(profiling, "_dropped", 0)
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(5):
            with profiling.span(f"codec.test.{i}", i=i) as s:
                s.set(twice=2 * i)
    recs, dropped = profiling.spans()
    assert dropped == 2
    assert [(r.name, r.counts) for r in recs] == [
        (f"codec.test.{i}", {"i": i, "twice": 2 * i}) for i in (2, 3, 4)]
    assert len({r.call_id for r in recs}) == 3


def test_spans_reach_the_benchmarks_timeline_and_name_an_idle_gap():
    from portbench import tracing

    images = _images()

    def call():
        with record_function("api.compress_batch"):
            return api.compress_batch(images, device="cpu")

    _, recs, events = _traced(call)
    tl = tracing.timeline(events, {"api.compress_batch"}, [0])
    names = {n for _, _, n in tl["host_ops"]}
    assert {r.name for r in recs} <= names
    # a gap in the assembly stage where no torch operation is open (the
    # host's Python and bytes): the card busy before and after it
    stage = _one(recs, "codec.encode.assemble")
    inner = sorted((s, e) for s, e, n in tl["host_ops"]
                   if stage.start_ns < s < stage.end_ns)
    free, at = [], stage.start_ns
    for s, e in inner + [(stage.end_ns, stage.end_ns)]:
        if s > at:
            free.append((s - at, at, s))
        at = max(at, e)
    _, lo, hi = max(free)
    a, b = tl["window"]
    tl["device_ops"] = [(0, a, lo, "k", "kernel"), (0, hi, b, "k", "kernel")]
    assert tracing.breakdown(tl)["idle_gaps"] == [
        ["api.compress_batch > codec.encode.assemble", (hi - lo) / 1e9]]


def test_the_chrome_trace_shows_the_spans(tmp_path):
    with profiling.trace(str(tmp_path), device="cpu"):
        api.compress_batch(_images(), device="cpu")
    with open(tmp_path / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"codec.compress_batch", "codec.encode.transform"} <= names
