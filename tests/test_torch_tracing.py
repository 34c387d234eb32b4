"""The port's spans (``profiling.span``) on the CPU: nothing recorded with
no profiler on; under ``torch.profiler`` the call and stage spans of encode,
decode and a local mesh, their counts, their ids, their clock against the
profiler's events, the bounded buffer, and the benchmark's reduction of the
profiler's timeline naming them."""

import json
import os
from collections import deque

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from tinyimgcodec_tpu_torch import api, golden, huffman, profiling
from tinyimgcodec_tpu_torch import container as tcontainer
from tinyimgcodec_tpu_torch.engine import Engine, compact_coefficients
from tinyimgcodec_tpu_torch.golden import CodecArrays
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
              else {"prepare", "host_entropy", "compact", "upload"})
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


def _dense_streams(n, h, w):
    """Streams of hand-made coefficients, |AC| up to 1023 in most places
    (the standard tables code them): more than an eighth of each stream's
    AC outside int8, so the batch goes up as int16."""
    rng = np.random.default_rng(11)
    nb = -(-h // 8) * -(-w // 8)
    return [tcontainer.compress_arrays(CodecArrays(
        h, w, 50, rng.integers(-40, 41, nb).astype(np.int32),
        rng.integers(-1023, 1024, (nb, 63)).astype(np.int32)))
        for _ in range(n)]


@pytest.mark.parametrize("n, h, w, quality", [
    (3, 16, 24, 10), (3, 13, 29, 50), (1, 37, 21, 90), (2, 16, 16, None)],
    ids=["16x24-q10", "13x29-q50", "37x21-q90-one", "16x16-int16"])
def test_the_host_entropy_stages_count_what_compact_coefficients_gives(
        n, h, w, quality):
    """``quality`` None: the streams of ``_dense_streams``."""
    if quality is None:
        streams = _dense_streams(n, h, w)
    else:
        images = _images(n, h, w)
        # a block of a hard edge: AC values past int8 at q90
        images[:, :8, 8:12], images[:, :8, 12:16] = 0, 255
        streams = api.compress_batch(images, quality, block_index=False,
                                     device="cpu")
    _, recs, _ = _traced(lambda: api.decompress_batch(streams,
                                                      device="cpu"))
    call = _one(recs, "codec.decompress_batch")
    assert call.counts["host_entropy"] == n
    order = sorted((r for r in recs if r is not call),
                   key=lambda r: r.start_ns)
    assert [r.name for r in order] == [f"codec.decode.{s}" for s in (
        "prepare", "host_entropy", "compact", "upload", "transform",
        "pull")]
    for a, b in zip(order, order[1:]):
        assert a.end_ns <= b.start_ns
    arrays = [tcontainer.decompress_to_arrays(s) for s in streams]
    _, ac_n, idx, _ = compact_coefficients(
        np.stack([a.dc for a in arrays]), np.stack([a.ac for a in arrays]))
    wide = int(ac_n.dtype == np.int16)
    # ``narrow``: the streams whose int8 rows the C decoder wrote and
    # that were not decoded again as int16
    assert _one(recs, "codec.decode.host_entropy").counts == {
        "streams": n, "threads": min(n, os.cpu_count() or 1),
        "narrow": 0 if wide else n}
    assert _one(recs, "codec.decode.compact").counts == {
        "outliers": idx.size, "wide": wide}
    if quality == 90:
        assert idx.size > 0
    assert wide == (quality is None)


def test_decode_arrays_records_the_int16_form_as_wide():
    """More than ``ac.size // 8`` AC values outside int8: the AC goes up as
    int16 with no outliers, and ``compact`` says so."""
    rng = np.random.default_rng(7)
    dc = rng.integers(-40, 41, 12).astype(np.int32)
    ac = rng.integers(-1023, 1024, (12, 63)).astype(np.int32)
    assert int((ac != ac.astype(np.int8)).sum()) > ac.size // 8
    arrays = CodecArrays(24, 32, 50, dc, ac)
    eng = Engine("exact", "cpu")
    want = eng.decode_arrays(arrays)
    got, recs, _ = _traced(lambda: eng.decode_arrays(arrays))
    assert np.array_equal(got, want)
    assert [r.name for r in sorted(recs, key=lambda r: r.start_ns)] == [
        f"codec.decode.{s}" for s in ("compact", "upload", "transform",
                                      "pull")]
    assert _one(recs, "codec.decode.compact").counts == {"outliers": 0,
                                                         "wide": 1}


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


# the kernel route: the symbol counts come from the card, so no pull of
# the coefficients before ``.table``; ``.pull`` is the blocks' offsets
AUTO_STAGES = ["upload", "transform", "table", "entropy", "place", "pull",
               "assemble"]


def _stage_order(recs, call):
    """The stage names of ``call`` by start, a run of one name once (the
    padding and each block range's copy are both ``upload``)."""
    names = [r.name for r in sorted((r for r in recs if r is not call),
                                    key=lambda r: r.start_ns)]
    return [n for i, n in enumerate(names) if i == 0 or n != names[i - 1]]


def test_an_auto_table_encode_records_its_stages_and_table_counts():
    img = synthetic_image(40, 56, seed=29)
    out, recs, _ = _traced(lambda: api.compress(
        img, 50, auto_generate_huffman_table=True, device="cpu"))
    assert out == tcontainer.compress(img, 50, True, block_index=True)
    call = _one(recs, "codec.compress")
    assert _stage_order(recs, call) == [f"codec.encode.{s}"
                                        for s in AUTO_STAGES]
    assert all((r.call_id, r.shard) == (call.call_id, 0) for r in recs)
    # the block range's stages sit side by side, as in a batch encode
    assert all(r.parent_id == call.span_id for r in recs if r is not call)
    spec = huffman.build_huffman_spec(golden.encode_arrays(img, 50))
    assert _one(recs, "codec.encode.table").counts == {
        "blocks": 5 * 7,
        "dc_symbols": int(np.count_nonzero(spec.dc_len)),
        "ac_symbols": int(np.count_nonzero(spec.ac_len)),
        "longest": int(max(spec.dc_len.max(), spec.ac_len.max())),
        "host_route": 0, "coeffs_pulled": 0}
    assert not any(r.name == "codec.encode.fallback" for r in recs)


def test_an_auto_table_encode_on_the_host_route_records_the_fallback():
    from test_torch_auto_table import CONTRAST

    out, recs, _ = _traced(lambda: api.compress(
        CONTRAST, 97, auto_generate_huffman_table=True, device="cpu"))
    assert out == tcontainer.compress(CONTRAST, 97, True, block_index=True)
    call = _one(recs, "codec.compress")
    # the extended table needs the coefficients on the host: their pull
    # opens inside ``.table``
    assert _stage_order(recs, call) == [
        f"codec.encode.{s}" for s in ("upload", "transform", "table",
                                      "pull", "fallback")]
    table = _one(recs, "codec.encode.table")
    assert _one(recs, "codec.encode.pull").parent_id == table.span_id
    assert table.counts["host_route"] == 1 and table.counts["blocks"] == 64
    assert table.counts["coeffs_pulled"] == 1
    assert _one(recs, "codec.encode.fallback").counts == {"images": 1}


@pytest.mark.parametrize("quality", [10, 90])
def test_auto_table_bytes_are_the_same_with_the_spans_on_and_off(quality):
    img = synthetic_image(37, 45, seed=quality)
    off = api.compress(img, quality, auto_generate_huffman_table=True,
                       device="cpu")
    on, recs, _ = _traced(lambda: api.compress(
        img, quality, auto_generate_huffman_table=True, device="cpu"))
    assert on == off
    assert {r.name for r in recs} >= {"codec.encode.table",
                                      "codec.encode.assemble"}
