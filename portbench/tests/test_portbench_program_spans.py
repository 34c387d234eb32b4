"""The readers of the program's own spans (``program_spans.py`` and the
``idle_in_*``, ``idle_unstaged.*`` and ``kernel_leg_share.decode`` readers)
on timelines and span records made by hand, whose values are known, and in
a traced run of small cells on the CPU."""

from __future__ import annotations

import json
import time

import pytest

from portbench import harness, program_spans, readers
from portbench.loader import Bench
from tinyimgcodec_tpu_torch import profiling

from .conftest import ROOT

MS = 1_000_000  # ns
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NEW = [m for m in SPEC["per_layer"]
       if m["source"] in ("program_span", "program_counter")]


def _span(name, start, end, shard=0, call=1, counts=None):
    """A record of shard ``shard``'s thread, nested in call ``call``."""
    return profiling.SpanRecord(
        name, int(start * MS), int(end * MS), 100 + shard, f"cuda:{shard}",
        shard, call, 0, call, counts or {})


def _timeline(ops, cards=(0,), window=(0, 10)):
    return {"window": (window[0] * MS, window[1] * MS),
            "device_ops": [(c, int(s * MS), int(e * MS), "k", "kernel")
                           for c, s, e in ops],
            "spans": [(window[0] * MS, window[1] * MS, "api.compress_batch")],
            "host_ops": [], "cards": list(cards)}


def _record(timeline, kind="encode"):
    return {"kind": kind, "timeline": timeline, "calls": [], "bench": Bench()}


@pytest.fixture
def spans(monkeypatch):
    """Hand the readers these records (and this dropped count)."""
    def give(records, dropped=0):
        monkeypatch.setattr(profiling, "spans",
                            lambda: (list(records), dropped))
    return give


# one card: busy 1-2 and 4-7 ms of a 10 ms window, so idle 0-1, 2-4, 7-10
ONE_CARD = [(0, 1, 2), (0, 4, 7)]
ENCODE = [_span("codec.encode.upload", 0.5, 1.5),
          _span("codec.encode.recompute", 2, 3.5, counts={"flagged": 7}),
          _span("codec.encode.assemble", 7.5, 9),
          _span("codec.compress_batch", 0.2, 9.5)]


def _read(name, record):
    return Bench().layer_metric(name).read(record)


def test_each_idle_instant_goes_to_the_stage_open_then(spans):
    spans(ENCODE)
    r = _record(_timeline(ONE_CARD))
    assert _read("idle_in_upload.encode", r)["value"] == pytest.approx(5.0)
    got = _read("idle_in_recompute.encode", r)
    assert got == pytest.approx({"value": 15.0, "flagged_blocks": 7.0})
    assert _read("idle_in_assemble.encode", r)["value"] == pytest.approx(15)
    # 6 ms idle, 3.5 of them in stages: the call span alone is unstaged
    assert _read("idle_unstaged.encode", r)["value"] == pytest.approx(25.0)
    # a stage that never meets an idle instant reads 0, one not run nothing
    spans(ENCODE + [_span("codec.encode.entropy", 5, 6)])
    assert _read("idle_in_entropy.encode", r)["value"] == 0.0
    assert _read("idle_in_pull.encode", r) is None
    assert _read("idle_in_recompute.decode", r) is None


def test_a_nested_stage_takes_the_time_from_the_one_around_it(spans):
    spans([_span("codec.decode.prepare", 0, 4),
           _span("codec.decode.recompute", 2.5, 3, counts={"flagged": 1})])
    r = _record(_timeline(ONE_CARD), "decode")
    shares = program_spans.idle_by_stage(r, "decode")
    # idle 0-1 and 2-4 in prepare, but 2.5-3 in recompute; 7-10 unstaged
    assert shares == pytest.approx({"prepare": 25.0, "recompute": 5.0,
                                    "": 30.0})


def test_two_cards_each_charged_to_its_own_shards_thread(spans):
    # card 1 busy 0-8: idle 8-10; its shard is in recompute 7-9 on its own
    # thread, while shard 0 is in assemble then
    spans(ENCODE + [
        _span("codec.encode.recompute", 7, 9, shard=1, counts={"flagged": 5}),
        _span("codec.encode.recompute", 12, 13, shard=1, call=2,
              counts={"flagged": 99})])
    r = _record(_timeline(ONE_CARD + [(1, 0, 8)], cards=(0, 1)))
    got = _read("idle_in_recompute.encode", r)
    # card 0: 1.5 ms, card 1: 1 ms, of 10 ms each; the span at 12 ms lies
    # outside the window, and each call's shards are summed
    assert got == pytest.approx({"value": 100 * 2.5 / 20,
                                 "flagged_blocks": 12.0})
    assert _read("idle_in_assemble.encode", r)["value"] == pytest.approx(
        100 * 1.5 / 20)
    assert _read("idle_unstaged.encode", r)["value"] == pytest.approx(
        100 * (2.5 + 1) / 20)


@pytest.mark.parametrize("kind, records", [
    ("encode", ENCODE),
    ("decode", [_span("codec.decode.prepare", 0, 1.5),
                _span("codec.decode.upload", 1.5, 2.2),
                _span("codec.decode.entropy", 2.2, 2.6),
                _span("codec.decode.transform", 2.6, 3.3),
                _span("codec.decode.recompute", 3.3, 3.9,
                      counts={"flagged": 2}),
                _span("codec.decode.pull", 3.9, 8.1),
                _span("codec.decompress_batch", 0, 8.5)])])
def test_the_stages_and_the_unstaged_share_add_up_to_the_idle_share(
        spans, kind, records):
    spans(records + [_span("codec.encode.pull", 1, 3, shard=1)])
    r = _record(_timeline(ONE_CARD + [(1, 2, 3)], cards=(0, 1)), kind)
    parts = [m["name"] for m in NEW
             if m["name"].endswith(f".{kind}") and "idle" in m["name"]]
    total = sum((_read(n, r) or {"value": 0.0})["value"] for n in parts)
    assert total == pytest.approx(readers.idle_pct(r, kind), abs=1e-9)
    assert sum(program_spans.idle_by_stage(r, kind).values()) == \
        pytest.approx(readers.idle_pct(r, kind), abs=1e-9)


def test_the_kernel_leg_share_counts_images(spans):
    spans([_span("codec.decompress_batch", 0, 1, call=1,
                 counts={"kernel": 49, "host_entropy": 0, "host_decoder": 0}),
           _span("codec.decompress_batch", 2, 3, call=2,
                 counts={"kernel": 47, "host_entropy": 0, "host_decoder": 2}),
           _span("codec.decompress_batch", 20, 21, call=3,
                 counts={"kernel": 0, "host_entropy": 49,
                         "host_decoder": 0})])
    r = _record(_timeline(ONE_CARD), "decode")
    assert _read("kernel_leg_share.decode", r) == pytest.approx(
        100 * 96 / 98)
    assert _read("kernel_leg_share.decode", _record(_timeline(ONE_CARD))) \
        is None


def test_nothing_is_read_without_a_trace_spans_or_whole_records(
        spans, monkeypatch):
    spans(ENCODE)
    names = [m["name"] for m in NEW if m["name"].endswith(".encode")]
    assert all(_read(n, _record(None)) is None for n in names)
    # the records of another run, before this window
    assert all(_read(n, _record(_timeline(ONE_CARD, window=(20, 30))))
               is None for n in names)
    # dropped records that may lie inside the window
    spans(ENCODE, dropped=1)
    assert all(_read(n, _record(_timeline(ONE_CARD))) is None
               for n in names)
    spans([], dropped=3)
    assert all(_read(n, _record(_timeline(ONE_CARD))) is None
               for n in names)
    # dropped records that ended before the window's start
    spans([_span("codec.encode.upload", -3, -2)] + ENCODE, dropped=5)
    assert _read("idle_unstaged.encode", _record(_timeline(ONE_CARD)))[
        "value"] == pytest.approx(25.0)
    # a program that records no spans
    monkeypatch.delattr(profiling, "spans")
    assert all(_read(n, _record(_timeline(ONE_CARD))) is None
               for n in names)


@pytest.mark.parametrize("cell", ["small.encode", "small.decode",
                                  "smallx4.encode"])
def test_a_traced_run_reports_the_new_metrics(small_bench, cell):
    r = harness.run(small_bench, cell, 2**31 + 29, 0.3, True,
                    time.perf_counter(), device="cpu",
                    log=lambda *a, **k: None)
    assert r["correct"]
    kind = cell.split(".")[1]
    want = ({m["name"] for m in small_bench.metrics_of(cell, True)}
            & {m["name"] for m in NEW})
    assert want and want <= set(r["metrics"])
    parts = sum(v["value"] for k, v in r["metrics"].items()
                if k.startswith(("idle_in_", "idle_unstaged")))
    assert parts == pytest.approx(
        r["metrics"][f"device_idle.{kind}"]["value"], abs=1e-9)
    assert r["metrics"][f"idle_in_recompute.{kind}"]["flagged_blocks"] >= 0
    if kind == "decode":
        assert r["metrics"]["kernel_leg_share.decode"]["value"] == 100.0
