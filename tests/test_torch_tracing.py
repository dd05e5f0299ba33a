"""The port's recorder (foldcomp_tpu_torch/tracing.py) on the CPU: the off
path, the spans' nesting, threads, batch numbers and thread CPU, the
profiler switching recording on, the clock against the profiler's, the
stream's and compress's spans and counters, the classed dispatch, the
exporter, and outputs byte-identical with recording on and off."""
import json
import threading
import time
import tracemalloc

import numpy as np
import pytest
import torch

from test_property_roundtrip import synthesize

from foldcomp_tpu_torch import cli, tracing
from foldcomp_tpu_torch.codec import batch as B
from foldcomp_tpu_torch.codec import batch_host as H
from foldcomp_tpu_torch.codec.decoder import decode
from foldcomp_tpu_torch.codec.encoder import encode
from foldcomp_tpu_torch.codec.fcz import serialize
from foldcomp_tpu_torch.io import pdb as port_pdb
from foldcomp_tpu_torch.io.db import DatabaseWriter

LENGTHS = (26, 60, 151, 240, 60, 90, 120)
STREAM_STAGES = ("stream.pack", "stream.wait_pack", "stream.launch",
                 "stream.h2d", "decode.dispatch", "stream.device_wait",
                 "stream.d2h", "stream.wait_d2h")


@pytest.fixture(scope="module")
def fczs():
    return [encode(synthesize(n, seed=i)) for i, n in enumerate(LENGTHS)]


@pytest.fixture(autouse=True)
def fresh(monkeypatch):
    """Recording off, no session open and none recorded."""
    tracing.disable()
    tracing._close()
    monkeypatch.setattr(tracing, "_last", None)
    monkeypatch.setenv("FOLDCOMP_TPU_WIRE", "full")
    monkeypatch.delenv("FOLDCOMP_TPU_TORCH_TRACE", raising=False)
    yield
    tracing.disable()
    tracing._close()


def _stream(fczs, batch_size=3):
    return [text for _, text in B.decode_fcz_stream(
        iter(fczs), batch_size=batch_size, device="cpu")]


def _recorded(fn, *a):
    tracing.enable()
    try:
        return fn(*a)
    finally:
        tracing.disable()


def test_off_records_and_allocates_nothing(fczs, monkeypatch):
    """With recording off a stream decode leaves no session, span() is
    one shared false object, no clock of the recorder is read, and
    nothing allocated by tracing.py is held or made in passing."""
    def no_clock():
        raise AssertionError("a clock was read with recording off")
    monkeypatch.setattr(tracing, "_pc", no_clock)
    monkeypatch.setattr(tracing, "_tt", no_clock)
    tracemalloc.start()
    try:
        _stream(fczs)
        held = tracemalloc.take_snapshot().filter_traces(
            [tracemalloc.Filter(True, tracing.__file__)])
        names = ("decode.dispatch",) * 2000
        tracemalloc.reset_peak()
        before = tracemalloc.get_traced_memory()[0]
        for n in names:
            with tracing.span(n, 7, True) as sp:
                tracing.count("d2h_bytes", 5)
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert tracing.last() is None
    assert not held.traces
    assert peak - before < 512
    assert tracing.span("x") is tracing.span("y", 3, True) is sp
    assert not sp


def test_enabled_spans_nest_across_threads():
    """Parent ids and inherited batch numbers on one thread, a batch
    number passed to another thread, thread CPU only where asked."""
    def worker(bi):
        with tracing.span("w.outer", bi, True):
            with tracing.span("w.inner"):
                sum(range(20000))

    tracing.enable()
    with tracing.span("outer", 5) as a:
        a.set(lanes=12)
        with tracing.span("inner"):
            th = threading.Thread(target=worker, args=(9,))
            th.start()
            th.join()
        tracing.count("d2h_bytes", 100)
    tracing.count("d2h_bytes", 20)
    tracing.disable()
    s = tracing.last()
    by = {x.name: x for x in s.spans}
    assert set(by) == {"outer", "inner", "w.outer", "w.inner"}
    assert by["outer"].parent == 0 and by["inner"].parent == by["outer"].id
    assert by["inner"].batch == 5 and by["outer"].attrs == {"lanes": 12}
    assert by["w.outer"].parent == 0 and by["w.outer"].batch == 9
    assert by["w.inner"].parent == by["w.outer"].id
    assert by["w.inner"].batch == 9
    assert by["outer"].thread == by["inner"].thread != by["w.outer"].thread
    assert by["w.outer"].thread == by["w.inner"].thread
    assert set(s.threads) == {by["outer"].thread, by["w.outer"].thread}
    assert by["w.outer"].cpu_ns > 0
    assert by["outer"].cpu_ns is by["inner"].cpu_ns is None
    assert by["w.inner"].cpu_ns is None
    assert by["outer"].start_ns <= by["inner"].start_ns \
        <= by["w.outer"].start_ns <= by["w.outer"].end_ns \
        <= by["inner"].end_ns <= by["outer"].end_ns
    assert s.counters == {"d2h_bytes": 120}
    assert len({x.id for x in s.spans}) == 4


def test_profiler_session_turns_recording_on():
    """A CPU profiler session records; the next span reached outside it
    ends that session, and the next profiler session starts a new one."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("a"):
            pass
    first = tracing.last()
    assert [x.name for x in first.spans] == ["a"] and first.open
    assert not tracing.span("b")
    assert not tracing.last().open
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("c"):
            pass
    second = tracing.last()
    assert [x.name for x in second.spans] == ["c"]
    assert second.t0_ns > first.t0_ns


def test_spans_are_on_the_profilers_clock():
    """A span around a torch op holds the op's interval as the profiler
    reports it, mapped onto time.time_ns() by trace_start_ns (as
    portbench/trace.py maps device events)."""
    from torch.profiler import ProfilerActivity, profile
    a = torch.randn(256, 256)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("mm"):
            torch.mm(a, a)
    res = prof.profiler.kineto_results
    base = res.trace_start_ns() if hasattr(res, "trace_start_ns") \
        else res.trace_start_us() * 1000
    ev = [e for e in prof.events() if e.name == "aten::mm"]
    assert len(ev) == 1
    op0 = base + int(ev[0].time_range.start * 1000)
    op1 = base + int(ev[0].time_range.end * 1000)
    sp = tracing.last().named("mm")[0]
    assert sp.start_ns <= op0 <= op1 <= sp.end_ns, (
        sp.start_ns - op0, sp.end_ns - op1)


def test_stream_stages_once_a_batch(fczs, monkeypatch):
    """decode_fcz_stream: each stage span once a batch with its number,
    stream.format once an entry, d2h_bytes the bytes the copies brought,
    format_residues the residues; the PDB text as with recording off."""
    copied = []
    real = B._outs_to_host

    def spy(outs):
        res = real(outs)
        copied.append(sum(a.nbytes for a in res if not isinstance(a, str)))
        return res
    monkeypatch.setattr(B, "_outs_to_host", spy)
    off = _stream(fczs)
    copied.clear()
    on = _recorded(_stream, fczs)
    assert on == off
    s = tracing.last()
    n_batches = -(-len(fczs) // 3)
    for name in STREAM_STAGES:
        got = sorted(x.batch for x in s.named(name) if x.batch is not None)
        assert got == list(range(n_batches)), name
    fmt = s.named("stream.format")
    assert len(fmt) == len(fczs) and all(x.cpu_ns > 0 for x in fmt)
    assert sorted(x.batch for x in fmt) == [0, 0, 0, 1, 1, 1, 2]
    assert all(x.cpu_ns is not None for x in s.named("stream.pack"))
    packs = [x.attrs for x in s.named("stream.pack")]
    assert sum(p["residues"] for p in packs) == sum(LENGTHS)
    assert sum(p["lanes"] for p in packs) == \
        sum(f.n_anchor - 1 for f in fczs)
    assert s.counters["d2h_bytes"] == sum(copied) > 0
    assert s.counters["format_residues"] == sum(LENGTHS)
    assert s.counters["h2d_bytes"] > 0
    launch = {x.batch: x for x in s.named("stream.launch")}
    for x in s.named("decode.dispatch", "stream.h2d"):
        assert x.parent == launch[x.batch].id
    xfer = {x.thread for x in s.named("stream.d2h", "stream.device_wait")}
    main = {x.thread for x in s.named("stream.wait_pack", "stream.wait_d2h",
                                      "stream.launch")}
    assert len(xfer) == len(main) == 1 and xfer != main


def _pdb_dir(d, fczs):
    d.mkdir()
    for i, f in enumerate(fczs):
        (d / f"p{i}.pdb").write_text(port_pdb.format_pdb(decode(f),
                                                         f"p{i}"))
    return d


def test_compress_fast_spans_once_a_batch(fczs, tmp_path, monkeypatch):
    """cli compress --fast --db: a compress.parse span an entry (thread
    CPU), parse_residues the residues, submit, wait, write and the
    finisher's spans once a batch; the database as with recording off."""
    monkeypatch.setenv("FOLDCOMP_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("FOLDCOMP_TPU_BATCH", "3")
    src = _pdb_dir(tmp_path / "pdbs", fczs)
    args = ["compress", "--fast", str(src), None, "--db"]
    args[3] = str(tmp_path / "off")
    assert cli.main(args) == 0
    args[3] = str(tmp_path / "on")
    assert _recorded(cli.main, args) == 0
    for ext in ("", ".index", ".lookup"):
        assert (tmp_path / f"on{ext}").read_bytes() == \
            (tmp_path / f"off{ext}").read_bytes()
    s = tracing.last()
    parse = s.named("compress.parse")
    assert len(parse) == len(fczs) and all(x.cpu_ns > 0 for x in parse)
    assert s.counters["parse_residues"] == sum(LENGTHS)
    n_batches = -(-len(fczs) // 3)
    assert sorted(x.batch for x in parse) == [0, 0, 0, 1, 1, 1, 2]
    for name in ("compress.submit", "compress.wait_finish", "compress.write",
                 "encode.device_wait", "encode.d2h", "encode.finish"):
        assert sorted(x.batch for x in s.named(name)) == \
            list(range(n_batches)), name
    assert all(x.cpu_ns > 0 for x in s.named("encode.finish"))
    assert s.counters["d2h_bytes"] > 0 and s.counters["h2d_bytes"] > 0
    fin = {x.thread for x in s.named("encode.d2h", "encode.finish")}
    cli_t = {x.thread for x in s.named("compress.parse", "compress.submit")}
    assert len(fin) == len(cli_t) == 1 and fin != cli_t


def test_classed_dispatch_one_k1_and_k2_k3_a_class(fczs, monkeypatch):
    """A width-classed batch (wclass "1", the split forced for this small
    corpus): one decode.dispatch with one decode.prep, one decode.k1, one
    decode.k2 (k2 over every class, attribute classes) and a decode.k3 a
    class inside it; the rows as with recording off."""
    real = H.split_lanes_classes
    monkeypatch.setattr(B, "split_lanes_classes",
                        lambda a, m, min_save: real(a, m, min_save=-100.0))
    arrays, _ = B.pack_decode_wire(fczs[:5], False, wclass="1")
    n_cls = len(arrays["classes"]["recs"])
    assert n_cls >= 2
    ta = B.arrays_to_torch(arrays, "cpu")
    off = B._seg_decode_arrays(ta)
    on = _recorded(B._seg_decode_arrays, ta)
    assert all(torch.equal(a, b) for a, b in zip(off, on))
    s = tracing.last()
    (d,) = s.named("decode.dispatch")
    assert d.attrs["classes"] == n_cls
    assert d.attrs["lanes"] == arrays["prev_idx"].shape[0]
    kids = [x for x in s.spans if x.parent == d.id]
    assert sorted(x.name for x in kids if x.name != "python.gc") == \
        ["decode.k1", "decode.k2"] + ["decode.k3"] * n_cls \
        + ["decode.prep"]
    (k2,) = s.named("decode.k2")
    assert k2.attrs["classes"] == n_cls


def test_exporter_writes_the_stream(fczs, tmp_path, monkeypatch):
    """decompress --fast with FOLDCOMP_TPU_TORCH_TRACE set writes valid
    trace-event JSON holding the stream's spans, in the timestamps of
    torch.profiler's export_chrome_trace (its baseTimeNanoseconds)."""
    from torch.profiler import ProfilerActivity, profile
    w = DatabaseWriter(str(tmp_path / "db"))
    for i, f in enumerate(fczs):
        w.append(serialize(f), i, f"e{i}")
    w.close()
    out = tmp_path / "trace.json"
    monkeypatch.setenv("FOLDCOMP_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("FOLDCOMP_TPU_BATCH", "3")
    monkeypatch.setenv("FOLDCOMP_TPU_TORCH_TRACE", str(out))
    assert cli.main(["decompress", "--fast", str(tmp_path / "db"),
                     str(tmp_path / "pdb"), "--db"]) == 0
    assert not tracing.recording()
    doc = json.loads(out.read_text())
    ev = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    names = {e["name"] for e in ev}
    assert set(STREAM_STAGES) | {"stream.format"} <= names
    assert doc["otherData"]["counters"]["format_residues"] == sum(LENGTHS)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(2).add_(1)
    prof.export_chrome_trace(str(tmp_path / "torch.json"))
    ref = json.loads((tmp_path / "torch.json").read_text())
    if "baseTimeNanoseconds" in ref:
        assert doc["baseTimeNanoseconds"] == ref["baseTimeNanoseconds"]
    s = tracing.last()
    first = min(s.spans, key=lambda x: x.start_ns)
    got = min(ev, key=lambda e: e["ts"])
    assert abs(doc["baseTimeNanoseconds"] + got["ts"] * 1000
               - first.start_ns) < 1000
    assert time.time_ns() - doc["baseTimeNanoseconds"] > 0
    assert np.isfinite([e["dur"] for e in ev]).all()
