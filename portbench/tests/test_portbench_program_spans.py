"""The readers of the port's own spans (portbench/program_spans.py and
the metrics that use it) on a hand-built session: each number worked out
by hand, and None where there is no session, where it outlasts the
window, and where the port has no recorder."""
from __future__ import annotations

import sys
from types import SimpleNamespace

import pytest

from portbench import manifest

T0 = 1_800_000_000_000_000_000
MS = 1_000_000


def _span(name, sid, parent, t0_ms, t1_ms, cpu_ms=None, thread=1):
    from foldcomp_tpu_torch.tracing import Span
    return Span(name, sid, parent, thread, None, T0 + int(t0_ms * MS),
                T0 + int(t1_ms * MS),
                None if cpu_ms is None else int(cpu_ms * MS), None)


def _session():
    """Two dispatches of 2 ms and 4 ms with 1.5 ms of kernel calls
    between them, one stream batch and one compress batch."""
    from foldcomp_tpu_torch.tracing import Session
    spans = [
        _span("decode.dispatch", 1, 0, 0, 2),
        _span("decode.k1", 2, 1, 0.5, 1.0),
        _span("decode.k2", 3, 1, 1.0, 1.5),
        _span("decode.dispatch", 4, 0, 10, 14),
        _span("decode.k3", 5, 4, 11, 11.5),
        _span("python.gc", 6, 4, 12, 13),
        _span("decode.k2", 7, 99, 20, 30),          # not a dispatch's child
        _span("stream.wait_pack", 8, 0, 30, 130),
        _span("stream.d2h", 9, 0, 130, 134, thread=2),
        _span("stream.wait_d2h", 10, 0, 140, 240),
        _span("stream.format", 11, 0, 240, 260, cpu_ms=18, thread=3),
        _span("stream.format", 12, 0, 240, 250, cpu_ms=2, thread=4),
        _span("compress.parse", 13, 0, 300, 400, cpu_ms=90),
        _span("compress.wait_finish", 14, 0, 400, 500),
    ]
    counters = {"d2h_bytes": 8_000_000, "format_residues": 4000,
                "parse_residues": 10_000}
    return Session(T0, spans, counters, {}, {}, False)


READINGS = {
    "dispatch_us_per_batch": 3000.0,          # (2 + 4) ms / 2
    "glue_us_per_batch": 2250.0,              # (6 - 1.5) ms / 2
    "d2h_gb_s.decompress": 2.0,               # 8 MB / 4 ms
    "stream_wait_share.decompress": 20.0,     # 200 ms of 1 s
    "format_cpu_s_per_mres.decompress": 5.0,  # 20 ms / 4,000 res
    "parse_cpu_s_per_mres.compress": 9.0,     # 90 ms / 10,000 res
    "finish_wait_share.compress": 10.0,       # 100 ms of 1 s
}


@pytest.fixture
def session(monkeypatch):
    from foldcomp_tpu_torch import tracing
    s = _session()
    monkeypatch.setattr(tracing, "last", lambda: s)
    return s


@pytest.mark.parametrize("name", sorted(READINGS))
def test_reader_on_a_hand_built_session(name, session):
    got = manifest.reader(name)(SimpleNamespace(window_s=1.0))
    assert got == pytest.approx(READINGS[name], rel=1e-9)


@pytest.mark.parametrize("case", ["no_session", "outlasts_window",
                                  "no_recorder", "nothing_to_read"])
def test_reader_finds_nothing(case, monkeypatch):
    from foldcomp_tpu_torch import tracing
    from foldcomp_tpu_torch.tracing import Session
    window = 1.0
    if case == "no_session":
        monkeypatch.setattr(tracing, "last", lambda: None)
    elif case == "outlasts_window":
        monkeypatch.setattr(tracing, "last", _session)
        window = 0.4
    elif case == "no_recorder":         # the port before it had one
        import foldcomp_tpu_torch
        monkeypatch.setattr(tracing, "last", _session)
        monkeypatch.delattr(foldcomp_tpu_torch, "tracing")
        monkeypatch.setitem(sys.modules, "foldcomp_tpu_torch.tracing", None)
    else:
        monkeypatch.setattr(tracing, "last", lambda: Session(
            T0, [_span("other", 1, 0, 0, 1)], {}, {}, {}, False))
    for name in READINGS:
        assert manifest.reader(name)(SimpleNamespace(window_s=window)) \
            is None, name


def test_every_reader_is_declared_where_it_reads():
    m = manifest.load()
    per = {e["name"]: e for e in m["per_layer"]}
    for name in READINGS:
        assert per[name]["source"] == "program_span"
        assert per[name]["workloads"]
