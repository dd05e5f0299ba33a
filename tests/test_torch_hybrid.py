"""The port's database jobs on CPU: the hybrid CPU + device scheduler
(parallel/hybrid.py), the CLI's database routing, `warmup`, and the link
probe's other consumers (the auto-`--fast` of batch decompress and
fast_batch_size).

The device stream runs the port's pipeline with its plain PyTorch versions
(device="cpu"); the CPU workers are real threads running the native C
codec. The corpus is verify.synthetic_corpus at lengths 120 and 200, whose
JAX-reference deviations tests/data/torch_port_ref_dev.json holds: an
entry the device wrote must lie within that deviation + 1e-3 A (+ the
print's rounding) of the exact decoder, and an entry the CPU workers wrote
must be byte-identical to the exact route. Compress output is byte-identical
to the exact route and to foldcomp_tpu's scheduler whoever wrote it. Some
tests slow the native chunk calls down so that the device stream gets a
share of a small job; none gates on a wall-clock time.
"""
import json
import os
import pathlib
import struct
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import pytest

from foldcomp_tpu.codec import batch as tpu_batch
from foldcomp_tpu.parallel import hybrid as tpu_hybrid
from foldcomp_tpu_torch import cli, verify
from foldcomp_tpu_torch.codec import batch as port_batch
from foldcomp_tpu_torch.codec.decoder import decode as decode_exact
from foldcomp_tpu_torch.codec.fcz import serialize
from foldcomp_tpu_torch.io.db import DatabaseReader, DatabaseWriter
from foldcomp_tpu_torch.io.pdb import format_pdb
from foldcomp_tpu_torch.parallel import hybrid
from foldcomp_tpu_torch.parallel.dist import (compress_db_shard,
                                              decompress_db_shard,
                                              merge_shard_dbs)
from foldcomp_tpu_torch.parallel.hybrid import (ChunkController,
                                                EndgameGuard, run_hybrid_db)

REPO = pathlib.Path(__file__).resolve().parents[1]
LENGTHS = (120, 200)          # lengths of tests/data/torch_port_ref_dev.json
N_ENTRIES = 48
PRINT_SLACK_A = 5e-4          # 3-decimal PDB coordinates
# the routing constants as measured on the H100 (cli.py, parallel/hybrid.py)
ROUTING_RECORDED = {"FAST_DEFAULT_MIN": 8192, "FAST_BATCH": 512,
                    "COLD_HORIZON_S": 11.0}


# ---------------------------------------------------------------- fixtures

@pytest.fixture(scope="module")
def corpus():
    return verify.synthetic_corpus(LENGTHS)


def _length_of(i):
    return LENGTHS[i % len(LENGTHS)]


@pytest.fixture(scope="module")
def fcz_db(corpus, tmp_path_factory):
    """N_ENTRIES FCZ entries, keys descending, names e<i>_L<n>."""
    path = tmp_path_factory.mktemp("fcz") / "fcz_db"
    w = DatabaseWriter(str(path))
    for i in range(N_ENTRIES):
        n = _length_of(i)
        w.append(serialize(corpus[n]), 1000 - i, f"e{i}_L{n}")
    w.close()
    return str(path)


@pytest.fixture(scope="module")
def pdb_db(corpus, tmp_path_factory):
    """PDB entries of the corpus, every fifth one two chains."""
    path = tmp_path_factory.mktemp("pdb") / "pdb_db"
    texts = {n: format_pdb(decode_exact(f), f"L{n}")
             for n, f in corpus.items()}
    w = DatabaseWriter(str(path))
    for i in range(N_ENTRIES // 2):
        text = texts[_length_of(i)]
        if i % 5 == 0:
            other = texts[_length_of(i + 1)]
            text += "".join(ln[:21] + "B" + ln[22:] + "\n"
                            for ln in other.splitlines()
                            if ln.startswith("ATOM"))
        w.append(text.encode() + b"\x00", 500 - i, f"p{i}_L{_length_of(i)}")
    w.close()
    return str(path)


def _read(path):
    """[(key, name, payload)] in index order."""
    r = DatabaseReader(str(path), use_lookup=True)
    try:
        return [(k, n, bytes(d)) for k, n, d in r.entries()]
    finally:
        r.close()


def _exact_route(mode, src, tmp_path):
    out = str(tmp_path / f"exact_{mode}")
    if mode == "decompress":
        decompress_db_shard(src, out, 0, 1, fast=False)
    else:
        compress_db_shard(src, out, 0, 1, fast=False)
    merge_shard_dbs(out, 1)
    return _read(out)


def _pdb_xyz(data):
    cols = b"".join(ln[30:54] for ln in data.split(b"\n")
                    if ln.startswith(b"ATOM"))
    return np.frombuffer(cols, dtype="S8").astype(np.float64).reshape(-1, 3)


def _check_decompressed(got, exact, corpus):
    """Every entry under its key and name, in key order; byte-identical
    to the exact route or within the JAX-reference bound. -> the count
    of entries that are not byte-identical."""
    assert [(k, n) for k, n, _ in got] == sorted((k, n) for k, n, _ in exact)
    want = {k: d for k, _, d in exact}
    ref = verify.load_ref_dev()
    xyz = {n: np.asarray(decode_exact(f).coords) for n, f in corpus.items()}
    n_differ = 0
    for key, name, data in got:
        if data == want[key]:
            continue
        n_differ += 1
        n = int(name.rsplit("_L", 1)[1])
        atoms = _pdb_xyz(data)
        assert len(atoms) == len(_pdb_xyz(want[key])), name
        m = min(len(atoms), len(xyz[n]))
        dev = float(np.abs(atoms[:m] - xyz[n][:m]).max())
        assert dev <= ref[n] + verify.REF_DEV_SLACK_A + PRINT_SLACK_A, \
            (name, dev, ref[n])
    return n_differ


@pytest.fixture
def slow_native(monkeypatch):
    """Native chunk calls that take 30 ms more, so that on this small job
    the device stream claims chunks before the CPU workers drain the
    list."""
    def slowed(fn):
        def run(*args):
            time.sleep(0.03)
            return fn(*args)
        return run
    monkeypatch.setattr(hybrid, "_decode_range_native",
                        slowed(hybrid._decode_range_native))
    monkeypatch.setattr(hybrid, "_encode_range_native",
                        slowed(hybrid._encode_range_native))


@pytest.fixture
def device_spy(monkeypatch):
    """Records, per device stream, the entries it completed and the
    (lo, hi) pointers of the chunk list when its first entry completed."""
    seen = {}

    def wrap(name):
        orig = getattr(hybrid, name)

        def spy(reader, writer, ctrl, chunk_entries, batch_size, extra,
                claimed, done, device=None):
            first = seen.setdefault("first", [])

            class Recording(set):
                def add(self, pos):
                    if not first:
                        first.append(ctrl.peek())
                    done.add(pos)
                    super().add(pos)

            rec = Recording()
            try:
                orig(reader, writer, ctrl, chunk_entries, batch_size, extra,
                     claimed, rec, device)
            finally:
                seen["done"] = len(rec)
                seen["claimed"] = len(claimed)
        monkeypatch.setattr(hybrid, name, spy)

    wrap("_device_decompress")
    wrap("_device_compress")
    return seen


# --------------------------------------------------------------- the guard

def _guard(mod, tmp_path, monkeypatch, n_chunks=100, chunk_entries=64,
           batch_size=512, completed=lambda: 0, warmup_env=None):
    """A fresh-process guard of `mod` (the port's or the JAX package's
    hybrid), its persisted estimate in an empty home."""
    batch_mod = port_batch if mod is hybrid else tpu_batch
    monkeypatch.setattr(batch_mod, "DEVICE_WARMED", False)
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.setenv("FOLDCOMP_TPU_JAX_CACHE", str(tmp_path / "jax"))
    if warmup_env is None:
        monkeypatch.delenv("FOLDCOMP_TPU_WARMUP_EST", raising=False)
    else:
        monkeypatch.setenv("FOLDCOMP_TPU_WARMUP_EST", warmup_env)
    ctrl = mod.ChunkController.create(
        str(tmp_path / f"ctrl_{mod.__name__}"), n_chunks)
    return ctrl, mod.EndgameGuard(ctrl, chunk_entries, batch_size,
                                  completed)


def _guard_scenario(case, mod, tmp_path, monkeypatch):
    """The scenarios of tests/test_hybrid.py:37-123 -> the actions."""
    done = {"n": 0}
    if case == "small_job_cold_stop":
        # 0.3 s in, CPUs drained 30 of 100 chunks: 0.7 s left < 5 s
        ctrl, g = _guard(mod, tmp_path, monkeypatch, warmup_env="5.0")
        for _ in range(30):
            ctrl.take_front()
        g._time = lambda: g.t0 + 0.3
        return [g.next_action(), g.claimed_entries]
    if case == "large_job_cold_claims":
        ctrl, g = _guard(mod, tmp_path, monkeypatch, n_chunks=10000,
                         warmup_env="5.0")
        for _ in range(3):
            ctrl.take_front()
        g._time = lambda: g.t0 + 0.3
        return [g.next_action()]
    if case == "grace_then_solo":
        ctrl, g = _guard(mod, tmp_path, monkeypatch, warmup_env="5.0")
        g._time = lambda: g.t0 + 0.1
        first = g.next_action()
        g._time = lambda: g.t0 + 0.5
        return [first, g.next_action()]
    if case == "backlog_aware_endgame":
        ctrl, g = _guard(mod, tmp_path, monkeypatch, n_chunks=1000,
                         completed=lambda: done["n"], warmup_env="5.0")
        g.note_claim(1200)
        done["n"] = 200
        for _ in range(80):
            ctrl.take_front()
        g._time = lambda: g.t0 + 10.0
        first = g.next_action()
        for _ in range(910):
            ctrl.take_front()
        return [first, g.next_action()]
    if case == "eager_mode_claims_cold":
        ctrl, g = _guard(mod, tmp_path, monkeypatch, n_chunks=4,
                         warmup_env="0")
        for _ in range(2):
            ctrl.take_front()
        g._time = lambda: g.t0 + 0.3
        return [g.next_action()]
    if case == "backlog_cap":
        # cold: claims stop at 2 batches + a chunk ahead of completions
        ctrl, g = _guard(mod, tmp_path, monkeypatch, batch_size=8,
                         chunk_entries=4, completed=lambda: done["n"],
                         warmup_env="0")
        g._time = lambda: g.t0 + 1.0
        acts = []
        for claimed in (16, 19, 20):
            g.claimed_entries = claimed
            acts.append(g.next_action())
        done["n"] = 8          # warm: 4 batches + a chunk
        g.claimed_entries = 43
        acts.append(g.next_action())
        g.claimed_entries = 44
        acts.append(g.next_action())
        return acts
    raise AssertionError(case)


GUARD_WANT = {
    "small_job_cold_stop": ["stop", 0],
    "large_job_cold_claims": ["claim"],
    "grace_then_solo": ["wait", "claim"],
    "backlog_aware_endgame": ["claim", "stop"],
    "eager_mode_claims_cold": ["claim"],
    "backlog_cap": ["claim", "claim", "wait", "claim", "wait"],
}


@pytest.mark.parametrize("case", sorted(GUARD_WANT))
def test_guard_matches_foldcomp_tpu(case, tmp_path, monkeypatch):
    got = _guard_scenario(case, hybrid, tmp_path, monkeypatch)
    assert got == GUARD_WANT[case]
    assert _guard_scenario(case, tpu_hybrid, tmp_path, monkeypatch) == got


def test_guard_in_process_warm(tmp_path, monkeypatch):
    """A device batch completed in this process: a 0.5 s horizon, and
    finalize() keeps the cold estimate on disk."""
    home = tmp_path / "home"
    path = home / ".cache" / "foldcomp_tpu_torch" / "device_warmup.json"
    path.parent.mkdir(parents=True)
    path.write_text(json.dumps({"warmup_s": 9.0}))
    monkeypatch.setenv("HOME", str(home))
    monkeypatch.delenv("FOLDCOMP_TPU_WARMUP_EST", raising=False)
    monkeypatch.setattr(port_batch, "DEVICE_WARMED", False)
    ctrl = ChunkController.create(str(tmp_path / "ctrl"), 100)
    assert EndgameGuard(ctrl, 64, 512, lambda: 0).warmup_est == 9.0
    monkeypatch.setattr(port_batch, "DEVICE_WARMED", True)
    g = EndgameGuard(ctrl, 64, 512, lambda: 64)
    assert g.warmup_est == 0.5
    g._time = lambda: g.t0 + 0.1
    g.next_action()
    g.finalize()
    assert json.loads(path.read_text())["warmup_s"] == 9.0


def test_guard_persists_its_own_warmup_file(tmp_path, monkeypatch):
    """finalize() writes time-to-first-completion to the port's own file
    under ~/.cache/foldcomp_tpu_torch; a new guard reads it back. The JAX
    package's file (a TPU's number) and its cache variable are never
    read."""
    done = {"n": 0}
    home = tmp_path / "home"
    jax_file = home / ".cache" / "foldcomp_tpu_jax" / "device_warmup.json"
    jax_file.parent.mkdir(parents=True)
    jax_file.write_text(json.dumps({"warmup_s": 42.0}))
    jax_env = tmp_path / "jax_env"
    jax_env.mkdir()
    (jax_env / "device_warmup.json").write_text('{"warmup_s": 43.0}')
    monkeypatch.setenv("FOLDCOMP_TPU_JAX_CACHE", str(jax_env))
    monkeypatch.setenv("HOME", str(home))
    monkeypatch.delenv("FOLDCOMP_TPU_WARMUP_EST", raising=False)
    monkeypatch.setattr(port_batch, "DEVICE_WARMED", False)
    ctrl = ChunkController.create(str(tmp_path / "ctrl"), 100)
    g = EndgameGuard(ctrl, 64, 512, lambda: done["n"])
    assert g.warmup_est == hybrid.COLD_HORIZON_S
    assert EndgameGuard._warmup_path() == str(
        home / ".cache" / "foldcomp_tpu_torch" / "device_warmup.json")
    done["n"] = 512
    g._time = lambda: g.t0 + 2.5
    g.next_action()
    g.finalize()
    assert abs(EndgameGuard(ctrl, 64, 512, lambda: 0).warmup_est
               - 2.5) < 0.2
    assert json.loads(jax_file.read_text())["warmup_s"] == 42.0


# ----------------------------------------------------- the chunk controller

def test_chunk_controller_two_pointer(tmp_path):
    p = str(tmp_path / "ctrl")
    ctrl = ChunkController.create(p, 5)
    assert [ctrl.take_front(), ctrl.take_back(), ctrl.take_back(),
            ctrl.take_front(), ctrl.take_front()] == [0, 4, 3, 1, 2]
    assert ctrl.take_front() is None and ctrl.take_back() is None
    with open(p, "rb") as fh:
        lo, hi = struct.unpack("<qq", fh.read(16))
    assert lo >= hi


def test_chunk_controller_no_double_claims(tmp_path):
    """Threads with a short switch interval and a worker process claim
    from both ends at once: every chunk exactly once."""
    n_chunks = 3000
    p = str(tmp_path / "ctrl")
    ChunkController.create(p, n_chunks)
    code = ("import random, sys\n"
            "from foldcomp_tpu_torch.parallel.hybrid import "
            "ChunkController\n"
            f"ctrl = ChunkController({p!r})\n"
            "got = []\n"
            "while (c := (ctrl.take_front() if random.random() < 0.5\n"
            "             else ctrl.take_back())) is not None:\n"
            "    got.append(c)\n"
            "assert 'torch' not in sys.modules\n"
            "print(' '.join(map(str, got)))\n")
    proc = subprocess.Popen([sys.executable, "-c", code],
                            env=dict(os.environ, PYTHONPATH=str(REPO)),
                            stdout=subprocess.PIPE, text=True)
    ctrl = ChunkController(p)
    got = [[] for _ in range(8)]

    def claimer(i):
        take = ctrl.take_front if i % 2 == 0 else ctrl.take_back
        while (c := take()) is not None:
            got[i].append(c)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=claimer, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    out, _ = proc.communicate(timeout=120)
    assert proc.returncode == 0
    claimed = [c for g in got for c in g] + [int(x) for x in out.split()]
    assert sorted(claimed) == list(range(n_chunks))


# --------------------------------------------------------- run_hybrid_db

@pytest.mark.parametrize("use_device", [True, False])
def test_hybrid_decompress(use_device, fcz_db, corpus, tmp_path,
                           monkeypatch, slow_native, device_spy):
    monkeypatch.setenv("FOLDCOMP_TPU_WARMUP_EST", "0")
    exact = _exact_route("decompress", fcz_db, tmp_path)
    out = tmp_path / "hybrid"
    rc = run_hybrid_db("decompress", fcz_db, str(out), n_native=1,
                       chunk_entries=4, batch_size=8,
                       use_device=use_device, device="cpu")
    assert rc == 0
    n_differ = _check_decompressed(_read(out), exact, corpus)
    if use_device:
        # the device wrote entries; theirs are the ones that differ
        assert device_spy["done"] > 0
        assert 0 < n_differ <= device_spy["done"]
    else:
        assert "done" not in device_spy and n_differ == 0
    # shards merged and removed, the control file gone
    assert not list(tmp_path.glob("hybrid.[0-9]*"))
    assert not (tmp_path / "hybrid.hybrid_ctrl").exists()


@pytest.mark.parametrize("use_device", [True, False])
def test_hybrid_compress(use_device, pdb_db, tmp_path, monkeypatch,
                         slow_native, device_spy):
    """Byte-identical to the port's exact route and to foldcomp_tpu's
    scheduler, whoever encoded each entry; multi-chain entries stay
    whole."""
    monkeypatch.setenv("FOLDCOMP_TPU_WARMUP_EST", "0")
    out = tmp_path / "hybrid"
    rc = run_hybrid_db("compress", pdb_db, str(out), n_native=1,
                       chunk_entries=2, batch_size=4,
                       use_device=use_device, device="cpu")
    assert rc == 0
    jax_out = tmp_path / "jax"
    assert tpu_hybrid.run_hybrid_db("compress", pdb_db, str(jax_out),
                                    n_native=2, chunk_entries=3,
                                    use_device=False) == 0

    def by_key(entries):
        d = {}
        for k, n, blob in entries:
            d.setdefault((k, n), []).append(blob)
        return {k: sorted(v) for k, v in d.items()}

    got = _read(out)
    assert [k for k, _, _ in got] == sorted(k for k, _, _ in got)
    assert len(got) > N_ENTRIES // 2              # two-chain entries
    assert by_key(got) == by_key(_exact_route("compress", pdb_db, tmp_path))
    assert by_key(got) == by_key(_read(jax_out))
    if use_device:
        assert device_spy["done"] > 0


def test_hybrid_skips_corrupt_entries(fcz_db, tmp_path, monkeypatch,
                                      slow_native):
    """Corrupt and truncated FCZ entries are skipped by both sides, as
    foldcomp_tpu's scheduler skips them."""
    monkeypatch.setenv("FOLDCOMP_TPU_WARMUP_EST", "0")
    db = str(tmp_path / "mixed")
    w = DatabaseWriter(db)
    for pos, (key, name, data) in enumerate(_read(fcz_db)):
        if pos % 5 == 2:
            data = b"NOTFCZ" + data[:40]
        elif pos % 5 == 4:
            data = data[:len(data) // 3]
        w.append(data, key, name)
    w.close()
    jax_out = str(tmp_path / "jax")
    assert tpu_hybrid.run_hybrid_db("decompress", db, jax_out, n_native=1,
                                    chunk_entries=3, use_device=False) == 0
    want = [(k, n) for k, n, _ in _read(jax_out)]
    assert 0 < len(want) < N_ENTRIES
    for use_device in (True, False):
        out = str(tmp_path / f"port_{use_device}")
        assert run_hybrid_db("decompress", db, out, n_native=1,
                             chunk_entries=3, batch_size=4,
                             use_device=use_device, device="cpu") == 0
        assert [(k, n) for k, n, _ in _read(out)] == want


def test_device_stream_completes_under_the_guard_cap(fcz_db, corpus,
                                                     tmp_path, monkeypatch,
                                                     device_spy):
    """The guard lets the device hold at most 2 batches + a chunk before
    its first completion. The stream must complete a batch within that,
    before the list is drained: with a sort window or prefetch queue
    deeper than the cap no batch would ever fill, and with no CPU worker
    to drain the list the job would never end."""
    monkeypatch.setenv("FOLDCOMP_TPU_WARMUP_EST", "0")
    out = tmp_path / "device_only"
    rcs = []
    t = threading.Thread(target=lambda: rcs.append(run_hybrid_db(
        "decompress", fcz_db, str(out), n_native=0, chunk_entries=4,
        batch_size=8, use_device=True, device="cpu")), daemon=True)
    t.start()
    t.join(timeout=300)
    assert not t.is_alive(), "device stream stalled under the guard's cap"
    assert rcs == [0]
    lo, hi = device_spy["first"][0]
    assert lo < hi                     # the list was not drained yet
    assert device_spy["done"] == N_ENTRIES
    exact = _exact_route("decompress", fcz_db, tmp_path)
    assert _check_decompressed(_read(out), exact, corpus) > 0


@pytest.mark.parametrize("case", ["decompress", "compress", "cli"])
def test_device_failure_is_reported_and_db_is_whole(case, fcz_db, pdb_db,
                                                    corpus, tmp_path,
                                                    monkeypatch, capsys):
    """A device stream that raises mid-job: the mop-up finishes its
    claimed chunks natively, so the database is whole, and the job
    returns 1 with an [Error] line."""
    monkeypatch.setenv("FOLDCOMP_TPU_WARMUP_EST", "0")
    real_stream = port_batch.decode_fcz_stream
    real_submit = port_batch.encode_submit
    calls = []

    def broken_stream(payloads, **kw):
        for i, item in enumerate(real_stream(payloads, **kw)):
            if i == 3:
                raise RuntimeError("injected device failure")
            yield item

    def broken_submit(*args, **kw):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("injected device failure")
        return real_submit(*args, **kw)

    monkeypatch.setattr(port_batch, "decode_fcz_stream", broken_stream)
    monkeypatch.setattr(port_batch, "encode_submit", broken_submit)
    mode = "compress" if case == "compress" else "decompress"
    src = pdb_db if mode == "compress" else fcz_db
    out = tmp_path / "out"
    if case == "cli":
        # the stream fails as it starts (a kernel that does not build,
        # say): the CLI's exit code carries it
        def no_stream(*args):
            raise RuntimeError("injected device failure")
        monkeypatch.setattr(hybrid, "_device_decompress", no_stream)
        monkeypatch.setattr(cli, "FAST_DEFAULT_MIN", 2)
        monkeypatch.setenv("FOLDCOMP_TPU_LINK", "ok")
        monkeypatch.setenv("FOLDCOMP_TORCH_DEVICE", "cpu")
        rc = cli.main(["decompress", "-t", "1", src, str(out), "--db"])
    else:
        rc = run_hybrid_db(mode, src, str(out), n_native=0,
                           chunk_entries=2, batch_size=4, use_device=True,
                           device="cpu")
    assert rc == 1
    assert "[Error] device stream failed" in capsys.readouterr().err
    exact = _exact_route(mode, src, tmp_path)
    got = _read(out)
    if mode == "compress":
        assert sorted(got) == sorted(exact)
    else:
        n_differ = _check_decompressed(got, exact, corpus)
        assert (n_differ > 0) == (case == "decompress")


# ------------------------------------------------------------ the CLI

@pytest.mark.parametrize("db_out", [False, True])
def test_sharded_extract_matches_single(db_out, fcz_db, tmp_path):
    """extract -t 3 on a db: merged text byte-identical to -t 1 and to
    foldcomp_tpu's; db output equal per name."""
    from foldcomp_tpu import cli as tpu_cli
    flags = ["-d"] if db_out else []
    outs = {}
    for label, main, t in (("one", cli.main, "1"), ("three", cli.main, "3"),
                           ("jax", tpu_cli.main, "3")):
        outs[label] = tmp_path / label
        assert main(["extract", "--plddt", "-t", t, *flags, "-y", fcz_db,
                     str(outs[label])]) == 0
    if not db_out:
        one = outs["one"].read_bytes()
        assert one and one == outs["three"].read_bytes() == \
            outs["jax"].read_bytes()
        return
    views = {k: sorted((n, d) for _, n, d in _read(p))
             for k, p in outs.items()}
    assert len(views["one"]) == N_ENTRIES
    assert views["one"] == views["three"] == views["jax"]


def _cli_env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("FOLDCOMP_TORCH_DEVICE", "FOLDCOMP_TPU_WARMUP_EST")}
    return dict(env, PYTHONPATH=str(REPO), **extra)


@pytest.mark.parametrize("src", ["fcz_db", "pdb_db"])
def test_warmup_writes_only_the_ports_file(src, fcz_db, pdb_db, tmp_path):
    home = tmp_path / "home"
    home.mkdir()
    path = fcz_db if src == "fcz_db" else pdb_db
    r = subprocess.run([sys.executable, "-m", "foldcomp_tpu_torch",
                        "warmup", path], cwd=tmp_path, capture_output=True,
                       text=True, timeout=600,
                       env=_cli_env(HOME=str(home),
                                    FOLDCOMP_TORCH_DEVICE="cpu"))
    assert r.returncode == 0, r.stderr
    assert "Warmed cpu codec on 128-entry batches" in r.stdout
    files = [q.relative_to(home) for q in home.rglob("*") if q.is_file()]
    want = pathlib.Path(".cache/foldcomp_tpu_torch/device_warmup.json")
    assert files == [want]
    assert json.loads((home / want).read_text())["warmup_s"] > 0


def test_warmup_refuses_without_a_device(tmp_path, fcz_db):
    import torch
    env = _cli_env(HOME=str(tmp_path))
    missing = subprocess.run([sys.executable, "-m", "foldcomp_tpu_torch",
                              "warmup", str(tmp_path / "nope")],
                             env=dict(env, FOLDCOMP_TORCH_DEVICE="cpu"),
                             capture_output=True, text=True, timeout=300)
    assert missing.returncode == 1 and "does not exist" in missing.stderr
    if torch.cuda.is_available():
        return
    r = subprocess.run([sys.executable, "-m", "foldcomp_tpu_torch",
                        "warmup", fcz_db], env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 1 and "CUDA" in r.stderr
    assert not (tmp_path / ".cache").exists()


@pytest.mark.parametrize("case", ["hybrid", "slow_link", "no_card",
                                  "no_card_t1", "exact", "small_job"])
def test_cli_db_routing(case, fcz_db, corpus, tmp_path, monkeypatch,
                        capsys):
    """Which route a no-flag db -> db job takes, what it says, and that
    each writes the whole database."""
    monkeypatch.setenv("FOLDCOMP_TPU_WARMUP_EST", "0")
    monkeypatch.setenv("FOLDCOMP_TORCH_DEVICE", "cpu")
    link = {"hybrid": "ok", "slow_link": "slow"}.get(case, "none")
    monkeypatch.setenv("FOLDCOMP_TPU_LINK", link)
    if case != "small_job":
        monkeypatch.setattr(cli, "FAST_DEFAULT_MIN", 2)
    probed = []
    real = cli._accelerator_present
    monkeypatch.setattr(cli, "_accelerator_present",
                        lambda: probed.append(1) or real())
    argv = ["decompress", "-t", "1" if case == "no_card_t1" else "2",
            fcz_db, str(tmp_path / "out"), "--db"]
    if case == "exact":
        argv.insert(1, "--exact")
    assert cli.main(argv) == 0
    err = capsys.readouterr().err
    info = [ln for ln in err.splitlines() if ln.startswith("[Info]")]
    want = {"hybrid": ["[Info] hybrid CPU+GPU scheduling (2 native workers "
                       "+ device stream on cpu)"],
            "slow_link": ["[Info] hybrid CPU+GPU scheduling (2 native "
                          "workers + CPU-only parent: host<->device link "
                          "too slow)"],
            "no_card": ["[Info] no CUDA device: the db job runs on native "
                        "CPU workers only"]}
    want["no_card_t1"] = want["no_card"]
    if case == "hybrid":
        assert info[1].startswith("[Info] hybrid: the device stream "
                                  f"finished ") and \
            info[1].endswith(f" of {N_ENTRIES} entries")
        info = info[:1]
    assert info == want.get(case, [])
    assert bool(probed) == (case not in ("exact", "small_job"))
    exact = _exact_route("decompress", fcz_db, tmp_path)
    n_differ = _check_decompressed(_read(tmp_path / "out"), exact, corpus)
    if case != "hybrid":
        assert n_differ == 0


def test_cli_db_route_needs_a_card(corpus, tmp_path, monkeypatch, capsys,
                                   slow_native):
    """FOLDCOMP_TPU_LINK=ok on a host without a card and no device asked
    for: the device stream fails once it has claimed a chunk, the CPU
    workers write the whole database, and the job returns 1. (Five chunks
    of the CLI's 64 entries, so that the device stream claims one.)"""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    db = str(tmp_path / "fcz_db")
    w = DatabaseWriter(db)
    for i in range(5 * 64):
        w.append(serialize(corpus[_length_of(i)]), i, f"e{i}_L{_length_of(i)}")
    w.close()
    monkeypatch.delenv("FOLDCOMP_TORCH_DEVICE", raising=False)
    monkeypatch.setenv("FOLDCOMP_TPU_LINK", "ok")
    monkeypatch.setenv("FOLDCOMP_TPU_WARMUP_EST", "0")
    monkeypatch.setattr(cli, "FAST_DEFAULT_MIN", 2)
    out = tmp_path / "out"
    assert cli.main(["decompress", db, str(out), "--db"]) == 1
    err = capsys.readouterr().err
    assert "[Error] device stream failed" in err and "CUDA" in err
    assert _read(out) == _exact_route("decompress", db, tmp_path)


@pytest.fixture
def fcz_dir(corpus, tmp_path):
    d = tmp_path / "fczs"
    d.mkdir()
    for i in range(8):
        (d / f"p{i}_L{_length_of(i)}.fcz").write_bytes(
            serialize(corpus[_length_of(i)]))
    return d


@pytest.mark.parametrize("case", ["engages", "small_job", "exact",
                                  "slow_link"])
def test_fast_default(case, fcz_dir, corpus, tmp_path, monkeypatch, capsys):
    """A large batch decompress takes the device decode by itself when the
    probe finds a card with an ok link (foldcomp_tpu/cli.py:868-885);
    small jobs, --exact and a slow link keep the exact native path."""
    monkeypatch.setenv("FOLDCOMP_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("FOLDCOMP_TPU_LINK",
                       "slow" if case == "slow_link" else "ok")
    if case != "small_job":
        monkeypatch.setattr(cli, "FAST_DEFAULT_MIN", 4)
    streams, probed = [], []
    real_stream = port_batch.decode_fcz_stream
    monkeypatch.setattr(port_batch, "decode_fcz_stream",
                        lambda *a, **k: streams.append(1)
                        or real_stream(*a, **k))
    real = cli._accelerator_present
    monkeypatch.setattr(cli, "_accelerator_present",
                        lambda: probed.append(1) or real())
    out = tmp_path / "out"
    argv = ["decompress", "-y", str(fcz_dir), str(out)]
    if case == "exact":
        argv.insert(1, "--exact")
    assert cli.main(argv) == 0
    err = capsys.readouterr().err
    assert bool(streams) == (case == "engages")
    assert bool(probed) == (case in ("engages", "slow_link"))
    if case == "engages":
        assert "[Info] GPU detected (link ok): using batched decode on cpu" \
            in err
    if case == "slow_link":
        assert "link is too slow" in err
    from foldcomp_tpu_torch.native import decode_fcz_pdb_native
    ref = verify.load_ref_dev()
    for p in sorted(fcz_dir.iterdir()):
        got = (out / (p.stem + ".pdb")).read_bytes()
        want = decode_fcz_pdb_native(p.read_bytes(), as_bytes=True)
        if case != "engages":
            assert got == want
            continue
        n = int(p.stem.rsplit("_L", 1)[1])
        xyz = np.asarray(decode_exact(corpus[n]).coords)
        a = _pdb_xyz(got)
        m = min(len(a), len(xyz))
        assert np.abs(a[:m] - xyz[:m]).max() <= \
            ref[n] + verify.REF_DEV_SLACK_A + PRINT_SLACK_A


@pytest.mark.parametrize("above", [False, True],
                         ids=["fast_default_min", "fast_default_min_plus_1"])
def test_fast_default_min_boundary(above, corpus, tmp_path, monkeypatch,
                                   capsys):
    """A no-flag batch decompress of FAST_DEFAULT_MIN entries stays on the
    native path; one of FAST_DEFAULT_MIN + 1 takes the device route, with
    the link probe's answer (_probe_info) an ok H100-like link. The
    constant is set to 4 here to keep the job small."""
    assert cli.FAST_DEFAULT_MIN == ROUTING_RECORDED["FAST_DEFAULT_MIN"]
    monkeypatch.setenv("FOLDCOMP_TORCH_DEVICE", "cpu")
    monkeypatch.setattr(cli, "_probe_info", lambda: ("ok", 2300.0))
    monkeypatch.setattr(cli, "FAST_DEFAULT_MIN", 4)
    src = tmp_path / "fczs"
    src.mkdir()
    n = 4 + above
    for i in range(n):
        (src / f"p{i}_L{_length_of(i)}.fcz").write_bytes(
            serialize(corpus[_length_of(i)]))
    streams = []
    real_stream = port_batch.decode_fcz_stream
    monkeypatch.setattr(port_batch, "decode_fcz_stream",
                        lambda *a, **k: streams.append(k["batch_size"])
                        or real_stream(*a, **k))
    out = tmp_path / "out"
    assert cli.main(["decompress", str(src), str(out)]) == 0
    err = capsys.readouterr().err
    assert streams == ([cli.FAST_BATCH] if above else [])
    assert ("[Info] GPU detected (link ok)" in err) is above
    assert len(list(out.iterdir())) == n
    from foldcomp_tpu_torch.native import decode_fcz_pdb_native
    for p in src.iterdir():
        got = (out / (p.stem + ".pdb")).read_bytes()
        want = decode_fcz_pdb_native(p.read_bytes(), as_bytes=True)
        assert (got == want) or above


def test_cold_horizon_default(tmp_path, monkeypatch):
    """With no warmup file, no FOLDCOMP_TPU_WARMUP_EST and no device batch
    completed in this process, the guard's cold horizon is
    COLD_HORIZON_S, the H100's measured value."""
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.delenv("FOLDCOMP_TPU_WARMUP_EST", raising=False)
    monkeypatch.setattr(port_batch, "DEVICE_WARMED", False)
    assert EndgameGuard.cold_horizon() == hybrid.COLD_HORIZON_S == \
        ROUTING_RECORDED["COLD_HORIZON_S"]
    ctrl = ChunkController.create(str(tmp_path / "ctrl"), 4)
    assert EndgameGuard(ctrl, 64, 512, lambda: 0).warmup_est == \
        hybrid.COLD_HORIZON_S


def test_fast_batch_size_follows_the_probe(monkeypatch, tmp_path):
    """FOLDCOMP_TPU_BATCH first; else FAST_BATCH (512, the H100's
    measured batch) from 1000 MB/s, 512 from 300, 128 below or on a link
    that is not ok: the JAX package's steps (foldcomp_tpu/cli.py:825-846)
    with the port's own FAST_BATCH."""
    assert cli.FAST_BATCH == ROUTING_RECORDED["FAST_BATCH"]
    monkeypatch.setenv("FOLDCOMP_TPU_BATCH", "77")
    assert cli.fast_batch_size() == 77
    monkeypatch.delenv("FOLDCOMP_TPU_BATCH")
    for link in ("ok", "slow", "none"):       # forced: 0 MB/s
        monkeypatch.setenv("FOLDCOMP_TPU_LINK", link)
        assert cli.fast_batch_size() == 128
        assert cli._accelerator_present() is (link != "none")
        assert cli._device_link_ok() is (link == "ok")
    monkeypatch.delenv("FOLDCOMP_TPU_LINK")
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr(tempfile, "tempdir", None)
    cache = tmp_path / f"foldcomp_tpu_torch_probe_{os.getuid()}.json"
    for result, mbs, want in (("ok", 2300.0, 512), ("ok", 999.0, 512),
                              ("ok", 300.0, 512), ("ok", 120.0, 128),
                              ("slow", 2300.0, 128)):
        cache.write_text(json.dumps(dict(ts=time.time(), result=result,
                                         mbs=mbs)))
        assert cli.fast_batch_size() == want, (result, mbs)
