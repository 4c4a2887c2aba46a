"""The port's write-ahead log against the JAX package's, on the CPU.

Mirrors ``tests/test_wal.py`` for ``repro_torch`` (framing, damage
tolerance, write-ahead logging through the index, replay, in-process
recovery, the fault plan) and holds the port to the JAX package:

* the same operations give **byte-identical WAL files** from both
  packages (REGISTER, INSERT, DELETE, SEAL, COMPACT, SET_REPLICATION);
* a log the JAX package wrote replays in the port, into an index built
  with the JAX tenant's family, to the JAX tenant's answers: ids equal
  wherever the JAX distances are distinct, distances allclose with
  ``rtol=1e-6, atol=1e-6`` (ROADMAP's parity contract);
* within the port, replay and recovery answer **bit for bit** as the
  index that wrote the log.

Every test that installs a fault plan clears it in a fixture, and every
environment variable is set through ``monkeypatch``.
"""

import dataclasses
import os
import struct

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.serve import ServableRegistry as JRegistry  # noqa: E402
from repro.serve import ServableSpec as JSpec  # noqa: E402
from repro.serve import wal as jwal  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.serve import (InjectedFault, SegmentedIndex,  # noqa: E402
                               ServableRegistry, ServableSpec, read_wal)
from repro_torch.serve import faults, wal  # noqa: E402

N_DIMS = 16


def _kw(name="t", **kw):
    base = dict(name=name, n_dims=N_DIMS, r=2.0, log2_buckets=8,
                bucket_capacity=64, segment_capacity=128, insert_chunk=64,
                chunk_sizes=(8, 32))
    base.update(kw)
    return base


def _spec(name="t", **kw):
    return ServableSpec(**_kw(name, **kw))


def _data(n, seed=0, scale=1.0):
    return (np.random.default_rng(seed).normal(size=(n, N_DIMS)) *
            scale).astype(np.float32)


def _reg(**kw):
    return ServableRegistry(device="cpu", **kw)


def _answer(index, q, k=10, n_probes=4):
    g, d = index.query(q, k, n_probes=n_probes)
    return np.asarray(g), np.asarray(d)


def _assert_bits(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1].view(np.uint32),
                                  want[1].view(np.uint32))


def _assert_parity(got, want):
    """ids equal where the reference distances are distinct, distances
    allclose (rtol 1e-6, atol 1e-6)."""
    gi, gd = got
    wi, wd = want
    np.testing.assert_allclose(gd, wd, rtol=1e-6, atol=1e-6)
    for r in range(wi.shape[0]):
        vals, counts = np.unique(wd[r], return_counts=True)
        distinct = np.isin(wd[r], vals[counts == 1])
        np.testing.assert_array_equal(gi[r][distinct], wi[r][distinct])


@pytest.fixture(autouse=True)
def _no_leftover_faults():
    faults.clear()
    yield
    faults.clear()


# ---------------------------------------------------------------------------
# framing
# ---------------------------------------------------------------------------


def test_frame_round_trip_all_ops(tmp_path):
    path = str(tmp_path / "t.wal")
    w = wal.WriteAheadLog(path, fsync_every=0)
    gids = np.arange(5, dtype=np.int32)
    emb = _data(5, seed=1)
    w.append(wal.encode_register({"name": "t", "n_dims": N_DIMS}))
    w.append(wal.encode_insert(gids, emb))
    w.append(wal.encode_delete(gids[:2]))
    w.append(wal.encode_seal())
    w.append(wal.encode_compact())
    w.append(wal.encode_set_replication([2, 1]))
    w.append(wal.encode_set_replication(None))
    w.append(wal.encode_lifecycle("ready"))
    w.close()

    records, report = read_wal(path)
    assert not report["truncated"]
    assert report["n_records"] == 8
    assert report["end_offset"] == report["wal_bytes"] == os.path.getsize(path)
    assert [r.op_name for r in records] == [
        "register", "insert", "delete", "seal", "compact",
        "set_replication", "set_replication", "lifecycle"]
    assert records[0].value == {"name": "t", "n_dims": N_DIMS}
    np.testing.assert_array_equal(records[1].gids, gids)
    np.testing.assert_array_equal(records[1].embeddings, emb)
    np.testing.assert_array_equal(records[2].gids, gids[:2])
    assert records[5].value == [2, 1]
    assert records[6].value is None
    assert records[7].value == {"state": "ready"}
    with pytest.raises(ValueError):
        wal.encode_lifecycle("exploded")


@pytest.mark.parametrize("payload", [
    lambda m: m.encode_register({"name": "t", "n_dims": N_DIMS,
                                 "chunk_sizes": [8, 32]}),
    lambda m: m.encode_insert(np.arange(7, dtype=np.int32), _data(7, 3)),
    lambda m: m.encode_insert(np.zeros(0, np.int32),
                              np.zeros((0, N_DIMS), np.float32)),
    lambda m: m.encode_delete(np.array([3, 1, 3], np.int64)),
    lambda m: m.encode_seal(),
    lambda m: m.encode_compact(),
    lambda m: m.encode_set_replication((2, 1)),
    lambda m: m.encode_set_replication(3),
    lambda m: m.encode_lifecycle("unloaded"),
], ids=["register", "insert", "insert-empty", "delete", "seal", "compact",
        "replication-factors", "replication-int", "lifecycle"])
def test_payloads_and_frames_equal_the_jax_packages(tmp_path, payload):
    """Each op's payload, and its frame on disk, byte for byte."""
    assert payload(wal) == payload(jwal)
    paths = []
    for mod, tag in ((wal, "port"), (jwal, "jax")):
        paths.append(str(tmp_path / f"{tag}.wal"))
        w = mod.WriteAheadLog(paths[-1], fsync_every=0)
        w.append(payload(mod))
        w.close()
    assert open(paths[0], "rb").read() == open(paths[1], "rb").read()


def test_group_commit_fsync_counting(tmp_path):
    """fsync_every=N syncs once per N appends; 0 leaves it to sync()."""
    w = wal.WriteAheadLog(str(tmp_path / "a.wal"), fsync_every=3)
    for _ in range(7):
        w.append(wal.encode_seal())
    assert w.syncs == 2                     # at appends 3 and 6
    w.sync()
    assert w.syncs == 3
    assert w.stats()["appends"] == 7
    w.close()

    w0 = wal.WriteAheadLog(str(tmp_path / "b.wal"), fsync_every=0)
    for _ in range(10):
        w0.append(wal.encode_seal())
    assert w0.syncs == 0
    w0.close()


def test_default_fsync_interval_from_env(tmp_path, monkeypatch):
    monkeypatch.delenv("REPRO_WAL_FSYNC_EVERY", raising=False)
    assert wal.default_fsync_every() == 8
    monkeypatch.setenv("REPRO_WAL_FSYNC_EVERY", "5")
    assert wal.default_fsync_every() == 5
    w = wal.WriteAheadLog(str(tmp_path / "t.wal"))
    assert w.fsync_every == 5
    w.close()
    monkeypatch.setenv("REPRO_WAL_FSYNC_EVERY", "nonsense")
    assert wal.default_fsync_every() == 8   # fallback, not a crash


def test_reopen_appends_after_existing_records(tmp_path):
    path = str(tmp_path / "t.wal")
    w = wal.WriteAheadLog(path, fsync_every=1)
    w.append(wal.encode_seal())
    w.close()
    w2 = wal.WriteAheadLog(path, fsync_every=1)
    assert w2.offset == os.path.getsize(path)
    w2.append(wal.encode_compact())
    w2.close()
    records, report = read_wal(path)
    assert [r.op_name for r in records] == ["seal", "compact"]
    assert not report["truncated"]


# ---------------------------------------------------------------------------
# damage tolerance: longest verifiable prefix
# ---------------------------------------------------------------------------


def _write_n(path, n, fsync_every=0):
    w = wal.WriteAheadLog(path, fsync_every=fsync_every)
    for i in range(n):
        w.append(wal.encode_insert(np.asarray([i], np.int32),
                                   _data(1, seed=i)))
    w.close()
    return os.path.getsize(path)


def test_truncated_tail_recovers_prefix(tmp_path):
    path = str(tmp_path / "t.wal")
    size = _write_n(path, 4)
    with open(path, "rb+") as f:
        f.truncate(size - 7)
    records, report = read_wal(path)
    assert len(records) == 3
    assert report["truncated"]
    assert "truncated payload" in report["bad_frame_reason"]
    assert report["bad_frame_at"] == report["end_offset"]
    # the JAX package reads the port's damaged log the same way
    jrecords, jreport = jwal.read_wal(path)
    assert len(jrecords) == 3 and jreport == report


def test_short_header_tail(tmp_path):
    path = str(tmp_path / "t.wal")
    size = _write_n(path, 2)
    with open(path, "ab") as f:
        f.write(b"\x01\x02\x03")            # 3 bytes of an 8-byte header
    records, report = read_wal(path)
    assert len(records) == 2
    assert report["truncated"]
    assert "short header" in report["bad_frame_reason"]
    assert report["end_offset"] == size


def test_corrupt_record_stops_at_crc(tmp_path):
    path = str(tmp_path / "t.wal")
    _write_n(path, 5)
    _, clean = read_wal(path)
    with open(path, "rb") as f:
        data = f.read()
    offsets, off = [], 0
    while off < len(data):
        offsets.append(off)
        off += 8 + struct.unpack_from("<I", data, off)[0]
    victim = offsets[2] + 8 + 2
    with open(path, "rb+") as f:
        f.seek(victim)
        b = f.read(1)
        f.seek(victim)
        f.write(bytes([b[0] ^ 0xFF]))
    records, report = read_wal(path)
    assert len(records) == 2                # records 3..5 unreachable
    assert report["truncated"]
    assert report["bad_frame_reason"] == "crc mismatch"
    assert report["bad_frame_at"] == offsets[2]
    assert clean["n_records"] == 5


def test_undecodable_payload_stops_the_scan(tmp_path):
    """A frame whose crc holds but whose body does not decode (an unknown
    op) is bad too."""
    path = str(tmp_path / "t.wal")
    w = wal.WriteAheadLog(path, fsync_every=0)
    w.append(wal.encode_seal())
    w.append(bytes([99]))
    w.append(wal.encode_seal())
    w.close()
    records, report = read_wal(path)
    assert len(records) == 1 and report["truncated"]
    assert "undecodable" in report["bad_frame_reason"]


def test_empty_and_fresh_wal(tmp_path):
    path = str(tmp_path / "t.wal")
    open(path, "wb").close()
    records, report = read_wal(path)
    assert records == [] and not report["truncated"]


def test_follower_polls_increments_and_stops_before_a_tear(tmp_path):
    path = str(tmp_path / "t.wal")
    fol = wal.WalFollower(path)
    assert fol.poll()[0] == [] and fol.lag_bytes() == 0   # no file yet
    _write_n(path, 3)
    recs, rep = fol.poll()
    assert len(recs) == 3 and fol.offset == rep["end_offset"]
    assert fol.lag_bytes() == 0
    with open(path, "ab") as f:
        f.write(struct.pack("<II", 100, 0) + b"\x00" * 10)   # torn frame
    recs, rep = fol.poll()
    assert recs == [] and rep["truncated"] and fol.lag_bytes() == 18
    assert fol.records_seen == 3


# ---------------------------------------------------------------------------
# write-ahead logging through the index
# ---------------------------------------------------------------------------


def test_mutations_logged_in_apply_order(tmp_path):
    reg = _reg(wal_dir=str(tmp_path), fsync_every=1)
    sv = reg.register(_spec())
    g = sv.insert(_data(150, seed=1))       # crosses a segment boundary
    sv.delete(g[:10])
    sv.index.maintenance.seal()
    sv.maintenance.compact()
    records, report = read_wal(str(tmp_path / "t.wal"))
    assert not report["truncated"]
    # the implicit mid-insert seal is not logged (replaying the INSERT
    # reproduces it); compaction's re-inserts are the shadow's, unlogged
    assert [r.op_name for r in records] == [
        "register", "insert", "delete", "seal", "compact"]
    np.testing.assert_array_equal(records[1].gids, g)
    np.testing.assert_array_equal(records[1].embeddings, _data(150, seed=1))


def test_background_compaction_deletes_are_logged_once(tmp_path):
    """A delete that lands during a compaction's build is logged once, as
    requested; the swap re-applies it from the ledger without logging."""
    reg = _reg(wal_dir=str(tmp_path), fsync_every=1)
    idx = reg.register(_spec()).index
    g = idx.insert(_data(300, seed=1))
    frozen_n, frozen = idx._compact_freeze()
    idx.delete(g[:7])
    idx._compact_swap(frozen_n, idx._compact_build(frozen))
    ops = [r.op_name for r in read_wal(str(tmp_path / "t.wal"))[0]]
    assert ops == ["register", "insert", "compact", "delete"]
    assert idx.n_live == 293


def test_insert_rejects_nan_inf_and_width(tmp_path):
    """Garbage is refused before it reaches the WAL or any segment."""
    reg = _reg(wal_dir=str(tmp_path), fsync_every=1)
    sv = reg.register(_spec())
    sv.insert(_data(10, seed=1))
    bad = _data(4, seed=2)
    bad[1, 3] = np.nan
    with pytest.raises(ValueError, match="NaN/Inf"):
        sv.insert(bad)
    bad[1, 3] = np.inf
    with pytest.raises(ValueError, match="NaN/Inf"):
        sv.insert(bad)
    with pytest.raises(ValueError, match="shape"):
        sv.insert(_data(3, seed=3)[:, :N_DIMS - 2])
    assert sv.index.n_live == 10
    inserts = [r for r in read_wal(str(tmp_path / "t.wal"))[0]
               if r.op == wal.OP_INSERT]
    assert len(inserts) == 1 and inserts[0].gids.size == 10


def test_replay_matches_uninterrupted_run(tmp_path):
    """Fresh index + full replay == the index that wrote the log, bit for
    bit (same seed, so the same family)."""
    reg = _reg(wal_dir=str(tmp_path), fsync_every=4)
    sv = reg.register(_spec())
    g = sv.insert(_data(300, seed=1))
    sv.delete(g[::7])
    sv.index.maintenance.seal()
    sv.insert(_data(20, seed=2))
    q = _data(9, seed=3, scale=0.9)
    want = _answer(sv.index, q)

    sv2 = _reg().register(_spec())
    report = sv2.index.replay(str(tmp_path / "t.wal"))
    assert report["applied"] == report["n_records"]
    assert report["dropped_duplicates"] == 0
    _assert_bits(_answer(sv2.index, q), want)


def test_replay_drops_duplicate_gids(tmp_path):
    reg = _reg(wal_dir=str(tmp_path), fsync_every=1)
    sv = reg.register(_spec())
    g = sv.insert(_data(60, seed=1))
    sv.delete(g[:5])
    q = _data(5, seed=2, scale=0.9)
    want = _answer(sv.index, q)
    size = os.path.getsize(str(tmp_path / "t.wal"))
    report = sv.index.replay(str(tmp_path / "t.wal"))  # onto itself
    assert report["dropped_duplicates"] == 60
    _assert_bits(_answer(sv.index, q), want)
    # replay appends nothing to the attached log
    assert os.path.getsize(str(tmp_path / "t.wal")) == size


def test_set_replication_is_logged_kept_and_replayed(tmp_path):
    reg = _reg(wal_dir=str(tmp_path), fsync_every=1)
    idx = reg.register(_spec()).index
    idx._maint_set_replication([2, 1])
    assert idx.replication() == (2, 1)
    idx2 = _reg().register(_spec()).index
    idx2.replay(str(tmp_path / "t.wal"))
    assert idx2.replication() == (2, 1)


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------


def _ops(reg, spec_cls, precision="fp32"):
    """One workload through a registry of either package: returns its
    servable.  Inserts cross segment boundaries; deletes, an explicit
    seal, a compaction and a replication policy follow."""
    sv = reg.register(spec_cls(**_kw(precision=precision)))
    g = np.asarray(sv.insert(_data(200, seed=1)))
    sv.delete(g[::9])
    sv.index.maintenance.seal()
    g2 = np.asarray(sv.insert(_data(90, seed=2)))
    sv.delete(np.concatenate([g2[:4], [10_000]]))
    sv.index._maint_set_replication(2)     # the name both packages use
    sv.maintenance.compact()
    sv.insert(_data(30, seed=3))
    return sv


@pytest.mark.parametrize("precision", ["fp32", "int8"])
def test_same_operations_write_byte_identical_logs(tmp_path, precision):
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    _ops(JRegistry(wal_dir=str(jdir), fsync_every=3), JSpec, precision)
    _ops(_reg(wal_dir=str(tdir), fsync_every=3), ServableSpec, precision)
    jbytes = (jdir / "t.wal").read_bytes()
    tbytes = (tdir / "t.wal").read_bytes()
    assert len(tbytes) == len(jbytes) and tbytes == jbytes
    assert [r.op_name for r in read_wal(str(tdir / "t.wal"))[0]] == [
        "register", "insert", "delete", "seal", "insert", "delete",
        "set_replication", "compact", "insert"]


@pytest.mark.parametrize("placement", [
    {"replication": "static:2"}, {"replication": "auto"},
    {"shard_axis": "data"}], ids=["static", "auto", "shard-axis"])
def test_spec_refuses_placement_across_devices(tmp_path, placement):
    """The placement fields are the JAX package's: a shard axis and the
    ``static:k`` / ``auto`` policies are accepted, also from a REGISTER
    record or a manifest (as the JAX spec accepts them), and the REGISTER
    record carries them byte for byte; a malformed policy is refused, as
    the JAX spec refuses it."""
    from repro_torch.serve.registry import _spec_from_manifest
    spec = ServableSpec(name="t", n_dims=N_DIMS, **placement)
    jspec = JSpec(name="t", n_dims=N_DIMS, **placement)
    assert spec.replication_policy() == jspec.replication_policy()
    raw = dataclasses.asdict(ServableSpec(name="t", n_dims=N_DIMS))
    assert _spec_from_manifest(dict(raw, **placement)) == spec
    assert wal.encode_register(dataclasses.asdict(spec)) == \
        jwal.encode_register(dataclasses.asdict(jspec))
    for bad in ("static:0", "always"):
        with pytest.raises(ValueError, match="replication"):
            ServableSpec(name="t", n_dims=N_DIMS, replication=bad)
        with pytest.raises(ValueError, match="replication"):
            _spec_from_manifest(dict(raw, replication=bad))


def test_register_record_is_the_jax_packages():
    """The REGISTER record is ``asdict(spec)``: the port's spec has the JAX
    package's fields in its order."""
    j = [f.name for f in dataclasses.fields(JSpec)]
    t = [f.name for f in dataclasses.fields(ServableSpec)]
    assert t == j
    assert wal.encode_register(dataclasses.asdict(_spec())) == \
        jwal.encode_register(dataclasses.asdict(JSpec(**_kw())))


@pytest.mark.parametrize("precision", ["fp32", "int8"])
@pytest.mark.parametrize("n_probes", [1, 4])
def test_jax_log_replays_in_the_port(tmp_path, precision, n_probes):
    """A log the JAX package wrote (SET_REPLICATION included) replays into
    a port index built with the JAX tenant's family, to the JAX tenant's
    answers (ids where distances are distinct; distances rtol 1e-6, atol
    1e-6)."""
    jsv = _ops(JRegistry(wal_dir=str(tmp_path), fsync_every=2), JSpec,
               precision)
    fam = convert.family_from_numpy(*(np.asarray(a) for a in
                                      jsv.index.family), device="cpu")
    spec = _spec(precision=precision)
    idx = SegmentedIndex(spec.index_config(),
                         segment_capacity=spec.segment_capacity,
                         insert_chunk=spec.insert_chunk, family=fam,
                         precision=precision, device="cpu")
    rep = idx.replay(str(tmp_path / "t.wal"))
    assert rep["applied"] == rep["n_records"] == 9
    assert not rep["truncated"] and rep["dropped_duplicates"] == 0
    assert idx.n_live == jsv.index.n_live
    assert idx.replication() == 2
    q = _data(12, seed=5, scale=0.9)
    wi, wd = jsv.index.query(jnp.asarray(q), 10, n_probes=n_probes)
    _assert_parity(_answer(idx, q, n_probes=n_probes),
                   (np.asarray(wi), np.asarray(wd)))
    # live items and their rows are the JAX tenant's
    e_t, g_t = idx.live_items()
    e_j, g_j = jsv.index.live_items()
    order = np.argsort(g_t.numpy())
    np.testing.assert_array_equal(g_t.numpy()[order], np.sort(g_j))
    np.testing.assert_array_equal(e_t.numpy()[order],
                                  e_j[np.argsort(g_j)])


# ---------------------------------------------------------------------------
# registry recovery (in-process)
# ---------------------------------------------------------------------------


def _workload(reg):
    """Two tenants (p = 2 basis, p = 1 qmc) with churn; query sets."""
    refs = {}
    for i, (name, p, embedder) in enumerate(
            (("a", 2.0, "basis"), ("b", 1.0, "qmc"))):
        sv = reg.register(_spec(name=name, p=p, embedder=embedder))
        g = sv.insert(_data(200, seed=10 + i))
        sv.delete(g[::9])
        refs[name] = _data(7, seed=5, scale=0.9)
    return refs


def test_recover_snapshot_plus_tail_bit_identical(tmp_path):
    wal_dir, ckpt_dir = str(tmp_path / "wal"), str(tmp_path / "ckpt")
    reg = _reg(wal_dir=wal_dir, fsync_every=4)
    qs = _workload(reg)
    reg.snapshot(ckpt_dir, step=1)
    for name in reg.names():
        sv = reg.get(name)
        g2 = sv.insert(_data(30, seed=11))
        sv.delete(g2[:4])
    want = {n: _answer(reg.get(n).index, qs[n]) for n in reg.names()}

    reg2 = _reg(wal_dir=wal_dir, fsync_every=4)
    reports = reg2.recover(ckpt_root=ckpt_dir)
    assert sorted(reports) == ["a", "b"]
    for n, rep in reports.items():
        assert rep["restored_step"] == 1
        assert rep["applied"] == 2           # the tail: insert + delete
        _assert_bits(_answer(reg2.get(n).index, qs[n]), want[n])
        assert reg2.get(n).index.wal is not None


def test_recover_wal_only_rebuilds_from_register_record(tmp_path):
    wal_dir = str(tmp_path / "wal")
    reg = _reg(wal_dir=wal_dir, fsync_every=1)
    qs = _workload(reg)
    want = {n: _answer(reg.get(n).index, qs[n]) for n in reg.names()}
    reg2 = _reg()
    reports = reg2.recover(ckpt_root=str(tmp_path / "no-ckpt"),
                           wal_dir=wal_dir)
    for n, rep in reports.items():
        assert rep["restored_step"] is None
        _assert_bits(_answer(reg2.get(n).index, qs[n]), want[n])


def test_recover_replay_from_start_is_idempotent(tmp_path):
    wal_dir, ckpt_dir = str(tmp_path / "wal"), str(tmp_path / "ckpt")
    reg = _reg(wal_dir=wal_dir, fsync_every=1)
    qs = _workload(reg)
    reg.snapshot(ckpt_dir, step=1)
    want = {n: _answer(reg.get(n).index, qs[n]) for n in reg.names()}
    reg2 = _reg()
    reports = reg2.recover(ckpt_root=ckpt_dir, wal_dir=wal_dir,
                           replay_from="start")
    for n, rep in reports.items():
        assert rep["dropped_duplicates"] > 0    # snapshot overlap, dropped
        _assert_bits(_answer(reg2.get(n).index, qs[n]), want[n])
    with pytest.raises(ValueError, match="replay_from"):
        reg2.recover(ckpt_root=ckpt_dir, wal_dir=wal_dir, replay_from="huh")


def test_recover_truncates_torn_tail_before_reattach(tmp_path):
    wal_dir = str(tmp_path / "wal")
    sv = _reg(wal_dir=wal_dir, fsync_every=1).register(_spec())
    sv.insert(_data(50, seed=1))
    wpath = os.path.join(wal_dir, "t.wal")
    with open(wpath, "rb+") as f:
        f.truncate(os.path.getsize(wpath) - 5)   # torn tail

    reg2 = _reg(wal_dir=wal_dir, fsync_every=1)
    rep = reg2.recover()["t"]
    assert rep["truncated"] and rep["truncated_to"] == rep["end_offset"]
    assert os.path.getsize(wpath) == rep["end_offset"]
    reg2.get("t").insert(_data(10, seed=2))
    assert not read_wal(wpath)[1]["truncated"]


def test_recover_falls_back_past_corrupt_checkpoint(tmp_path):
    wal_dir, ckpt_dir = str(tmp_path / "wal"), str(tmp_path / "ckpt")
    reg = _reg(wal_dir=wal_dir, fsync_every=1)
    sv = reg.register(_spec())
    g = sv.insert(_data(100, seed=1))
    reg.snapshot(ckpt_dir, step=1)
    sv.delete(g[:10])
    sv.insert(_data(30, seed=2))
    reg.snapshot(ckpt_dir, step=2)
    q = _data(6, seed=3, scale=0.9)
    want = _answer(sv.index, q)
    npz = os.path.join(ckpt_dir, "t", f"step_{2:010d}", "arrays.npz")
    with open(npz, "rb+") as f:
        f.seek(os.path.getsize(npz) // 2)
        b = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([b[0] ^ 0xFF]))

    reg2 = _reg()
    rep = reg2.recover(ckpt_root=ckpt_dir, wal_dir=wal_dir)["t"]
    assert rep["restored_step"] == 1
    assert [s for s, _ in rep["corrupt_steps"]] == [2]
    assert "corrupt checkpoint" in rep["corrupt_steps"][0][1]
    _assert_bits(_answer(reg2.get("t").index, q), want)


def test_recover_skips_a_cleanly_unloaded_tenant(tmp_path):
    wal_dir = str(tmp_path / "wal")
    reg = _reg(wal_dir=wal_dir, fsync_every=1)
    for name in ("keep", "gone"):
        reg.register(_spec(name=name)).insert(_data(20, seed=1))
    w = reg.get("gone").index.wal
    w.append(wal.encode_lifecycle("unloaded"))
    w.sync()
    reports = _reg().recover(wal_dir=wal_dir)
    assert reports["gone"]["skipped"] == "unloaded"
    assert "skipped" not in reports["keep"]


def test_register_record_written_at_register_time(tmp_path):
    _reg(wal_dir=str(tmp_path), fsync_every=0).register(
        _spec(embedder="qmc", p=1.0))
    raw = wal.read_spec(str(tmp_path / "t.wal"))
    assert raw["name"] == "t" and raw["embedder"] == "qmc"
    assert wal.read_last_lifecycle(str(tmp_path / "t.wal")) is None
    assert wal.read_last_lifecycle(str(tmp_path / "nope.wal")) is None


def test_store_dtype_env_is_resolved_once_at_register(tmp_path,
                                                      monkeypatch):
    """``$REPRO_STORE_DTYPE`` wins over the spec at registration; the
    resolved tier rides the REGISTER record, and recovery with the
    variable gone rebuilds that tier."""
    from repro_torch.kernels import dispatch
    monkeypatch.setenv("REPRO_STORE_DTYPE", "int8")
    assert dispatch.store_dtype("bf16") == "int8"
    reg = _reg(wal_dir=str(tmp_path), fsync_every=1)
    sv = reg.register(_spec())
    assert sv.spec.precision == "int8" and sv.index.precision == "int8"
    sv.insert(_data(200, seed=1))
    assert wal.read_spec(str(tmp_path / "t.wal"))["precision"] == "int8"
    monkeypatch.setenv("REPRO_STORE_DTYPE", "fp8")
    with pytest.raises(ValueError, match="store dtype"):
        dispatch.store_dtype()
    monkeypatch.delenv("REPRO_STORE_DTYPE")
    assert dispatch.store_dtype() == "fp32"
    assert dispatch.store_dtype("bf16") == "bf16"
    reg2 = _reg()
    reg2.recover(wal_dir=str(tmp_path))
    assert reg2.get("t").index.precision == "int8"
    q = _data(5, seed=2, scale=0.9)
    _assert_bits(_answer(reg2.get("t").index, q), _answer(sv.index, q))


# ---------------------------------------------------------------------------
# fault plan (raise action; kill runs in subprocess tests)
# ---------------------------------------------------------------------------


def test_fault_plan_raises_at_nth_event(tmp_path):
    faults.install(faults.FaultPlan(
        faults.FaultSpec("wal.append", nth=3, action="raise")))
    w = wal.WriteAheadLog(str(tmp_path / "t.wal"), fsync_every=0)
    w.append(wal.encode_seal())
    w.append(wal.encode_seal())
    with pytest.raises(InjectedFault, match="wal.append"):
        w.append(wal.encode_seal())
    w.close()
    assert faults.active_plan().fired == ["wal.append"]
    records, report = read_wal(str(tmp_path / "t.wal"))
    assert len(records) == 2 and report["truncated"]


@pytest.mark.parametrize("site", ["seal", "compact.freeze", "compact.swap"])
def test_fault_sites_in_the_index_fire_after_logging(tmp_path, site):
    """A raise at a maintenance site leaves the record in the log and the
    index as it was; a replay of the log applies the operation."""
    reg = _reg(wal_dir=str(tmp_path), fsync_every=1)
    idx = reg.register(_spec()).index
    g = idx.insert(_data(150, seed=1))
    idx.delete(g[:20])
    n_seg = len(idx.segments)
    faults.install(faults.FaultPlan(faults.FaultSpec(site, 1, "raise")))
    with pytest.raises(InjectedFault):
        if site == "seal":
            idx.maintenance.seal()
        else:
            idx.maintenance.compact()
    faults.clear()
    ops = [r.op_name for r in read_wal(str(tmp_path / "t.wal"))[0]]
    assert ops[-1] == ("seal" if site == "seal" else "compact")
    if site != "compact.swap":
        assert len(idx.segments) == n_seg     # nothing applied
    idx2 = _reg().register(_spec()).index
    idx2.replay(str(tmp_path / "t.wal"))
    assert idx2.n_live == 130
    assert idx2.n_items == (130 if site != "seal" else 150)


def test_fault_plan_from_env(monkeypatch):
    monkeypatch.setenv("REPRO_FAULTS", "wal.fsync:2:kill, seal:1:raise")
    plan = faults.FaultPlan.from_env()
    assert plan.specs["wal.fsync"].nth == 2
    assert plan.specs["wal.fsync"].action == "kill"
    assert plan.specs["seal"].action == "raise"
    assert faults.install_from_env() is faults.active_plan()
    monkeypatch.delenv("REPRO_FAULTS")
    assert faults.FaultPlan.from_env() is None
    with pytest.raises(ValueError):
        faults.FaultSpec("x", nth=0, action="raise")
    with pytest.raises(ValueError):
        faults.FaultSpec("x", nth=1, action="explode")
    with pytest.raises(ValueError):
        faults.FaultPlan(("x", 1), ("x", 2))
    with pytest.raises(ValueError):
        faults.FaultPlan.from_env("x:1:kill:extra")


# ---------------------------------------------------------------------------
# the launcher's durability flags
# ---------------------------------------------------------------------------


def test_launcher_wal_snapshot_restore_and_recover(tmp_path, capsys):
    """``--wal-dir`` + ``--snapshot``, then ``--restore`` + ``--wal-dir``
    (crash recovery) and ``--restore`` alone; what a run logged recovers
    to the bits of a fresh replay of its whole log."""
    from repro_torch.launch import serve as tserve
    from repro_torch.serve.registry import _spec_from_manifest
    w, s = str(tmp_path / "wal"), str(tmp_path / "snap")
    common = ["--device", "cpu", "--tenants", "l2-basis,l1-qmc",
              "--n-dims", "16", "--segment-capacity", "128",
              "--recall-probe-size", "8", "--fsync-every", "2"]
    tserve.main(common + ["--n-items", "300", "--steps", "2",
                          "--wal-dir", w, "--snapshot", s])
    out = capsys.readouterr().out
    assert "[serve] snapshot -> " in out and "[serve] wal l1-qmc: " in out
    tserve.main(common + ["--n-items", "0", "--steps", "3",
                          "--wal-dir", w, "--restore", s])
    out = capsys.readouterr().out
    assert "[serve] recovered l2-basis: step=2 replayed=0" in out
    assert "[serve] OK" in out

    reg = _reg()
    reports = reg.recover(ckpt_root=s, wal_dir=w)
    q = _data(6, seed=4)
    for name in ("l1-qmc", "l2-basis"):
        assert reports[name]["restored_step"] == 2
        assert reports[name]["applied"] > 0          # the second run's
        wpath = os.path.join(w, f"{name}.wal")
        ref = _reg().register(_spec_from_manifest(wal.read_spec(wpath)))
        ref.index.replay(wpath)
        _assert_bits(_answer(reg.get(name).index, q),
                     _answer(ref.index, q))

    tserve.main(common + ["--n-items", "0", "--steps", "1",
                          "--restore", s])
    assert "[serve] restored tenants ['l1-qmc', 'l2-basis']" in \
        capsys.readouterr().out
