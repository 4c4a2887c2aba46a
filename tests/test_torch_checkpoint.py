"""The port's checkpoints and snapshots against the JAX package's, on the CPU.

Mirrors ``tests/test_checkpoint.py`` for ``repro_torch.checkpoint`` (the
``extra`` manifest, atomicity, checksums, keep-last-k GC, the background
save) and holds the port to the JAX package's on-disk layout:

* a snapshot the JAX package wrote restores in the port, at fp32 and int8,
  to the JAX tenant's answers: ids equal wherever the JAX distances are
  distinct, distances allclose with ``rtol=1e-6, atol=1e-6`` (ROADMAP's
  parity contract), and the restored items and rows equal the JAX
  tenant's;
* a snapshot the port wrote after the same operations (the JAX tenant's
  family injected) has the JAX snapshot's keys, files, shapes, dtypes and
  crc32s, and ``repro.checkpoint.checkpoint.restore`` reads it;
* within the port, snapshot + restore answers bit for bit, and bf16
  tensors round-trip through their raw ``uint16`` bits.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import checkpoint as jckpt  # noqa: E402
from repro.serve import ServableRegistry as JRegistry  # noqa: E402
from repro.serve import ServableSpec as JSpec  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import checkpoint as ckpt  # noqa: E402
from repro_torch.checkpoint.checkpoint import ArraySpec  # noqa: E402
from repro_torch.serve import (ServableRegistry, ServableSpec,  # noqa: E402
                               faults)

N_DIMS = 16


def _tree():
    return {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3)}


def _target():
    return {"w": ArraySpec((2, 3), torch.float32)}


def _kw(name="t", **kw):
    base = dict(name=name, n_dims=N_DIMS, r=2.0, log2_buckets=8,
                bucket_capacity=64, segment_capacity=128, insert_chunk=64,
                chunk_sizes=(8, 32))
    base.update(kw)
    return base


def _data(n, seed=0, scale=1.0):
    return (np.random.default_rng(seed).normal(size=(n, N_DIMS)) *
            scale).astype(np.float32)


def _answer(index, q, k=10, n_probes=4):
    g, d = index.query(q, k, n_probes=n_probes)
    return np.asarray(g), np.asarray(d)


def _assert_parity(got, want):
    """ids equal where the reference distances are distinct, distances
    allclose (rtol 1e-6, atol 1e-6)."""
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6, atol=1e-6)
    for r in range(want[0].shape[0]):
        vals, counts = np.unique(want[1][r], return_counts=True)
        distinct = np.isin(want[1][r], vals[counts == 1])
        np.testing.assert_array_equal(got[0][r][distinct],
                                      want[0][r][distinct])


@pytest.fixture(autouse=True)
def _clean_state():
    """No fault plan in or out; the background save joined and dead."""
    faults.clear()
    yield
    faults.clear()
    ckpt.wait(timeout=30)
    assert ckpt._save_thread is None or not ckpt._save_thread.is_alive()


# ---------------------------------------------------------------------------
# the checkpoint layer
# ---------------------------------------------------------------------------


def test_extra_nested_dicts_round_trip(tmp_path):
    extra = {"spec": {"name": "t", "embedder_params": {"clip": 0.01,
                                                       "sequence": "sobol"},
                      "chunk_sizes": [8, 32]},
             "segments": [{"n_items": 3, "nested": {"deep": [1, 2, 3]}}],
             "empty": {}, "none": None}
    ckpt.save(str(tmp_path), 1, _tree(), extra=extra)
    got = ckpt.load_extra(str(tmp_path), 1)
    assert got == json.loads(json.dumps(extra))
    assert got["spec"]["embedder_params"]["clip"] == 0.01


def test_extra_absent_and_empty(tmp_path):
    ckpt.save(os.path.join(tmp_path, "a"), 1, _tree())
    assert ckpt.load_extra(os.path.join(tmp_path, "a"), 1) == {}
    ckpt.save(os.path.join(tmp_path, "b"), 2, _tree(), extra={})
    assert ckpt.load_extra(os.path.join(tmp_path, "b"), 2) == {}
    out = ckpt.restore(os.path.join(tmp_path, "a"), 1, _target(),
                       device="cpu")
    assert torch.equal(out["w"], _tree()["w"])


def test_nested_tree_keys_dtypes_and_round_trip(tmp_path):
    """Keys are the dict key or list index joined by '/'; files follow the
    keys' sorted order; every dtype the serve layer stores round-trips,
    bf16 through its raw uint16 bits, and the JAX package reads it all."""
    bf = torch.tensor([1.5, -2.0, 3.25, 0.0], dtype=torch.bfloat16)
    tree = {"segments": [{"state": [torch.ones(2, 3), torch.zeros(4)],
                          "live": torch.tensor([True, False]),
                          "codes": torch.tensor([[-3, 7]], dtype=torch.int8),
                          "bf": bf,
                          "mix": np.array([[1, 2 ** 32 - 1]], np.uint32),
                          "scale": torch.tensor(0.5)}
                         for _ in range(11)]}
    ckpt.save(str(tmp_path), 3, tree)
    manifest = json.load(open(tmp_path / f"step_{3:010d}" / "manifest.json"))
    keys = sorted(manifest["keys"])
    assert [manifest["keys"][k]["file"] for k in keys] == [
        f"a{i}" for i in range(len(keys))]
    assert "segments/10/state/1" in keys and "segments/0/scale" in keys
    meta = manifest["keys"]["segments/2/bf"]
    assert meta["dtype"] == "bfloat16" and meta["shape"] == [4]
    assert manifest["keys"]["segments/0/mix"]["dtype"] == "uint32"

    target = {"segments": [{
        "state": [ArraySpec((2, 3), torch.float32),
                  ArraySpec((4,), torch.float32)],
        "live": ArraySpec((2,), torch.bool),
        "codes": ArraySpec((1, 2), torch.int8),
        "bf": ArraySpec((4,), torch.bfloat16),
        "mix": ArraySpec((1, 2), torch.uint32),
        "scale": ArraySpec((), torch.float32)} for _ in range(11)]}
    out = ckpt.restore(str(tmp_path), 3, target, device="cpu")
    seg = out["segments"][10]
    assert torch.equal(seg["bf"].view(torch.int16), bf.view(torch.int16))
    assert seg["codes"].dtype == torch.int8
    assert seg["live"].tolist() == [True, False]
    assert seg["mix"].to(torch.int64).tolist() == [[1, 2 ** 32 - 1]]
    assert float(seg["scale"]) == 0.5
    assert isinstance(seg["state"], list)

    # the JAX package restores the port's file, bf16 as ml_dtypes bf16
    jtarget = {"segments": [{
        "state": [jax.ShapeDtypeStruct((2, 3), jnp.float32),
                  jax.ShapeDtypeStruct((4,), jnp.float32)],
        "live": jax.ShapeDtypeStruct((2,), jnp.bool_),
        "codes": jax.ShapeDtypeStruct((1, 2), jnp.int8),
        "bf": jax.ShapeDtypeStruct((4,), jnp.bfloat16),
        "mix": jax.ShapeDtypeStruct((1, 2), jnp.uint32),
        "scale": jax.ShapeDtypeStruct((), jnp.float32)} for _ in range(11)]}
    jout = jckpt.restore(str(tmp_path), 3, jtarget)
    np.testing.assert_array_equal(
        np.asarray(jout["segments"][10]["bf"], np.float32),
        [1.5, -2.0, 3.25, 0.0])


@pytest.mark.parametrize("bad", ["shape", "dtype", "missing"])
def test_restore_checks_shape_dtype_and_keys(tmp_path, bad):
    ckpt.save(str(tmp_path), 1, _tree())
    target = {"shape": {"w": ArraySpec((3, 2), torch.float32)},
              "dtype": {"w": ArraySpec((2, 3), torch.float64)},
              "missing": {"w": ArraySpec((2, 3), torch.float32),
                          "extra_leaf": ArraySpec((2,), torch.float32)},
              }[bad]
    err = KeyError if bad == "missing" else ValueError
    with pytest.raises(err, match={"shape": "shape mismatch",
                                   "dtype": "dtype mismatch",
                                   "missing": "missing key"}[bad]):
        ckpt.restore(str(tmp_path), 1, target, device="cpu")


def test_restore_target_may_hold_tensors(tmp_path):
    ckpt.save(str(tmp_path), 1, _tree())
    out = ckpt.restore(str(tmp_path), 1, {"w": torch.zeros(2, 3)},
                       device="cpu")
    assert torch.equal(out["w"], _tree()["w"])


def _corrupt(path):
    with open(path, "rb+") as f:
        f.seek(os.path.getsize(path) // 2)
        b = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([b[0] ^ 0xFF]))


def test_partial_save_invisible_to_latest_step(tmp_path):
    ckpt.save(str(tmp_path), 1, _tree())
    os.makedirs(tmp_path / "tmp-5")                 # crashed mid-write
    os.makedirs(tmp_path / f"step_{7:010d}")        # no manifest at all
    mangled = tmp_path / f"step_{9:010d}"
    os.makedirs(mangled)
    (mangled / "manifest.json").write_text("{not json")
    assert ckpt.latest_step(str(tmp_path)) == 1
    assert ckpt.steps(str(tmp_path)) == [1, 7, 9]
    assert ckpt.latest_step(str(tmp_path / "nope")) is None
    assert ckpt.steps(str(tmp_path / "nope")) == []


def test_corrupt_array_raises_naming_file(tmp_path):
    ckpt.save(str(tmp_path), 1, _tree())
    npz = os.path.join(tmp_path, f"step_{1:010d}", "arrays.npz")
    _corrupt(npz)
    with pytest.raises(ckpt.CheckpointCorruptError) as ei:
        ckpt.restore(str(tmp_path), 1, _target(), device="cpu")
    assert npz in str(ei.value) and ei.value.path == npz
    with pytest.raises(ckpt.CheckpointCorruptError):
        ckpt.verify(str(tmp_path), 1)
    assert ckpt.verify(str(tmp_path), 1, deep=False)["step"] == 1


def test_missing_array_container(tmp_path):
    ckpt.save(str(tmp_path), 1, _tree())
    os.remove(os.path.join(tmp_path, f"step_{1:010d}", "arrays.npz"))
    with pytest.raises(ckpt.CheckpointCorruptError, match="missing"):
        ckpt.verify(str(tmp_path), 1, deep=False)


def test_corrupt_manifest_raises_naming_file(tmp_path):
    ckpt.save(str(tmp_path), 2, _tree())
    mpath = os.path.join(tmp_path, f"step_{2:010d}", "manifest.json")
    with open(mpath) as f:
        manifest = json.load(f)
    manifest["keys"]["w"]["shape"] = [999, 999]     # tamper -> crc mismatch
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    with pytest.raises(ckpt.CheckpointCorruptError, match="crc"):
        ckpt.load_extra(str(tmp_path), 2)
    assert ckpt.latest_step(str(tmp_path)) is None


def test_pre_checksum_checkpoints_still_load(tmp_path):
    ckpt.save(str(tmp_path), 1, _tree())
    mpath = os.path.join(tmp_path, f"step_{1:010d}", "manifest.json")
    with open(mpath) as f:
        manifest = json.load(f)
    manifest.pop("manifest_crc32")
    for meta in manifest["keys"].values():
        meta.pop("crc32")
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    out = ckpt.restore(str(tmp_path), 1, _target(), device="cpu")
    assert torch.equal(out["w"], _tree()["w"])


def test_gc_keeps_last_k_in_order(tmp_path):
    for s in range(1, 7):
        ckpt.save(str(tmp_path), s, _tree(), keep=3)
    assert ckpt.steps(str(tmp_path)) == [4, 5, 6]
    assert ckpt.latest_step(str(tmp_path)) == 6


def test_gc_never_deletes_last_verifiable(tmp_path):
    for s in (1, 2, 3):
        ckpt.save(str(tmp_path), s, _tree(), keep=10)
    for s in (2, 3):
        (tmp_path / f"step_{s:010d}" / "manifest.json").write_text("{broken")
    ckpt.save(str(tmp_path), 4, _tree(), keep=10)
    (tmp_path / f"step_{4:010d}" / "manifest.json").write_text("{broken")
    ckpt._gc(str(tmp_path), keep=2)                 # kept window = {3, 4}
    assert 1 in ckpt.steps(str(tmp_path))
    assert ckpt.latest_step(str(tmp_path)) == 1
    out = ckpt.restore(str(tmp_path), 1, _target(), device="cpu")
    assert torch.equal(out["w"], _tree()["w"])


def test_save_async_copies_now_and_wait_joins(tmp_path):
    """save_async copies the tree at the call (a later in-place write does
    not reach the file); wait() joins; the thread ends dead."""
    tree = {"w": torch.arange(8, dtype=torch.float32)}
    t1 = ckpt.save_async(str(tmp_path), 1, tree, extra={"tag": "a"})
    tree["w"][0] = 100.0
    t2 = ckpt.save_async(str(tmp_path), 2, tree, extra={"tag": "b"})
    assert not t1.is_alive()                  # the second joined the first
    ckpt.wait(timeout=30)
    ckpt.wait(timeout=30)                     # idempotent
    assert not t2.is_alive()
    assert ckpt.steps(str(tmp_path)) == [1, 2]
    assert ckpt.load_extra(str(tmp_path), 1) == {"tag": "a"}
    assert ckpt.load_extra(str(tmp_path), 2) == {"tag": "b"}
    target = {"w": ArraySpec((8,), torch.float32)}
    for s, first in ((1, 0.0), (2, 100.0)):
        ckpt.verify(str(tmp_path), s)
        out = ckpt.restore(str(tmp_path), s, target, device="cpu")
        assert float(out["w"][0]) == first


def test_resave_same_step_never_leaves_gap(tmp_path):
    ckpt.save(str(tmp_path), 1, {"w": torch.zeros(4)})
    ckpt.save(str(tmp_path), 1, {"w": torch.ones(4)})
    assert sorted(os.listdir(tmp_path)) == [f"step_{1:010d}"]
    out = ckpt.restore(str(tmp_path), 1, {"w": ArraySpec((4,),
                                                         torch.float32)},
                       device="cpu")
    assert torch.equal(out["w"], torch.ones(4))


def test_ckpt_rename_fault_leaves_no_new_step(tmp_path):
    """A raise at ``ckpt.rename``: the temp dir is written, the step is
    not there, the older step still restores."""
    ckpt.save(str(tmp_path), 1, _tree())
    faults.install(faults.FaultPlan(faults.FaultSpec("ckpt.rename", 1)))
    with pytest.raises(faults.InjectedFault):
        ckpt.save(str(tmp_path), 2, {"w": torch.ones(2, 3)})
    assert ckpt.steps(str(tmp_path)) == [1]
    assert os.path.isdir(tmp_path / "tmp-2")
    assert ckpt.latest_step(str(tmp_path)) == 1


# ---------------------------------------------------------------------------
# serve-layer snapshots, against the JAX package
# ---------------------------------------------------------------------------


def _fill(sv):
    """The same operations through either package's servable."""
    g = np.asarray(sv.insert(_data(300, seed=1)))
    sv.delete(g[::7])
    sv.index.maintenance.seal()
    sv.insert(_data(50, seed=2))
    sv.delete(g[1:40:3])
    return sv


@pytest.mark.parametrize("precision", ["fp32", "int8"])
def test_jax_snapshot_restores_in_the_port(tmp_path, precision):
    jreg = JRegistry()
    jsv = _fill(jreg.register(JSpec(**_kw(precision=precision))))
    jreg.snapshot(str(tmp_path), step=4)

    reg = ServableRegistry(device="cpu")
    assert reg.restore(str(tmp_path)) == ["t"]
    sv = reg.get("t")
    assert sv.spec.precision == precision
    idx = sv.index
    assert idx.n_live == jsv.index.n_live and idx._next_gid == 350
    assert [s.sealed for s in idx.segments] == [
        s.sealed for s in jsv.index.segments]
    # the family is segment 0's, the JAX tenant's
    for got, want in zip(idx.family, jsv.index.family):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for n_probes in (1, 4):
        q = _data(12, seed=5, scale=0.9)
        wi, wd = jsv.index.query(jnp.asarray(q), 10, n_probes=n_probes)
        _assert_parity(_answer(idx, q, n_probes=n_probes),
                       (np.asarray(wi), np.asarray(wd)))
    e_t, g_t = idx.live_items()
    e_j, g_j = jsv.index.live_items()
    np.testing.assert_array_equal(g_t.numpy(), g_j)
    np.testing.assert_array_equal(e_t.numpy(), e_j)
    # the restored tenant keeps taking writes and seals
    sv.insert(_data(200, seed=9))
    assert idx.n_live == jsv.index.n_live + 200


@pytest.mark.parametrize("precision", ["fp32", "int8"])
def test_port_snapshot_is_the_jax_packages(tmp_path, precision):
    """After the same operations on the same family, the port's snapshot
    has the JAX snapshot's keys, files, shapes, dtypes and crc32s, and the
    JAX package restores it to the JAX tenant's answers."""
    jreg = JRegistry()
    jsv = _fill(jreg.register(JSpec(**_kw(precision=precision))))
    jreg.snapshot(str(tmp_path / "jax"), step=1)
    fam = convert.family_from_numpy(
        *(np.asarray(a) for a in jsv.index.family), device="cpu")
    reg = ServableRegistry(device="cpu")
    _fill(reg.register(ServableSpec(**_kw(precision=precision)), family=fam))
    reg.snapshot(str(tmp_path / "port"), step=1)

    def manifest(root):
        with open(os.path.join(root, "t", f"step_{1:010d}",
                               "manifest.json")) as f:
            return json.load(f)
    mj, mt = manifest(tmp_path / "jax"), manifest(tmp_path / "port")
    assert mt["keys"] == mj["keys"]
    assert mt["extra"] == mj["extra"]
    assert mt["manifest_crc32"] == mj["manifest_crc32"]

    jreg2 = JRegistry()
    assert jreg2.restore(str(tmp_path / "port")) == ["t"]
    q = _data(9, seed=6, scale=0.9)
    wi, wd = jsv.index.query(jnp.asarray(q), 10, n_probes=4)
    gi, gd = jreg2.get("t").index.query(jnp.asarray(q), 10, n_probes=4)
    np.testing.assert_array_equal(np.asarray(gi), np.asarray(wi))
    np.testing.assert_array_equal(np.asarray(gd), np.asarray(wd))


@pytest.mark.parametrize("precision", ["fp32", "bf16", "int8"])
def test_port_snapshot_restore_bit_identical(tmp_path, precision):
    reg = ServableRegistry(device="cpu")
    sv = _fill(reg.register(ServableSpec(**_kw(precision=precision))))
    reg.snapshot(str(tmp_path), step=2)
    reg2 = ServableRegistry(device="cpu")
    reg2.restore(str(tmp_path))
    q = _data(9, seed=6, scale=0.9)
    want = _answer(sv.index, q)
    got = _answer(reg2.get("t").index, q)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1].view(np.uint32),
                                  want[1].view(np.uint32))
    lay, lay2 = sv.index.layout(), reg2.get("t").index.layout()
    assert lay2["n_sealed"] == lay["n_sealed"]
    assert lay2["db_dtype"] == lay["db_dtype"]


def test_restore_tolerates_unknown_spec_keys(tmp_path):
    reg = ServableRegistry(device="cpu")
    reg.register(ServableSpec(**_kw())).insert(_data(50, seed=1))
    reg.snapshot(str(tmp_path), step=3)
    mpath = os.path.join(tmp_path, "t", f"step_{3:010d}", "manifest.json")
    with open(mpath) as f:
        manifest = json.load(f)
    manifest["extra"]["spec"]["future_knob"] = {"nested": True}
    manifest["extra"]["totally_new_section"] = [1, 2]
    manifest["manifest_crc32"] = ckpt._manifest_crc(manifest)
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    reg2 = ServableRegistry(device="cpu")
    assert reg2.restore(str(tmp_path)) == ["t"]
    assert not hasattr(reg2.get("t").spec, "future_knob")
    ids, _ = reg2.get("t").index.query(_data(4, seed=1)[:4], 3)
    assert ids[:, 0].tolist() == [0, 1, 2, 3]


def test_corrupt_snapshot_leaves_no_half_built_tenant(tmp_path):
    reg = ServableRegistry(device="cpu")
    reg.register(ServableSpec(**_kw())).insert(_data(50, seed=1))
    reg.snapshot(str(tmp_path), step=1)
    _corrupt(os.path.join(tmp_path, "t", f"step_{1:010d}", "arrays.npz"))
    reg2 = ServableRegistry(device="cpu")
    with pytest.raises(ckpt.CheckpointCorruptError):
        reg2.restore(str(tmp_path))
    assert reg2.names() == []


def test_int8_scale_bits_equal_the_jax_packages():
    """The int8 scale is the JAX package's, bit for bit, over 500 random
    segments of magnitudes 1e-6 to 1e4 (a true division by 127 differs
    from it by one ulp in ~4% of them: XLA multiplies by f32(1/127)); the
    codes are equal too.  Snapshots of the same items then carry the same
    bytes."""
    from repro.kernels import quantize as jq
    from repro_torch.kernels import quantize as tq
    rng = np.random.default_rng(7)
    for _ in range(500):
        x = (rng.normal(size=(64, 8)) *
             10 ** rng.uniform(-6, 4)).astype(np.float32)
        cj, sj = jq.encode(jnp.asarray(x), "int8")
        ct, st = tq.encode(torch.as_tensor(x), "int8")
        assert np.asarray(sj).view(np.uint32) == st.numpy().view(np.uint32)
        np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
