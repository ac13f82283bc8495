"""The port's Orbax checkpoint reader against the libraries and the JAX
package, on the CPU.

* ``utils/zstd``: every frame ``zstandard`` writes (random, repetitive
  and all-zero inputs at levels 1, 3 and 19, with and without a
  checksum; streams of many blocks, several frames, skippable frames;
  a corpus that reaches every literals and sequences mode), every frame
  of one checkpoint, xxHash64's known values, and damaged frames, which
  raise;
* ``utils/ocdbt``: ``list``/``read`` against tensorstore on every
  checkpoint in ``pretrained/`` and on stores tensorstore writes here
  (B-trees of several levels, values on both sides of the inline limit,
  zstd on and off, more versions than the manifest holds);
* ``utils/zarr``: arrays tensorstore writes (C and F order, ``.`` and
  ``/`` separators, edge and missing chunks, fill values, the three
  dtypes, scalars); unknown dtypes and compressors raise;
* ``train/checkpoint``: all 112 shipped step directories read bit for
  bit as the JAX ``Trainer.restore`` gives them (params, Adam's moments
  and count, the step), the port's ``Trainer.restore`` on each family's
  latest step, a ``best/`` and an ``ema/``; a flipped byte and a
  truncated manifest raise;
* what uses it: a v1 dock with Orbax-restored weights against the JAX
  pipeline, ``cli train --resume`` and ``train_flagship`` resuming a JAX
  run directory at its step, ``coupling_spectrum`` line for line against
  ``tools/coupling_spectrum.py``; and the small helpers ported with it
  (``splat``, ``default_origin``, ``geodesic_angle``, ``translate``,
  ``center_of_mass``, ``bounding_box``, ``DockResult``).
"""
import collections
import glob
import importlib.util
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from torch_parity import ROOT, np_, t_

from deeplocalproteindocking_torch.train import checkpoint
from deeplocalproteindocking_torch.utils import zstd
from deeplocalproteindocking_torch.utils.ocdbt import OcdbtError, OcdbtStore
from deeplocalproteindocking_torch.utils.zarr import ZarrError, read_array

PRETRAINED = os.path.join(ROOT, "pretrained")
STEP_DIRS = sorted(glob.glob(os.path.join(PRETRAINED, "**", "step_*"),
                             recursive=True))
V9P_BEST_STEP = os.path.join(PRETRAINED, "synthetic-v9p", "best",
                             "step_00000500")


def _rel(path):
    return os.path.relpath(path, PRETRAINED)


def test_every_shipped_checkpoint_is_listed():
    assert len(STEP_DIRS) == 112
    assert all(checkpoint.is_orbax_step(d) for d in STEP_DIRS)


# ------------------------------------------------------------------- zstd

def _inputs():
    rng = np.random.default_rng(0)
    words = [bytes(rng.integers(97, 123, rng.integers(1, 9), dtype=np.uint8))
             for _ in range(300)]
    return {
        "random": rng.integers(0, 256, 60000, dtype=np.uint8).tobytes(),
        "repetitive": b" ".join(words[i]
                                for i in rng.integers(0, 300, 12000)),
        "zeros": bytes(70000),
    }


INPUTS = _inputs()


@pytest.mark.parametrize("checksum", [False, True])
@pytest.mark.parametrize("level", [1, 3, 19])
@pytest.mark.parametrize("name", sorted(INPUTS))
def test_zstd_matches_zstandard(name, level, checksum):
    zstandard = pytest.importorskip("zstandard")
    data = INPUTS[name]
    frame = zstandard.ZstdCompressor(level=level,
                                     write_checksum=checksum).compress(data)
    assert zstd.decompress(frame) == data


def test_zstd_blocks_frames_and_skippable_frames():
    zstandard = pytest.importorskip("zstandard")
    data = INPUTS["repetitive"] + INPUTS["random"][:20000]
    # A stream with no content size, cut into many blocks.
    co = zstandard.ZstdCompressor(level=3, write_content_size=False,
                                  write_checksum=True).compressobj()
    stream = b"".join(co.compress(data[i:i + 7000])
                      + co.flush(zstandard.COMPRESSOBJ_FLUSH_BLOCK)
                      for i in range(0, len(data), 7000)) + co.flush()
    assert zstd.decompress(stream) == data
    small = zstandard.ZstdCompressor(level=1).compress(b"xyz" * 1000)
    empty = zstandard.ZstdCompressor(level=1).compress(b"")
    skip = (0x184D2A53).to_bytes(4, "little") + (5).to_bytes(4, "little") \
        + b"12345"
    assert zstd.decompress(stream + skip + small + empty + stream) == (
        data + b"xyz" * 1000 + data)
    assert zstd.decompress(empty) == b""


def _mode_corpus():
    """Frames that reach every literals and sequences mode."""
    zstandard = pytest.importorskip("zstandard")
    rng = np.random.default_rng(1)
    words = [bytes(rng.integers(97, 123, rng.integers(1, 9), dtype=np.uint8))
             for _ in range(300)]
    segs = [rng.integers(0, 256, 40, dtype=np.uint8).tobytes()
            for _ in range(20)]
    head = b"".join(segs)
    body = b"".join(segs[i] + b"\x07" * int(k) for i, k in zip(
        rng.integers(0, 20, 3000), rng.integers(1, 4, 3000)))
    texts = [b" ".join(words[i] for i in rng.integers(0, 300, 20000)),
             bytes(30000), b"abcabcabdabcabc" * 3,
             rng.geometric(0.3, 60000).clip(0, 255).astype(np.uint8)
             .tobytes(),
             np.round(rng.standard_normal(30000), 2).astype(np.float32)
             .tobytes(),
             rng.integers(0, 256, 50000, dtype=np.uint8).tobytes()]
    for lvl in (1, 3, 19):
        for data in texts:
            yield data, zstandard.ZstdCompressor(level=lvl).compress(data)
            co = zstandard.ZstdCompressor(level=lvl).compressobj()
            yield data, b"".join(
                co.compress(data[i:i + 3000])
                + co.flush(zstandard.COMPRESSOBJ_FLUSH_BLOCK)
                for i in range(0, len(data), 3000)) + co.flush()
        co = zstandard.ZstdCompressor(level=lvl).compressobj()
        yield head + body, (co.compress(head)
                            + co.flush(zstandard.COMPRESSOBJ_FLUSH_BLOCK)
                            + co.compress(body) + co.flush())
    # Built by hand: raw literals "abcdef", then two sequences whose three
    # codes are RLE tables (3 literals, repeat offset 1, match of 5).
    frame = (bytes.fromhex("28b52ffd2010") + bytes([0x6D, 0, 0, 0x30])
             + b"abcdef" + bytes([2, 0x54, 3, 0, 2, 1]))
    yield zstandard.ZstdDecompressor().decompress(frame), frame


def test_zstd_reaches_every_mode(monkeypatch):
    """Raw, RLE, Huffman (one and four streams) and treeless literals;
    Huffman weights direct and FSE-coded; predefined, RLE, FSE and
    repeat tables for each of the three sequence codes."""
    seen = collections.Counter()
    literals, sequences = zstd._Frame.literals, zstd._Frame.sequences
    weights = zstd._huffman_weights

    def spy_literals(self, blk):
        kind, fmt = blk[0] & 3, (blk[0] >> 2) & 3
        seen["lit", kind, 4 if kind >= 2 and fmt else 1] += 1
        return literals(self, blk)

    def spy_sequences(self, blk, p):
        if blk[p]:
            modes = blk[p + (1 if blk[p] < 128 else 2 if blk[p] < 255 else 3)]
            for name, shift in (("ll", 6), ("of", 4), ("ml", 2)):
                seen["seq", name, (modes >> shift) & 3] += 1
        return sequences(self, blk, p)

    def spy_weights(buf, start):
        seen["weights", buf[start] >= 128] += 1
        return weights(buf, start)

    monkeypatch.setattr(zstd._Frame, "literals", spy_literals)
    monkeypatch.setattr(zstd._Frame, "sequences", spy_sequences)
    monkeypatch.setattr(zstd, "_huffman_weights", spy_weights)
    for data, frame in _mode_corpus():
        assert zstd.decompress(frame) == data
    want = ({("lit", 0, 1), ("lit", 1, 1), ("lit", 2, 1), ("lit", 2, 4),
             ("lit", 3, 1), ("lit", 3, 4), ("weights", True),
             ("weights", False)}
            | {("seq", n, m) for n in ("ll", "of", "ml") for m in range(4)})
    assert want <= set(seen), want - set(seen)


def test_zstd_every_frame_of_a_checkpoint():
    """Every zstd frame of one checkpoint (manifests, B-tree nodes, zarr
    chunks) decodes as ``zstandard`` decodes it."""
    zstandard = pytest.importorskip("zstandard")
    frames = []
    for path in glob.glob(os.path.join(V9P_BEST_STEP, "**", "*"),
                          recursive=True):
        if os.path.isfile(path):
            with open(path, "rb") as f:
                raw = f.read()
            at = raw.find(b"\x28\xb5\x2f\xfd")
            while at >= 0:
                frames.append(raw[at:])
                at = raw.find(b"\x28\xb5\x2f\xfd", at + 1)
    store = OcdbtStore(V9P_BEST_STEP)
    chunks = [store.read(k) for k in store.list()
              if not k.endswith(b".zarray")]
    assert len(chunks) == 13
    n = 0
    for blob in chunks + frames:
        obj = zstandard.ZstdDecompressor().decompressobj()
        try:
            want = obj.decompress(blob)
        except zstandard.ZstdError:
            continue             # four magic bytes inside other data
        frame = blob[:len(blob) - len(obj.unused_data)]
        assert zstd.decompress(frame) == want
        n += 1
    assert n >= len(chunks) + 4


def test_xxh64_known_values():
    assert zstd.xxh64(b"") == 0xEF46DB3751D8E999
    assert zstd.xxh64(b"abc") == 0x44BC2CF5AD770999
    pytest.importorskip("zstandard")


def test_zstd_damaged_frames_raise():
    """Every single-bit flip of a checksummed frame raises (or, where
    the flip lands in a field the decoder may ignore, decodes to the
    same bytes); truncations and foreign bytes raise."""
    zstandard = pytest.importorskip("zstandard")
    data = INPUTS["repetitive"][:600]
    frame = zstandard.ZstdCompressor(level=19,
                                     write_checksum=True).compress(data)
    wrong = []
    for i in range(len(frame)):
        for bit in range(8):
            bad = bytearray(frame)
            bad[i] ^= 1 << bit
            try:
                got = zstd.decompress(bytes(bad))
            except zstd.ZstdError:
                continue
            if got != data:
                wrong.append((i, bit))
    assert not wrong
    for cut in (1, 5, len(frame) // 2, len(frame) - 1):
        with pytest.raises(zstd.ZstdError):
            zstd.decompress(frame[:cut])
    with pytest.raises(zstd.ZstdError):
        zstd.decompress(b"not a zstd frame")
    with pytest.raises(zstd.ZstdError):
        zstd.decompress(frame + b"\x00")


# ------------------------------------------------------------------ OCDBT

def _ts_store(path):
    ts = pytest.importorskip("tensorstore")
    return ts.KvStore.open({"driver": "ocdbt",
                            "base": "file://" + os.path.abspath(path) + "/"}
                           ).result()


def test_ocdbt_matches_tensorstore_on_every_checkpoint():
    for d in STEP_DIRS:
        kv = _ts_store(d)
        keys = kv.list().result()
        store = OcdbtStore(d)
        assert store.list() == sorted(keys), d
        for k in keys:
            assert store.read(k) == kv.read(k).result().value, (d, k)


@pytest.mark.parametrize("compression", [None, "zstd"])
@pytest.mark.parametrize("max_inline", [0, 24, 4096])
def test_ocdbt_matches_tensorstore_on_written_stores(tmp_path, compression,
                                                     max_inline):
    ts = pytest.importorskip("tensorstore")
    rng = np.random.default_rng(max_inline)
    cfg = {"max_decoded_node_bytes": 400,
           "max_inline_value_bytes": max_inline,
           "compression": {"id": "zstd"} if compression else None}
    kv = ts.KvStore.open({"driver": "ocdbt", "config": cfg,
                          "base": "file://" + str(tmp_path) + "/"}).result()
    want = {}
    for commit in range(20):          # 20 versions: older ones leave the
        with ts.Transaction() as txn:  # manifest for version nodes
            for _ in range(15):
                key = f"arr{rng.integers(0, 40)}/{rng.integers(0, 9)}." \
                      f"{rng.integers(0, 9)}".encode()
                value = rng.integers(0, 256, rng.integers(0, 60),
                                     dtype=np.uint8).tobytes()
                kv.with_transaction(txn)[key] = value
                want[key] = value
    manifest = ts.ocdbt.dump(ts.KvStore.open(
        "file://" + str(tmp_path) + "/").result()).result()
    assert manifest["versions"][-1]["root_height"] >= 2
    assert manifest["version_tree_nodes"]
    store = OcdbtStore(tmp_path)
    assert store.generation == manifest["versions"][-1]["generation_number"]
    assert store.list() == sorted(want)
    for k, v in want.items():
        assert store.read(k) == v
    with pytest.raises(KeyError):
        store.read(b"missing")


def test_ocdbt_empty_store_and_crc32c(tmp_path):
    ts = pytest.importorskip("tensorstore")
    kv = ts.KvStore.open({"driver": "ocdbt",
                          "base": "file://" + str(tmp_path) + "/"}).result()
    kv[b"a"] = b"1"
    del kv[b"a"]
    assert OcdbtStore(tmp_path).list() == []
    from deeplocalproteindocking_torch.utils.ocdbt import crc32c
    assert crc32c(b"123456789") == 0xE3069283


# ------------------------------------------------------------------- zarr

ZARR_CASES = [
    dict(dtype="<f4", order="C", sep=".", comp=True, fill=None),
    dict(dtype="<f4", order="F", sep="/", comp=True, fill=1.5),
    dict(dtype="<u4", order="C", sep="/", comp=False, fill=7),
    dict(dtype="<i4", order="F", sep=".", comp=False, fill=None),
]


@pytest.mark.parametrize("case", ZARR_CASES,
                         ids=lambda c: "-".join(map(str, c.values())))
def test_zarr_matches_tensorstore(tmp_path, case):
    ts = pytest.importorskip("tensorstore")
    base = {"driver": "ocdbt", "base": "file://" + str(tmp_path) + "/"}
    meta = {"shape": [5, 7, 3], "chunks": [2, 3, 2], "dtype": case["dtype"],
            "order": case["order"], "dimension_separator": case["sep"],
            "compressor": {"id": "zstd", "level": 3} if case["comp"]
            else None, "fill_value": case["fill"]}
    arr = ts.open({"driver": "zarr", "kvstore": base, "path": "a/",
                   "metadata": meta, "create": True}).result()
    rng = np.random.default_rng(3)
    full = rng.integers(0, 1000, (5, 7, 3)).astype(case["dtype"])
    arr[0:4, 1:7, :] = full[0:4, 1:7, :]     # chunks left unwritten stay
    scalar = ts.open({"driver": "zarr", "kvstore": base, "path": "s/",
                      "metadata": {"shape": [], "chunks": [],
                                   "dtype": case["dtype"],
                                   "compressor": meta["compressor"]},
                      "create": True}).result()
    scalar[()] = full[0, 0, 0]
    store = OcdbtStore(tmp_path)
    got = read_array(store, "a")
    np.testing.assert_array_equal(got, arr.read().result())
    assert got.dtype == np.dtype(case["dtype"])
    chunk_keys = [k for k in store.list() if k.startswith(b"a/")
                  and not k.endswith(b".zarray")]
    assert len(chunk_keys) < 3 * 3 * 2          # some chunks are missing
    s = read_array(store, "s")
    assert s.shape == () and s == full[0, 0, 0]


class _DictStore(dict):
    def read(self, key):
        return self[key.encode() if isinstance(key, str) else key]


@pytest.mark.parametrize("change", [{"dtype": "<f8"}, {"dtype": ">f4"},
                                    {"compressor": {"id": "blosc"}},
                                    {"filters": [{"id": "delta"}]},
                                    {"zarr_format": 3}])
def test_zarr_rejects_what_it_does_not_know(change):
    meta = {"chunks": [2], "compressor": None, "dimension_separator": ".",
            "dtype": "<f4", "fill_value": None, "filters": None,
            "order": "C", "shape": [2], "zarr_format": 2}
    meta.update(change)
    store = _DictStore({b"x/.zarray": json.dumps(meta).encode(),
                        b"x/0": b"\0" * 8})
    with pytest.raises(ZarrError):
        read_array(store, "x")
    with pytest.raises(KeyError):
        read_array(store, "y")


# ------------------------------------------------------------ checkpoints

def _key_name(p):
    for attr in ("key", "idx", "name"):
        if hasattr(p, attr):
            return str(getattr(p, attr))
    raise TypeError(p)


_JAX_TRAINERS = {}


def _config_text(ckpt_dir):
    path = os.path.join(ckpt_dir, "config.json")
    if not os.path.exists(path):
        path = os.path.join(os.path.dirname(ckpt_dir), "config.json")
    with open(path) as f:
        return f.read()


def _jax_restore(step_dir):
    """The JAX ``Trainer.restore`` of ``step_dir``, flat by key tuple."""
    import jax
    from deeplocalproteindocking_tpu.config import DockConfig
    from deeplocalproteindocking_tpu.train.trainer import Trainer
    ckpt, step = os.path.dirname(step_dir), int(step_dir.rsplit("_", 1)[1])
    text = _config_text(ckpt)
    if text not in _JAX_TRAINERS:
        _JAX_TRAINERS[text] = Trainer(DockConfig.from_json(text))
    st = _JAX_TRAINERS[text].restore(ckpt, step)
    tree = dict(params=st.params, opt_state=st.opt_state, step=st.step,
                key=jax.random.key_data(st.key))
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {tuple(_key_name(p) for p in path): np.asarray(v)
            for path, v in leaves}


@pytest.mark.parametrize("step_dir", STEP_DIRS, ids=_rel)
def test_orbax_restore_bit_equal_to_jax(step_dir):
    want = _jax_restore(step_dir)
    got = checkpoint.read_tree(step_dir)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        assert got[k].tobytes() == v.tobytes(), k


FAMILY_CKPTS = ["synthetic-v1", "synthetic-v2", "synthetic-v3",
                "synthetic-v4", "synthetic-v5u", "synthetic-v6u",
                "synthetic-v7p", "synthetic-v9p", "synthetic-v7p/best",
                "synthetic-v9p/ema"]


@pytest.mark.parametrize("ckpt", FAMILY_CKPTS)
def test_trainer_restore_matches_jax(ckpt):
    """The port's ``Trainer.restore`` of a family's latest step: params,
    Adam's moments and count, the step, as the JAX restore gives them
    (conv kernels in torch's layout)."""
    from deeplocalproteindocking_torch import weights
    from deeplocalproteindocking_torch.config import DockConfig
    from deeplocalproteindocking_torch.train.trainer import Trainer
    path = os.path.join(PRETRAINED, ckpt)
    cfg = DockConfig.from_json(_config_text(path))
    state = Trainer(cfg, device="cpu").restore(path)
    step = checkpoint.latest_step(path)
    want = _jax_restore(checkpoint.step_path(path, step))

    def part(prefix):
        n = len(prefix)
        return weights.params_from_numpy(
            {"/".join(k[n:]): v for k, v in want.items()
             if k[:n] == prefix})

    for got, ref in ((state.params, part(("params",))),
                     (state.opt_state["mu"], part(("opt_state", "0", "mu"))),
                     (state.opt_state["nu"], part(("opt_state", "0", "nu")))):
        assert set(got) == set(ref)
        for k in ref:
            assert torch.equal(got[k], ref[k]), k
    assert state.opt_state["count"] == int(want[("opt_state", "0", "count")])
    assert state.step == int(want[("step",)]) == step
    assert state.rng is None
    assert checkpoint.load_params(path).keys() == state.params.keys()


def test_v9p_best_equals_its_export():
    from deeplocalproteindocking_torch import weights
    got = checkpoint.load_params(os.path.join(PRETRAINED, "synthetic-v9p",
                                              "best"))
    want = weights.load_npz(os.path.join(PRETRAINED, "synthetic-v9p",
                                         "best_params.npz"))
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_latest_step_and_state_pt_first(tmp_path):
    """The latest ``step_*`` holding a checkpoint, as the JAX restore
    takes it; a step's ``state.pt`` is read before its Orbax files."""
    from deeplocalproteindocking_torch.train.trainer import TrainState
    shutil.copytree(V9P_BEST_STEP, tmp_path / "step_00000500")
    (tmp_path / "step_00000700").mkdir()            # no checkpoint in it
    (tmp_path / "step_00000900.orbax-checkpoint-tmp-1").mkdir()
    assert checkpoint.latest_step(str(tmp_path)) == 500
    orbax = checkpoint.load_params(str(tmp_path))
    zeroed = {k: torch.zeros_like(v) for k, v in orbax.items()}
    torch.save(TrainState(zeroed, {}, 500, None)._asdict(),
               tmp_path / "step_00000500" / "state.pt")
    got = checkpoint.load_params(str(tmp_path))
    assert all(not v.any() for v in got.values())
    with pytest.raises(FileNotFoundError):
        checkpoint.latest_step(str(tmp_path / "step_00000700"))


def test_damaged_checkpoints_raise(tmp_path):
    """A byte flipped in a data file, a truncated manifest, a damaged
    chunk frame: each raises, never a wrong array."""
    def fresh(name):
        dst = tmp_path / name / "step_00000500"
        shutil.copytree(V9P_BEST_STEP, dst)
        return dst

    node_dir = fresh("node")
    node = next((node_dir / "d").iterdir())
    raw = bytearray(node.read_bytes())
    raw[len(raw) // 2] ^= 0x01
    node.write_bytes(bytes(raw))
    with pytest.raises(OcdbtError, match="CRC-32C"):
        checkpoint.read_tree(str(node_dir))

    cut = fresh("manifest")
    m = (cut / "manifest.ocdbt").read_bytes()
    (cut / "manifest.ocdbt").write_bytes(m[:-7])
    with pytest.raises(OcdbtError):
        checkpoint.read_tree(str(cut))

    # A chunk's frame header with a reserved bit set.
    chunk_dir = fresh("chunk")
    store = OcdbtStore(chunk_dir)
    rel, offset, _ = store._entries[
        b"params.representation.cnn.conv0.kernel/0.0.0.0.0"]
    data = chunk_dir / rel
    raw = bytearray(data.read_bytes())
    assert raw[offset:offset + 4] == b"\x28\xb5\x2f\xfd"
    raw[offset + 4] |= 0x08
    data.write_bytes(bytes(raw))
    with pytest.raises(ZarrError, match="reserved bit"):
        checkpoint.read_tree(str(chunk_dir))
    # A data file cut short.
    data.write_bytes(bytes(raw[:offset + 10]))
    with pytest.raises(OcdbtError, match="run past the file"):
        checkpoint.read_tree(str(chunk_dir))


# ------------------------------------------------------- what uses it

@pytest.mark.parametrize("missing", ["manifest.ocdbt", "d",
                                     "ocdbt.process_0/d"])
def test_missing_store_file_is_damage(tmp_path, missing):
    """A step copied without one of its OCDBT files is a damaged
    checkpoint: every entry point raises or exits naming it, and none
    falls back on an exported npz or starts the run again at step 0."""
    from deeplocalproteindocking_torch import cli as tcli
    from deeplocalproteindocking_torch import eval_matrix, train_flagship
    from deeplocalproteindocking_torch.config import DockConfig
    from deeplocalproteindocking_torch.train.trainer import Trainer
    src = os.path.join(PRETRAINED, "synthetic-v9p")
    run = tmp_path / "v9p"
    shutil.copytree(V9P_BEST_STEP, run / "step_00000500")
    for name in ("config.json", "best_params.npz"):
        shutil.copy(os.path.join(src, name), run / name)
    shutil.copy(os.path.join(src, "best_params.npz"),
                tmp_path / "v9p_params.npz")
    step = run / "step_00000500"
    if missing == "ocdbt.process_0/d":      # the file the values are in
        missing, = {v[0] for v in OcdbtStore(step)._entries.values()
                    if isinstance(v, tuple)}
    elif missing == "d":                    # the root B-tree node's
        missing = os.path.join("d", *os.listdir(step / "d"))
    (step / missing).unlink()
    with pytest.raises(OcdbtError, match="No such file"):
        checkpoint.load_params(str(run))
    with pytest.raises(OcdbtError):
        Trainer(DockConfig.from_json(_config_text(str(run))),
                device="cpu").restore(str(run))
    with pytest.raises(SystemExit, match=f"checkpoint {run}: .*No such"):
        tcli.load_checkpoint_params(str(run))
    with pytest.raises(OcdbtError):
        eval_matrix.checkpoint_params(str(run))
    s = train_flagship.settings_from_env(
        {"TF_SEEDS": "1", "TF_VAL_COMPLEXES": "1", "TF_VAL_NROT": "4"})
    with pytest.raises(OcdbtError):
        train_flagship.run(3000, str(run), s, device="cpu")
    assert sorted(d for d in os.listdir(run)
                  if d.startswith(("step_", "best"))) == [
        "best_params.npz", "step_00000500"]


def test_v1_dock_with_orbax_weights_matches_jax():
    """v1 (grid 32, the plain CNN with biases) docks 64 rotations with
    its Orbax-restored weights as the JAX pipeline docks them with its
    own restore."""
    from deeplocalproteindocking_tpu import pipeline as jpipe
    from deeplocalproteindocking_tpu.config import DockConfig as JConfig
    from deeplocalproteindocking_tpu.data import benchmark as jbench
    from deeplocalproteindocking_tpu.train.trainer import Trainer as JTrainer
    from deeplocalproteindocking_torch.config import DockConfig
    from deeplocalproteindocking_torch.pipeline import DockingPipeline
    v1 = os.path.join(PRETRAINED, "synthetic-v1")
    cfg = DockConfig.from_json(_config_text(v1)).replace(
        num_rotations=64, rotation_chunk=16, top_k=8)
    port = DockingPipeline(cfg, params=checkpoint.load_params(v1),
                           device="cpu")
    jcfg = JConfig.from_json(cfg.to_json())
    ref = jpipe.DockingPipeline(config=jcfg)
    ref.params = JTrainer(jcfg).restore(v1).params
    cplx = jbench.synthetic_complex(seed=3, n_res_rec=20, n_res_lig=8)
    got = port.dock_complex(cplx, cluster=False)
    want = ref.dock_complex(cplx, cluster=False)
    assert len(got) == len(want) > 0
    np.testing.assert_allclose(got.scores, want.scores, rtol=1e-4,
                               atol=1e-3)
    assert (int(got.rot_idx[0]), list(got.shifts[0])) == (
        int(want.rot_idx[0]), list(np.asarray(want.shifts[0])))


def test_cli_train_resumes_a_jax_run(tmp_path, monkeypatch, capsys):
    """``train --resume --ckpt-dir`` on a copy of v1's JAX run resumes
    at its step 100 from its params and Adam state, and saves after it."""
    from deeplocalproteindocking_torch import cli as tcli
    from deeplocalproteindocking_torch.config import DockConfig
    from deeplocalproteindocking_torch.train.trainer import Trainer
    run = tmp_path / "v1"
    shutil.copytree(os.path.join(PRETRAINED, "synthetic-v1"), run)
    cfg = DockConfig.from_json(_config_text(str(run))).replace(
        num_decoys=4, batch_complexes=1)
    monkeypatch.setattr(tcli, "_build_config", lambda args: cfg)
    stepped = []
    train_step = Trainer.train_step

    def spy(self, state, batch):
        stepped.append(state)
        return train_step(self, state, batch)

    monkeypatch.setattr(Trainer, "train_step", spy)
    tcli.main(["train", "--synthetic", "1", "--ckpt-dir", str(run),
               "--steps", "101", "--resume", "--device", "cpu"])
    assert "resumed from step 100" in capsys.readouterr().out
    assert len(stepped) == 1 and stepped[0].step == 100
    want = _jax_restore(str(run / "step_00000100"))
    w = want[("params", "representation", "conv0", "kernel")]
    got = stepped[0].params["representation.convs.0.weight"]
    np.testing.assert_array_equal(np_(got), w.transpose(4, 3, 0, 1, 2))
    np.testing.assert_array_equal(
        np_(stepped[0].opt_state["nu"]["coupling"]),
        want[("opt_state", "0", "nu", "coupling")])
    assert stepped[0].opt_state["count"] == 100
    assert os.path.exists(run / "step_00000101" / "state.pt")
    assert not os.path.exists(run / "step_00000100" / "state.pt")


def test_flagship_resumes_a_jax_run(tmp_path, monkeypatch):
    """``train_flagship.run`` on a JAX run directory (v9p's latest step,
    its EMA, best.json, the mined buffer) resumes at step 3000 under the
    run's config, with nothing left to train; it never starts again."""
    from deeplocalproteindocking_torch import train_flagship
    from deeplocalproteindocking_torch.train.trainer import Trainer
    src = os.path.join(PRETRAINED, "synthetic-v9p")
    run = tmp_path / "v9p"
    run.mkdir()
    for name in ("config.json", "best.json", "mined.npz"):
        shutil.copy(os.path.join(src, name), run / name)
    shutil.copytree(os.path.join(src, "step_00003000"),
                    run / "step_00003000")
    shutil.copytree(os.path.join(src, "ema", "step_00003000"),
                    run / "ema" / "step_00003000")

    def no_init(self, seed=None):
        raise AssertionError("the run started again at step 0")

    monkeypatch.setattr(Trainer, "init_state", no_init)
    restored = []
    restore = Trainer.restore

    def spy(self, ckpt_dir, step=None):
        out = restore(self, ckpt_dir, step)
        restored.append((ckpt_dir, out))
        return out

    monkeypatch.setattr(Trainer, "restore", spy)
    s = train_flagship.settings_from_env(
        {"TF_SEEDS": "1", "TF_VAL_COMPLEXES": "1", "TF_VAL_NROT": "4"})
    events = train_flagship.run(3000, str(run), s, device="cpu")
    assert events == []
    (main_dir, state), (ema_dir, ema) = restored
    assert state.step == 3000 and state.opt_state["count"] == 3000
    assert ema_dir == os.path.join(str(run), "ema")
    want = _jax_restore(str(run / "step_00003000"))
    np.testing.assert_array_equal(np_(state.params["coupling"]),
                                  want[("params", "coupling")])
    want_ema = _jax_restore(str(run / "ema" / "step_00003000"))
    np.testing.assert_array_equal(np_(ema.params["coupling"]),
                                  want_ema[("params", "coupling")])
    assert sorted(os.listdir(run / "step_00003000")) == sorted(
        os.listdir(os.path.join(src, "step_00003000")))
    assert not os.path.exists(run / "step_00000000")


def _jax_tool_output(ckpt, capsys):
    spec = importlib.util.spec_from_file_location(
        "_coupling_spectrum_tool",
        os.path.join(ROOT, "tools", "coupling_spectrum.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    argv = sys.argv
    sys.argv = ["coupling_spectrum.py", ckpt]
    try:
        tool.main()
    finally:
        sys.argv = argv
    return capsys.readouterr().out


@pytest.mark.parametrize("ckpt", ["synthetic-v5u/best", "synthetic-v9p/best"])
def test_coupling_spectrum_matches_jax_tool(ckpt, capsys):
    from deeplocalproteindocking_torch import coupling_spectrum
    path = os.path.join(PRETRAINED, ckpt)
    want = _jax_tool_output(path, capsys)
    coupling_spectrum.main([path])
    got = capsys.readouterr().out
    assert got == want
    assert got.splitlines()[-1].startswith("smallest rank keeping")
    assert coupling_spectrum.DEFAULT_CKPT == os.path.join(
        "pretrained", "synthetic-v5u", "best")


# ------------------------------------------------------------- helpers

@pytest.mark.parametrize("kw", [
    dict(grid_size=16, resolution=1.5),
    dict(grid_size=24, resolution=1.0, window=4, sigma=1.3, num_types=5),
])
@pytest.mark.parametrize("masked", [False, True])
def test_splat_matches_jax(kw, masked):
    """The dense reference splat: atoms near and past the box edge,
    masked rows and negative types left out, and its gradient."""
    import jax
    import jax.numpy as jnp
    from deeplocalproteindocking_tpu.grids import voxelize as jv
    from deeplocalproteindocking_torch.grids import voxelize as tv
    rng = np.random.default_rng(7)
    n = 40
    coords = rng.normal(0, 7, (n, 3)).astype(np.float32)
    types = rng.integers(-1, kw.get("num_types", 11), n)
    mask = (rng.random(n) > 0.25) if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else t_(mask)
    want = jv.splat(jnp.asarray(coords), jnp.asarray(types), jm, **kw)
    c = t_(coords).requires_grad_(True)
    got = tv.splat(c, t_(types), tm, **kw)
    np.testing.assert_allclose(np_(got), np_(want), rtol=1e-5, atol=1e-5)
    w = rng.normal(size=got.shape).astype(np.float32)
    (got * t_(w)).sum().backward()
    gw = jax.grad(lambda x: (jv.splat(x, jnp.asarray(types), jm, **kw)
                             * w).sum())(jnp.asarray(coords))
    np.testing.assert_allclose(np_(c.grad), np_(gw), rtol=1e-4, atol=1e-4)
    # Excluded atoms add nothing.
    keep = (types >= 0) if mask is None else (types >= 0) & mask
    only = tv.splat(t_(coords[keep]), t_(types[keep]), **kw)
    np.testing.assert_allclose(np_(got.detach()), np_(only), atol=1e-6)
    np.testing.assert_array_equal(
        np_(tv.default_origin(kw["grid_size"], kw["resolution"])),
        np_(jv.default_origin(kw["grid_size"], kw["resolution"])))


def test_structure_helpers_match_jax():
    import jax.numpy as jnp
    from deeplocalproteindocking_tpu import structure as jst
    from deeplocalproteindocking_tpu.sweep import docker as jdocker
    from deeplocalproteindocking_torch import grids, structure as tst, sweep
    from deeplocalproteindocking_torch.sweep import docker, topk
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 9, 3)).astype(np.float32) * 4
    t = rng.normal(size=(2, 3)).astype(np.float32)
    mask = rng.random((2, 9)) > 0.4
    mask[1] = False                                  # no real atom
    np.testing.assert_array_equal(np_(tst.translate(t_(x), t_(t))),
                                  np_(jst.translate(jnp.asarray(x),
                                                    jnp.asarray(t))))
    for m in (None, mask):
        tm = None if m is None else t_(m)
        jm = None if m is None else jnp.asarray(m)
        np.testing.assert_allclose(np_(tst.center_of_mass(t_(x), tm)),
                                   np_(jst.center_of_mass(jnp.asarray(x),
                                                          jm)),
                                   rtol=1e-6, atol=1e-6)
        for a, b in zip(tst.bounding_box(t_(x), tm),
                        jst.bounding_box(jnp.asarray(x), jm)):
            np.testing.assert_array_equal(np_(a), np_(b))
    R = np_(jst.super_fibonacci_rotations(6))
    Q = np_(jst.super_fibonacci_rotations(6))[::-1].copy()
    for a, b in ((R, Q), (R, R)):
        np.testing.assert_allclose(
            np_(tst.geodesic_angle(t_(a), t_(b))),
            np_(jst.geodesic_angle(jnp.asarray(a), jnp.asarray(b))),
            atol=1e-3)
    assert docker.DockResult is topk.DockResult is sweep.DockResult
    assert "DockResult" in docker.__all__
    assert docker.DockResult._fields == jdocker.DockResult._fields
    assert grids.splat is not None and grids.default_origin is not None
