"""`recordio` and the native IO library of the PyTorch port against the
JAX package's on the CPU.

Files cross both ways byte for byte: a .rec/.idx pair written by either
package reads back in the other, the same payloads in the same order, and
the two writers produce the same bytes.  Corruption behaves the same in
both readers: a torn tail, a bad magic word (resync on the next record),
broken multi-part records and `read_idx` of a damaged record (None, one
quarantine entry), with the same ``corrupt_records`` counts.  The native
library builds from ``src/io_native.cc`` into ``build/native/`` and its
record scan and batch finishes equal the numpy routes bit for bit.
"""
import ctypes
import struct

import numpy as np
import pytest

from incubator_mxnet_tpu import recordio as jrec
from incubator_mxnet_tpu import image as jimage

from incubator_mxnet_tpu_torch import config, native
from incubator_mxnet_tpu_torch import recordio as trec
from incubator_mxnet_tpu_torch import image as timage

MAGIC = struct.pack("<I", 0xced7230a)
PAYLOADS = [b"plain record", b"head" + MAGIC + b"tail",
            MAGIC + b"starts with magic", b"ends with magic" + MAGIC,
            b"a" + MAGIC + b"b" + MAGIC + b"c", b"", b"xyz" * 101]


class _Log:
    """A quarantine log: records what the readers append."""

    def __init__(self):
        self.entries = []

    def append(self, **entry):
        self.entries.append(entry)


def _write(pkg, tmp_path, name, payloads=PAYLOADS, indexed=True):
    rec, idx = str(tmp_path / f"{name}.rec"), str(tmp_path / f"{name}.idx")
    w = pkg.MXIndexedRecordIO(idx, rec, "w") if indexed else \
        pkg.MXRecordIO(rec, "w")
    for i, p in enumerate(payloads):
        if indexed:
            w.write_idx(i, p)
        else:
            w.write(p)
    w.close()
    return rec, idx


@pytest.mark.parametrize("writer,reader", [(jrec, trec), (trec, jrec)],
                         ids=["jax_to_port", "port_to_jax"])
def test_files_cross_both_ways(tmp_path, writer, reader):
    rec, idx = _write(writer, tmp_path, "x")
    seq = reader.MXRecordIO(rec, "r")
    assert [seq.read() for _ in PAYLOADS] == PAYLOADS
    assert seq.read() is None and seq.corrupt_records == 0
    ind = reader.MXIndexedRecordIO(idx, rec, "r")
    assert ind.keys == list(range(len(PAYLOADS)))
    for i in (4, 0, 6, 2):
        assert ind.read_idx(i) == PAYLOADS[i]


def test_writers_write_the_same_bytes(tmp_path):
    a = _write(jrec, tmp_path, "jax")
    b = _write(trec, tmp_path, "port")
    for x, y in zip(a, b):
        assert open(x, "rb").read() == open(y, "rb").read()


def _damage(path, kind):
    data = bytearray(open(path, "rb").read())
    if kind == "torn_tail":
        data = data[:-7]
    elif kind == "bad_magic":
        data[20] ^= 0xFF          # the second record's magic word
    elif kind == "bad_length":
        data[24] ^= 0xFF          # the second record's length
    elif kind == "lost_start":
        # the first multi-part record loses its start part's magic
        off = data.find(MAGIC, 1)
        data[off] ^= 0x01
    elif kind == "garbage_tail":
        data += b"\x01\x02\x03\x04\x05\x06\x07\x08\x09"
    open(path, "wb").write(bytes(data))


@pytest.mark.parametrize("kind", ["torn_tail", "bad_magic", "bad_length",
                                  "lost_start", "garbage_tail"])
def test_corruption_is_skipped_alike(tmp_path, kind):
    """Both sequential readers return the same records and count the
    same skips; the record scans of both iterators agree too."""
    rec, _ = _write(trec, tmp_path, "c", indexed=False)
    _damage(rec, kind)
    out = {}
    for name, pkg in (("jax", jrec), ("port", trec)):
        r = pkg.MXRecordIO(rec, "r")
        log = _Log()
        r.set_quarantine(log)
        got = []
        while True:
            s = r.read()
            if s is None:
                break
            got.append(s)
        out[name] = (got, r.corrupt_records, len(log.entries))
    assert out["port"] == out["jax"]
    assert out["port"][1] >= 1
    buf = open(rec, "rb").read()
    jrecs, jbad = jimage._index_records_tolerant(buf)
    trecs, tbad = timage._index_records_tolerant(buf)
    assert (trecs, tbad) == (jrecs, jbad)


def test_read_idx_of_a_damaged_record_is_none(tmp_path):
    payloads = [b"r%d" % i * 20 for i in range(6)]
    out = {}
    for name, pkg in (("jax", jrec), ("port", trec)):
        rec, idx = _write(pkg, tmp_path, name, payloads)
        r = pkg.MXIndexedRecordIO(idx, rec, "r")
        data = bytearray(open(rec, "rb").read())
        data[r.idx[3]] ^= 0xFF
        open(rec, "wb").write(bytes(data))
        r = pkg.MXIndexedRecordIO(idx, rec, "r")
        log = _Log()
        r.set_quarantine(log)
        got = [r.read_idx(i) for i in range(6)]
        out[name] = (got, r.corrupt_records,
                     [e.get("record") for e in log.entries
                      if e.get("record") is not None])
    assert out["port"] == out["jax"]
    assert out["port"][0][3] is None and out["port"][2] == [3]
    assert out["port"][0][4] == payloads[4]


def test_headers_pack_alike():
    for header in (trec.IRHeader(0, 2.5, 7, 1),
                   trec.IRHeader(0, [1.0, 2.0, 3.0], 9, 0)):
        s = trec.pack(header, b"body")
        assert s == jrec.pack(jrec.IRHeader(*header), b"body")
        h, body = trec.unpack(s)
        jh, jbody = jrec.unpack(s)
        assert body == jbody == b"body"
        np.testing.assert_array_equal(h.label, jh.label)
        assert (h.flag, h.id, h.id2) == (jh.flag, jh.id, jh.id2)


@pytest.mark.parametrize("fmt", [".jpg", ".png"])
def test_pack_img_matches_the_jax_package(fmt):
    img = np.random.RandomState(3).randint(0, 256, (20, 24, 3), np.uint8)
    h = trec.IRHeader(0, 1.0, 2, 0)
    s = trec.pack_img(h, img, img_fmt=fmt)
    assert s == jrec.pack_img(jrec.IRHeader(*h), img, img_fmt=fmt)
    _, a = trec.unpack_img(s)
    _, b = jrec.unpack_img(s)
    np.testing.assert_array_equal(a, b)


def test_ppm_packs_without_a_codec():
    img = np.random.RandomState(4).randint(0, 256, (5, 7, 3), np.uint8)
    s = trec.pack_img(trec.IRHeader(0, 3.0, 1, 0), img, img_fmt=".ppm")
    _, payload = trec.unpack(s)
    assert payload[:11] == b"P6\n7 5\n255\n"
    np.testing.assert_array_equal(timage.decode_ppm(payload), img)


def test_shard_ranges_match():
    for n, parts in ((10, 3), (7, 7), (5, 8), (1000, 6)):
        assert trec.shard_ranges(n, parts) == jrec.shard_ranges(n, parts)


def test_native_library_builds_from_the_source():
    lib = native.lib()
    assert lib is not None, native.unavailable_reason()
    path = native.lib_path()
    assert path.parent == native.BUILD_DIR and path.exists()
    assert path.parent.parent.name == "build"
    assert native.SOURCE.name == "io_native.cc"
    assert "libmxtpu_io.so" not in str(path.name)


def test_native_off_switch(monkeypatch):
    monkeypatch.setenv("MXNET_USE_NATIVE_IO", "0")
    assert config.get("MXNET_USE_NATIVE_IO") is False
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_reason", None)
    assert native.lib() is None
    assert native.unavailable_reason() == "MXNET_USE_NATIVE_IO=0"


def test_native_build_failure_is_reported(monkeypatch, tmp_path):
    bad = tmp_path / "io_native.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_reason", None)
    assert native.lib() is None
    assert "exit" in native.unavailable_reason()


def test_native_scan_equals_the_python_walk(tmp_path, monkeypatch):
    rec, _ = _write(trec, tmp_path, "s", indexed=False)
    buf = open(rec, "rb").read()
    nat = timage._index_records_tolerant(buf)
    monkeypatch.setattr(native, "lib", lambda: None)
    walk = timage._index_records_tolerant(buf)
    assert nat == walk
    records, bad = nat
    assert bad == 0 and len(records) == len(PAYLOADS)
    assert [bytes(timage._record_payload(buf, r)) for r in records] == \
        PAYLOADS


def test_native_finishes_equal_numpy():
    """`mxtpu_augment_batch` (fp32 NCHW) and `mxtpu_crop_batch_u8`
    (uint8 NHWC) against the numpy expressions of the iterator."""
    lib = native.lib()
    rng = np.random.RandomState(0)
    imgs = [rng.randint(0, 256, (40 + i, 36, 3), np.uint8) for i in range(3)]
    h = w = 32
    dims = np.array([[im.shape[0] for im in imgs], [36] * 3, [0, 5, 9],
                     [4, 0, 2]], np.int64)
    mirrors = np.array([0, 1, 1], np.int32)
    mean = np.array([123.68, 116.78, 103.94], np.float32)
    stdinv = 1.0 / np.array([58.4, 57.1, 57.4], np.float32)
    ptrs = (ctypes.c_void_p * 3)(*(im.ctypes.data for im in imgs))
    i64p = ctypes.POINTER(ctypes.c_int64)
    f32p = ctypes.POINTER(ctypes.c_float)
    mp = mirrors.ctypes.data_as(ctypes.POINTER(ctypes.c_int))
    f32 = np.empty((3, 3, h, w), np.float32)
    lib.mxtpu_augment_batch(ptrs, dims[0].ctypes.data_as(i64p),
                            dims[1].ctypes.data_as(i64p), 3,
                            dims[2].ctypes.data_as(i64p),
                            dims[3].ctypes.data_as(i64p), h, w, mp,
                            mean.ctypes.data_as(f32p),
                            stdinv.ctypes.data_as(f32p),
                            f32.ctypes.data_as(f32p), 3, 1)
    u8 = np.empty((3, h, w, 3), np.uint8)
    lib.mxtpu_crop_batch_u8(ptrs, dims[0].ctypes.data_as(i64p),
                            dims[1].ctypes.data_as(i64p), 3,
                            dims[2].ctypes.data_as(i64p),
                            dims[3].ctypes.data_as(i64p), h, w, mp,
                            u8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                            3, 1)
    for i, im in enumerate(imgs):
        y0, x0 = dims[2, i], dims[3, i]
        crop = im[y0:y0 + h, x0:x0 + w, ::-1]
        if mirrors[i]:
            crop = crop[:, ::-1]
        np.testing.assert_array_equal(u8[i], crop)
        want = ((crop.astype(np.float32) - mean) * stdinv).transpose(2, 0, 1)
        assert np.array_equal(f32[i], want)
