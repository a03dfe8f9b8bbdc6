"""RecordIO: packed binary record files (reference `python/mxnet/recordio.py`,
dmlc-core recordio format).

PyTorch port of `incubator_mxnet_tpu/recordio.py`; the format needs no
tensor at all, so this is the JAX module's code, byte for byte on disk:
records are [magic uint32 0xced7230a][lrecord uint32][data][pad to 4B],
where lrecord encodes cflag (3 bits) | length (29 bits), and a payload
holding the magic word is split into parts (cflag 1 start, 2 middle, 3
end).  `IRHeader` (flag, label, id, id2) matches `mx.recordio.IRHeader`.

Corruption tolerance: a torn tail, a magic mismatch or a broken
multi-part sequence never raises.  The reader resynchronizes on the next
magic word where it can, otherwise treats the tail as EOF, counts every
skip on ``corrupt_records``, and appends one entry per skip to a
quarantine log attached with `set_quarantine` (any object with an
``append(reason=, source=, ...)`` method).  `read_idx` of a damaged
record returns None.  Every assembled record passes the
``io.corrupt_record`` payload fault site (`resilience.faults.mutate`),
where a ``corrupt`` clause bit-flips it, as in the JAX module.

`pack_img`/`unpack_img` code with PIL where it imports, as the JAX
package does, else with OpenCV; PPM (P6) needs neither.
"""
from __future__ import annotations

import logging
import numbers
import os
import struct

import numpy as np

from .base import MXNetError

_log = logging.getLogger(__name__)
_WARN_CAP = 5   # per-reader warnings before dropping to debug

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "IRHeader", "pack", "unpack",
           "pack_img", "unpack_img", "shard_range", "shard_ranges"]

MAGIC = 0xced7230a
MAGIC_BYTES = struct.pack("<I", MAGIC)
_CFLAG_BITS = 29


def shard_range(n, num_parts, part_index):
    """The per-host input-partition rule: contiguous ``[start, stop)``
    over `n` records for shard `part_index` of `num_parts`, the remainder
    spread over the first shards.  Disjoint, exhaustive, deterministic."""
    n = int(n)
    num_parts = int(num_parts)
    part_index = int(part_index)
    if num_parts < 1 or not 0 <= part_index < num_parts:
        raise MXNetError(
            f"shard_range: part_index {part_index} out of range for "
            f"num_parts {num_parts}")
    per, rem = divmod(n, num_parts)
    start = part_index * per + min(part_index, rem)
    return start, start + per + (1 if part_index < rem else 0)


def shard_ranges(n, num_parts):
    """Every shard's ``(start, stop)`` under `shard_range`'s rule."""
    return [shard_range(n, num_parts, p) for p in range(int(num_parts))]


def quarantine_append(log, **entry):
    """Append one entry to a quarantine log; a failing log must not stop
    the reader (the skip is already counted)."""
    if log is None:
        return
    try:
        log.append(**entry)
    except Exception:   # noqa: BLE001 - the log is the caller's object
        _log.debug("quarantine log refused %s", entry, exc_info=True)


class MXRecordIO:
    """Sequential reader/writer (reference `recordio.py:MXRecordIO`)."""

    def __init__(self, uri, flag):
        self.uri = uri
        self.flag = flag
        self.handle = None
        self.corrupt_records = 0
        self._quarantine = None
        self.open()

    def open(self):
        if self.flag == "w":
            self.handle = open(self.uri, "wb")
            self.writable = True
        elif self.flag == "r":
            self.handle = open(self.uri, "rb")
            self.writable = False
        else:
            raise ValueError("Invalid flag %s" % self.flag)
        self.is_open = True
        self.corrupt_records = 0

    def set_quarantine(self, log):
        """Attach a quarantine log: every corrupt region this reader
        skips appends one entry (source + offset)."""
        self._quarantine = log

    def _corrupt(self, reason, offset=None):
        """Count and report one skipped corrupt region (never raises)."""
        self.corrupt_records += 1
        where = self.uri if offset is None else f"{self.uri}@{offset}"
        if self.corrupt_records <= _WARN_CAP:
            _log.warning("RecordIO: skipping corrupt record in %s: %s "
                         "(corrupt_records=%d)", where, reason,
                         self.corrupt_records)
        else:
            _log.debug("RecordIO: skipping corrupt record in %s: %s",
                       where, reason)
        quarantine_append(self._quarantine, reason="corrupt_record",
                          source=self.uri, offset=offset, detail=reason)

    def _resync(self):
        """Scan forward for the next magic word and leave the handle at
        it; False when the file ends first (the tail is garbage)."""
        window = b""
        while True:
            chunk = self.handle.read(1 << 16)
            if not chunk:
                return False
            window += chunk
            hit = window.find(MAGIC_BYTES)
            if hit != -1:
                self.handle.seek(hit - len(window), os.SEEK_CUR)
                return True
            window = window[-3:]   # a magic may straddle the boundary

    def close(self):
        if self.is_open:
            self.handle.close()
            self.is_open = False

    def __del__(self):
        try:
            self.close()
        except Exception:   # noqa: BLE001 - interpreter shutdown
            pass

    def __getstate__(self):
        d = dict(self.__dict__)
        d["handle"] = None
        if d["is_open"]:
            d["is_open"] = False
            d["_reopen"] = True
        return d

    def __setstate__(self, d):
        reopen = d.pop("_reopen", False)
        self.__dict__.update(d)
        if reopen:
            self.open()

    def reset(self):
        self.close()
        self.open()

    def _write_part(self, cflag, buf):
        length = len(buf)
        self.handle.write(struct.pack("<II", MAGIC,
                                      (cflag << _CFLAG_BITS) | length))
        self.handle.write(buf)
        pad = (4 - length % 4) % 4
        if pad:
            self.handle.write(b"\x00" * pad)

    def write(self, buf):
        """Write one logical record, split at in-payload magic words
        (cflag 1/2/3; the magic at each split is implied by the next
        part's header and not stored)."""
        assert self.writable
        buf = bytes(buf)
        if MAGIC_BYTES not in buf:
            self._write_part(0, buf)
            return
        parts = buf.split(MAGIC_BYTES)
        for i, part in enumerate(parts):
            cflag = 1 if i == 0 else (3 if i == len(parts) - 1 else 2)
            self._write_part(cflag, part)

    def _read_part(self):
        while True:
            offset = self.handle.tell()
            header = self.handle.read(8)
            if not header:
                return None, None           # clean EOF
            if len(header) < 8:
                self._corrupt("short header (%d of 8 bytes)"
                              % len(header), offset)
                return None, None
            magic, lrecord = struct.unpack("<II", header)
            if magic != MAGIC:
                self._corrupt("magic mismatch (0x%08x)" % magic, offset)
                self.handle.seek(offset + 1)
                if not self._resync():
                    return None, None
                continue
            cflag = lrecord >> _CFLAG_BITS
            length = lrecord & ((1 << _CFLAG_BITS) - 1)
            buf = self.handle.read(length)
            if len(buf) < length:
                self._corrupt("short payload (%d of %d bytes)"
                              % (len(buf), length), offset)
                return None, None
            pad = (4 - length % 4) % 4
            if pad:
                self.handle.read(pad)
            return cflag, buf

    def read(self):
        """Read one logical record, reassembling multi-part sequences
        with the magic word between the parts; None at the end.  Damaged
        regions are skipped and counted, never raised."""
        assert not self.writable
        while True:
            cflag, buf = self._read_part()
            if cflag is None:
                return None
            if cflag == 0:
                return self._deliver(buf)
            if cflag != 1:
                self._corrupt("unexpected continuation flag %d at "
                              "record start" % cflag)
                continue
            parts = [buf]
            while True:
                cflag, buf = self._read_part()
                if cflag is None:
                    self._corrupt("truncated multi-part record at EOF")
                    return None
                if cflag == 2:
                    parts.append(buf)
                    continue
                if cflag == 3:
                    parts.append(buf)
                    return self._deliver(MAGIC_BYTES.join(parts))
                # a fresh record start interrupted the sequence: drop
                # the torn record, adopt this part
                self._corrupt("multi-part record interrupted by flag %d"
                              % cflag)
                if cflag == 0:
                    return self._deliver(buf)
                parts = [buf]

    def _deliver(self, rec):
        """One assembled record through the ``io.corrupt_record`` payload
        fault site (one global read when no schedule is configured)."""
        from .resilience import faults as _faults
        return _faults.mutate("io.corrupt_record", rec, uri=self.uri)

    def tell(self):
        return self.handle.tell()

    def seek(self, pos):
        assert not self.writable
        self.handle.seek(pos)


class MXIndexedRecordIO(MXRecordIO):
    """Random-access reader/writer with an .idx file
    (reference `recordio.py:MXIndexedRecordIO`)."""

    def __init__(self, idx_path, uri, flag, key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        self.fidx = None
        super().__init__(uri, flag)

    def open(self):
        super().open()
        self.idx = {}
        self.keys = []
        if self.flag == "w":
            self.fidx = open(self.idx_path, "w")
        else:
            self.fidx = open(self.idx_path, "r")
            for line in self.fidx:
                parts = line.strip().split("\t")
                key = self.key_type(parts[0])
                self.idx[key] = int(parts[1])
                self.keys.append(key)

    def close(self):
        if self.is_open:
            super().close()
            self.fidx.close()

    def read_idx(self, idx):
        """Record `idx`'s payload, or None when the region at its offset
        is damaged.  A resync must not return the next record as this
        one's (a misaligned sample/label pair); the damaged id goes to
        the quarantine log."""
        self.seek(self.idx[idx])
        before = self.corrupt_records
        rec = self.read()
        if self.corrupt_records != before:
            quarantine_append(self._quarantine, reason="corrupt_record",
                              source=self.uri,
                              record=int(idx) if isinstance(idx, int)
                              else None)
            return None
        return rec

    def write_idx(self, idx, buf):
        key = self.key_type(idx)
        pos = self.tell()
        self.write(buf)
        self.fidx.write(f"{key}\t{pos}\n")
        self.idx[key] = pos
        self.keys.append(key)


class IRHeader:
    """Image record header (reference `recordio.py:IRHeader` namedtuple)."""

    __slots__ = ("flag", "label", "id", "id2")

    def __init__(self, flag, label, id, id2):  # noqa: A002
        self.flag = flag
        self.label = label
        self.id = id
        self.id2 = id2

    def __iter__(self):
        yield from (self.flag, self.label, self.id, self.id2)

    def __eq__(self, other):
        return tuple(self) == tuple(other)


_IR_FORMAT = "<IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


def pack(header, s):
    """Pack header + bytes (reference `recordio.py pack`)."""
    flag, label, id_, id2 = header
    if isinstance(label, numbers.Number):
        return struct.pack(_IR_FORMAT, 0, float(label), id_, id2) + s
    label = np.asarray(label, dtype=np.float32)
    hdr = struct.pack(_IR_FORMAT, label.size, 0.0, id_, id2)
    return hdr + label.tobytes() + s


def unpack(s):
    """Unpack to (IRHeader, bytes) (reference `recordio.py unpack`)."""
    flag, label, id_, id2 = struct.unpack(_IR_FORMAT, s[:_IR_SIZE])
    payload = s[_IR_SIZE:]
    if flag > 0:
        label = np.frombuffer(payload[:flag * 4], dtype=np.float32)
        payload = payload[flag * 4:]
    return IRHeader(flag, label, id_, id2), payload


def pack_img(header, img, quality=95, img_fmt=".jpg"):
    """Encode an HWC uint8 RGB image and pack it (reference `recordio.py
    pack_img`).  ``img_fmt`` ".jpg"/".jpeg" or ".png" encode with PIL, as
    the JAX package does (the same bytes), else with cv2; ".ppm" writes
    binary P6, which needs no codec."""
    img = np.ascontiguousarray(np.asarray(img).astype(np.uint8))
    fmt = img_fmt.lower()
    if fmt == ".ppm":
        return pack(header, encode_ppm(img))
    jpeg = fmt in (".jpg", ".jpeg")
    from . import image as _image
    pil = _image.pil_module()
    if pil is not None:
        import io as _io
        out = _io.BytesIO()
        pil.fromarray(img).save(out, format="JPEG" if jpeg else "PNG",
                                quality=quality)
        return pack(header, out.getvalue())
    cv2 = _image.cv2_module()
    if cv2 is None:
        raise MXNetError(f"pack_img: no codec for {img_fmt} (neither PIL "
                         "nor cv2 imports); pack '.ppm'")
    bgr = img[:, :, ::-1] if img.ndim == 3 else img
    ok, buf = cv2.imencode(".jpg" if jpeg else ".png",
                           np.ascontiguousarray(bgr),
                           [cv2.IMWRITE_JPEG_QUALITY, int(quality)]
                           if jpeg else [])
    if not ok:
        raise MXNetError(f"pack_img: cv2 could not encode {img_fmt}")
    return pack(header, buf.tobytes())


def encode_ppm(img):
    """Binary PPM (P6) bytes of an HWC uint8 RGB image."""
    h, w = img.shape[:2]
    if img.ndim != 3 or img.shape[2] != 3:
        raise MXNetError(f"encode_ppm: needs HxWx3, got {img.shape}")
    return b"P6\n%d %d\n255\n" % (w, h) + np.ascontiguousarray(
        img, dtype=np.uint8).tobytes()


def unpack_img(s, iscolor=-1):
    """Unpack and decode an image to numpy HWC (reference `recordio.py
    unpack_img`): through PIL where it imports, as the JAX package
    decodes (RGB, "L" for ``iscolor=0``), else `image.decode_rgb`."""
    from . import image as _image
    header, payload = unpack(s)
    pil = _image.pil_module()
    if pil is None:
        img = _image.decode_rgb(payload)
        if iscolor == 0 and img.ndim == 3:
            raise MXNetError("unpack_img: iscolor=0 needs PIL")
        return header, img
    import io as _io
    img = pil.open(_io.BytesIO(payload))
    if iscolor == 0:
        img = img.convert("L")
    elif iscolor == 1:
        img = img.convert("RGB")
    return header, np.asarray(img)
