"""Image pipeline: decode -> augment -> batch (reference
`src/io/iter_image_recordio_2.cc`, `image_aug_default.cc`, python surface
`python/mxnet/image/image.py`).

PyTorch port of `incubator_mxnet_tpu/image.py`: `imdecode`, the resize
and crop helpers, the `Augmenter` classes, `CreateAugmenter`, `ImageIter`
and `ImageRecordIterImpl` (the engine of `io.ImageRecordIter`) with its
batch pool and record index.  The work is host numpy, cv2 and the native
IO library (`native.py`); a batch leaves as a CPU NDArray over its numpy
buffer, and `io_plane.DevicePrefetchIter` (which `Module.fit` wraps the
iterator in) copies it to the card once, from pinned memory, off the
training thread.  The JAX iterator instead copies to the device of the
current context in its worker threads.

Decode contract of `ImageRecordIterImpl`: ``cv2.imdecode(buf,
IMREAD_COLOR)``, HWC uint8 in BGR order (the finish reverses it to RGB).
Routes, first that imports: cv2; PIL (its RGB reversed); numpy for
binary PPM (P6), which needs no codec.  A record no route can decode for
want of a codec raises `CodecUnavailableError`; it is never counted as a
corrupt record; a record that fails to decode is replaced by zeros,
counted and quarantined, and each record's bytes pass the
``io.corrupt_record`` payload fault site first.  Without cv2 the
iterator's resize is `resize_linear`,
the fixed-point arithmetic of cv2's INTER_LINEAR for uint8, and
``fast_decode`` (libjpeg's reduced decode) falls back to a full decode.
The detection pipeline (`image_detection`: the Det augmenters,
`CreateDetAugmenter`, `ImageDetIter`) shares this namespace, as in the
reference.
"""
from __future__ import annotations

import ctypes
import logging
import os
import random as _pyrandom
import threading

import numpy as np
import torch

from .base import MXNetError
from .context import cpu
from .io import DataIter, DataBatch, DataDesc
from .obs import metrics as _obs_metrics
from .obs import trace as _obs_trace
from .ndarray.ndarray import NDArray, array
from . import native as _native
from . import recordio as _recordio
from .resilience import faults as _faults

_log = logging.getLogger(__name__)

__all__ = ["imdecode", "resize_short", "center_crop", "random_crop",
           "random_size_crop", "resize_linear", "decode_bgr", "decode_rgb",
           "Augmenter", "ResizeAug", "ForceResizeAug", "RandomCropAug",
           "CenterCropAug", "RandomSizedCropAug", "HorizontalFlipAug",
           "BrightnessJitterAug", "ColorNormalizeAug", "CastAug",
           "CreateAugmenter", "ImageIter", "ImageRecordIterImpl",
           "CodecUnavailableError", "decode_route"]


class CodecUnavailableError(MXNetError):
    """A record's image format has no decoder on this machine."""


# ---------------------------------------------------------------------------
# codecs: cv2, then PIL, then numpy PPM
# ---------------------------------------------------------------------------

def cv2_module():
    """OpenCV's module, or None where it does not import."""
    try:
        import cv2
    except ImportError:
        return None
    return cv2


def pil_module():
    """PIL's ``Image`` module, or None where it does not import."""
    try:
        from PIL import Image
    except ImportError:
        return None
    return Image


def decode_route():
    """The route `decode_bgr` takes on this machine: "cv2", "pil" or
    "numpy" (binary PPM only)."""
    if cv2_module() is not None:
        return "cv2"
    return "pil" if pil_module() is not None else "numpy"


def _ppm_fields(buf):
    """(width, height, maxval, header bytes) of a binary PPM (P6)
    header, or None when `buf` is not one."""
    if bytes(buf[:2]) != b"P6":
        return None
    fields, pos, n = [], 2, len(buf)
    while len(fields) < 3:
        while pos < n and buf[pos] in b" \t\r\n":
            pos += 1
        if pos < n and buf[pos] == ord("#"):
            while pos < n and buf[pos] not in b"\r\n":
                pos += 1
            continue
        start = pos
        while pos < n and buf[pos] not in b" \t\r\n":
            pos += 1
        if start == pos:
            return None
        fields.append(int(bytes(buf[start:pos])))
    return fields[0], fields[1], fields[2], pos + 1   # one whitespace


def decode_ppm(buf):
    """HWC uint8 RGB pixels of a binary PPM (P6, maxval 255), or None
    when `buf` is not one (or is cut short)."""
    head = _ppm_fields(buf)
    if head is None:
        return None
    w, h, maxval, off = head
    if maxval != 255 or len(buf) < off + w * h * 3:
        return None
    return np.frombuffer(buf, np.uint8, w * h * 3, off).reshape(h, w, 3)


def decode_bgr(payload, reduced=False):
    """``cv2.imdecode(payload, IMREAD_COLOR)`` (``IMREAD_REDUCED_COLOR_2``
    with `reduced`): HWC uint8 BGR, or None when the bytes do not decode.
    Without cv2, PIL decodes (its RGB reversed) and numpy reads PPM;
    `reduced` needs cv2 and is ignored without it.  Raises
    `CodecUnavailableError` for a compressed image no route can read."""
    raw = np.frombuffer(payload, np.uint8)
    cv2 = cv2_module()
    if cv2 is not None:
        return cv2.imdecode(raw, cv2.IMREAD_REDUCED_COLOR_2 if reduced
                            else cv2.IMREAD_COLOR)
    pil = pil_module()
    if pil is not None:
        import io as _io
        try:
            img = pil.open(_io.BytesIO(bytes(payload)))
            rgb = np.asarray(img.convert("RGB"), dtype=np.uint8)
        except (OSError, ValueError, SyntaxError):
            return None
        return np.ascontiguousarray(rgb[:, :, ::-1])
    rgb = decode_ppm(raw)
    if rgb is not None:
        return np.ascontiguousarray(rgb[:, :, ::-1])
    head = bytes(raw[:12])
    kind = next((name for sig, name in _COMPRESSED if head.startswith(sig)),
                None)
    if kind is None:
        return None                      # not an image: a corrupt record
    raise CodecUnavailableError(
        f"no decoder for a {kind} image: neither cv2 nor PIL imports, and "
        "numpy reads only binary PPM (P6); pack the records as PPM or "
        "install a codec")


# signatures of the formats cv2 decodes that the numpy route cannot
_COMPRESSED = ((b"\xff\xd8\xff", "JPEG"), (b"\x89PNG", "PNG"),
               (b"GIF8", "GIF"), (b"BM", "BMP"), (b"RIFF", "WebP"),
               (b"II*\x00", "TIFF"), (b"MM\x00*", "TIFF"))


def decode_rgb(payload):
    """HWC uint8 RGB pixels: PIL as the JAX package decodes, else cv2
    (reversed), else numpy PPM."""
    pil = pil_module()
    if pil is not None:
        import io as _io
        img = pil.open(_io.BytesIO(bytes(payload)))
        return np.asarray(img.convert("RGB"), dtype=np.uint8)
    bgr = decode_bgr(payload)
    if bgr is None:
        raise MXNetError("decode_rgb: not a decodable image")
    return np.ascontiguousarray(bgr[:, :, ::-1])


# ---------------------------------------------------------------------------
# resize
# ---------------------------------------------------------------------------

_COEF_SCALE = 2048   # cv2's INTER_RESIZE_COEF_SCALE (11 fraction bits)


def _linear_weights(n_src, n_dst):
    """cv2's INTER_LINEAR taps along one axis: the source index left of
    each output position (half-pixel centres, the scale as cv2 forms it)
    and the fraction past it, in fp32."""
    scale = 1.0 / (n_dst / n_src)
    f = ((np.arange(n_dst, dtype=np.float64) + 0.5) * scale
         - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s.astype(np.float32)).astype(np.float32)
    return s, f


def _fixed(f):
    """The two weights of fraction `f` in 11-bit fixed point."""
    return (np.rint((np.float32(1) - f) * _COEF_SCALE).astype(np.int32),
            np.rint(f * _COEF_SCALE).astype(np.int32))


def resize_linear(img, w, h):
    """Bilinear resize of an HWC (or HW) uint8 image to `w` x `h` with
    the arithmetic of ``cv2.resize(img, (w, h))`` (INTER_LINEAR): half-
    pixel centres, no antialias, 11-bit fixed-point weights, columns
    clamped at the edges, rows read clipped, the vertical pass on
    (row >> 4) products; an exact 2x downscale averages 2x2 blocks, as
    cv2 does there; the same size is a copy."""
    ih, iw = img.shape[:2]
    if (ih, iw) == (h, w):
        return img.copy()
    if iw == 2 * w and ih == 2 * h:
        x = img.astype(np.int32)
        return ((x[0::2, 0::2] + x[0::2, 1::2] + x[1::2, 0::2]
                 + x[1::2, 1::2] + 2) >> 2).astype(np.uint8)
    xs, fx = _linear_weights(iw, w)
    lo, hi = xs < 0, xs >= iw - 1
    fx[lo | hi] = 0
    xs = np.clip(xs, 0, iw - 1)
    a0, a1 = _fixed(fx)
    ys, fy = _linear_weights(ih, h)
    b0, b1 = _fixed(fy)
    y0, y1 = np.clip(ys, 0, ih - 1), np.clip(ys + 1, 0, ih - 1)
    extra = (1,) * (img.ndim - 2)
    src = img.astype(np.int32)
    hor = src[:, xs] * a0.reshape((1, -1) + extra) + \
        src[:, np.minimum(xs + 1, iw - 1)] * a1.reshape((1, -1) + extra)
    vs = (-1, 1) + extra
    out = (((hor[y0] >> 4) * b0.reshape(vs)) >> 16) + \
        (((hor[y1] >> 4) * b1.reshape(vs)) >> 16)
    return np.clip((out + 2) >> 2, 0, 255).astype(np.uint8)


def _resize_cv2(img, w, h):
    """``cv2.resize(img, (w, h))``, or `resize_linear` without cv2."""
    cv2 = cv2_module()
    if cv2 is not None:
        return cv2.resize(img, (w, h))
    return resize_linear(img, w, h)


# ---------------------------------------------------------------------------
# numpy augmenter primitives (reference image_aug_default.cc)
# ---------------------------------------------------------------------------

def _host(src):
    return src.asnumpy() if isinstance(src, NDArray) else src


def _u8(img):
    return array(img, ctx=cpu(), dtype="uint8")


def imdecode(buf, to_rgb=1, **kwargs):
    """Decode image bytes to an NDArray HWC uint8 on the CPU (reference
    `image_io.cc imdecode`), RGB unless ``to_rgb=0``."""
    img = decode_rgb(buf)
    return _u8(img if to_rgb else img[:, :, ::-1].copy())


def _resize_np(img, w, h, interp=2):
    """The augmenters' resize: PIL's BILINEAR, as the JAX package
    resizes (antialiased when it shrinks); `resize_linear` without
    PIL."""
    pil = pil_module()
    if pil is None:
        return resize_linear(np.ascontiguousarray(img), w, h)
    return np.asarray(pil.fromarray(img).resize((w, h), pil.BILINEAR))


def resize_short(src, size, interp=2):
    """Resize the shorter edge to `size` (reference `image.py
    resize_short`)."""
    img = _host(src)
    h, w = img.shape[:2]
    if h > w:
        new_w, new_h = size, int(h * size / w)
    else:
        new_w, new_h = int(w * size / h), size
    return _u8(_resize_np(img, new_w, new_h))


def center_crop(src, size, interp=2):
    img = _host(src)
    h, w = img.shape[:2]
    cw, ch = size
    x0 = max((w - cw) // 2, 0)
    y0 = max((h - ch) // 2, 0)
    out = img[y0:y0 + ch, x0:x0 + cw]
    if out.shape[:2] != (ch, cw):
        out = _resize_np(out, cw, ch)
    return _u8(out), (x0, y0, cw, ch)


def random_crop(src, size, interp=2):
    img = _host(src)
    h, w = img.shape[:2]
    cw, ch = size
    if w < cw or h < ch:
        img = _resize_np(img, max(w, cw), max(h, ch))
        h, w = img.shape[:2]
    x0 = _pyrandom.randint(0, w - cw)
    y0 = _pyrandom.randint(0, h - ch)
    return _u8(img[y0:y0 + ch, x0:x0 + cw]), (x0, y0, cw, ch)


def random_size_crop(src, size, area, ratio, interp=2):
    """Random-resized-crop (reference image_aug_default.cc / image.py)."""
    img = _host(src)
    h, w = img.shape[:2]
    src_area = h * w
    if isinstance(area, (int, float)):
        area = (area, 1.0)
    for _ in range(10):
        target_area = _pyrandom.uniform(*area) * src_area
        log_ratio = (np.log(ratio[0]), np.log(ratio[1]))
        aspect = np.exp(_pyrandom.uniform(*log_ratio))
        cw = int(round(np.sqrt(target_area * aspect)))
        ch = int(round(np.sqrt(target_area / aspect)))
        if cw <= w and ch <= h:
            x0 = _pyrandom.randint(0, w - cw)
            y0 = _pyrandom.randint(0, h - ch)
            crop = img[y0:y0 + ch, x0:x0 + cw]
            return _u8(_resize_np(crop, size[0], size[1])), \
                (x0, y0, cw, ch)
    return center_crop(_u8(_resize_np(img, size[0], size[1])), size)


class Augmenter:
    """Base augmenter (reference `image.py:Augmenter`)."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        import json
        return json.dumps([self.__class__.__name__.lower(), self._kwargs],
                          default=lambda o: o.tolist()
                          if hasattr(o, "tolist") else str(o))

    def __call__(self, src):
        raise NotImplementedError


class ResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size

    def __call__(self, src):
        return resize_short(src, self.size)


class ForceResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size

    def __call__(self, src):
        return _u8(_resize_np(_host(src), self.size[0], self.size[1]))


class RandomCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size

    def __call__(self, src):
        return random_crop(src, self.size)[0]


class CenterCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size

    def __call__(self, src):
        return center_crop(src, self.size)[0]


class RandomSizedCropAug(Augmenter):
    def __init__(self, size, area, ratio, interp=2):
        super().__init__(size=size, area=area, ratio=ratio, interp=interp)
        self.size = size
        self.area = area
        self.ratio = ratio

    def __call__(self, src):
        return random_size_crop(src, self.size, self.area, self.ratio)[0]


class HorizontalFlipAug(Augmenter):
    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if _pyrandom.random() < self.p:
            return _u8(_host(src)[:, ::-1].copy())
        return src


class BrightnessJitterAug(Augmenter):
    def __init__(self, brightness):
        super().__init__(brightness=brightness)
        self.brightness = brightness

    def __call__(self, src):
        alpha = 1.0 + _pyrandom.uniform(-self.brightness, self.brightness)
        img = (_host(src).astype("float32") * alpha).clip(0, 255)
        return _u8(img.astype("uint8"))


class ColorNormalizeAug(Augmenter):
    def __init__(self, mean, std):
        super().__init__(mean=mean, std=std)
        self.mean = np.asarray(mean, dtype="float32") \
            if mean is not None else None
        self.std = np.asarray(std, dtype="float32") \
            if std is not None else None

    def __call__(self, src):
        img = _host(src).astype("float32")
        if self.mean is not None:
            img = img - self.mean
        if self.std is not None:
            img = img / self.std
        return array(img, ctx=cpu(), dtype="float32")


class CastAug(Augmenter):
    def __call__(self, src):
        return array(_host(src).astype("float32"), ctx=cpu(),
                     dtype="float32")


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,
                    rand_mirror=False, mean=None, std=None, brightness=0,
                    contrast=0, saturation=0, hue=0, pca_noise=0,
                    rand_gray=0, inter_method=2):
    """Reference `image.py CreateAugmenter`."""
    auglist = []
    if resize > 0:
        auglist.append(ResizeAug(resize, inter_method))
    crop_size = (data_shape[2], data_shape[1])
    if rand_resize:
        auglist.append(RandomSizedCropAug(crop_size, (0.08, 1.0),
                                          (3 / 4.0, 4 / 3.0), inter_method))
    elif rand_crop:
        auglist.append(RandomCropAug(crop_size, inter_method))
    else:
        auglist.append(CenterCropAug(crop_size, inter_method))
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5))
    auglist.append(CastAug())
    if brightness:
        auglist.append(BrightnessJitterAug(brightness))
    if mean is True:
        mean = np.array([123.68, 116.28, 103.53])
    if std is True:
        std = np.array([58.395, 57.12, 57.375])
    if mean is not None or std is not None:
        auglist.append(ColorNormalizeAug(mean, std))
    return auglist


def _auto_parts(part_index):
    """(part_index, num_parts) for an explicit ``num_parts='auto'``:
    the dist environment when MXNET_IO_AUTO_SHARD is on, else one
    part."""
    from . import config as _config
    if not _config.get("MXNET_IO_AUTO_SHARD"):
        return 0, 1
    from . import io_plane as _io_plane
    return _io_plane.auto_shard(part_index if part_index != "auto"
                                else None, None)


def _host_batch(data):
    """A CPU NDArray over a numpy batch, without a copy."""
    return NDArray(torch.from_numpy(np.ascontiguousarray(data)), ctx=cpu())


class ImageIter(DataIter):
    """Python image iterator over a .rec or an image list
    (reference `python/mxnet/image/image.py:ImageIter`)."""

    def __init__(self, batch_size, data_shape, label_width=1,
                 path_imgrec=None, path_imglist=None, path_root=None,
                 shuffle=False, part_index=None, num_parts=None,
                 aug_list=None, imglist=None, data_name="data",
                 label_name="softmax_label", **kwargs):
        super().__init__(batch_size)
        assert path_imgrec or path_imglist or imglist
        self.data_shape = tuple(data_shape)
        self.batch_size = batch_size
        self.label_width = label_width
        self.shuffle = shuffle
        self.auglist = aug_list if aug_list is not None else \
            CreateAugmenter(data_shape, **{k: v for k, v in kwargs.items()
                                           if k in ("resize", "rand_crop",
                                                    "rand_resize",
                                                    "rand_mirror", "mean",
                                                    "std")})
        self.imgrec = None
        self.imglist = None
        self.path_root = path_root
        if path_imgrec:
            idx_path = os.path.splitext(path_imgrec)[0] + ".idx"
            if os.path.exists(idx_path):
                self.imgrec = _recordio.MXIndexedRecordIO(
                    idx_path, path_imgrec, "r")
                self.seq = list(self.imgrec.keys)
            else:
                self.imgrec = _recordio.MXRecordIO(path_imgrec, "r")
                self.seq = None
        elif path_imglist:
            with open(path_imglist) as fin:
                imglist = {}
                for line in fin:
                    parts = line.strip().split("\t")
                    label = np.asarray(parts[1:-1], dtype="float32")
                    imglist[int(parts[0])] = (label, parts[-1])
                self.imglist = imglist
                self.seq = list(imglist.keys())
        else:
            self.imglist = {i: (np.asarray(l, dtype="float32"), p)
                            for i, (l, p) in enumerate(imglist)}
            self.seq = list(self.imglist.keys())
        # the shard (`recordio.shard_range`) re-resolves at every reset
        self._full_seq = list(self.seq) if self.seq is not None else None
        self._part_index_req = part_index
        self._num_parts_req = num_parts
        self._quarantined_ids = set()
        self._reshard_seq()
        self.cur = 0
        self.data_name = data_name
        self.label_name = label_name
        self.corrupt_records = 0   # undecodable/corrupt samples skipped
        self._quarantine = None
        self._last_idx = None
        self.reset()

    def set_quarantine(self, log):
        """Attach a quarantine log: corrupt samples this iterator skips
        append one entry each, and so do the RecordIO reader's skips."""
        self._quarantine = log
        if self.imgrec is not None:
            self.imgrec.set_quarantine(log)

    def apply_quarantine(self, entries):
        """Drop records quarantined earlier for this source: their ids
        never enter an epoch's sequence again."""
        if self.seq is None:
            return
        bad = {int(e["record"]) for e in entries
               if e.get("record") is not None and e.get("source") in (
                   None, getattr(self.imgrec, "uri", None))}
        if bad:
            self._quarantined_ids.update(bad)
            self.seq = [k for k in self.seq if k not in bad]

    def _reshard_seq(self):
        """This epoch's sequence: the resolved shard window minus the
        quarantined ids."""
        if self._full_seq is None:
            return
        pi, nparts = self._part_index_req, self._num_parts_req
        if nparts == "auto":
            pi, nparts = _auto_parts(pi)
        elif nparts in (None, 0):
            pi, nparts = 0, 1
        lo, hi = _recordio.shard_range(len(self._full_seq), int(nparts),
                                       int(pi or 0))
        bad = self._quarantined_ids
        self.seq = [k for k in self._full_seq[lo:hi] if k not in bad]

    def _corrupt_sample(self, idx, exc):
        self.corrupt_records += 1
        _log.warning("ImageIter: skipping corrupt record %s (%s) — "
                     "corrupt_records=%d", idx, str(exc)[:120],
                     self.corrupt_records)
        _recordio.quarantine_append(
            self._quarantine, reason="corrupt_record",
            source=getattr(self.imgrec, "uri", None),
            record=idx if isinstance(idx, int) else None,
            detail=str(exc)[:200])
        _faults.note("corrupt-record", site="io.corrupt_record",
                     record=idx if isinstance(idx, int) else -1)

    @property
    def provide_data(self):
        return [DataDesc(self.data_name,
                         (self.batch_size,) + self.data_shape)]

    @property
    def provide_label(self):
        shape = (self.batch_size,) if self.label_width == 1 else \
            (self.batch_size, self.label_width)
        return [DataDesc(self.label_name, shape)]

    def reset(self):
        self._reshard_seq()
        if self.shuffle and self.seq is not None:
            _pyrandom.shuffle(self.seq)
        if self.imgrec is not None and self.seq is None:
            self.imgrec.reset()
        self.cur = 0

    def next_sample(self):
        self._last_idx = None
        if self.seq is not None:
            if self.cur >= len(self.seq):
                raise StopIteration
            idx = self.seq[self.cur]
            self.cur += 1
            self._last_idx = idx
            if self.imgrec is not None:
                s = self.imgrec.read_idx(idx)
                header, img = _recordio.unpack(s)
                return header.label, img
            label, fname = self.imglist[idx]
            with open(os.path.join(self.path_root or "", fname), "rb") as f:
                return label, f.read()
        s = self.imgrec.read()
        if s is None:
            raise StopIteration
        header, img = _recordio.unpack(s)
        return header.label, img

    def next(self):
        c, h, w = self.data_shape
        batch_data = np.zeros((self.batch_size, c, h, w), dtype="float32")
        batch_label = np.zeros((self.batch_size, self.label_width),
                               dtype="float32")
        i = 0
        pad = 0
        try:
            while i < self.batch_size:
                try:
                    label, buf = self.next_sample()
                    img = imdecode(buf)
                except StopIteration:
                    raise
                except CodecUnavailableError:
                    raise
                except Exception as e:   # noqa: BLE001 - a bad record
                    # a corrupt record (torn payload, damaged image, bad
                    # header) must not end the epoch: skip and count it
                    self._corrupt_sample(self._last_idx, e)
                    continue
                for aug in self.auglist:
                    img = aug(img)
                batch_data[i] = img.asnumpy().transpose(2, 0, 1)
                lab = np.asarray(label, dtype="float32").reshape(-1)
                batch_label[i, :len(lab[:self.label_width])] = \
                    lab[:self.label_width]
                i += 1
        except StopIteration:
            if i == 0:
                raise
            pad = self.batch_size - i
        label_out = batch_label[:, 0] if self.label_width == 1 \
            else batch_label
        return DataBatch(data=[_host_batch(batch_data)],
                         label=[_host_batch(label_out)], pad=pad,
                         provide_data=self.provide_data,
                         provide_label=self.provide_label)


class ImageRecordIterImpl(DataIter):
    """Param-compatible `ImageRecordIter` (reference
    `iter_image_recordio_2.cc:727` registration).

    The whole .rec is mapped into memory and indexed in one native scan
    (`src/io_native.cc mxtpu_recordio_index`); `preprocess_threads`
    workers each build whole batches (cv2's decode and the native
    crop/mirror/normalize/HWC->CHW finish release the GIL) and a reorder
    buffer hands them out in order.  The augmentation of batch b of an
    epoch draws from a stream seeded by (seed, epoch, b), so the batches
    are the same under any thread count, and the same as the JAX
    iterator's.
    """

    def __init__(self, path_imgrec, data_shape, batch_size, label_width=1,
                 shuffle=False, rand_crop=False, rand_mirror=False,
                 mean_r=0.0, mean_g=0.0, mean_b=0.0, std_r=1.0, std_g=1.0,
                 std_b=1.0, resize=0, part_index=None, num_parts=None,
                 preprocess_threads=None, prefetch_buffer=4,
                 round_batch=True, data_name="data",
                 label_name="softmax_label", seed=0, fast_decode=True,
                 device_augment=False, **kwargs):
        super().__init__(batch_size)
        from . import config as _config
        if preprocess_threads is None:
            preprocess_threads = _config.get("MXNET_CPU_WORKER_NTHREADS")
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self._shuffle = shuffle
        self._rand_crop = rand_crop
        self._rand_mirror = rand_mirror
        self._resize = resize
        self._mean = np.array([mean_r, mean_g, mean_b], dtype="float32")
        # the original std too: normalize_symbol passes it to the
        # in-graph ImageNormalize, whose fp32 reciprocal then equals
        # `_stdinv` bit for bit
        self._std = np.array([std_r, std_g, std_b], dtype="float32")
        self._stdinv = 1.0 / np.array([std_r, std_g, std_b],
                                      dtype="float32")
        # batch builders are CPU-bound: more threads than cores only add
        # GIL contention
        self._threads = max(1, min(int(preprocess_threads),
                                   os.cpu_count() or 1))
        self._prefetch = max(2, int(prefetch_buffer))
        self._data_name = data_name
        self._label_name = label_name
        self._seed = seed
        self._rng = np.random.RandomState(seed)
        self._epoch = 0
        self._round_batch = round_batch
        # fast_decode: libjpeg's 1/2-scale decode when the frame stays
        # large enough for the resize (cv2 only); adaptive, see _decode
        self._fast_decode = bool(fast_decode)
        self._fd_tries = 0
        self._fd_wins = 0
        # device_augment: the host stops at crop + mirror and ships
        # uint8 NHWC; normalize, cast and NCHW run on the device
        # (`normalize_symbol`).  "auto" reads MXNET_IO_UINT8_WIRE.
        if isinstance(device_augment, str) and \
                device_augment.lower() in ("auto", "none"):
            device_augment = bool(_config.get("MXNET_IO_UINT8_WIRE"))
        self._device_augment = bool(device_augment)

        import mmap
        self._path_imgrec = path_imgrec
        self._file = open(path_imgrec, "rb")
        self._buf = mmap.mmap(self._file.fileno(), 0,
                              access=mmap.ACCESS_READ)
        self._records, n_corrupt = _index_records_tolerant(self._buf)
        # structural damage found at index time plus per-sample decode
        # failures found by the batch builders
        self.corrupt_records = n_corrupt
        self._corrupt_lock = threading.Lock()
        self._quarantine = None
        if n_corrupt:
            _log.warning("ImageRecordIter: %s holds %d corrupt region(s); "
                         "the damaged records are skipped (corrupt_records "
                         "counts them)", path_imgrec, n_corrupt)
        # record ids stay global (indexes into the full record list) so
        # quarantine entries attribute after a re-shard; the shard only
        # restricts the epoch order, re-resolved at every reset()
        self._part_index_req = part_index
        self._num_parts_req = num_parts
        self._quarantined = set()
        self.part_index = 0
        self.num_parts = 1
        self._pool = None
        self.reset()

    def _resolve_parts(self):
        """(part_index, num_parts) of the next epoch: only an explicit
        ``num_parts='auto'`` reads the dist environment; unset stays one
        part (an eval iterator must score the whole set)."""
        pi, nparts = self._part_index_req, self._num_parts_req
        if nparts == "auto":
            return _auto_parts(pi)
        if nparts in (None, 0):
            return 0, 1
        return int(pi or 0), int(nparts)

    def _reshard(self):
        """This epoch's record order from the resolved shard, minus the
        quarantined ids."""
        self.part_index, self.num_parts = self._resolve_parts()
        lo, hi = _recordio.shard_range(len(self._records),
                                       self.num_parts, self.part_index)
        if self._quarantined:
            self._order = np.asarray(
                [i for i in range(lo, hi) if i not in self._quarantined],
                dtype=np.int64)
        else:
            self._order = np.arange(lo, hi, dtype=np.int64)

    @property
    def provide_data(self):
        if self._device_augment:
            c, h, w = self.data_shape
            return [DataDesc(self._data_name, (self.batch_size, h, w, c),
                             dtype=np.uint8)]
        return [DataDesc(self._data_name,
                         (self.batch_size,) + self.data_shape)]

    @property
    def provide_label(self):
        shape = (self.batch_size,) if self.label_width == 1 else \
            (self.batch_size, self.label_width)
        return [DataDesc(self._label_name, shape)]

    def normalize_symbol(self, data, dtype="float32"):
        """The graph-side half of device_augment mode: `data` (a uint8
        NHWC variable) through ImageNormalize with this iterator's mean
        and its original std, to `dtype` NCHW."""
        from . import symbol as _sym
        return _sym.ImageNormalize(
            data, mean=tuple(float(v) for v in self._mean),
            std=tuple(float(v) for v in self._std), input_layout="NHWC",
            output_layout="NCHW", dtype=dtype)

    def _rebuild_pool(self):
        """(Re)build the batch pool over the current epoch order.
        round_batch: the tail batch wraps to the epoch start and reports
        the wrapped count as pad."""
        if self._pool is not None:
            self._pool.stop()
        n = len(self._order)
        n_batches = (-(-n // self.batch_size) if self._round_batch and
                     n % self.batch_size else n // self.batch_size)
        self._pool = _BatchPool(self._build_batch, n_batches, self._threads,
                                self._prefetch)

    def reset(self):
        self._reshard()
        if self._shuffle:
            self._rng.shuffle(self._order)
        self._epoch += 1
        self._rebuild_pool()

    def set_quarantine(self, log):
        """Attach a quarantine log: corrupt records the batch builders
        skip append one entry each (source path + record id)."""
        self._quarantine = log

    def apply_quarantine(self, entries):
        """Drop quarantined record ids of this .rec from the epoch order
        (and every later one); the record list keeps its ids."""
        bad = {int(e["record"]) for e in entries
               if e.get("record") is not None and
               e.get("source") in (None, self._path_imgrec)}
        if bad:
            self._quarantined.update(bad)
            self._order = np.asarray(
                [i for i in self._order if int(i) not in bad],
                dtype=np.int64)
            # without advancing the epoch (the augmentation streams key
            # on it)
            self._rebuild_pool()

    def record_range(self, nbatch):
        """(source, lo, hi): the record positions batch `nbatch` of this
        epoch draws from."""
        lo = int(nbatch) * self.batch_size
        return (self._path_imgrec, lo,
                min(lo + self.batch_size, len(self._order)))

    def _corrupt_record(self, rec_id, exc):
        with self._corrupt_lock:
            self.corrupt_records += 1
            n = self.corrupt_records
        _log.warning("ImageRecordIter: record %d of %s is corrupt (%s) — "
                     "substituting zeros and quarantining "
                     "(corrupt_records=%d)", rec_id, self._path_imgrec,
                     str(exc)[:120], n)
        _recordio.quarantine_append(
            self._quarantine, reason="corrupt_record",
            source=self._path_imgrec, record=int(rec_id),
            detail=str(exc)[:200])
        _faults.note("corrupt-record", site="io.corrupt_record",
                     record=int(rec_id))

    def close(self):
        if self._pool is not None:
            self._pool.stop()
            self._pool = None

    def __del__(self):
        try:
            self.close()
            self._buf.close()
            self._file.close()
        except Exception:   # noqa: BLE001 - interpreter shutdown
            pass

    def _decode(self, payload, need):
        """`decode_bgr`, at libjpeg's 1/2 scale when the frame stays at
        least `need` on its shorter side (cv2 only).  Adaptive: a reduced
        attempt that comes up short costs a second, full decode, so after
        16 tries the reduced path stays on only while it wins at least
        half the time.  The counters are shared by the worker threads
        without a lock, as in the JAX iterator."""
        if self._fast_decode and self._resize > 0 and need > 0 and \
                cv2_module() is not None and \
                (self._fd_tries < 16 or self._fd_wins * 2 >= self._fd_tries):
            self._fd_tries += 1
            img = decode_bgr(payload, reduced=True)
            if img is not None and min(img.shape[:2]) >= need:
                self._fd_wins += 1
                return img
        return decode_bgr(payload)

    def _build_batch(self, bidx):
        c, h, w = self.data_shape
        bs = self.batch_size
        label = np.zeros((bs, self.label_width), dtype="float32")
        nat = _native.lib()
        base = bidx * bs
        n_rec = len(self._order)
        pad = max(0, base + bs - n_rec)
        # a per-batch stream: (seed, epoch, batch) fix the draws under any
        # thread schedule
        rng = np.random.RandomState(
            (self._seed * 1000003 + self._epoch * 8191 + bidx) % (2**31))
        crop_u = rng.rand(bs, 2) if self._rand_crop else None
        mirrors = (rng.rand(bs) < 0.5).astype(np.int32) \
            if self._rand_mirror else np.zeros(bs, np.int32)
        need = self._resize if self._resize else max(h, w)

        imgs = []
        dims = np.empty((4, bs), np.int64)  # rows: ih, iw, y0, x0
        for i in range(bs):
            rec_id = int(self._order[(base + i) % n_rec])
            header = img = None
            try:
                raw = _record_payload(self._buf, self._records[rec_id])
                # the payload fault site: a ``corrupt`` clause bit-flips
                # this record's bytes, deterministically
                raw = _faults.mutate("io.corrupt_record", bytes(raw),
                                     record=rec_id)
                header, payload = _recordio.unpack(raw)
                img = self._decode(payload, need)
                if img is None:
                    raise MXNetError("not a decodable image")
            except CodecUnavailableError:
                raise
            except Exception as e:   # noqa: BLE001 - a bad record
                # a corrupt record must not end the epoch: a zero image
                # (deterministic), counted and quarantined
                self._corrupt_record(rec_id, e)
                header, img = None, np.zeros((h, w, c), np.uint8)
            if self._resize:
                ih, iw = img.shape[:2]
                if ih > iw:
                    img = _resize_cv2(img, self._resize,
                                      int(ih * self._resize / iw))
                else:
                    img = _resize_cv2(img, int(iw * self._resize / ih),
                                      self._resize)
            ih, iw = img.shape[:2]
            if ih < h or iw < w:
                img = _resize_cv2(img, max(iw, w), max(ih, h))
                ih, iw = img.shape[:2]
            if self._rand_crop:
                y0 = int(crop_u[i, 0] * (ih - h + 1))
                x0 = int(crop_u[i, 1] * (iw - w + 1))
            else:
                y0, x0 = (ih - h) // 2, (iw - w) // 2
            if not img.flags["C_CONTIGUOUS"]:
                img = np.ascontiguousarray(img)
            imgs.append(img)
            dims[:, i] = (ih, iw, y0, x0)
            if header is not None:
                lab = np.asarray(header.label, dtype="float32").reshape(-1)
                label[i, :min(len(lab), self.label_width)] = \
                    lab[:self.label_width]

        # a fresh buffer each batch, never recycled: the emitted NDArray
        # wraps it without a copy
        u8 = self._device_augment
        if nat is not None:
            dims = np.ascontiguousarray(dims)
            ptrs = (ctypes.c_void_p * bs)(
                *(img.ctypes.data for img in imgs))
            i64p = ctypes.POINTER(ctypes.c_int64)
            mirrors_p = np.ascontiguousarray(mirrors).ctypes.data_as(
                ctypes.POINTER(ctypes.c_int))
        if u8:
            # crop + mirror + BGR->RGB into uint8 NHWC
            data = np.empty((bs, h, w, c), dtype=np.uint8)
            if nat is not None:
                nat.mxtpu_crop_batch_u8(
                    ptrs, dims[0].ctypes.data_as(i64p),
                    dims[1].ctypes.data_as(i64p), c,
                    dims[2].ctypes.data_as(i64p),
                    dims[3].ctypes.data_as(i64p), h, w, mirrors_p,
                    data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                    bs, 1)
            else:
                for i, img in enumerate(imgs):
                    ih, iw, y0, x0 = dims[:, i]
                    crop = img[y0:y0 + h, x0:x0 + w, ::-1]
                    if mirrors[i]:
                        crop = crop[:, ::-1]
                    data[i] = crop
            return self._emit(data, label, pad)
        data = np.empty((bs, c, h, w), dtype="float32")
        if nat is not None:
            # the kernel reverses BGR into RGB planes as it goes
            f32p = ctypes.POINTER(ctypes.c_float)
            nat.mxtpu_augment_batch(
                ptrs, dims[0].ctypes.data_as(i64p),
                dims[1].ctypes.data_as(i64p), c,
                dims[2].ctypes.data_as(i64p),
                dims[3].ctypes.data_as(i64p), h, w, mirrors_p,
                self._mean.ctypes.data_as(f32p),
                self._stdinv.ctypes.data_as(f32p),
                data.ctypes.data_as(f32p), bs, 1)
        else:
            for i, img in enumerate(imgs):
                ih, iw, y0, x0 = dims[:, i]
                crop = img[y0:y0 + h, x0:x0 + w, ::-1]
                if mirrors[i]:
                    crop = crop[:, ::-1]
                data[i] = ((crop.astype("float32") - self._mean)
                           * self._stdinv).transpose(2, 0, 1)
        return self._emit(data, label, pad)

    def _emit(self, data, label, pad):
        """The batch as CPU NDArrays over the numpy buffers: the ring
        (`io_plane`) copies them to the card."""
        label_out = label[:, 0] if self.label_width == 1 else label
        return DataBatch(data=[_host_batch(data)],
                         label=[_host_batch(label_out)], pad=pad,
                         provide_data=self.provide_data,
                         provide_label=self.provide_label)

    def next(self):
        batch = self._pool.next()
        if batch is None:
            raise StopIteration
        return batch


class _WorkerError:
    """A worker exception in transit to the consumer thread."""

    __slots__ = ("exc",)

    def __init__(self, exc):
        self.exc = exc


class _BatchPool:
    """N workers building whole batches; results handed out in order.
    Each build is an ``io.decode`` span and the finished-but-unread
    batches the ``io.decode.queue_depth`` gauge, as in the JAX package."""

    def __init__(self, build, n_batches, n_threads, prefetch):
        self._build = build
        self._n = n_batches
        self._stop_evt = threading.Event()
        self._results = {}
        self._cond = threading.Condition()
        self._next_out = 0
        self._max_ahead = max(prefetch, n_threads + 1)
        self._task = iter(range(n_batches))
        self._task_lock = threading.Lock()
        self._threads = [threading.Thread(target=self._work, daemon=True,
                                          name=f"mx-io-decode-{i}")
                         for i in range(n_threads)]
        for t in self._threads:
            t.start()

    def _work(self):
        while not self._stop_evt.is_set():
            with self._task_lock:
                bidx = next(self._task, None)
            if bidx is None:
                return
            with self._cond:
                # bounded read-ahead keeps memory flat
                self._cond.wait_for(
                    lambda: self._stop_evt.is_set()
                    or bidx < self._next_out + self._max_ahead)
                if self._stop_evt.is_set():
                    return
            try:
                with _obs_trace.span("io.decode", cat="io", batch=bidx):
                    out = self._build(bidx)
            except BaseException as e:   # noqa: BLE001 - re-raised by next()
                out = _WorkerError(e)
            with self._cond:
                self._results[bidx] = out
                _obs_metrics.gauge("io.decode.queue_depth").set(
                    len(self._results))
                self._cond.notify_all()

    def next(self):
        if self._next_out >= self._n:
            return None
        with self._cond:
            self._cond.wait_for(lambda: self._next_out in self._results)
            out = self._results.pop(self._next_out)
            self._next_out += 1
            self._cond.notify_all()
        if isinstance(out, _WorkerError):
            self.stop()
            raise out.exc
        return out

    def stop(self):
        self._stop_evt.set()
        with self._cond:
            self._cond.notify_all()
        for t in self._threads:
            t.join(timeout=5)


def _group_parts(parts):
    """Group (offset, length, cflag) physical parts into logical records:
    cflag 0 stands alone; 1/2*/3 sequences form one record.  A truncated
    sequence or a continuation without a start drops the damaged record
    and counts it.  Returns (records, n_corrupt)."""
    records = []
    pending = None
    corrupt = 0
    for off, ln, cf in parts:
        if cf == 0:
            if pending is not None:
                corrupt += 1     # interrupted multi-part: drop it
                pending = None
            records.append([(off, ln)])
        elif cf == 1:
            if pending is not None:
                corrupt += 1
            pending = [(off, ln)]
        elif cf in (2, 3):
            if pending is None:
                corrupt += 1     # continuation without a start
                continue
            pending.append((off, ln))
            if cf == 3:
                records.append(pending)
                pending = None
        else:
            corrupt += 1
            pending = None
    if pending is not None:
        corrupt += 1             # truncated multi-part record at EOF
    return records, corrupt


def _record_payload(buf, segments):
    """Payload bytes of one logical record: a single part is a slice of
    the mapped file; parts re-join with the magic word the writer
    dropped at each split."""
    if len(segments) == 1:
        off, ln = segments[0]
        return buf[off:off + ln]
    return _recordio.MAGIC_BYTES.join(bytes(buf[off:off + ln])
                                      for off, ln in segments)


def _index_records_tolerant(buf):
    """Segment lists of every logical record: the native scan where the
    library builds, a struct walk otherwise.  A magic mismatch resyncs on
    the next magic word (the bytes between are one corrupt region), a
    truncated tail stops the scan, broken multi-part sequences drop (see
    `_group_parts`); a native scan that reports invalid structure (-1)
    falls back to the walk.  Returns (records, n_corrupt)."""
    nat = _native.lib()
    parts = None
    corrupt = 0
    if nat is not None:
        cap = max(1024, len(buf) // 12)
        offs = np.empty(cap, dtype=np.int64)
        lens = np.empty(cap, dtype=np.int64)
        cfls = np.empty(cap, dtype=np.int32)
        view = np.frombuffer(buf, dtype=np.uint8)
        n = nat.mxtpu_recordio_index(
            view.ctypes.data_as(ctypes.c_void_p), len(buf),
            offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            cfls.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), cap)
        if n >= 0:
            parts = list(zip(offs[:n].tolist(), lens[:n].tolist(),
                             cfls[:n].tolist()))
            # the native scan stops silently at a truncated tail: bytes
            # past the last part are one corrupt region
            end = 0
            if parts:
                off, ln, _ = parts[-1]
                end = off + ln + (4 - ln % 4) % 4
            if len(buf) - end > 0:
                corrupt += 1
    if parts is None:
        import struct as _struct
        out = []
        pos = 0
        while pos + 8 <= len(buf):
            magic, lrec = _struct.unpack_from("<II", buf, pos)
            if magic != _recordio.MAGIC:
                corrupt += 1
                hit = buf.find(_recordio.MAGIC_BYTES, pos + 1)
                if hit == -1:
                    break
                pos = hit
                continue
            length = lrec & ((1 << 29) - 1)
            if pos + 8 + length > len(buf):
                corrupt += 1     # truncated tail record
                break
            out.append((pos + 8, length, lrec >> 29))
            pos += 8 + length + (4 - length % 4) % 4
        parts = out
    records, n_bad = _group_parts(parts)
    return records, corrupt + n_bad


def _index_records(buf):
    """`_index_records_tolerant`'s records only."""
    return _index_records_tolerant(buf)[0]


# the detection pipeline shares this namespace in the reference (mx.image.*)
from .image_detection import (DetAugmenter, DetBorrowAug,   # noqa: E402
                              DetRandomSelectAug, DetHorizontalFlipAug,
                              DetRandomCropAug, DetRandomPadAug,
                              CreateDetAugmenter, ImageDetIter)
