"""Detection augmentation pipeline (reference
`python/mxnet/image/detection.py`): augmenters transform (image, boxes)
pairs, so crops, flips and pads move the ground-truth boxes with the
pixels.  Boxes are normalized [cls, x1, y1, x2, y2] rows, -1 padded.

PyTorch port of `incubator_mxnet_tpu/image_detection.py`, on the port's
`image.ImageIter`.  The augmenters draw from Python's `random`, as the
JAX ones do, so the same seed gives the same crops and flips in both.
Images stay host arrays (CPU NDArrays); a batch leaves as a CPU NDArray
over its numpy buffer, as `ImageIter`'s do.
"""
from __future__ import annotations

import json
import random as _pyrandom

import numpy as np

from .base import MXNetError
from .image import Augmenter, imdecode, _host, _host_batch, _u8
from .io import DataIter, DataBatch, DataDesc

__all__ = ["DetAugmenter", "DetBorrowAug", "DetRandomSelectAug",
           "DetHorizontalFlipAug", "DetRandomCropAug", "DetRandomPadAug",
           "CreateDetAugmenter", "ImageDetIter"]


class DetAugmenter:
    """Base detection augmenter (reference `detection.py:39`)."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        return json.dumps([self.__class__.__name__.lower(), self._kwargs],
                          default=lambda o: o.tolist()
                          if hasattr(o, "tolist") else str(o))

    def __call__(self, src, label):
        raise NotImplementedError


class DetBorrowAug(DetAugmenter):
    """Lift an image-only augmenter; labels pass through
    (reference `detection.py:65`)."""

    def __init__(self, augmenter):
        if not isinstance(augmenter, Augmenter):
            raise MXNetError("DetBorrowAug expects an image Augmenter")
        super().__init__(augmenter=augmenter.dumps())
        self.augmenter = augmenter

    def __call__(self, src, label):
        return self.augmenter(src), label


class DetRandomSelectAug(DetAugmenter):
    """Randomly pick one of several augmenters (reference `:90`)."""

    def __init__(self, aug_list, skip_prob=0.0):
        super().__init__(skip_prob=skip_prob)
        self.aug_list = aug_list
        self.skip_prob = skip_prob

    def __call__(self, src, label):
        if _pyrandom.random() < self.skip_prob or not self.aug_list:
            return src, label
        return _pyrandom.choice(self.aug_list)(src, label)


class DetHorizontalFlipAug(DetAugmenter):
    """Mirror image AND boxes (reference `:126`)."""

    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src, label):
        if _pyrandom.random() < self.p:
            src = _u8(_host(src)[:, ::-1].copy())
            label = label.copy()
            valid = label[:, 0] >= 0
            x1 = label[valid, 1].copy()
            label[valid, 1] = 1.0 - label[valid, 3]
            label[valid, 3] = 1.0 - x1
        return src, label


class DetRandomCropAug(DetAugmenter):
    """IOU-constrained random crop (reference `:152`): sample a crop whose
    IOU with some ground-truth box exceeds `min_object_covered`; boxes are
    clipped/dropped relative to the crop."""

    def __init__(self, min_object_covered=0.1, aspect_ratio_range=(0.75,
                 1.33), area_range=(0.05, 1.0), max_attempts=50):
        super().__init__(min_object_covered=min_object_covered,
                         aspect_ratio_range=aspect_ratio_range,
                         area_range=area_range, max_attempts=max_attempts)
        self.min_object_covered = min_object_covered
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = area_range
        self.max_attempts = max_attempts

    def _sample_crop(self, label):
        for _ in range(self.max_attempts):
            area = _pyrandom.uniform(*self.area_range)
            ratio = _pyrandom.uniform(*self.aspect_ratio_range)
            w = min(1.0, np.sqrt(area * ratio))
            h = min(1.0, np.sqrt(area / ratio))
            x0 = _pyrandom.uniform(0, 1 - w)
            y0 = _pyrandom.uniform(0, 1 - h)
            crop = (x0, y0, x0 + w, y0 + h)
            valid = label[:, 0] >= 0
            if not valid.any():
                return crop
            boxes = label[valid, 1:5]
            ix1 = np.maximum(boxes[:, 0], crop[0])
            iy1 = np.maximum(boxes[:, 1], crop[1])
            ix2 = np.minimum(boxes[:, 2], crop[2])
            iy2 = np.minimum(boxes[:, 3], crop[3])
            inter = np.maximum(ix2 - ix1, 0) * np.maximum(iy2 - iy1, 0)
            barea = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
            cover = inter / np.maximum(barea, 1e-12)
            if (cover >= self.min_object_covered).any():
                return crop
        return None

    def __call__(self, src, label):
        crop = self._sample_crop(label)
        if crop is None:
            return src, label
        img = _host(src)
        H, W = img.shape[:2]
        x0, y0, x1, y1 = crop
        px0, py0 = int(x0 * W), int(y0 * H)
        px1, py1 = max(px0 + 1, int(x1 * W)), max(py0 + 1, int(y1 * H))
        out = img[py0:py1, px0:px1]
        cw, ch = x1 - x0, y1 - y0
        new = np.full_like(label, -1.0)
        j = 0
        for row in label:
            if row[0] < 0:
                continue
            bx1 = (max(row[1], x0) - x0) / cw
            by1 = (max(row[2], y0) - y0) / ch
            bx2 = (min(row[3], x1) - x0) / cw
            by2 = (min(row[4], y1) - y0) / ch
            if bx2 - bx1 <= 0.001 or by2 - by1 <= 0.001:
                continue                  # box left the crop
            new[j, 0] = row[0]
            new[j, 1:5] = (bx1, by1, bx2, by2)
            new[j, 5:] = row[5:]
            j += 1
        return _u8(out), new


class DetRandomPadAug(DetAugmenter):
    """Pad to a larger random canvas; boxes shrink into it
    (reference `:323`)."""

    def __init__(self, aspect_ratio_range=(0.75, 1.33),
                 area_range=(1.0, 3.0), max_attempts=50,
                 pad_val=(127, 127, 127)):
        super().__init__(aspect_ratio_range=aspect_ratio_range,
                         area_range=area_range, max_attempts=max_attempts,
                         pad_val=pad_val)
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = area_range
        self.pad_val = np.asarray(pad_val, np.uint8)

    def __call__(self, src, label):
        img = _host(src)
        H, W = img.shape[:2]
        scale = _pyrandom.uniform(*self.area_range)
        if scale <= 1.0:
            return src, label
        ratio = _pyrandom.uniform(*self.aspect_ratio_range)
        nw = int(W * np.sqrt(scale * ratio))
        nh = int(H * np.sqrt(scale / ratio))
        nw, nh = max(nw, W), max(nh, H)
        ox = _pyrandom.randint(0, nw - W)
        oy = _pyrandom.randint(0, nh - H)
        canvas = np.empty((nh, nw, img.shape[2]), img.dtype)
        canvas[:] = self.pad_val
        canvas[oy:oy + H, ox:ox + W] = img
        label = label.copy()
        valid = label[:, 0] >= 0
        label[valid, 1] = (label[valid, 1] * W + ox) / nw
        label[valid, 3] = (label[valid, 3] * W + ox) / nw
        label[valid, 2] = (label[valid, 2] * H + oy) / nh
        label[valid, 4] = (label[valid, 4] * H + oy) / nh
        return _u8(canvas), label


def CreateDetAugmenter(data_shape, resize=0, rand_crop=0, rand_pad=0,
                       rand_gray=0, rand_mirror=False, mean=None, std=None,
                       brightness=0, contrast=0, saturation=0, pca_noise=0,
                       hue=0, inter_method=2, min_object_covered=0.1,
                       aspect_ratio_range=(0.75, 1.33),
                       area_range=(0.05, 3.0), max_attempts=50,
                       pad_val=(127, 127, 127)):
    """Reference `detection.py:482 CreateDetAugmenter`."""
    auglist = []
    if resize > 0:
        from .image import ResizeAug
        auglist.append(DetBorrowAug(ResizeAug(resize, inter_method)))
    if rand_crop > 0:
        crop = DetRandomCropAug(min_object_covered, aspect_ratio_range,
                                (area_range[0], min(1.0, area_range[1])),
                                max_attempts)
        auglist.append(DetRandomSelectAug([crop], 1 - rand_crop))
    if rand_mirror:
        auglist.append(DetHorizontalFlipAug(0.5))
    if rand_pad > 0:
        pad = DetRandomPadAug(aspect_ratio_range,
                              (1.0, max(1.0, area_range[1])), max_attempts,
                              pad_val)
        auglist.append(DetRandomSelectAug([pad], 1 - rand_pad))
    from .image import ForceResizeAug, CastAug, ColorNormalizeAug
    auglist.append(DetBorrowAug(ForceResizeAug((data_shape[2],
                                                data_shape[1]),
                                               inter_method)))
    auglist.append(DetBorrowAug(CastAug()))
    if mean is True:
        mean = np.array([123.68, 116.28, 103.53])
    if std is True:
        std = np.array([58.395, 57.12, 57.375])
    if mean is not None or std is not None:
        auglist.append(DetBorrowAug(ColorNormalizeAug(mean, std)))
    return auglist


class ImageDetIter(DataIter):
    """Detection iterator over .rec/list sources (reference
    `detection.py:594 ImageDetIter`): labels are (batch, max_objects, 5)."""

    def __init__(self, batch_size, data_shape, path_imgrec=None,
                 path_imglist=None, path_root=None, imglist=None,
                 shuffle=False, aug_list=None, data_name="data",
                 label_name="label", max_objects=16, **kwargs):
        super().__init__(batch_size)
        from .image import ImageIter
        self._iter = ImageIter(batch_size, data_shape,
                               path_imgrec=path_imgrec,
                               path_imglist=path_imglist,
                               path_root=path_root, imglist=imglist,
                               shuffle=shuffle, aug_list=[],
                               data_name=data_name, label_name=label_name)
        self.data_shape = tuple(data_shape)
        self.max_objects = max_objects
        self.auglist = aug_list if aug_list is not None else \
            CreateDetAugmenter(data_shape, **kwargs)
        self.data_name = data_name
        self.label_name = label_name

    @property
    def provide_data(self):
        return [DataDesc(self.data_name,
                         (self.batch_size,) + self.data_shape)]

    @property
    def provide_label(self):
        return [DataDesc(self.label_name,
                         (self.batch_size, self.max_objects, 5))]

    def reset(self):
        self._iter.reset()

    def _parse_label(self, raw):
        """Reference `detection.py _parse_label` convention: the label is
        [A, B, header..., objects...] where A = header width (counting A
        and B themselves), B = object record width >= 5; objects begin at
        raw[A:].  A flat multiple-of-5 list with no plausible header is
        accepted as bare [cls,x1,y1,x2,y2] rows for convenience."""
        raw = np.asarray(raw, np.float32).ravel()
        obj = None
        if raw.size >= 2:
            header = int(raw[0])
            width = int(raw[1])
            if (2 <= header <= raw.size and width >= 5
                    and float(header) == raw[0] and float(width) == raw[1]
                    and (raw.size - header) % width == 0):
                obj = raw[header:].reshape(-1, width)[:, :5]
        if obj is None:
            if raw.size % 5:
                raise MXNetError(
                    f"ImageDetIter: cannot parse label of size {raw.size} "
                    "(neither [A,B,header...,objects...] nor flat 5-wide)")
            obj = raw.reshape(-1, 5)
        out = np.full((self.max_objects, 5), -1.0, np.float32)
        n = min(len(obj), self.max_objects)
        out[:n] = obj[:n]
        return out

    def next(self):
        c, h, w = self.data_shape
        data = np.zeros((self.batch_size, c, h, w), np.float32)
        labels = np.full((self.batch_size, self.max_objects, 5), -1.0,
                         np.float32)
        i = 0
        pad = 0
        try:
            while i < self.batch_size:
                raw_label, buf = self._iter.next_sample()
                img = imdecode(buf)
                label = self._parse_label(raw_label)
                for aug in self.auglist:
                    img, label = aug(img, label)
                arr = img.asnumpy()
                data[i] = arr.transpose(2, 0, 1)
                labels[i] = label
                i += 1
        except StopIteration:
            if i == 0:
                raise
            pad = self.batch_size - i
        return DataBatch(data=[_host_batch(data)],
                         label=[_host_batch(labels)],
                         pad=pad, provide_data=self.provide_data,
                         provide_label=self.provide_label)
