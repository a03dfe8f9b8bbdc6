"""The detection data path of the PyTorch port (`image_detection`: the
Det augmenters, `CreateDetAugmenter`, `ImageDetIter`) against the JAX
package's, on the CPU.

The six cases of `tests/test_image_detection.py`, each run in the port
with its own assertions and held to the JAX package on the same image,
label and Python `random` seed, bit for bit (images and boxes); then
`ImageDetIter` over one .rec in both packages, with and without the
augmenters, batches, labels and pads equal bit for bit.
"""
import random

import numpy as np
import pytest

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import recordio as jrec

import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import recordio as trec


def _sample(pkg):
    rng = np.random.RandomState(0)
    img = pkg.nd.array(rng.randint(0, 255, (60, 80, 3), np.uint8),
                       ctx=pkg.cpu(), dtype="uint8")
    label = np.full((4, 5), -1.0, np.float32)
    label[0] = [1, 0.25, 0.25, 0.75, 0.75]
    label[1] = [0, 0.10, 0.10, 0.30, 0.40]
    return img, label


def _both(make, seed=0, calls=1):
    """`make(pkg)` -> augmenter, applied `calls` times to the sample in
    each package after random.seed(seed); the outputs of each."""
    out = []
    for pkg in (tmx, jmx):
        img, label = _sample(pkg)
        aug = make(pkg)
        random.seed(seed)
        got = []
        for _ in range(calls):
            o, lab = aug(img, label)
            got.append((o.asnumpy(), lab))
        out.append(got)
    for (a, la), (b, lb) in zip(*out):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(la, lb)
    return out[0]


def test_flip_moves_boxes():
    (out, lab), = _both(lambda pkg: pkg.image.DetHorizontalFlipAug(p=1.0))
    img, _ = _sample(tmx)
    np.testing.assert_array_equal(out, img.asnumpy()[:, ::-1])
    np.testing.assert_allclose(lab[0, [1, 3]], [0.25, 0.75], atol=1e-6)
    np.testing.assert_allclose(lab[1, [1, 3]], [0.70, 0.90], atol=1e-6)
    assert (lab[2:, 0] == -1).all()


def test_random_crop_clips_boxes():
    got = _both(lambda pkg: pkg.image.DetRandomCropAug(
        min_object_covered=0.5, area_range=(0.3, 0.8)), seed=3, calls=10)
    img, _ = _sample(tmx)
    found_smaller = False
    for out, lab in got:
        valid = lab[lab[:, 0] >= 0]
        assert len(valid) >= 1
        assert (valid[:, 1:5] >= -1e-6).all()
        assert (valid[:, 1:5] <= 1 + 1e-6).all()
        if out.shape != img.shape:
            found_smaller = True
    assert found_smaller


def test_random_pad_shrinks_boxes():
    (out, lab), = _both(lambda pkg: pkg.image.DetRandomPadAug(
        area_range=(2.0, 2.5)), seed=4)
    img, label = _sample(tmx)
    assert out.shape[0] >= img.shape[0] and out.shape[1] >= img.shape[1]
    v = lab[lab[:, 0] >= 0]
    orig = label[label[:, 0] >= 0]
    assert ((v[:, 3] - v[:, 1]) <= (orig[:, 3] - orig[:, 1]) + 1e-6).all()


def _write_rec(path, n=12, header=False):
    """`n` PNGs of 48x48 with one box each (class i % 3); with `header`
    the labels are [A=2, B=5, cls, x1, y1, x2, y2, ...] with a second
    box on odd records, else the flat 5-wide row."""
    import cv2
    rng = np.random.RandomState(1)
    rec = jrec.MXRecordIO(str(path), "w")
    for i in range(n):
        img = rng.randint(0, 255, (48, 48, 3), np.uint8)
        ok, enc = cv2.imencode(".png", img)
        objs = [[i % 3, 0.2, 0.2, 0.8, 0.8]]
        if header and i % 2:
            objs.append([(i + 1) % 3, 0.1, 0.3, 0.5, 0.9])
        label = np.asarray(objs, np.float32).ravel()
        if header:
            label = np.concatenate([[2.0, 5.0], label]).astype(np.float32)
        rec.write(jrec.pack(jrec.IRHeader(0, label, i, 0), enc.tobytes()))
    rec.close()
    return str(path)


def test_image_det_iter(tmp_path):
    rec = _write_rec(tmp_path / "det.rec")
    it = tmx.image.ImageDetIter(batch_size=4, data_shape=(3, 32, 32),
                                path_imgrec=rec, rand_mirror=True,
                                max_objects=3)
    n = 0
    for batch in it:
        assert batch.data[0].shape == (4, 3, 32, 32)
        assert batch.label[0].shape == (4, 3, 5)
        lab = batch.label[0].asnumpy()
        assert (lab[..., 0] >= 0).any()
        n += 4 - batch.pad
    assert n == 12


def test_create_det_augmenter_pipeline():
    got = []
    for pkg in (tmx, jmx):
        img, label = _sample(pkg)
        augs = pkg.image.CreateDetAugmenter(
            (3, 32, 32), rand_crop=0.5, rand_mirror=True, rand_pad=0.5,
            mean=True, std=True)
        random.seed(6)
        out, lab = img, label
        for aug in augs:
            out, lab = aug(out, lab)
        got.append((out.asnumpy(), lab))
    assert got[0][0].shape == (32, 32, 3)
    assert got[0][0].dtype == np.float32
    np.testing.assert_array_equal(got[0][0], got[1][0])
    np.testing.assert_array_equal(got[0][1], got[1][1])


def test_parse_label_header_format():
    raw = np.array([4, 6, 9.9, 9.9,
                    1, 0.1, 0.2, 0.3, 0.4, 0.0,
                    2, 0.5, 0.5, 0.9, 0.9, 0.0], np.float32)
    flat = np.array([0, 0.1, 0.1, 0.2, 0.2], np.float32)
    outs = []
    for pkg in (tmx, jmx):
        it = pkg.image.ImageDetIter.__new__(pkg.image.ImageDetIter)
        it.max_objects = 3
        outs.append((it._parse_label(raw), it._parse_label(flat)))
        with pytest.raises(pkg.MXNetError):
            it._parse_label(np.arange(7, dtype=np.float32))
    out, out2 = outs[0]
    np.testing.assert_allclose(out[0], [1, 0.1, 0.2, 0.3, 0.4])
    np.testing.assert_allclose(out[1], [2, 0.5, 0.5, 0.9, 0.9])
    assert out[2, 0] == -1
    np.testing.assert_allclose(out2[0], flat)
    for a, b in zip(outs[0], outs[1]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("augment", [False, True])
def test_image_det_iter_matches_jax(tmp_path, augment):
    """ImageDetIter over one .rec of header labels ([2, 5, objects]),
    shuffled, in both packages after random.seed: every batch's images,
    labels and pad equal bit for bit; with no augmenter the labels are
    the packed ones and the images the records' pixels."""
    rec = _write_rec(tmp_path / "det.rec", n=10, header=True)
    kw = dict(rand_crop=0.5, rand_mirror=True, rand_pad=0.3, mean=True,
              std=True) if augment else dict(aug_list=[])
    out = []
    for pkg in (tmx, jmx):
        random.seed(11)
        it = pkg.image.ImageDetIter(batch_size=4, data_shape=(3, 48, 48),
                                    path_imgrec=rec, shuffle=augment,
                                    max_objects=3, **kw)
        out.append([(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad)
                    for b in it])
    assert len(out[0]) == len(out[1]) == 3
    for (x, y, p), (u, v, q) in zip(*out):
        np.testing.assert_array_equal(x, u)
        np.testing.assert_array_equal(y, v)
        assert p == q
    if not augment:
        labels = np.concatenate([y for _, y, _ in out[0]])[:10]
        assert (labels[1::2, 1, 0] >= 0).all()    # the second box
        assert (labels[0::2, 1, 0] == -1).all()
        reader = trec.MXRecordIO(rec, "r")
        for i in range(10):
            header, payload = trec.unpack(reader.read())
            img = tmx.image.imdecode(payload).asnumpy()
            np.testing.assert_array_equal(
                out[0][i // 4][0][i % 4], img.transpose(2, 0, 1))
        reader.close()
