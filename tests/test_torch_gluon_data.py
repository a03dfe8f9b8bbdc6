"""gluon's data plane in the port against the JAX package on the CPU:
`nd.image`, every vision transform, the vision datasets over files the
tests write, `RecordFileDataset`, `DataLoader` at 0 and 3 workers, the
JAX loader's three faults (shown on the JAX class, absent in the port),
`io_plane.DevicePrefetchLoader` and the Estimator's ring wrap.

Tolerances.  Decoding, cropping, resizing, stacking and the flips move
bytes and are held bit for bit.  `to_tensor`, `normalize` and the
jitters are one IEEE operation an element, in float32 in both packages,
so they too are held bit for bit.  The flips' coins come from different
generators (a JAX key against a torch generator): a flip is held to its
mirror given its draw, and the share of flips over 400 draws to 0.5
within 5 sigma.  The seeded random transforms draw from Python's
`random` in the same order in both packages, so they are held bit for
bit with one thread; with workers the order of draws across threads is
not fixed in either package, so the worker tests use deterministic
transforms and must equal ``num_workers = 0`` exactly.  JPEG records
are held to the JAX package only where both decode through PIL
(`recordio.unpack_img` and `image.imdecode` do in both).
"""
import gzip
import os
import random
import struct
import sys
import threading
import time

import numpy as np
import pytest

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu.ndarray import image as jimage

import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import io_plane
from incubator_mxnet_tpu_torch import recordio as trec

CPU = tmx.cpu()
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


def _img(shape=(20, 28, 3), seed=0, dtype=np.uint8):
    x = np.random.RandomState(seed).randint(0, 256, shape)
    return x.astype(dtype)


def _same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.array_equal(got, want)


# how long a test waits for the JAX loader's threads to show a fault: its
# workers batch through JAX, which can take seconds a batch when the
# test run loads every core
JAX_WAIT_S = 60.0


def _workers(prefix="mx-dataloader-worker"):
    """The port's live threads named `prefix`*: the JAX loader names its
    workers alike, and those may still run after a JAX test's epoch."""
    return [t for t in threading.enumerate() if t.name.startswith(prefix)
            and getattr(getattr(t, "_target", None), "__module__",
                        "").startswith("incubator_mxnet_tpu_torch")]


def _wait_gone(prefix, seconds=5.0):
    deadline = time.monotonic() + seconds
    while _workers(prefix) and time.monotonic() < deadline:
        time.sleep(0.01)
    return _workers(prefix)


# -- nd.image ---------------------------------------------------------------

@pytest.mark.parametrize("shape,dtype", [
    ((20, 28, 3), np.uint8), ((2, 20, 28, 3), np.uint8),
    ((20, 28, 3), np.float32), ((12, 9), np.uint8)])
def test_to_tensor_matches_jax(shape, dtype):
    x = _img(shape, 1, dtype)
    got = tmx.nd.image.to_tensor(tmx.nd.array(x, ctx=CPU, dtype=dtype))
    want = jimage.to_tensor(jmx.nd.array(x, dtype=dtype))
    assert got.context == CPU
    _same(got.asnumpy(), want.asnumpy())


@pytest.mark.parametrize("shape,mean,std", [
    ((3, 20, 28), MEAN, STD), ((2, 3, 20, 28), MEAN, STD),
    ((3, 20, 28), 0.5, 0.25), ((20, 28), 0.1, 2.0)])
def test_normalize_matches_jax(shape, mean, std):
    x = np.random.RandomState(2).rand(*shape).astype(np.float32)
    got = tmx.nd.image.normalize(tmx.nd.array(x, ctx=CPU), mean, std)
    want = jimage.normalize(jmx.nd.array(x), mean, std)
    _same(got.asnumpy(), want.asnumpy())


def test_jax_flips_reverse_the_channels_of_an_hwc_image():
    """The JAX flips reverse axes -1 and -2 whatever the layout: on a
    3-channel HWC image, left-right reverses the colours and leaves the
    width (ROADMAP Queue 3).  The port mirrors W and H, as the
    reference's HWC image ops do."""
    x = _img((6, 8, 3), 3)
    jl = jimage.flip_left_right(jmx.nd.array(x, dtype="uint8")).asnumpy()
    jt = jimage.flip_top_bottom(jmx.nd.array(x, dtype="uint8")).asnumpy()
    _same(jl, x[:, :, ::-1])            # the colours, not the width
    assert not np.array_equal(jl, x[:, ::-1, :])
    _same(jt, x[:, ::-1, :])            # the width, not the height
    t = tmx.nd.array(x, ctx=CPU, dtype="uint8")
    _same(tmx.nd.image.flip_left_right(t).asnumpy(), x[:, ::-1, :])
    _same(tmx.nd.image.flip_top_bottom(t).asnumpy(), x[::-1, :, :])


@pytest.mark.parametrize("shape", [(6, 8, 3), (2, 6, 8, 3)])
def test_flips_match_jax_after_to_tensor(shape):
    """Where the two agree: the port's flip of an HWC image, then
    `to_tensor`, equals the JAX `to_tensor`, then the JAX flip (on CHW,
    axes -1 and -2 are W and H)."""
    x = _img(shape, 4)
    for tflip, jflip in ((tmx.nd.image.flip_left_right,
                          jimage.flip_left_right),
                         (tmx.nd.image.flip_top_bottom,
                          jimage.flip_top_bottom)):
        got = tmx.nd.image.to_tensor(
            tflip(tmx.nd.array(x, ctx=CPU, dtype="uint8")))
        want = jflip(jimage.to_tensor(jmx.nd.array(x, dtype="uint8")))
        _same(got.asnumpy(), want.asnumpy())


@pytest.mark.parametrize("which", ["left_right", "top_bottom"])
def test_random_flips_given_their_draw_and_their_share(which):
    """Each call returns the image or its mirror (the flip given the
    coin); over 400 calls the mirror's share is 0.5 within 5 sigma; the
    same seed gives the same coins.  The JAX op's share is held alike."""
    x = _img((5, 7, 3), 5)
    mirror = x[:, ::-1] if which == "left_right" else x[::-1]
    tfn = getattr(tmx.nd.image, "random_flip_" + which)
    jfn = getattr(jimage, "random_flip_" + which)
    n = 400
    band = 5 * 0.5 / np.sqrt(n)

    def coins(seed):
        tmx.random.seed(seed)
        out = []
        for _ in range(n):
            got = tfn(tmx.nd.array(x, ctx=CPU, dtype="uint8")).asnumpy()
            flipped = np.array_equal(got, mirror)
            assert flipped or np.array_equal(got, x)
            out.append(flipped)
        return out

    first = coins(7)
    assert abs(np.mean(first) - 0.5) <= band
    assert coins(7) == first
    jmx.random.seed(7)
    jshare = np.mean([not np.array_equal(
        jfn(jmx.nd.array(x, dtype="uint8")).asnumpy(), x) for _ in range(n)])
    assert abs(jshare - 0.5) <= band


# -- the transforms ---------------------------------------------------------

def _transform(mx, name):
    T = mx.gluon.data.vision.transforms
    return {
        "cast": lambda: T.Cast("float16"),
        "to_tensor": lambda: T.ToTensor(),
        "normalize": lambda: T.Compose([T.ToTensor(),
                                        T.Normalize(MEAN, STD)]),
        "resize": lambda: T.Resize((17, 13)),
        "resize_keep_ratio": lambda: T.Resize(16, keep_ratio=True),
        "center_crop": lambda: T.CenterCrop(12),
        "center_crop_larger": lambda: T.CenterCrop((30, 24)),
        "random_resized_crop": lambda: T.RandomResizedCrop(14),
        "random_resized_crop_no_fit": lambda: T.RandomResizedCrop(
            (16, 12), scale=(3.0, 4.0)),
        "brightness": lambda: T.RandomBrightness(0.4),
        "contrast": lambda: T.RandomContrast(0.4),
        "saturation": lambda: T.RandomSaturation(0.4),
        "pipeline": lambda: T.Compose([
            T.Resize(24, keep_ratio=True), T.CenterCrop(20),
            T.RandomResizedCrop(16), T.RandomBrightness(0.4),
            T.RandomContrast(0.4), T.RandomSaturation(0.4), T.ToTensor(),
            T.Normalize(MEAN, STD)]),
    }[name]()


TRANSFORMS = ("cast", "to_tensor", "normalize", "resize", "resize_keep_ratio",
              "center_crop", "center_crop_larger", "random_resized_crop", "random_resized_crop_no_fit",
              "brightness", "contrast", "saturation", "pipeline")


@pytest.mark.parametrize("name", TRANSFORMS)
def test_transform_matches_jax(name):
    """Each transform on three HWC images, Python's `random` seeded alike
    before each package: the same pixels, dtype and shape."""
    imgs = [_img((20 + 3 * k, 26 - 2 * k, 3), 10 + k) for k in range(3)]

    def run(mx, ctx):
        t = _transform(mx, name)
        random.seed(11)
        kw = {"ctx": ctx} if ctx is not None else {}
        return [t(mx.nd.array(x, dtype="uint8", **kw)).asnumpy()
                for x in imgs]

    want = run(jmx, None)
    got = run(tmx, CPU)
    for g, w in zip(got, want):
        _same(g, w)


@pytest.mark.parametrize("which", ["left_right", "top_bottom"])
def test_flip_transforms_mirror_the_image(which):
    T = tmx.gluon.data.vision.transforms
    t = T.RandomFlipLeftRight() if which == "left_right" else \
        T.RandomFlipTopBottom()
    x = _img((6, 9, 3), 12)
    mirror = x[:, ::-1] if which == "left_right" else x[::-1]
    tmx.random.seed(3)
    seen = set()
    for _ in range(40):
        got = t(tmx.nd.array(x, ctx=CPU, dtype="uint8")).asnumpy()
        assert got.dtype == np.uint8
        seen.add(np.array_equal(got, mirror))
        assert np.array_equal(got, mirror) or np.array_equal(got, x)
    assert seen == {True, False}


# -- the datasets -----------------------------------------------------------

def _write_mnist(root, n, gz, train=True, seed=0):
    rng = np.random.RandomState(seed)
    imgs = rng.randint(0, 256, (n, 28, 28)).astype(np.uint8)
    labels = rng.randint(0, 10, n).astype(np.uint8)
    stem = "train" if train else "t10k"
    op = gzip.open if gz else open
    sfx = ".gz" if gz else ""
    os.makedirs(root, exist_ok=True)
    with op(os.path.join(root, f"{stem}-images-idx3-ubyte{sfx}"), "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 28, 28) + imgs.tobytes())
    with op(os.path.join(root, f"{stem}-labels-idx1-ubyte{sfx}"), "wb") as f:
        f.write(struct.pack(">II", 2049, n) + labels.tobytes())
    return imgs, labels


def _write_cifar(root, files, label_bytes, n=6, seed=0):
    rng = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    out = {}
    for k, name in enumerate(files):
        raw = rng.randint(0, 256, (n, label_bytes + 3072)).astype(np.uint8)
        raw[:, :label_bytes] %= 10 if label_bytes == 1 else 100
        raw.tofile(os.path.join(root, name))
        out[name] = raw
    return out


def _items(ds):
    out = []
    for i in range(len(ds)):
        x, y = ds[i]
        out.append((x.asnumpy(), np.asarray(y)))
    return out


def _same_items(got, want):
    assert len(got) == len(want) > 0
    for (gx, gy), (wx, wy) in zip(got, want):
        _same(gx, wx)
        assert np.array_equal(gy, wy)


@pytest.mark.parametrize("cls,gz,train", [
    ("MNIST", False, True), ("MNIST", True, False),
    ("FashionMNIST", True, True)])
def test_mnist_datasets_match_jax(tmp_path, cls, gz, train):
    imgs, labels = _write_mnist(str(tmp_path), 9, gz, train)
    want = _items(getattr(jmx.gluon.data.vision, cls)(str(tmp_path), train))
    got = _items(getattr(tmx.gluon.data.vision, cls)(str(tmp_path), train))
    _same_items(got, want)
    _same(got[3][0], imgs[3][..., None].astype(np.float32))
    assert got[3][1] == labels[3]


def test_cifar10_matches_jax(tmp_path):
    files = [f"data_batch_{i}.bin" for i in range(1, 6)] + ["test_batch.bin"]
    raw = _write_cifar(str(tmp_path), files, 1)
    for train in (True, False):
        want = _items(jmx.gluon.data.vision.CIFAR10(str(tmp_path), train))
        got = _items(tmx.gluon.data.vision.CIFAR10(str(tmp_path), train))
        _same_items(got, want)
    first = raw["test_batch.bin"][0]
    _same(got[0][0], first[1:].reshape(3, 32, 32).transpose(1, 2, 0)
          .astype(np.float32))


def test_cifar100_reads_both_label_bytes(tmp_path):
    """CIFAR100's records hold a coarse and a fine label byte.  The JAX
    class reads `train` before setting it (AttributeError; ROADMAP Queue
    3); the port reads the records as the reference does."""
    raw = _write_cifar(str(tmp_path), ["train.bin", "test.bin"], 2)
    with pytest.raises(AttributeError):
        jmx.gluon.data.vision.CIFAR100(str(tmp_path))
    for train, fine in ((True, False), (False, True)):
        ds = tmx.gluon.data.vision.CIFAR100(str(tmp_path), fine_label=fine,
                                            train=train)
        rec = raw["train.bin" if train else "test.bin"]
        assert len(ds) == len(rec)
        for i in range(len(ds)):
            x, y = ds[i]
            _same(x.asnumpy(), rec[i, 2:].reshape(3, 32, 32)
                  .transpose(1, 2, 0).astype(np.float32))
            assert y == rec[i, int(fine)]


def test_missing_files_raise(tmp_path):
    vision = tmx.gluon.data.vision
    for make in (lambda: vision.MNIST(str(tmp_path)),
                 lambda: vision.FashionMNIST(str(tmp_path), train=False),
                 lambda: vision.CIFAR10(str(tmp_path)),
                 lambda: vision.CIFAR100(str(tmp_path))):
        with pytest.raises(tmx.MXNetError, match="not found"):
            make()


def _rec(tmp_path, fmt, n=10, seed=0, name="imgs"):
    rng = np.random.RandomState(seed)
    path = str(tmp_path / f"{name}{fmt.replace('.', '_')}.rec")
    w = trec.MXIndexedRecordIO(path[:-4] + ".idx", path, "w")
    for i in range(n):
        img = rng.randint(0, 256, (18 + i % 3, 21 + i % 4, 3), np.uint8)
        w.write_idx(i, trec.pack_img(trec.IRHeader(0, float(i % 4), i, 0),
                                     img, img_fmt=fmt))
    w.close()
    return path


def test_record_file_dataset_matches_jax(tmp_path):
    path = _rec(tmp_path, ".png")
    want = jmx.gluon.data.RecordFileDataset(path)
    got = tmx.gluon.data.RecordFileDataset(path)
    assert len(got) == len(want) == 10
    for i in range(len(got)):
        assert got[i] == want[i]


@pytest.mark.parametrize("fmt", [".png", ".jpg", ".ppm"])
def test_image_record_dataset_matches_jax(tmp_path, fmt):
    path = _rec(tmp_path, fmt)
    want = _items(jmx.gluon.data.vision.ImageRecordDataset(path))
    got = _items(tmx.gluon.data.vision.ImageRecordDataset(path))
    _same_items(got, want)


def _folder(tmp_path, n=9, seed=0):
    from PIL import Image
    rng = np.random.RandomState(seed)
    root = tmp_path / "folder"
    for i in range(n):
        d = root / ("cat", "dog", "emu")[i % 3]
        d.mkdir(parents=True, exist_ok=True)
        img = rng.randint(0, 256, (16 + i, 20, 3), np.uint8)
        Image.fromarray(img).save(str(d / f"{i:02d}.png"))
    (root / "notes.txt").write_text("not a class folder")
    (root / "cat" / "readme.md").write_text("not an image")
    return str(root)


def test_image_folder_dataset_matches_jax(tmp_path):
    root = _folder(tmp_path)
    jds = jmx.gluon.data.vision.ImageFolderDataset(root)
    tds = tmx.gluon.data.vision.ImageFolderDataset(root)
    assert tds.synsets == jds.synsets == ["cat", "dog", "emu"]
    assert tds.items == jds.items
    _same_items(_items(tds), _items(jds))


def test_synthetic_dataset_and_lazy_transform_match_jax():
    def run(mx):
        T = mx.gluon.data.vision.transforms
        ds = mx.gluon.data.vision.SyntheticImageDataset(
            12, (10, 12, 3), 5, seed=3).transform_first(
                T.Compose([T.ToTensor(), T.Normalize(MEAN, STD)]))
        return [(x.asnumpy(), y) for x, y in (ds[i] for i in range(12))]
    want = run(jmx)
    with tmx.cpu():
        got = run(tmx)
    for (gx, gy), (wx, wy) in zip(got, want):
        _same(gx, wx)
        assert gy == wy


# -- the DataLoader ---------------------------------------------------------

def _pipeline(mx):
    T = mx.gluon.data.vision.transforms
    return T.Compose([T.Resize(20, keep_ratio=True), T.CenterCrop(16),
                      T.ToTensor(), T.Normalize(MEAN, STD)])


def _batches(loader):
    return [[a.asnumpy() for a in b] for b in loader]


@pytest.mark.parametrize("shuffle,last_batch", [
    (False, "keep"), (True, "keep"), (True, "discard"),
    (False, "rollover")])
def test_loader_at_0_and_3_workers_matches_jax(tmp_path, shuffle, last_batch):
    """Images of a PNG .rec through a deterministic pipeline: the port's
    loader at 0 and at 3 workers yields the JAX loader's batches (at 0
    workers), in order, bit for bit."""
    path = _rec(tmp_path, ".png", n=11)

    def run(mx, workers):
        ds = mx.gluon.data.vision.ImageRecordDataset(path).transform_first(
            _pipeline(mx))
        np.random.seed(5)
        loader = mx.gluon.data.DataLoader(ds, batch_size=4, shuffle=shuffle,
                                          last_batch=last_batch,
                                          num_workers=workers)
        return len(loader), _batches(loader)

    want = run(jmx, 0)
    for workers in (0, 3):
        got = run(tmx, workers)
        assert got[0] == want[0]
        assert len(got[1]) == len(want[1]) > 0
        for g, w in zip(got[1], want[1]):
            for a, b in zip(g, w):
                _same(a, b)
    assert not _wait_gone("mx-dataloader-worker")


def test_record_reads_are_safe_across_workers(tmp_path):
    """The records of one .rec read by 4 workers equal one thread's: the
    port's RecordFileDataset holds a lock over its seek and read."""
    path = _rec(tmp_path, ".ppm", n=64)
    ds = tmx.gluon.data.vision.ImageRecordDataset(path).transform_first(
        _pipeline(tmx))
    one = _batches(tmx.gluon.data.DataLoader(ds, batch_size=2))
    for _ in range(3):
        many = _batches(tmx.gluon.data.DataLoader(ds, batch_size=2,
                                                  num_workers=4, prefetch=8))
        assert len(many) == len(one)
        for g, w in zip(many, one):
            for a, b in zip(g, w):
                _same(a, b)


def test_loader_order_under_thread_stress():
    """More workers than cores, the interpreter switching threads every
    microsecond, prefetch depths 1 to 32: every batch in its place, none
    lost or repeated (the workers share the results table)."""
    data = np.arange(4 * 257, dtype=np.float32).reshape(257, 4)
    ds = tmx.gluon.data.ArrayDataset(data, np.arange(257))
    want = _batches(tmx.gluon.data.DataLoader(ds, batch_size=3))
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for prefetch in (1, 5, 32):
            got = _batches(tmx.gluon.data.DataLoader(
                ds, batch_size=3, num_workers=2 * os.cpu_count(),
                prefetch=prefetch))
            assert len(got) == len(want)
            for g, w in zip(got, want):
                for a, b in zip(g, w):
                    _same(a, b)
    finally:
        sys.setswitchinterval(interval)
    assert not _wait_gone("mx-dataloader-worker")


class _Counting:
    """A dataset that counts its reads and can raise at one index; with
    `hold_first`, reading sample 0 waits (up to JAX_WAIT_S) until that
    many other samples have been read."""

    def __init__(self, n, raise_at=None, delay=0.0, hold_first=None):
        self.n, self.raise_at, self.delay = n, raise_at, delay
        self.hold_first = hold_first
        self.reads = 0
        self._lock = threading.Lock()

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if self.delay:
            time.sleep(self.delay)
        if i == 0 and self.hold_first is not None:
            deadline = time.monotonic() + JAX_WAIT_S
            while self.reads < self.hold_first and \
                    time.monotonic() < deadline:
                time.sleep(0.01)
        with self._lock:
            self.reads += 1
        if i == self.raise_at:
            raise ValueError(f"sample {i} is broken")
        return np.full((2,), i, np.float32)


def test_jax_loader_reads_the_whole_epoch_ahead():
    """JAX `DataLoader` queues every batch of the epoch at once and never
    reads `prefetch` (ROADMAP Queue 3): while the consumer waits for its
    first batch (sample 0 held until the other batches are read), the
    workers read the whole epoch.  (Its consumer holds the results lock
    across each yield, so once a batch is handed out the workers stall
    until the next one is asked for.)  The port's loader keeps at most
    `prefetch` batches ahead of the consumer."""
    n, batch, prefetch = 64, 4, 2
    jds = _Counting(n, hold_first=n - batch)
    it = iter(jmx.gluon.data.DataLoader(jds, batch_size=batch, num_workers=2,
                                        prefetch=prefetch))
    next(it)
    assert jds.reads == n
    tds = _Counting(n)
    it = iter(tmx.gluon.data.DataLoader(tds, batch_size=batch, num_workers=2,
                                        prefetch=prefetch))
    for k in range(3):
        next(it)
        time.sleep(0.2)
        # the batches consumed, plus at most `prefetch` fetched ahead
        assert tds.reads <= (k + 1 + prefetch) * batch
    it.close()


def test_jax_loader_hangs_on_a_worker_that_raised():
    """A JAX worker that raises dies without a word, and the consumer
    waits for its batch forever (ROADMAP Queue 3); the port raises the
    worker's exception at that batch's turn, after the batches before
    it."""
    jds = _Counting(16, raise_at=9)
    got = []

    def consume():
        for b in jmx.gluon.data.DataLoader(jds, batch_size=4, num_workers=2):
            got.append(b)

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    deadline = time.monotonic() + JAX_WAIT_S
    while len(got) < 2 and time.monotonic() < deadline:
        time.sleep(0.01)
    t.join(2.0)
    assert t.is_alive() and len(got) == 2     # stuck before batch 2
    tds = _Counting(16, raise_at=9)
    seen = []
    with pytest.raises(ValueError, match="sample 9 is broken"):
        for b in tmx.gluon.data.DataLoader(tds, batch_size=4, num_workers=2):
            seen.append(b[0].asnumpy())
    assert len(seen) == 2
    assert not _wait_gone("mx-dataloader-worker")


def test_loader_workers_stop_when_the_iteration_is_dropped():
    """Breaking off mid-epoch: the JAX workers read on through the whole
    epoch (the port's stop when the generator is closed or dropped)."""
    jds = _Counting(40, delay=0.005)
    for _ in jmx.gluon.data.DataLoader(jds, batch_size=2, num_workers=2):
        break
    deadline = time.monotonic() + JAX_WAIT_S
    while jds.reads < 40 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert jds.reads == 40
    tds = _Counting(40, delay=0.005)
    for _ in tmx.gluon.data.DataLoader(tds, batch_size=2, num_workers=2):
        break
    assert not _wait_gone("mx-dataloader-worker")
    reads = tds.reads
    time.sleep(0.1)
    assert tds.reads == reads <= 2 * (1 + 4)
    it = iter(tmx.gluon.data.DataLoader(_Counting(40), batch_size=2,
                                        num_workers=3))
    next(it)
    del it
    assert not _wait_gone("mx-dataloader-worker")


# -- DevicePrefetchLoader and the Estimator's wrap ----------------------------

def test_device_prefetch_loader_on_the_cpu(tmp_path):
    """The ring over a threaded loader: the same pairs on the context,
    every batch counted in the ring's stats, epochs repeat, a loader
    error reaches the consumer, and closing stops the feeder and the
    loader's workers."""
    path = _rec(tmp_path, ".ppm", n=10)
    ds = tmx.gluon.data.vision.ImageRecordDataset(path).transform_first(
        _pipeline(tmx))
    loader = tmx.gluon.data.DataLoader(ds, batch_size=3, num_workers=2)
    want = _batches(loader)
    ring = io_plane.DevicePrefetchLoader(loader, ctx=CPU)
    assert len(ring) == len(want) == 4
    for epoch in range(2):
        got = list(ring)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert all(a.context == CPU for a in g)
            for a, b in zip(g, w):
                _same(a.asnumpy(), b)
    assert ring.ring_stats()["batches"] == 2 * len(want)
    for _ in ring:
        break
    assert not _wait_gone("mx-io-h2d")
    assert not _wait_gone("mx-dataloader-worker")
    bad = io_plane.DevicePrefetchLoader(tmx.gluon.data.DataLoader(
        _Counting(12, raise_at=7), batch_size=2, num_workers=2), ctx=CPU)
    with pytest.raises(ValueError, match="sample 7"):
        list(bad)
    bad.close()


def _estimator_run(ring):
    """Two epochs of a small hybridized net through Estimator.fit with
    the fused step; returns the parameters, the fused step's count and
    the estimator."""
    os.environ["MXNET_IO_RING"] = "1" if ring else "0"
    try:
        rng = np.random.RandomState(0)
        x = rng.rand(24, 6).astype(np.float32)
        y = rng.randint(0, 3, 24).astype(np.float32)
        done = {}

        def build():
            net = tmx.gluon.nn.HybridSequential()
            with net.name_scope():
                net.add(tmx.gluon.nn.Dense(8, activation="relu",
                                           in_units=6))
                net.add(tmx.gluon.nn.Dense(3, in_units=8))
            done["net"] = net

        t = threading.Thread(target=build)
        t.start()
        t.join()
        net = done["net"]
        tmx.random.seed(0)
        net.initialize(tmx.init.Xavier(), ctx=CPU)
        net.hybridize()
        trainer = tmx.gluon.Trainer(net.collect_params(), "sgd",
                                    {"learning_rate": 0.1})
        est = tmx.gluon.contrib.estimator.Estimator(
            net, tmx.gluon.loss.SoftmaxCrossEntropyLoss(),
            trainer=trainer, context=CPU)
        loader = tmx.gluon.data.DataLoader(
            tmx.gluon.data.ArrayDataset(x, y), batch_size=6, num_workers=2)
        est.fit(loader, epochs=2, event_handlers=[])
        return ({k: v.data().asnumpy()
                 for k, v in net.collect_params().items()},
                est._fused.steps, est)
    finally:
        os.environ.pop("MXNET_IO_RING", None)


def test_estimator_wraps_its_loader_in_the_ring():
    """With ``MXNET_IO_RING`` on, Estimator.fit feeds the fused step from
    a DevicePrefetchLoader that carries every batch; the parameters equal
    the unwrapped fit's bit for bit."""
    ring, steps, est = _estimator_run(True)
    plain, psteps, pest = _estimator_run(False)
    assert steps == psteps == 8
    assert isinstance(est.io_loader, io_plane.DevicePrefetchLoader)
    assert est.io_loader.ring_stats()["batches"] == 8
    assert pest.io_loader is None
    for k in plain:
        _same(ring[k], plain[k])
    assert not _wait_gone("mx-io-h2d")
