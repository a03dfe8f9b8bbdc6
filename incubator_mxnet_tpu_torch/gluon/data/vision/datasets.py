"""Vision datasets (reference `python/mxnet/gluon/data/vision/
datasets.py`).

PyTorch port of `incubator_mxnet_tpu/gluon/data/vision/datasets.py`.
The datasets read local files only: MNIST and FashionMNIST their idx
files (gzipped or not), CIFAR10 and CIFAR100 their binary batches; a
missing file raises `MXNetError`, and nothing is downloaded.  `ImageRecordDataset`
decodes a RecordIO pack's images (`recordio.unpack_img`),
`ImageFolderDataset` a ``root/label/image`` tree (`image.imdecode`), and
`SyntheticImageDataset` draws class prototypes plus noise from a seed.
Every image is a host NDArray (HWC), as in the reference.
"""
from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from ....base import MXNetError
from ....context import cpu
from ....ndarray.ndarray import array
from ..dataset import Dataset, RecordFileDataset

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100",
           "ImageRecordDataset", "ImageFolderDataset", "SyntheticImageDataset"]


class _DownloadedDataset(Dataset):
    """Images and labels read whole from files under `root`."""

    def __init__(self, root, transform):
        self._transform = transform
        self._data = None
        self._label = None
        self._root = os.path.expanduser(root)
        self._get_data()

    def __getitem__(self, idx):
        if self._transform is not None:
            return self._transform(self._data[idx], self._label[idx])
        return self._data[idx], self._label[idx]

    def __len__(self):
        return len(self._label)

    def _get_data(self):
        raise NotImplementedError


class MNIST(_DownloadedDataset):
    """MNIST from its idx files under `root` (reference
    `datasets.py:MNIST`): (28, 28, 1) images, int32 labels."""

    _train_files = ("train-images-idx3-ubyte", "train-labels-idx1-ubyte")
    _test_files = ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte")

    def __init__(self, root="~/.mxnet/datasets/mnist", train=True,
                 transform=None):
        self._train = train
        super().__init__(root, transform)

    def _get_data(self):
        paths = []
        for f in self._train_files if self._train else self._test_files:
            found = next((c for c in (os.path.join(self._root, f),
                                      os.path.join(self._root, f + ".gz"))
                          if os.path.exists(c)), None)
            if found is None:
                raise MXNetError(
                    f"{type(self).__name__} file {f} not found under "
                    f"{self._root}: nothing is downloaded; place the idx "
                    "files there, or use SyntheticImageDataset")
            paths.append(found)
        self._data = array(_read_images(paths[0])[..., None], ctx=cpu())
        self._label = _read_labels(paths[1]).astype(np.int32)


class FashionMNIST(MNIST):
    def __init__(self, root="~/.mxnet/datasets/fashion-mnist", train=True,
                 transform=None):
        super().__init__(root, train, transform)


def _read_images(path):
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rb") as f:
        _, n, rows, cols = struct.unpack(">IIII", f.read(16))
        return np.frombuffer(f.read(n * rows * cols),
                             dtype=np.uint8).reshape(n, rows, cols)


def _read_labels(path):
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rb") as f:
        _, n = struct.unpack(">II", f.read(8))
        return np.frombuffer(f.read(n), dtype=np.uint8)


class CIFAR10(_DownloadedDataset):
    """CIFAR10 from its binary batches under `root` (reference
    `datasets.py:CIFAR10`): (32, 32, 3) images, int32 labels."""

    _label_bytes = 1

    def __init__(self, root="~/.mxnet/datasets/cifar10", train=True,
                 transform=None):
        self._train = train
        super().__init__(root, transform)

    def _file_list(self):
        if self._train:
            return [f"data_batch_{i}.bin" for i in range(1, 6)]
        return ["test_batch.bin"]

    def _label_column(self):
        return 0

    def _get_data(self):
        data, labels = [], []
        width = self._label_bytes + 3072
        for fname in self._file_list():
            path = os.path.join(self._root, fname)
            if not os.path.exists(path):
                raise MXNetError(
                    f"CIFAR file {fname} not found under {self._root}: "
                    "nothing is downloaded; place the files there, or use "
                    "SyntheticImageDataset")
            raw = np.fromfile(path, dtype=np.uint8).reshape(-1, width)
            labels.append(raw[:, self._label_column()])
            data.append(raw[:, self._label_bytes:].reshape(-1, 3, 32, 32)
                        .transpose(0, 2, 3, 1))
        self._data = array(np.concatenate(data), ctx=cpu())
        self._label = np.concatenate(labels).astype(np.int32)


class CIFAR100(CIFAR10):
    """CIFAR100's ``train.bin``/``test.bin``: records of a coarse and a
    fine label byte and the image, the fine labels with `fine_label`
    (reference `datasets.py:CIFAR100`).  The JAX class sets `train`
    after reading and reads CIFAR10's record width (ROADMAP Queue 3)."""

    _label_bytes = 2

    def __init__(self, root="~/.mxnet/datasets/cifar100", fine_label=False,
                 train=True, transform=None):
        self._fine_label = fine_label
        super().__init__(root, train, transform)

    def _file_list(self):
        return ["train.bin" if self._train else "test.bin"]

    def _label_column(self):
        return int(bool(self._fine_label))


class ImageRecordDataset(Dataset):
    """Images of a RecordIO pack with their header labels (reference
    `datasets.py:ImageRecordDataset`); `flag` 1 decodes RGB, 0 gray."""

    def __init__(self, filename, flag=1, transform=None):
        self._record = RecordFileDataset(filename)
        self._flag = flag
        self._transform = transform

    def __getitem__(self, idx):
        from .... import recordio
        header, img = recordio.unpack_img(self._record[idx], self._flag)
        img = array(img, ctx=cpu(), dtype="uint8")
        if self._transform is not None:
            return self._transform(img, header.label)
        return img, header.label

    def __len__(self):
        return len(self._record)


class ImageFolderDataset(Dataset):
    """Images under ``root/<label>/`` (jpg, jpeg, png), labels by the
    sorted folder names (``synsets``) (reference
    `datasets.py:ImageFolderDataset`)."""

    def __init__(self, root, flag=1, transform=None):
        self._root = os.path.expanduser(root)
        self._flag = flag
        self._transform = transform
        self._exts = [".jpg", ".jpeg", ".png"]
        self._list_images(self._root)

    def _list_images(self, root):
        self.synsets = []
        self.items = []
        for folder in sorted(os.listdir(root)):
            path = os.path.join(root, folder)
            if not os.path.isdir(path):
                continue
            label = len(self.synsets)
            self.synsets.append(folder)
            for filename in sorted(os.listdir(path)):
                if os.path.splitext(filename)[1].lower() in self._exts:
                    self.items.append((os.path.join(path, filename), label))

    def __getitem__(self, idx):
        from .... import image
        with open(self.items[idx][0], "rb") as f:
            img = image.imdecode(f.read(), to_rgb=self._flag)
        label = self.items[idx][1]
        if self._transform is not None:
            return self._transform(img, label)
        return img, label

    def __len__(self):
        return len(self.items)


class SyntheticImageDataset(Dataset):
    """Seeded classification images: a uint8 prototype per class plus
    noise in [-20, 20), int32 labels."""

    def __init__(self, num_samples=1000, shape=(28, 28, 1), num_classes=10,
                 seed=0, transform=None):
        rng = np.random.RandomState(seed)
        protos = rng.randint(0, 255, (num_classes,) + tuple(shape)) \
            .astype(np.uint8)
        self._labels = rng.randint(0, num_classes,
                                   num_samples).astype(np.int32)
        noise = rng.randint(-20, 20, (num_samples,) + tuple(shape))
        imgs = protos[self._labels].astype(np.int32) + noise
        self._imgs = np.clip(imgs, 0, 255).astype(np.uint8)
        self._transform = transform

    def __getitem__(self, idx):
        img = array(self._imgs[idx], ctx=cpu(), dtype="uint8")
        label = self._labels[idx]
        if self._transform is not None:
            return self._transform(img, label)
        return img, label

    def __len__(self):
        return len(self._labels)
