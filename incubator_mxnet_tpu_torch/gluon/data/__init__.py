"""`gluon.data` (reference `python/mxnet/gluon/data/`): datasets
(`RecordFileDataset` among them), samplers, `DataLoader` with its worker
threads, and `vision`."""
from .dataset import Dataset, SimpleDataset, ArrayDataset, RecordFileDataset
from .sampler import Sampler, SequentialSampler, RandomSampler, \
    BatchSampler
from .dataloader import DataLoader, default_batchify_fn
from . import vision

__all__ = ["Dataset", "SimpleDataset", "ArrayDataset", "RecordFileDataset",
           "Sampler", "SequentialSampler", "RandomSampler", "BatchSampler",
           "DataLoader", "default_batchify_fn", "vision"]
