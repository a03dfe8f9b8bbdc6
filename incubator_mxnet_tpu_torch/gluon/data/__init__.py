"""`gluon.data` (reference `python/mxnet/gluon/data/`): datasets,
samplers and `DataLoader`.  `RecordFileDataset` and `vision` are not
ported yet."""
from .dataset import Dataset, SimpleDataset, ArrayDataset
from .sampler import Sampler, SequentialSampler, RandomSampler, \
    BatchSampler
from .dataloader import DataLoader, default_batchify_fn

__all__ = ["Dataset", "SimpleDataset", "ArrayDataset", "Sampler",
           "SequentialSampler", "RandomSampler", "BatchSampler",
           "DataLoader", "default_batchify_fn"]
