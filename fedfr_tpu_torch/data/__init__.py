from . import codec
from .datasets import AllClientData, BatchLoader, CombinedDataset, FaceRecordDataset
from .pipeline import DevicePrefetcher, prefetched
from .recordio import (
    IRHeader,
    IndexedRecordReader,
    IndexedRecordWriter,
    SplitMeta,
    pack,
    read_split_meta,
    unpack,
    write_split,
)

__all__ = [
    "IRHeader",
    "IndexedRecordReader",
    "IndexedRecordWriter",
    "SplitMeta",
    "pack",
    "read_split_meta",
    "unpack",
    "write_split",
    "AllClientData",
    "BatchLoader",
    "CombinedDataset",
    "DevicePrefetcher",
    "FaceRecordDataset",
    "codec",
    "prefetched",
]
