"""Ingestion: the packed shard format and its mmap reader, the host
pipeline (threaded prep, the per-batch pre-sort) and the synthetic
streams; ``python -m repro_torch.data`` packs datasets."""

from repro_torch.data import format, pipeline, reader, synthetic  # noqa: F401
from repro_torch.data.format import DatasetSpec, ShardWriter  # noqa: F401
from repro_torch.data.pipeline import HostPipeline, presort_batch  # noqa: F401
from repro_torch.data.reader import ShardedReader  # noqa: F401
