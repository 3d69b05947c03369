"""The training data path: deterministic synthetic batches and the
prefetching host -> device pipeline (the reference's ``repro.data``)."""

from repro_torch.data.pipeline import PrefetchIterator, SyntheticLM

__all__ = ["PrefetchIterator", "SyntheticLM"]
