"""Data pipeline: synthetic corpus, packing, resumable iteration."""

from repro_torch.data.pipeline import BatcherState, PackedBatcher, SyntheticCorpus  # noqa: F401
