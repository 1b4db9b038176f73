"""Token data for the LM train loop (port of ``repro.data``)."""
from .pipeline import SyntheticLM, MemmapSource, LMBatcher, host_batch_slice

__all__ = ["SyntheticLM", "MemmapSource", "LMBatcher", "host_batch_slice"]
