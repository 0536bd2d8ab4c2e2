"""Training data (counterpart of ``repro.data``)."""
from repro_torch.data.pipeline import SyntheticLMData, TokenFileData, make_batch_sharded

__all__ = ["SyntheticLMData", "TokenFileData", "make_batch_sharded"]
