"""The port's data pipeline (numpy; the counterpart of `repro.data`)."""
from repro_torch.data.pipeline import SyntheticTextDataset, make_batches

__all__ = ["SyntheticTextDataset", "make_batches"]
