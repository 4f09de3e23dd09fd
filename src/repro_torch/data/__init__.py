from repro_torch.data.signals import DATASETS, make_signal
from repro_torch.data.pipeline import SignalPipeline, TokenPipeline

__all__ = ["DATASETS", "make_signal", "SignalPipeline", "TokenPipeline"]
