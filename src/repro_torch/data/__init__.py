from repro_torch.data.signals import DATASETS, make_signal

__all__ = ["DATASETS", "make_signal"]
