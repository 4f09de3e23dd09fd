"""The LM model library (port of ``repro/models``): the dense and VLM
families on one device.  ``build_model(cfg)`` gives a :class:`Model`."""
from repro_torch.models.api import Model, build_model
from repro_torch.models.config import ArchConfig

__all__ = ["Model", "build_model", "ArchConfig"]
