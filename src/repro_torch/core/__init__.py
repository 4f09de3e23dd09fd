"""FPTC core: the codec's modules, in PyTorch."""
from repro_torch.core.calibration import (
    DeviceTables,
    DomainTables,
    calibrate,
    tables_from_arrays,
    tables_from_hist,
)
from repro_torch.core.codec import (
    decode,
    decode_device,
    encode,
    encode_device,
    transcode,
)
from repro_torch.core.config import DOMAIN_DEFAULTS, PREDICTORS, CodecConfig
from repro_torch.core.container import Container, ContainerFormatError
from repro_torch.core.domains import (
    KV_DOMAIN_ID,
    TRAIN_STATE_DOMAIN_ID,
    calibrate_kv,
    calibrate_train_state,
)

__all__ = [
    "CodecConfig",
    "DOMAIN_DEFAULTS",
    "PREDICTORS",
    "Container",
    "ContainerFormatError",
    "DomainTables",
    "DeviceTables",
    "calibrate",
    "tables_from_arrays",
    "tables_from_hist",
    "encode",
    "decode",
    "decode_device",
    "encode_device",
    "transcode",
    "KV_DOMAIN_ID",
    "TRAIN_STATE_DOMAIN_ID",
    "calibrate_kv",
    "calibrate_train_state",
]
