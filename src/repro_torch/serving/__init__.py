from repro_torch.serving.batch_decode import (
    BatchDecoder,
    DecodedBatch,
    DecodePlan,
    StreamGroup,
    default_decoder,
    streams_from_containers,
)
from repro_torch.serving.batch_encode import (
    DEFAULT_CHUNK_SIZE,
    BatchEncoder,
    EncodedBatch,
    EncodedBucketParts,
    EncodePlan,
    default_encoder,
)
from repro_torch.serving.engine import (
    BucketScheduler,
    GatherStage,
    PipelineExecutor,
    SubmitBuffer,
    resolve_device,
)
from repro_torch.serving.quarantine import (
    PoisonedContainerError,
    validate_container,
    validate_or_poison,
)
from repro_torch.serving.transcode import (
    TranscodePlan,
    Transcoder,
    TranscoderStats,
    default_transcoder,
)
from repro_torch.tuning.policy import HALF_OCTAVE, P2, BucketPolicy

__all__ = [
    "BatchDecoder",
    "DecodedBatch",
    "DecodePlan",
    "StreamGroup",
    "default_decoder",
    "streams_from_containers",
    "BatchEncoder",
    "EncodedBatch",
    "EncodedBucketParts",
    "EncodePlan",
    "default_encoder",
    "DEFAULT_CHUNK_SIZE",
    "Transcoder",
    "TranscoderStats",
    "TranscodePlan",
    "default_transcoder",
    "PoisonedContainerError",
    "validate_container",
    "validate_or_poison",
    "BucketScheduler",
    "GatherStage",
    "PipelineExecutor",
    "SubmitBuffer",
    "resolve_device",
    "BucketPolicy",
    "P2",
    "HALF_OCTAVE",
]
