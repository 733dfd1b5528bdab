from tal_asrd_tpu_torch.core.config import (
    DecodeConfig,
    FrontendConfig,
    LMConfig,
    MeshConfig,
    ModelConfig,
    SDModelConfig,
    SpecAugmentConfig,
    TrainConfig,
)
from tal_asrd_tpu_torch.core.utils import (
    SuppressPrint,
    cdiv,
    count_parameters,
    debug_log,
    round_up,
    set_seed,
)
from tal_asrd_tpu_torch.core.checkpoint import (
    CheckpointManager,
    average_params,
    expand_speaker_embeddings,
    load_params_partial,
    load_pytree,
    save_pytree,
)

# The JAX package's names.
__all__ = [
    "DecodeConfig",
    "FrontendConfig",
    "LMConfig",
    "MeshConfig",
    "ModelConfig",
    "SDModelConfig",
    "SpecAugmentConfig",
    "TrainConfig",
    "SuppressPrint",
    "cdiv",
    "count_parameters",
    "debug_log",
    "round_up",
    "set_seed",
    "CheckpointManager",
    "average_params",
    "expand_speaker_embeddings",
    "load_params_partial",
    "load_pytree",
    "save_pytree",
]
