from tal_asrd_tpu_torch.train.system import ASRSystem
from tal_asrd_tpu_torch.train.losses import (
    log_softmax_cross_entropy,
    masked_accuracy,
    masked_mean,
    masked_token_loss,
)
from tal_asrd_tpu_torch.train.optimizers import LAMB, Adafactor, Lookahead, RAdam
from tal_asrd_tpu_torch.train.schedules import (
    constant_schedule,
    inv_sqrt_schedule,
    linear_decay_schedule,
    triangle_schedule,
)
from tal_asrd_tpu_torch.train.loop import Trainer, TrainerConfig
from tal_asrd_tpu_torch.train.lm_system import LMSystem, LMTextDataset
from tal_asrd_tpu_torch.train.embed_system import (
    ContrastiveCollator,
    ContrastiveDataset,
    EmbedSystem,
)

__all__ = [
    "ASRSystem",
    "log_softmax_cross_entropy",
    "masked_accuracy",
    "masked_mean",
    "masked_token_loss",
    "LAMB",
    "RAdam",
    "Adafactor",
    "Lookahead",
    "constant_schedule",
    "inv_sqrt_schedule",
    "linear_decay_schedule",
    "triangle_schedule",
    "Trainer",
    "TrainerConfig",
    "LMSystem",
    "LMTextDataset",
    "ContrastiveCollator",
    "ContrastiveDataset",
    "EmbedSystem",
]
