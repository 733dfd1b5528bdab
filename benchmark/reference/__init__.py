"""The plain reference of the benchmark: the joint ASR model of arXiv:2005.08072
(log-mel frontend, TDS encoder, ReZero transformer decoder with a factorised
tied embedding), its label-smoothed loss and the LAMB step, in plain PyTorch
and float32 with TF32 off. It imports nothing of the program. It reads
weights by the names of the program's state_dict, which the benchmark draws
itself and hands to both sides.

`Precision` says how every product of the model (linear layers, convolutions,
attention) takes its operands: exactly in float32, or rounded first to
bfloat16 or to fp8 (e4m3, one scale a tensor), the control's precision.
"""
from .model import (Drops, Precision, decoder_logits, encode, exact, features,  # noqa: F401
                    log_mel, masked_batch_mean, padding_mask, specaug_keep, token_loss)
from .lamb import lamb_step  # noqa: F401
