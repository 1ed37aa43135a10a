"""Scale-out on ``torch.distributed`` (counterpart of dss_tpu/parallel): a
("data", "model") device mesh, sharding rules, and the sharded word path
and training steps."""

from .mesh import make_mesh
from .shard import (
    batched_vocoder_sharding,
    shard_batch,
    shard_lstm_params,
    sharded_decoder_train_step,
    sharded_fused_word_path,
    sharded_vad_train_step,
    sharded_vocoder_train_step,
)

__all__ = [
    "make_mesh",
    "shard_lstm_params",
    "shard_batch",
    "sharded_decoder_train_step",
    "sharded_vad_train_step",
    "sharded_vocoder_train_step",
    "sharded_fused_word_path",
    "batched_vocoder_sharding",
]
