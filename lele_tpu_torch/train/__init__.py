"""Fine-tuning for the ASR family (counterpart of lele_tpu/train)."""

from .trainer import (  # noqa: F401
    AdamW,
    TrainState,
    ctc_loss,
    ctc_loss_fn,
    ctc_train_step,
    make_train_step,
    shard_batch,
)
