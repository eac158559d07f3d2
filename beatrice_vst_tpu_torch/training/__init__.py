"""Training (port of `beatrice_vst_tpu/training/`): distillation and
adversarial (GAN) vocoder training, per-module feature distillation, the
WAV-pair data pipeline, checkpoint/resume, and copies of the NumPy
synthetic corpus and quality metrics."""

from .checkpoint import (  # noqa: F401
    latest_step,
    prune_checkpoints,
    restore_checkpoint,
    save_checkpoint,
)
from .data import PairDataset, make_pair_batcher  # noqa: F401
from .distill import (  # noqa: F401
    distillation_loss,
    make_optimizer,
    multi_resolution_stft_loss,
    train_step,
)
from .gan import gan_train_step, make_gan_optimizers  # noqa: F401
from .loop import make_teacher_batcher, train, train_gan  # noqa: F401
from .quality import should_promote  # noqa: F401
