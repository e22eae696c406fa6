"""The two-task training step of the adaptive-scaling detector, in PyTorch
(counterpart of ``adascale/training``: the step, the optimizer and its
schedule, metrics and seeds; the loop, checkpoints and the data pipeline
are not ported yet)."""
from .metrics import Metrics  # noqa: F401
from .opt import setup_seeds  # noqa: F401
from .optimizer import ClippedAdamW, OptimizerConfig, build_optimizer  # noqa: F401
from .schedule import cosine_annealing_warm_restarts  # noqa: F401
from .train_step import (  # noqa: F401
    TrainStepConfig,
    batch_checksum,
    make_eval_step,
    make_train_step,
    seeded_batches,
    two_task_loss,
    upcast_batch,
)
