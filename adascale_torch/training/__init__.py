"""Training of the adaptive-scaling detector, in PyTorch (counterpart of
``adascale/training``): the two-task step, the optimizer and its schedule,
metrics and seeds, checkpoints (``training.checkpoint``) and the loop
(``training.loop``, imported on its own: it pulls in the data pipeline)."""
from .metrics import Metrics  # noqa: F401
from .opt import calculate_iterable_dataset_num_samples, setup_seeds  # noqa: F401
from .optimizer import ClippedAdamW, OptimizerConfig, build_optimizer  # noqa: F401
from .schedule import cosine_annealing_warm_restarts  # noqa: F401
from .train_step import (  # noqa: F401
    TrainStepConfig,
    batch_checksum,
    make_eval_step,
    make_grad_inspection_fn,
    make_train_step,
    seeded_batches,
    precise_task_loss,
    rough_task_loss,
    two_task_loss,
    upcast_batch,
)
