"""Training: AdamW, the train step, LM batches and checkpoints.

Counterpart of ``repro.training``. The model is a
:class:`repro_torch.models.model.Model`; its parameters are updated in
place, and a checkpoint is written in the reference's format, so either
package reads what the other wrote.
"""
from repro_torch.training.optimizer import AdamWState, adamw  # noqa: F401
from repro_torch.training.train_step import make_train_step  # noqa: F401
