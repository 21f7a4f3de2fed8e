"""Training substrate: optimizer, trainer, gradient compression."""
from .optimizer import AdamW, cosine_schedule, global_norm
from .trainer import TrainConfig, cross_entropy, make_train_step
