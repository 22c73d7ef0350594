"""The federated environment and the synchronous trainer."""

from .environment import FedEnvironment, split_data, volume_fractions
from .loop import FederatedTrainer, TrainerConfig

__all__ = ["FedEnvironment", "split_data", "volume_fractions",
           "FederatedTrainer", "TrainerConfig"]
