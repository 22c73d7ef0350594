"""The federated environment, client arrival simulation and the trainers
(synchronous and deadline-buffered)."""

from .arrivals import Arrival, ArrivalSimulator, LatencyModel
from .environment import FedEnvironment, split_data, volume_fractions
from .loop import BufferedFederatedTrainer, FederatedTrainer, TrainerConfig

__all__ = ["FedEnvironment", "split_data", "volume_fractions",
           "FederatedTrainer", "BufferedFederatedTrainer", "TrainerConfig",
           "Arrival", "ArrivalSimulator", "LatencyModel"]
