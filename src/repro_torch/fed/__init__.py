"""The federated runtime: the environment (Alg. 5 splits), the trainers
(synchronous, deadline-buffered and event-driven), client arrival
simulation, fleet scenarios, fault injection with server hardening, and
pluggable client samplers."""

from .arrivals import Arrival, ArrivalSimulator, LatencyModel
from .environment import FedEnvironment, split_data, volume_fractions
from .events import (EventClock, EventDrivenTrainer, EventLoop, EventRecord,
                     simulate_scenario)
from .faults import (ByzantineFault, CollusionFault, CorruptPayload,
                     FaultModel, ScaleAttackFault, ServerKilled,
                     SignFlipFault, make_fault, register_fault,
                     registered_faults)
from .loop import (BufferedFederatedTrainer, FederatedTrainer, TrainerConfig,
                   build_apply_phase, build_encode_phase)
from .sampling import (ClientSampler, SamplerView, make_sampler,
                       register_sampler, registered_samplers)
from .scenarios import (ComposedScenario, FlashOutageScenario, Scenario,
                        make_scenario, register_scenario,
                        registered_scenarios)

__all__ = ["FedEnvironment", "split_data", "volume_fractions",
           "FederatedTrainer", "BufferedFederatedTrainer", "TrainerConfig",
           "build_encode_phase", "build_apply_phase",
           "Arrival", "ArrivalSimulator", "LatencyModel",
           "EventClock", "EventLoop", "EventRecord", "EventDrivenTrainer",
           "simulate_scenario",
           "Scenario", "ComposedScenario", "FlashOutageScenario",
           "make_scenario", "register_scenario", "registered_scenarios",
           "FaultModel", "ServerKilled", "CorruptPayload", "make_fault",
           "register_fault", "registered_faults",
           "ByzantineFault", "SignFlipFault", "ScaleAttackFault",
           "CollusionFault",
           "ClientSampler", "SamplerView", "make_sampler", "register_sampler",
           "registered_samplers"]
