"""repro_torch.sim — population-scale one-shot FL simulation.

engine.py      device-parallel local training: batched Gram + SDCA
               passes a bucket of devices at a time, streaming
               GroupUpdates; the sequential loop survives as
               ``mode="loop"``, the oracle for equivalence tests;
               ``mode="sharded"`` lays the passes over the ranks of a
               ``torch.distributed`` world (``make_shard_ctx``);
               ``mode="streamed"`` consumes a lazy DeviceStream in
               bounded chunks — O(chunk) host memory, the same
               per-device results as ``mode="bucketed"``
scenarios.py   registry of named, seedable federation generators (IID,
               Dirichlet label skew, quantity skew, feature shift,
               temporal drift, availability/straggler masks), each
               exposed lazily as a ``DeviceStream`` (``device_stream``)
               and materialised as a ``Federation`` (``make_federation``)
population.py  scenario -> engine -> selection -> capped ensemble eval,
               with streaming progress callbacks; ``engine="streamed"``
               runs the whole round in fixed host memory
"""
from repro_torch.sim.engine import (
    DeviceOutcome,
    GroupUpdate,
    PopulationResult,
    iter_population,
    make_shard_ctx,
    train_device,
    train_population,
    train_selected,
)
from repro_torch.sim.population import PopulationConfig, PopulationReport, run_population
from repro_torch.sim.scenarios import (
    SCENARIOS,
    DeviceStream,
    Federation,
    ScenarioSpec,
    device_stream,
    list_scenarios,
    make_federation,
    register_scenario,
)

__all__ = [
    "DeviceOutcome", "GroupUpdate", "PopulationResult",
    "iter_population", "make_shard_ctx", "train_device", "train_population", "train_selected",
    "DeviceStream", "Federation", "SCENARIOS", "ScenarioSpec",
    "device_stream", "list_scenarios", "make_federation", "register_scenario",
    "PopulationConfig", "PopulationReport", "run_population",
]
