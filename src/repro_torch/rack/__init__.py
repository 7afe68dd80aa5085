"""repro_torch.rack — rack-scale CXL pool simulation.

Three pillars:

  * :mod:`repro_torch.rack.topology` — switched rack topology (hosts x
    expanders x switch tiers) with per-edge hop latency, per-port
    bandwidth, and correlated failure domains; ``path(host, expander)``
    is the cost function the tier model and the per-link arbiters
    consume.  Direct attach (the paper's setup) is the 1-switch
    degenerate case.
  * :mod:`repro_torch.rack.des` — vectorized (numpy struct-of-arrays)
    discrete-event core: many device lanes advance in lockstep through
    the index/data stage recurrences in queue-depth-sized chunks, so a
    rack of hundreds of devices and millions of simulated IOs runs at
    tolerable wall-clock.  ``repro_torch.sim.engine`` re-expresses its
    ``simulate*`` entry points on this core.
  * :mod:`repro_torch.rack.scenarios` — rack-level experiments (hop-cost
    sweep, skewed vs pool-aware placement, correlated-failure recovery,
    pool-utilization sweep) published through ``benchmarks/run.py
    --only rack_sweep`` with declarative CI gates.
"""

from repro_torch.rack.des import LaneResult, simulate_lanes
from repro_torch.rack.topology import PathCost, RackTopology

__all__ = ["LaneResult", "PathCost", "RackTopology", "simulate_lanes"]
