"""repro_torch.rack — the switched rack topology (copied from repro.rack).

``core.fabric`` prices every placement through ``topology.path_cost``, so
the topology comes with the control plane; the rack simulators follow in
a later slice.
"""

from repro_torch.rack.topology import PathCost, RackTopology

__all__ = ["PathCost", "RackTopology"]
