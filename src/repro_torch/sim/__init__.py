"""repro_torch.sim — discrete-event reproduction of the paper's §4 evaluation."""

from repro_torch.sim.engine import (MultiExpanderResult, SharedFabricResult,
                              SimResult, simulate, simulate_multi_expander,
                              simulate_shared_fabric)
from repro_torch.sim.ssd import (GEN4_SSD, GEN5_SSD, Scheme, SSDSpec,
                           make_ssd_model)
from repro_torch.sim.workload import Workload, arrival_times, make_workload

__all__ = ["MultiExpanderResult", "SharedFabricResult", "SimResult",
           "simulate", "simulate_multi_expander", "simulate_shared_fabric",
           "GEN4_SSD", "GEN5_SSD", "Scheme", "SSDSpec", "make_ssd_model",
           "Workload", "arrival_times", "make_workload"]
