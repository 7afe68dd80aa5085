"""The port's simulators against the JAX package's: the Fig-6 DES
(``sim.engine``, both backends), the vectorized lane core
(``rack.des``), link contention (``qos.contention``) and each rack
scenario, at small sizes.

All of them are numpy code copied verbatim into the port (the drift guard
in ``test_torch_port.py`` holds the text), so the comparison is exact
equality of every field; only host wall-clock timings are left out.
"""

import dataclasses

import numpy as np
import pytest

import repro.qos.contention as jcontention
import repro.rack as jrack
import repro.rack.scenarios as jscenarios
import repro.sim as jsim
import repro.sim.ssd as jssd
import repro_torch.qos.contention as contention
import repro_torch.rack as rack
import repro_torch.rack.scenarios as scenarios
import repro_torch.sim as sim
import repro_torch.sim.ssd as ssd
from repro.core.tiers import TierKind as JTierKind
from repro.core.tiers import tpu_tiers as jtpu_tiers
from repro_torch.core.tiers import TierKind, tpu_tiers

#: (simulator package, its ssd module), the reference's first
PACKAGES = ((jsim, jssd), (sim, ssd))
N_IOS = 2_000


def plain(x):
    """A result as plain Python values, comparable across packages."""
    if dataclasses.is_dataclass(x):
        return {f.name: plain(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return (str(x.dtype), x.shape, x.tolist())
    if isinstance(x, np.generic):
        return x.item()
    return x


def both(run):
    """``run(sim_pkg, ssd_mod)`` on the reference, then on the port, as
    plain values."""
    return [plain(run(s, m)) for s, m in PACKAGES]


def _model(s, m, gen=5, scheme="lmb-cxl"):
    spec = s.make_ssd_model(gen)
    return spec, m.make_schemes(spec)[scheme]


@pytest.mark.parametrize("engine", ["vector", "scalar"])
@pytest.mark.parametrize("case", [
    dict(gen=5, scheme="lmb-cxl", workload="randread"),
    dict(gen=4, scheme="dftl", workload="randwrite"),
    dict(gen=5, scheme="lmb-pcie", workload="seqread", prefetch_depth=4),
    dict(gen=5, scheme="lmb-cxl", workload="randread",
         link_utilization=0.8, extra_index_latency_s=2e-7),
    dict(gen=4, scheme="ideal", workload="randread",
         data_rate_cap_iops=2e5, seed=11),
])
def test_simulate_equals_reference(engine, case):
    case = dict(case)
    gen, scheme, name = case.pop("gen"), case.pop("scheme"), \
        case.pop("workload")

    def run(s, m):
        spec, sch = _model(s, m, gen, scheme)
        return s.simulate(spec, sch, s.make_workload(name, n_ios=N_IOS),
                          engine=engine, **case)

    jres, tres = both(run)
    assert tres == jres
    assert tres["n_ios"] == N_IOS and tres["iops"] > 0


@pytest.mark.parametrize("engine", ["vector", "scalar"])
@pytest.mark.parametrize("n_devices,weights,depth", [
    (4, None, 0), (3, [3.0, 1.0, 1.0], 4)])
def test_shared_fabric_equals_reference(engine, n_devices, weights, depth):
    def run(s, m):
        spec, sch = _model(s, m)
        return s.simulate_shared_fabric(
            spec, sch, s.make_workload("randread", n_ios=N_IOS), n_devices,
            link_bandwidth_Bps=8e9, weights=weights, prefetch_depth=depth,
            engine=engine)

    jres, tres = both(run)
    assert tres == jres
    assert len(tres["per_device"]) == n_devices


@pytest.mark.parametrize("engine", ["vector", "scalar"])
@pytest.mark.parametrize("placement", [None, [1] * 6, [2, 2, 2, 2, 1, 2]])
def test_multi_expander_equals_reference(engine, placement):
    def run(s, m):
        spec, sch = _model(s, m)
        r = s.simulate_multi_expander(
            spec, sch, s.make_workload("randread", n_ios=N_IOS), 6,
            n_expanders=3, placement=placement, engine=engine)
        return plain(r), r.recovery_fraction, r.row()

    jres, tres = both(run)
    assert tres == jres
    assert tres[0]["migrated_devices"] > 0


def test_recovery_fraction_equals_reference():
    cases = [(100.0, 40.0, 20.0), (50.0, 60.0, 20.0), (20.0, 10.0, 20.0),
             (30.0, 5.0, 20.0)]
    from repro.sim.engine import recovery_fraction as jrecovery
    from repro_torch.sim.engine import recovery_fraction
    assert [recovery_fraction(*c) for c in cases] == \
        [jrecovery(*c) for c in cases]


@pytest.mark.parametrize("kw", [
    dict(),
    dict(data_rate_cap_iops=[1e5, 3e5, 2e5, 5e5],
         link_utilization=[0.0, 0.5, 0.9, 0.2],
         extra_index_latency_s=[0.0, 1e-7, 5e-7, 2e-6]),
    dict(link_utilization=0.6, prefetch_depth=8),
])
def test_simulate_lanes_equals_reference(kw):
    def run(s, m):
        spec, sch = _model(s, m)
        lanes = (jrack if s is jsim else rack).simulate_lanes(
            spec, sch, s.make_workload("randread", n_ios=N_IOS),
            seeds=[3, 4, 5, 6], **kw)
        return plain(lanes), lanes.total_ios

    jres, tres = both(run)
    assert tres == jres


def test_workload_draws_equal_reference():
    from repro.sim import workload as jworkload
    from repro_torch.sim import workload
    for mod in (jworkload, workload):
        assert mod.IO_BYTES == jworkload.IO_BYTES
    outs = []
    for mod in (jworkload, workload):
        wl = mod.make_workload("randread", n_ios=500, seed=2)
        outs.append(plain((
            wl, wl.generate(1 << 20), mod.locality_hits(300, 0.4, 9),
            mod.locality_hits(300, 0.0, 9),
            mod.batch_locality_hits(200, 0.7, [1, 2, 3]),
            mod.arrival_times(64, 40.0, process="bursty", burst_size=4,
                              seed=5, t0=1.5),
            mod.batch_arrival_times(32, 100.0, [7, 8]))))
    assert outs[1] == outs[0]


def test_link_state_and_contended_tiers_equal_reference():
    outs = []
    for mod, tiers, kinds in ((jcontention, jtpu_tiers(), JTierKind),
                              (contention, tpu_tiers(), TierKind)):
        link = mod.LinkState(link_bandwidth_Bps=16e9)
        utils = []
        for nbytes, window in ((1 << 20, 1e-4), (8 << 20, 2e-4),
                               (0, 1e-3), (1 << 30, 1e-3), (5, 0.0)):
            link.observe_bytes(nbytes, window)
            utils.append(link.utilization)
        wrapped = mod.contended_tiers(tiers, link)
        rows = []
        for kind in sorted(wrapped, key=lambda k: k.value):
            spec = wrapped[kind]
            rows.append((kind.value, type(spec).__name__,
                         spec.added_latency_s, spec.bandwidth_Bps,
                         spec.capacity_bytes, spec.access_time(1 << 16),
                         spec.access_time(4096, utilization=0.5)))
        link.set_demand(9e9)
        rows.append(wrapped[kinds.HOST_DRAM].access_time(1 << 16))
        link.set_demand(-1.0)
        rows.append(link.utilization)
        only = mod.contended_tiers(tiers, link, shared_kinds=set())
        rows.append(sorted(type(v).__name__ for v in only.values()))
        outs.append((utils, rows))
    assert outs[1] == outs[0]


@pytest.mark.parametrize("name,kw,timings", [
    ("hop_cost_sweep", dict(n_ios=N_IOS), ()),
    ("placement_face_off", dict(n_devices=4, n_ios=1024), ()),
    ("failover_recovery", dict(n_devices=8, n_ios=1024), ()),
    ("scale_sweep", dict(n_expanders=4, devices_per_expander=8,
                         n_ios=512), ("wall_s",)),
    ("vector_speedup", dict(n_lanes=6, n_ios=1024),
     ("scalar_s", "vector_s", "speedup")),
])
def test_rack_scenario_equals_reference(name, kw, timings):
    def drop(x):
        if isinstance(x, dict):
            return {k: drop(v) for k, v in x.items() if k not in timings}
        if isinstance(x, list):
            return [drop(v) for v in x]
        return x

    outs = [drop(plain(getattr(mod, name)(**kw)))
            for mod in (jscenarios, scenarios)]
    assert outs[1] == outs[0]
    if name == "vector_speedup":
        assert outs[1]["results_agree"] is True
