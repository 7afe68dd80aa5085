"""One deployment of the program from a configuration file: the model at
the file's sizes, its flags, the LMB stack and the serving engine, through
the program's public surface (``build_model``, ``LMBSystem``/``SystemSpec``,
``EngineConfig``, ``ServeEngine``).
"""

from __future__ import annotations

import dataclasses


def arch_config(config: dict):
    """The program's ``ArchConfig`` for ``config``: its registered config
    with every key of the file's ``model`` section put in, so the file is
    what runs.  A key that is no field of ``ArchConfig`` raises
    ``KeyError``, naming it."""
    from repro_torch.configs.base import ArchConfig, get_config
    fields = {f.name for f in dataclasses.fields(ArchConfig)}
    unknown = sorted(set(config["model"]) - fields)
    if unknown:
        raise KeyError(f"{config.get('name')!r}: model keys {unknown} are no "
                       f"fields of the program's ArchConfig")
    return dataclasses.replace(get_config(config["port_config"]),
                               **config["model"])


def build(config: dict, weights_seed: int, device: str):
    """``(engine, system, params, model)``: the weights drawn from
    ``weights_seed`` on ``device`` (``bench.weights``), the engine over one
    LMB stack whose pool is pinned host memory on a card."""
    from repro_torch.core import (DeviceSpec, HostSpec, LMBSystem,
                                  SystemSpec)
    from repro_torch.models import build_model
    from repro_torch.models.flags import Flags
    from repro_torch.serve import EngineConfig, ServeEngine

    from bench import weights

    model = build_model(arch_config(config), Flags(**config["flags"]),
                        device=device)
    params = weights.make(model.abstract_params(), weights_seed,
                          model.device, float(config["init_std"]))
    lmb = config["lmb"]
    system = LMBSystem(SystemSpec(
        expanders=int(lmb["expanders"]), pool_gib=int(lmb["pool_gib"]),
        hosts=(HostSpec("server", page_bytes=int(lmb["host_page_bytes"])),),
        devices=(DeviceSpec("gpu0"),)))
    engine = ServeEngine(model, params, system,
                         EngineConfig(**config["engine"]), device_id="gpu0",
                         device=device)
    return engine, system, params, model
