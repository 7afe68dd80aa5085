"""One deployment of the program from a configuration file: the model at
the file's sizes, its flags, the LMB stack and the serving engine, through
the program's public surface (``build_model``, ``LMBSystem``/``SystemSpec``,
``EngineConfig``, ``ServeEngine``).
"""

from __future__ import annotations

import dataclasses

#: configuration keys that name the model's shape, checked against the
#: program's registered config of ``port_config``
MODEL_KEYS = ("num_layers", "d_model", "num_heads", "num_kv_heads", "d_ff",
              "vocab_size", "head_dim", "qk_norm", "qkv_bias", "act",
              "rope_theta", "norm_eps", "block_type", "dtype",
              "sliding_window")


def arch_config(config: dict):
    """The program's ``ArchConfig`` for ``config``: its registered config
    with the file's model keys put in, so the file is what runs."""
    from repro_torch.configs.base import get_config
    model = {k: config["model"][k] for k in MODEL_KEYS
             if k in config["model"]}
    return dataclasses.replace(get_config(config["port_config"]), **model)


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
