"""The dry run's train step on reduced configs of every block family, as
DTensors on a fake (2, 2) mesh under ``FakeTensorMode``: the parameters,
AdamW's state and the batch placed by the rules, forward, backward under
remat and the update traced on this rank's shards."""

import pytest
import torch.distributed as dist

from repro_torch.configs.base import ShapeConfig, get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_mesh


@pytest.fixture(autouse=True)
def _no_group_left():
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "dbrx-132b", "rwkv6-7b",
                                  "hymba-1.5b", "seamless-m4t-large-v2"])
def test_reduced_train_step_traces_on_a_fake_2x2_mesh(arch):
    cfg, shape = get_config(arch).reduced(), ShapeConfig("t", 64, 4, "train")
    mesh = fake_mesh((2, 2), ("data", "model"))
    got = dryrun.measure_cell(cfg, shape, mesh)
    _, args, specs = dryrun.build_cell(cfg, shape, mesh)
    mem = got["memory"]
    assert mem["argument_size_in_bytes"] == \
        dryrun.argument_bytes(args, specs, mesh)
    # the new params and optimizer state are held to the old ones'
    # layout while the caller still holds those, so the peak holds both
    assert 0 < mem["output_size_in_bytes"] <= mem["peak_size_in_bytes"]
    assert got["flops"] > 0 and got["coll"] > 0
    assert got["rewrites"] == {"vocab_lookup": 1, "vocab_gather": 1}
