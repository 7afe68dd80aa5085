"""The dry run's traced cells on reduced configs, and its rules for ops
DTensor shards badly.

Every block family (dense, MoE, RWKV6, hybrid, encoder-decoder) runs its
prefill and decode step as DTensors on a fake (2, 2) mesh under
``FakeTensorMode`` (the train steps: ``test_torch_dryrun_train.py``); a
reduced dense decode is held to a hand count of its matmuls.  The
rules are checked on real tensors on rank 0 of a fake mesh (a
fake group moves no data, so a rule's local arithmetic is what shows).
"""

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs.base import ShapeConfig, get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_mesh

FAMILIES = ["qwen2-1.5b", "dbrx-132b", "rwkv6-7b", "hymba-1.5b",
            "seamless-m4t-large-v2"]
CELLS = {"prefill": ShapeConfig("p", 64, 4, "prefill"),
         "decode": ShapeConfig("d", 128, 4, "decode")}


@pytest.fixture(autouse=True)
def _no_group_left():
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("kind", list(CELLS))
@pytest.mark.parametrize("arch", FAMILIES)
def test_reduced_cell_traces_on_a_fake_2x2_mesh(arch, kind):
    cfg, shape = get_config(arch).reduced(), CELLS[kind]
    mesh = fake_mesh((2, 2), ("data", "model"))
    got = dryrun.measure_cell(cfg, shape, mesh)
    _, args, specs = dryrun.build_cell(cfg, shape, mesh)
    mem = got["memory"]
    assert mem["argument_size_in_bytes"] == \
        dryrun.argument_bytes(args, specs, mesh)
    assert got["flops"] > 0 and got["bytes"] > 0
    assert mem["peak_size_in_bytes"] > 0
    assert got["coll"] > 0                      # the model axis talks
    assert got["rewrites"].get("vocab_lookup") == 1
    if kind == "decode" and arch != "rwkv6-7b":
        # the new token's K/V and position into a seq-sharded cache
        assert got["rewrites"]["masked_write"] == 3 * cfg.num_layers
        # and attend over the slots with no gather of the scores; an
        # encoder-decoder's cross-attention over the sequence-sharded
        # source too, once its queries are summed where they are made
        assert got["rewrites"]["sharded_softmax"] == cfg.num_layers * (
            2 if cfg.encoder_decoder else 1)
    terms = dryrun.roofline_of(got, cfg, shape, 4)
    assert terms.step_time_s > 0


def _hand_flops(cfg, B, C):
    """Matmul FLOPs of one decode step of a dense GQA decoder, all
    devices together."""
    D, H, KV, hd, F = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                       cfg.head_dim_, cfg.d_ff)
    per_layer = (2 * B * D * (H + 2 * KV) * hd     # q, k, v
                 + 2 * 2 * B * H * hd * C          # scores, p @ v
                 + 2 * B * H * hd * D              # wo
                 + 3 * 2 * B * D * F)              # swiglu MLP
    return cfg.num_layers * per_layer + 2 * B * D * cfg.padded_vocab


def test_reduced_dense_decode_flops_equal_a_hand_count():
    """On one device the count is the hand count exactly; on the fake
    (2, 2) mesh each device does between a quarter of it (ideal split)
    and all of it (DTensor replicates the small weights of a reduced
    config rather than split its two-token batch further)."""
    cfg = get_config("qwen2-1.5b").reduced()
    shape = CELLS["decode"]
    hand = _hand_flops(cfg, shape.global_batch, shape.seq_len)
    assert hand == 950_272
    one = dryrun.measure_cell(cfg, shape, fake_mesh((1, 1),
                                                    ("data", "model")))
    assert one["flops"] == hand
    # one rank: every placement replicated, nothing moves
    assert one["coll"] == 0 and one["collectives"] == []
    assert one["rewrites"] == {"folded_matmul": cfg.num_layers}
    four = dryrun.measure_cell(cfg, shape, fake_mesh((2, 2),
                                                     ("data", "model")))
    assert hand / 4 <= four["flops"] < hand


def test_one_device_memory_is_the_tensors_the_step_holds():
    """A decode step on one device allocates its logits and the layers'
    temporaries; the count holds the logits at the end and the step's
    peak above its arguments, at the allocator's 512-byte blocks."""
    cfg = get_config("qwen2-1.5b").reduced()
    shape = CELLS["decode"]
    got = dryrun.measure_cell(cfg, shape, fake_mesh((1, 1),
                                                    ("data", "model")))
    mem = got["memory"]
    logits = shape.global_batch * cfg.padded_vocab * 4
    assert mem["output_size_in_bytes"] >= logits
    assert mem["peak_size_in_bytes"] % 512 == 0
    assert mem["peak_size_in_bytes"] >= -(-logits // 512) * 512


# ------------------------------------------------------------------ rules
def test_masked_write_lands_only_on_the_shard_that_holds_the_slot():
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = fake_mesh((1, 2), ("data", "model"))     # rank 0: slots 0..3
    cache = DTensor.from_local(torch.zeros(2, 4, 3), mesh,
                               [Replicate(), Shard(1)], run_check=False)
    src = DTensor.from_local(torch.arange(6.).reshape(2, 3), mesh,
                             [Replicate(), Replicate()], run_check=False)
    assert dryrun._masked_setitem(cache, (slice(None), 1), src)
    assert torch.equal(cache._local_tensor[:, 1], src._local_tensor)
    before = cache._local_tensor.clone()
    assert dryrun._masked_setitem(cache, (slice(None), 6), src)  # rank 1's
    assert torch.equal(cache._local_tensor, before)
    # a slice across the shard edge writes the part rank 0 holds
    run = DTensor.from_local(torch.ones(2, 4, 3), mesh,
                             [Replicate(), Replicate()], run_check=False)
    assert dryrun._masked_setitem(cache, (slice(None), slice(2, 6)), run)
    assert torch.equal(cache._local_tensor[:, 2:], torch.ones(2, 2, 3))
    # a full slice is left to DTensor
    assert not dryrun._masked_setitem(cache, slice(None), 0.0)


def test_vocab_lookup_and_gather_are_local_partial_sums():
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = fake_mesh((1, 2), ("data", "model"))     # rank 0: rows 0..3
    table = DTensor.from_local(torch.arange(8.).reshape(4, 2), mesh,
                               [Replicate(), Shard(0)], run_check=False)
    ids = DTensor.from_local(torch.tensor([[0, 5, 3]]), mesh,
                             [Replicate(), Replicate()], run_check=False)
    rows = dryrun._vocab_lookup(table, ids)
    assert rows.shape == (1, 3, 2) and rows.placements[1] == Partial()
    assert torch.equal(rows._local_tensor,
                       torch.tensor([[[0., 1.], [0., 0.], [6., 7.]]]))
    logits = DTensor.from_local(torch.arange(8.).reshape(1, 2, 4), mesh,
                                [Replicate(), Shard(2)], run_check=False)
    gold = dryrun._vocab_gather(logits, -1, DTensor.from_local(
        torch.tensor([[[1], [6]]]), mesh, [Replicate(), Replicate()],
        run_check=False))
    assert gold.placements[1] == Partial()
    assert torch.equal(gold._local_tensor, torch.tensor([[[1.], [0.]]]))
    assert dryrun._vocab_lookup(torch.zeros(4, 2), ids) is None


def test_sharded_softmax_all_reduces_its_max_and_sum_and_gathers_nothing():
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.debug import CommDebugMode
    mesh = fake_mesh((1, 2), ("data", "model"))     # rank 0: columns 0..3
    local = torch.arange(8.).reshape(2, 4)
    x = DTensor.from_local(local, mesh, [Replicate(), Shard(1)],
                           run_check=False, shape=(2, 8), stride=(8, 1))
    with CommDebugMode() as comm:
        p = dryrun._sharded_softmax(x, -1)
    counts = {str(k).rsplit(".", 1)[-1]: n
              for k, n in comm.get_comm_counts().items()}
    assert counts == {"all_reduce": 2}
    assert p.shape == x.shape and p.placements == x.placements
    # a fake group reduces nothing: rank 0's own max and sum show
    assert torch.allclose(p._local_tensor, torch.softmax(local, dim=-1))
    assert dryrun._sharded_softmax(x, 0) is None     # dim 0 is whole
    assert dryrun._sharded_softmax(local, -1) is None


def test_folded_matmul_flattens_what_matmul_would_expand():
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = fake_mesh((2, 1), ("data", "model"))     # rank 0: sequence 0
    # [2, 1, 4] with a size-1 dim's stride that keeps matmul from folding
    local = torch.arange(4.).reshape(1, 4, 1).permute(0, 2, 1)
    x = DTensor.from_local(local, mesh, [Shard(0), Replicate()],
                           run_check=False, shape=(2, 1, 4),
                           stride=(4, 1, 1))
    w = DTensor.from_local(torch.arange(12.).reshape(4, 3), mesh,
                           [Replicate(), Replicate()], run_check=False)
    y = dryrun._folded_matmul(x, w)
    assert y.shape == (2, 1, 3) and y.placements == x.placements
    assert torch.equal(y._local_tensor, local @ w._local_tensor)
    flat = DTensor.from_local(torch.arange(4.).reshape(1, 1, 4), mesh,
                              [Shard(0), Replicate()], run_check=False,
                              shape=(2, 1, 4), stride=(4, 4, 1))
    assert dryrun._folded_matmul(flat, w) is None    # folds already
