"""Shared set-up of the tests that run the port's model on DTensors
(``tests/test_torch_dryrun_models*.py``): one arch a family, the sharding
profiles, a (4, 4) mesh over a ``"fake"`` world of 16 ranks, and the step
check. The files split the families so that the test workers share them."""

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro_torch.configs import ARCHS
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import dryrun as D
from repro_torch.optim.adamw import tree_leaves

# DTensor's sharding decisions cached by other modules of a worker can be
# wrong for these configs (``dryrun.clear_sharding_cache``): each module
# clears the cache once, and its configs then share their decisions

# one arch a family
FAMILIES = {"dense": "llama3-8b", "moe": "granite-moe-1b-a400m",
            "ssm": "rwkv6-7b", "hybrid": "zamba2-2.7b",
            "vlm": "llama-3.2-vision-11b", "audio": "whisper-small"}
# the profiles rules_for makes, as config edits (tests/test_torch_sharding.py)
PROFILES = {"tp": dict(sharding_profile="tp"),
            "dp": dict(sharding_profile="dp"),
            "zero3cp": dict(sharding_profile="zero3cp"),
            "sp": dict(sequence_parallel=True),
            "fsdp": dict(fsdp=True),
            "cache_seq": dict(decode_cache_shard="seq")}
SEQ, BATCH = 8, 16


def fake_mesh():
    """A fixture's body: the (4, 4) mesh over a fake world of 16 ranks."""
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=16)
    try:
        yield init_device_mesh("cpu", (4, 4), mesh_dim_names=("data",
                                                              "model"))
    finally:
        dist.destroy_process_group()


def check_steps(mesh, family, profile):
    """Train, prefill and decode of the smoke config at one structural
    unit of depth (the dry run's probe depth): every op finds a
    sharding strategy, the outputs have their global shapes, the counters
    see work, and the donated state / cache comes back in place."""
    cfg = D.make_probe_cfg(ARCHS[FAMILIES[family]].smoke(), 1).replace(
        attn_impl="auto", **PROFILES[profile])
    for kind in ("train", "prefill", "decode"):
        shape = ShapeSpec(kind, SEQ, BATCH, kind)
        _, fn, args, donated = D.build_cell(cfg, shape, False, mesh=mesh)
        tally, mem, out = D.run_step(fn, args, donated)
        assert tally.flops > 0 and tally.bytes > 0, kind
        assert mem["peak_memory_in_bytes"] >= \
            mem["argument_size_in_bytes"] > 0
        if kind == "train":
            state, loss = out
            assert isinstance(loss, DTensor) and loss.shape == ()
            # the state is updated in place: every parameter and moment
            assert [id(t) for t in tree_leaves(state["params"])] == \
                [id(t) for t in tree_leaves(args[0]["params"])]
            assert mem["alias_size_in_bytes"] == \
                mem["donated_size_in_bytes"] - 4          # the new step
        else:
            logits, cache = out
            assert tuple(logits.shape) == (BATCH, cfg.padded_vocab)
            assert cache is args[2]
            assert mem["alias_size_in_bytes"] == mem["donated_size_in_bytes"]
        assert dist.get_world_size() == 16


