"""The plain reference against the program at the program's smoke widths
on the CPU, in float32 where the program allows it."""

import torch

from harness import weights
from harness.spec import reference_class
from reference.common import Numerics
from smallcells import small_cell


def _program_and_reference(name):
    from repro_torch.models import LM
    cell, port = small_cell(name)
    ref = reference_class(cell.config)(cell.config["config"])
    model = LM(port.replace(use_flash=True))
    params = weights.make(ref.param_layout(), 5, 0, "cpu")
    weights.check_layout(params, model.shapes(), "parameters")
    return model, ref, params


def test_prefill_then_decode_agree_with_the_reference():
    """The program's prefill and two decode steps against the reference's
    prefill (a MoE routes each prompt as one group, as the program does)
    and two teacher-forced steps from the reference's own cache: each
    position's logits within 8 % (relative L2 error). At these widths over
    seeds 1-7 the program, in bf16, read at most 0.014 (but for one seed at
    which a routing choice flipped on rounding: 0.20); the reference in fp8
    0.11-0.61."""
    model, ref, params = _program_and_reference("granite-moe.train_4k")
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, 500, (2, 12), generator=g)
    cache = model.init_cache(2, 16, "cpu")
    logits, _ = model.prefill(params, {"tokens": toks[:, :10]}, cache)
    outs = [logits]
    for i in (10, 11):
        lg, _ = model.decode_step(params, {"tokens": toks[:, i:i + 1]},
                                  cache, i)
        outs.append(lg)
    state = {n: torch.zeros((t.shape[0], 2) + t.shape[2:])
             for n, t in ref.flat_cache(cache).items()}
    state["k"], state["v"] = state["k"][..., :0, :], state["v"][..., :0, :]
    want, new = ref.forward_cached(Numerics(), params, toks[:, :10],
                                   state, last_only=True,
                                   token_groups=False)
    wants = [want[:, -1]]
    for i in (10, 11):
        state = {n: (torch.cat([state[n], t], 3) if n in ("k", "v")
                     else t) for n, t in new.items()}
        want, new = ref.forward_cached(Numerics(), params,
                                       toks[:, i:i + 1], state)
        wants.append(want[:, -1])
    for got, w, pos in zip(outs, wants, (9, 10, 11)):
        err = (got.float() - w).norm() / w.norm()
        assert err < 0.08, (pos, float(err))


def test_train_loss_agrees_with_the_reference():
    model, ref, params = _program_and_reference("granite-moe.train_4k")
    g = torch.Generator().manual_seed(2)
    toks = torch.randint(0, 500, (2, 33), generator=g)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    got = float(model.loss(params, batch))
    f32 = weights.items(params)
    tree = {}
    for n, t in f32:
        d = tree
        *path, last = n.split(".")
        for p in path:
            d = d.setdefault(p, {})
        d[last] = t.float()
    want = float(ref.loss(Numerics(), tree, batch["tokens"],
                          batch["labels"]))
    assert abs(got - want) / want < 5e-3, (got, want)
