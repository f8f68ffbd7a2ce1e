"""``remat="dots"`` in the port against the JAX package's
``checkpoint_dots``, on smoke configs of a dense, a MoE, an SSM and the
hybrid family: the loss and every gradient at f32 1e-4 (``_torch_lm``'s
bar; MoE routing held clear of ties as there), the port's "dots" equal to
its "full" at f32 1e-6, and a count of the matrix products backward runs:
under "dots" it reruns none of the forward's (their outputs are kept),
under "full" it reruns them all.
"""

import jax
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.models.model import DOT_OPS

from _torch_lm import (TIE_GAP, close, flat, np_batch, pair, port_batch,
                       ref_batch, routing_gaps)

ARCHS = ("llama3-8b", "granite-moe-1b-a400m", "rwkv6-7b", "zamba2-2.7b")
B, S = 2, 16


def _loss_and_grads(port, params, nb):
    names = [n for n, _ in flat(params)]
    leaves = [p.requires_grad_() for _, p in flat(params)]
    with routing_gaps() as gaps:
        loss = port.loss(params, port_batch(nb, "f32"))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    for p in leaves:
        p.requires_grad_(False)
    return loss, dict(zip(names, grads)), gaps


@pytest.mark.parametrize("arch", ARCHS)
def test_dots_loss_and_every_gradient_match_reference_dots(arch):
    ref, port, rparams, params = pair(arch, "f32", remat="dots")
    assert ref.cfg.remat == port.cfg.remat == "dots"
    nb = np_batch(port.cfg, B, S, seed=5)
    want_loss, want_grads = jax.jit(jax.value_and_grad(ref.loss))(
        rparams, ref_batch(nb, "f32"))
    loss, grads, gaps = _loss_and_grads(port, params, nb)
    assert all(g > TIE_GAP for g in gaps), gaps
    close(loss, want_loss, 1e-4)
    want = dict(flat(want_grads))
    assert sorted(want) == sorted(grads)
    for n, g in want.items():
        got = grads[n] if grads[n] is not None else torch.zeros(g.shape)
        close(got, g, 1e-4, msg=n)


@pytest.mark.parametrize("arch", ARCHS)
def test_dots_equals_full_in_the_port(arch):
    _, port, _, params = pair(arch, "f32", remat="dots")
    nb = np_batch(port.cfg, B, S, seed=6)
    loss_d, grads_d, _ = _loss_and_grads(port, params, nb)
    full = type(port)(port.cfg.replace(remat="full"))
    loss_f, grads_f, _ = _loss_and_grads(full, params, nb)
    torch.testing.assert_close(loss_d, loss_f, rtol=1e-6, atol=1e-6)
    for n, g in grads_f.items():
        if g is None:
            assert grads_d[n] is None, n
        else:
            torch.testing.assert_close(grads_d[n], g, rtol=1e-6, atol=1e-6,
                                       msg=n)


class _CountProducts(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func in DOT_OPS
        return func(*args, **(kwargs or {}))


def _products(port, params, nb):
    """(products in forward, products in backward) of one loss."""
    leaves = [p.requires_grad_() for _, p in flat(params)]
    with _CountProducts() as fwd:
        loss = port.loss(params, port_batch(nb, "f32"))
    with _CountProducts() as bwd:
        torch.autograd.grad(loss, leaves, allow_unused=True)
    for p in leaves:
        p.requires_grad_(False)
    return fwd.n, bwd.n


@pytest.mark.parametrize("arch", ARCHS)
def test_dots_backward_reruns_no_forward_product(arch):
    """Backward's products: under "dots" as many as without remat (only the
    gradients' own), under "full" those plus the remat'd layers' forward
    products, rerun."""
    _, port, _, params = pair(arch, "f32")
    nb = np_batch(port.cfg, B, S, seed=7)
    counts = {r: _products(type(port)(port.cfg.replace(remat=r)), params, nb)
              for r in ("none", "dots", "full")}
    fwd = counts["none"][0]
    assert fwd > 0 and counts["dots"][0] == counts["full"][0] == fwd
    assert counts["dots"][1] == counts["none"][1]
    assert counts["full"][1] > counts["none"][1]
    assert counts["full"][1] - counts["none"][1] <= fwd
