"""The JAX package's model tests (tests/test_models.py) replayed on the
port, for all ten archs: a smoke forward (shapes, finite), one AdamW step
(finite), prefill + decode against the no-cache forward at the reference's
0.05, the full config's parameter count against the analytic one (no
allocation), and the MoE capacity bound. Imports torch and the port only.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.launch import steps as S  # noqa: E402
from repro_torch.models import LM, param_count  # noqa: E402
from repro_torch.optim import (AdamWConfig, adamw_init,  # noqa: E402
                               adamw_update)
from repro_torch.optim.adamw import tree_leaves  # noqa: E402

ARCH_NAMES = sorted(ARCHS)


def _smoke_batch(cfg, b=2, s=16, seed=0):
    """The reference's ``_smoke_batch``: random tokens, labels rolled by
    one, ``0.1 * ones`` bf16 image embeddings or frames."""
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(b, s)))
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, dims=1)}
    if cfg.family == "vlm":
        batch["image_embeds"] = 0.1 * torch.ones(
            (b, cfg.num_image_tokens, cfg.d_model), dtype=torch.bfloat16)
    if cfg.family == "audio":
        batch["frames"] = 0.1 * torch.ones((b, 1500, cfg.d_model),
                                           dtype=torch.bfloat16)
    return batch


def _init(cfg):
    m = LM(cfg)
    return m, m.init(torch.Generator().manual_seed(0), "cpu")


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_smoke_forward_shapes_and_finite(arch):
    cfg = get_config(arch).smoke()
    m, params = _init(cfg)
    with torch.no_grad():
        logits, aux = m.forward(params, _smoke_batch(cfg))
    assert logits.shape == (2, 16, cfg.padded_vocab)
    assert torch.isfinite(logits.float()).all() and torch.isfinite(aux)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_smoke_train_step_no_nans(arch):
    cfg = get_config(arch).smoke()
    m, params = _init(cfg)
    opt_cfg = AdamWConfig(lr=1e-3)
    opt = adamw_init(params, opt_cfg)
    batch = _smoke_batch(cfg)
    loss, grads = S.loss_and_grads(m, params, batch)
    assert torch.isfinite(loss), f"{arch}: loss {loss}"
    params, opt = adamw_update(params, grads, opt, opt_cfg)
    assert all(torch.isfinite(p.float()).all() for p in tree_leaves(params))
    with torch.no_grad():
        assert torch.isfinite(m.loss(params, batch))


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_prefill_decode_matches_forward(arch):
    cfg = get_config(arch).smoke()
    if cfg.num_experts:
        # as the reference: every expert routed, so no capacity drop and no
        # discrete choice can flip between the two paths
        cfg = cfg.replace(capacity_factor=8.0,
                          experts_per_token=cfg.num_experts)
    m, params = _init(cfg)
    b, s = 2, 16
    batch = _smoke_batch(cfg, b, s)
    with torch.no_grad():
        full, _ = m.forward(params, batch)
        cache = m.init_cache(b, s + 4, "cpu")
        pb = {k: v for k, v in batch.items() if k != "labels"}
        pb["tokens"] = batch["tokens"][:, :s - 1]
        lg_pre, cache = m.prefill(params, pb, cache)
        lg_dec, cache = m.decode_step(
            params, {"tokens": batch["tokens"][:, s - 1:s]}, cache, s - 1)
    np.testing.assert_allclose(lg_pre.float().numpy(),
                               full[:, s - 2].float().numpy(),
                               rtol=0.05, atol=0.05)
    np.testing.assert_allclose(lg_dec.float().numpy(),
                               full[:, s - 1].float().numpy(),
                               rtol=0.05, atol=0.05)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_full_config_param_defs_match_analytic_count(arch):
    """The full config's ParamDef tree (no allocation) is within 6% of the
    analytic parameter count used for MODEL_FLOPS."""
    cfg = get_config(arch)
    defs_n = param_count(LM(cfg).param_defs())
    analytic = cfg.param_count()
    assert abs(defs_n - analytic) / analytic < 0.06, (defs_n, analytic)


def test_moe_capacity_drops_are_bounded():
    """At capacity_factor=1.25 the load-balance aux stays well below its
    collapse value (E)."""
    cfg = get_config("granite-moe-1b-a400m").smoke()
    m, params = _init(cfg)
    with torch.no_grad():
        _, aux = m.forward(params, _smoke_batch(cfg, b=4, s=32))
    assert torch.isfinite(aux) and float(aux) < 8.0


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_caches_hold_the_reference_dtypes(arch):
    """Recurrent states are f32 in the cache; K/V, shifts and conv history
    are the model's bf16."""
    cfg = get_config(arch).smoke()
    cache = LM(cfg).init_cache(2, 8, "cpu")

    def walk(tree, pre=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from walk(v, pre + k + ".")
            else:
                yield pre + k, v
    for name, t in walk(cache):
        want = torch.float32 if name in ("wkv", "mamba.ssm") else \
            torch.bfloat16
        assert t.dtype == want and not t.any(), name
