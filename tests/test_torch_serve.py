"""The port's llama3 serving slice against the JAX package, end to end.

Reference parameters are converted with ``params_from_reference``; both
models then see the same numpy tokens. Decode is teacher-forced (both get the
same next token), so an argmax flip cannot make them diverge. Bar: rtol=atol
5e-2, the reference's own bar for bf16 logits (tests/test_models.py).
"""

import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import LM as RefLM  # noqa: E402
from repro.models.params import param_count as ref_param_count  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import LM, param_count  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.models.params import map_defs  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
TOL = 5e-2


def _close(got, want):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=TOL, atol=TOL)


# G = 1 (the smoke config keeps 4 kv heads for 4 query heads) and G = 2
@pytest.mark.parametrize("kv_heads", [4, 2])
@pytest.mark.parametrize("use_flash", [False, True])
def test_prefill_and_teacher_forced_decode_match_reference(kv_heads,
                                                           use_flash):
    kw = dict(num_kv_heads=kv_heads, use_flash=use_flash)
    rcfg = ref_get_config("llama3-8b").smoke().replace(**kw)
    cfg = get_config("llama3-8b").smoke().replace(**kw)
    ref, port = RefLM(rcfg), LM(cfg)
    rparams = ref.init(jax.random.PRNGKey(0))
    params = params_from_reference(jax.tree.map(np.asarray, rparams), "cpu")

    b, plen, steps = 2, 8, 4
    toks = np.random.default_rng(kv_heads).integers(
        0, cfg.vocab_size, size=(b, plen + steps)).astype("int32")
    ttoks = torch.from_numpy(toks).long()

    rcache = ref.init_cache(b, plen + steps)
    cache = port.init_cache(b, plen + steps, "cpu")
    want, rcache = jax.jit(ref.prefill)(rparams, {"tokens": toks[:, :plen]},
                                        rcache)
    got, cache = port.prefill(params, {"tokens": ttoks[:, :plen]}, cache)
    _close(got, want)

    rdecode = jax.jit(ref.decode_step)
    for i in range(steps):
        p = plen + i
        want, rcache = rdecode(rparams, {"tokens": toks[:, p:p + 1]}, rcache,
                               jnp.int32(p))
        got, cache = port.decode_step(params, {"tokens": ttoks[:, p:p + 1]},
                                      cache, p)
        _close(got, want)
    _close(cache["self"]["k"], rcache["self"]["k"])
    _close(cache["self"]["v"], rcache["self"]["v"])

    # the no-cache forward (through flash under use_flash), in f32, where
    # the point is the algorithm and not bf16 rounding
    r32 = jax.tree.map(lambda a: np.asarray(a, np.float32), rparams)
    want, _ = jax.jit(ref.forward)(r32, {"tokens": toks})
    got, aux = port.forward(params_from_reference(r32, "cpu"),
                            {"tokens": ttoks})
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)
    assert float(aux) == 0.0


def test_param_tree_matches_reference_at_full_size():
    """Names, shapes and dtypes of every llama3-8b parameter, unallocated."""
    ref, port = RefLM(ref_get_config("llama3-8b")), LM(get_config("llama3-8b"))

    def flat(tree, pre=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, f"{pre}{k}.")
            else:
                yield f"{pre}{k}", v

    want = {n: (tuple(s.shape), str(s.dtype)) for n, s in flat(ref.shapes())}
    got = {n: (tuple(d.shape), str(d.dtype).removeprefix("torch."))
           for n, d in flat(port.param_defs())}
    assert got == want
    assert param_count(port.param_defs()) == ref_param_count(ref.param_defs())
    assert param_count(port.param_defs()) == 8_030_261_248


def test_init_follows_the_reference_std_rule():
    cfg = get_config("llama3-8b").smoke()
    m = LM(cfg)
    params = m.init(torch.Generator().manual_seed(0), "cpu")
    shapes = map_defs(lambda d: (tuple(d.shape), d.dtype), m.param_defs())
    assert map_defs(lambda t: (tuple(t.shape), t.dtype), params) == shapes
    assert torch.all(params["blocks"]["ln1"]["scale"] == 1)
    d = cfg.d_model
    for w, std in ((params["blocks"]["attn"]["wq"], d ** -0.5),
                   (params["embed"]["tok"], d ** -0.5),
                   (params["blocks"]["ffn"]["w_down"],
                    (2 * cfg.num_layers) ** -0.5 / cfg.d_ff ** 0.5)):
        assert abs(w.float().std().item() / std - 1) < 0.05


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_config_copies_agree_with_reference(arch):
    """Every field the port keeps has the reference's value (the training
    knobs remat, optimizer and grad_compress and the sharding knobs
    included); the fields it leaves out are ``attn_shard`` (read by no
    code) and ``scan_layers`` (the port loops over layers)."""
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    kept = {f.name for f in dataclasses.fields(cfg)}
    assert {n: getattr(cfg, n) for n in kept} == {
        n: getattr(rcfg, n) for n in kept}
    assert cfg.param_count() == rcfg.param_count()
    left_out = {f.name for f in dataclasses.fields(rcfg)} - kept
    assert left_out == {"attn_shard", "scan_layers"}
    assert {"remat", "optimizer", "grad_compress", "fsdp", "sharding_profile",
            "sequence_parallel", "decode_cache_shard"} <= kept


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_lm_builds_every_arch_with_the_reference_param_tree(arch):
    """Every family builds, and its full-size parameter tree equals the
    reference's path for path in shape and dtype (definitions only, no
    allocation): the f32 router and the rest in bf16."""
    ref, port = RefLM(ref_get_config(arch)), LM(get_config(arch))

    def flat(tree, pre=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, f"{pre}{k}.")
            else:
                yield f"{pre}{k}", v

    want = {n: (tuple(s.shape), str(s.dtype)) for n, s in flat(ref.shapes())}
    got = {n: (tuple(d.shape), str(d.dtype).removeprefix("torch."))
           for n, d in flat(port.param_defs())}
    assert got == want
    assert param_count(port.param_defs()) == ref_param_count(ref.param_defs())


def test_serve_cli_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
         "--device", "cpu", "--batch", "2", "--prompt-len", "8", "--gen", "4"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "prefill 2x8" in out.stdout and "decode 4 tokens" in out.stdout


def test_serve_on_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--smoke", "--batch", "1", "--prompt-len", "2",
                    "--gen", "2"])


def test_serve_returns_greedy_tokens_and_their_logits():
    r = serve.serve(get_config("llama3-8b").smoke(), batch=2, prompt_len=5,
                    gen=3, device="cpu")
    assert r.tokens.shape == (2, 3) and r.logits.shape[:2] == (3, 2)
    assert torch.equal(r.tokens, r.logits.argmax(-1).T)
    assert torch.isfinite(r.logits.float()).all()
    assert r.next_pos == 7


_FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|repro)\b|from\s+(jax|repro)(\.|\s+import\b))",
    re.MULTILINE)


def test_port_imports_neither_jax_nor_the_reference():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    assert REPO / "src" / "repro_torch" / "models" / "ssm.py" in files
    hits = [f"{f.relative_to(REPO)}: {m.group(0).strip()}"
            for f in files for m in _FORBIDDEN.finditer(f.read_text())]
    assert hits == []
