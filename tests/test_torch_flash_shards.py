"""The two attention kernels on shards, as each rank of a mesh runs them,
held to the JAX package's Pallas kernels on the whole input.

* ``flash_decode``'s partial form (``return_lse=True``) on slot shards of a
  cache, split by ``torch.chunk``'s rule (even and uneven, 1 to 4 shards,
  one shard wholly past a sequence's frontier), merged by
  ``merge_partials``, equals the Pallas ``flash_decode`` on the whole cache;
* ``flash_attention`` with a query-row offset on row slices equals the
  matching rows of the Pallas ``flash_attention`` on the whole sequence;
* both wrappers refuse DTensors, and the model's decode branch
  (``layers._local_decode``) runs the kernel on each layout of a one-rank
  mesh's DTensor cache, or raises naming the placements it cannot take.

On the CPU the wrappers run their plain versions; the Pallas kernels run in
interpret mode, as the reference's own tests run them. Inputs are made with
numpy from a seed and handed to both.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402
from torch.distributed.tensor import (DTensor, Partial, Replicate,  # noqa: E402
                                      Shard, distribute_tensor)

from repro.kernels.flash_attention import flash_attention as ref_flash  # noqa: E402
from repro.kernels.flash_decode import flash_decode as ref_decode  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.flash_decode import (flash_decode,  # noqa: E402
                                              merge_partials)
from repro_torch.launch.mesh import make_smoke_mesh  # noqa: E402
from repro_torch.models import layers  # noqa: E402

# the JAX package's own bars (tests/test_kernels.py) in bf16; in f32 both
# sides sum in f32 and differ only in order
DECODE_TOL = {torch.float32: 1e-5, torch.bfloat16: 4e-2}
ATTENTION_TOL = 2e-5


def _decode_inputs(rng, b, kv, g, t, hd):
    return (rng.normal(size=(b, kv, g, hd)).astype("float32"),
            rng.normal(size=(b, kv, t, hd)).astype("float32"),
            rng.normal(size=(b, kv, t, hd)).astype("float32"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", [64, 61])        # even and uneven shards
@pytest.mark.parametrize("shards", [1, 2, 3, 4])
def test_partial_decode_on_slot_shards_merges_to_the_whole_cache(
        shards, t, dtype):
    """Each shard [lo, lo + n) of torch.chunk's split runs the partial form
    with its own frontier clamp(len - lo, 0, n); the merged states equal the
    Pallas kernel on the whole cache. The third sequence's length (5) leaves
    every shard after the first wholly past its frontier: output 0, lse
    -inf, weighed 0."""
    rng = np.random.default_rng(shards * 100 + t)
    b, kv, g, hd = 3, 2, 4, 32
    q, k, v = _decode_inputs(rng, b, kv, g, t, hd)
    lens = np.asarray([t, 37, 5], np.int32)
    cast = [jnp.asarray(a).astype(jnp.bfloat16 if dtype == torch.bfloat16
                                  else jnp.float32) for a in (q, k, v)]
    want = np.asarray(ref_decode(*cast, jnp.asarray(lens), bk=16),
                      np.float32)
    tq, tk, tv = (torch.from_numpy(a).to(dtype) for a in (q, k, v))
    outs, lses, lo, past = [], [], 0, 0
    for ks, vs in zip(tk.chunk(shards, dim=2), tv.chunk(shards, dim=2)):
        n = ks.shape[2]
        ln = (torch.from_numpy(lens) - lo).clamp(0, n).to(torch.int32)
        out, lse = flash_decode(tq, ks.contiguous(), vs.contiguous(), ln,
                                return_lse=True)
        assert out.dtype == lse.dtype == torch.float32
        assert lse.shape == (b, kv, g)
        for i in np.flatnonzero(ln.numpy() == 0):
            assert torch.all(out[i] == 0) and torch.all(lse[i] == -np.inf)
            past += 1
        outs.append(out), lses.append(lse)
        lo += n
    assert past >= (shards - 1)                  # the third sequence at least
    got = merge_partials(outs, lses).to(dtype)      # rounded once
    tol = DECODE_TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


def test_partial_decode_log_sum_exp_is_the_scores_logsumexp():
    """lse is ln sum_t exp(q.k_t / sqrt(hd)) over the slots below the
    frontier, in f64 on the host, within f32 rounding."""
    rng = np.random.default_rng(7)
    q, k, v = _decode_inputs(rng, 2, 2, 3, 40, 16)
    lens = np.asarray([40, 9], np.int32)
    _, lse = flash_decode(*(torch.from_numpy(a) for a in (q, k, v, lens)),
                          return_lse=True)
    s = np.einsum("bkgd,bktd->bkgt", q.astype(np.float64), k) / 4.0
    for i, n in enumerate(lens):
        top = s[i, ..., :n].max(-1, keepdims=True)
        want = (top + np.log(np.exp(s[i, ..., :n] - top).sum(-1,
                                                               keepdims=True)))
        np.testing.assert_allclose(lse[i].numpy(), want[..., 0], rtol=1e-6,
                                   atol=1e-5)


def test_merge_of_empty_states_is_zero():
    out = torch.ones(2, 3, 8)
    lse = torch.full((2, 3), float("-inf"))
    got = merge_partials([out, out], [lse, lse])
    assert torch.all(got == 0)


@pytest.mark.parametrize("d", [16, 80])
@pytest.mark.parametrize("causal", [True, False])
def test_offset_attention_on_row_slices_matches_the_whole_sequence(d,
                                                                   causal):
    """q's rows cut into 4 slices of 25 (offsets 0, 25, 50, 75: none a
    multiple of a kernel tile), each against the whole K and V with its
    q_off, equal to the matching rows of the Pallas kernel on all 100 rows
    (GQA: 4 query heads on 2 kv heads, repeated for the reference)."""
    rng = np.random.default_rng(d + causal)
    b, h, hkv, s = 2, 4, 2, 100
    q = rng.normal(size=(b, h, s, d)).astype("float32")
    k = rng.normal(size=(b, hkv, s, d)).astype("float32")
    v = rng.normal(size=(b, hkv, s, d)).astype("float32")
    rep = [jnp.asarray(np.repeat(x, h // hkv, axis=1)) for x in (k, v)]
    want = np.asarray(ref_flash(jnp.asarray(q), *rep, causal=causal, bq=32,
                                bk=32))
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    for i, qs in enumerate(torch.from_numpy(q).chunk(4, dim=2)):
        got = flash_attention(qs, tk, tv, causal=causal, q_off=25 * i)
        np.testing.assert_allclose(got.numpy(), want[:, :, 25 * i:25 * i + 25],
                                   rtol=ATTENTION_TOL, atol=ATTENTION_TOL)


def test_offset_attention_rejects_a_negative_offset():
    x = torch.zeros(1, 2, 4, 16)
    with pytest.raises(ValueError, match="q_off"):
        flash_attention(x, x, x, q_off=-1)


# ---------------------------------------------------------------------------
# DTensors on a one-rank mesh


@pytest.fixture(scope="module")
def mesh():
    started = not dist.is_initialized()
    m = make_smoke_mesh("cpu")
    yield m
    if started:
        dist.destroy_process_group()


def _cache(rng, b=2, kv=2, g=2, t=12, hd=16):
    q, k, v = _decode_inputs(rng, b, kv, g, t, hd)
    return (torch.from_numpy(q)[:, None], torch.from_numpy(k),
            torch.from_numpy(v))


@pytest.mark.parametrize("which", ["flash_decode", "flash_attention"])
def test_wrappers_refuse_dtensors(mesh, which):
    q, k, v = _cache(np.random.default_rng(1))
    dq, dk, dv = (distribute_tensor(x, mesh, [Replicate(), Replicate()])
                  for x in (q[:, 0], k, v))
    with pytest.raises(TypeError, match="local_map"):
        if which == "flash_decode":
            flash_decode(dq, dk, dv, torch.full((2,), 5, dtype=torch.int32))
        else:
            flash_attention(dk, dk, dv)


@pytest.mark.parametrize("placements", [
    (Shard(0), Shard(3)),          # the default rules: batch, head dim
    (Shard(0), Shard(2)),          # decode_cache_shard="seq": slots
    (Shard(2), Shard(2)),          # slots on both mesh dims
    (Shard(0), Shard(0))])         # "dp": the batch on both
def test_decode_branch_on_each_cache_layout_equals_plain(mesh, placements):
    """On a one-rank mesh every layout's local call is the whole call; the
    slot layouts take the partial form and the merge over a group of one."""
    q, k, v = _cache(np.random.default_rng(2))
    want = layers._local_decode(q, k, v, 7)
    dq = distribute_tensor(q, mesh, [Replicate(), Replicate()])
    dk, dv = (distribute_tensor(x, mesh, list(placements)) for x in (k, v))
    before = flash_decode.lse_launches
    got = layers._local_decode(dq, dk, dv, 7)
    assert isinstance(got, DTensor)
    torch.testing.assert_close(got.full_tensor(), want, rtol=0, atol=0)
    assert flash_decode.lse_launches == before   # CPU tensors launch nothing


@pytest.mark.parametrize("bad", ["partial", "kv_heads", "k_and_v_differ"])
def test_decode_branch_raises_on_a_layout_it_does_not_take(mesh, bad):
    q, k, v = _cache(np.random.default_rng(3))
    dq = distribute_tensor(q, mesh, [Replicate(), Replicate()])
    if bad == "kv_heads":          # no rule shards the cache's kv heads
        dk, dv = (distribute_tensor(x, mesh, [Shard(1), Replicate()])
                  for x in (k, v))
        match = r"Shard\(dim=1\)"
    elif bad == "partial":
        dk = DTensor.from_local(k, mesh, [Partial(), Replicate()])
        dv = DTensor.from_local(v, mesh, [Partial(), Replicate()])
        match = "Partial"
    else:
        dk = distribute_tensor(k, mesh, [Shard(0), Shard(3)])
        dv = distribute_tensor(v, mesh, [Shard(0), Shard(2)])
        match = "differ"
    with pytest.raises(NotImplementedError, match=match):
        layers._local_decode(dq, dk, dv, 7)


@pytest.mark.parametrize("arch", ["llama3-8b", "whisper-small"])
def test_serve_on_a_one_rank_mesh_equals_plain_tensors(mesh, arch):
    """``serve(..., mesh=)`` (params, batch and cache laid out by
    ``serve_shardings``, the kernels' branches on DTensor shards: whisper's
    encoder through flash_attention) gives the plain run's tokens and
    logits on the smoke config."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    cfg = get_config(arch).smoke()
    runs = [serve.serve(cfg, batch=2, prompt_len=8, gen=4, device="cpu",
                        mesh=m) for m in (None, mesh)]
    assert isinstance(runs[1].cache["self"]["k"], DTensor)
    torch.testing.assert_close(runs[1].logits, runs[0].logits, rtol=0,
                               atol=0)
    assert torch.equal(runs[1].tokens, runs[0].tokens)
