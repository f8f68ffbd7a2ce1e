"""The command itself: without a card it fails and prints no result (no
fallback to the CPU); it loads no JAX and nothing of the JAX package; the
references import nothing of the program; the counts match hand-worked
values and bound the program's own tally from below."""

import ast
import subprocess
import sys

import pytest
import torch

from harness import counts
from harness.run import forbidden_modules
from harness.spec import ROOT, load_cell, reference_class

CMD = [sys.executable, str(ROOT / "perfbench" / "run.py")]


def test_without_a_card_it_fails_with_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = subprocess.run(CMD + ["--workload", "granite-moe.train_4k",
                              "--seed", "3", "--seconds", "1",
                              "--trace", "0"],
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_no_jax_and_no_jax_package_loaded():
    from smallcells import small_run
    small_run("granite-moe.train_4k")
    assert forbidden_modules() == []
    assert "repro_torch" in sys.modules       # the program: not "repro"


def test_references_import_nothing_of_the_program():
    for path in (ROOT / "perfbench" / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in ("repro_torch", "repro", "jax",
                                               "harness"), (path, n)


def _granite():
    config = load_cell("granite-moe.train_4k").config
    return reference_class(config)(config["config"])


def test_counts_by_hand():
    ref = _granite()
    pg = ref.counts()
    # granite: 24 x (attn 3 145 728 + router 32 768 + norms 2 048)
    # + out 50 593 792 + final norm 1 024; experts 24 x 32 x 1 572 864
    assert pg["dense"] == 24 * (3145728 + 32768 + 2048) + 1024 * 49408 + 1024
    assert pg["experts"] == 24 * 32 * 3 * 1024 * 512
    # the program's count, 1 384 913 920, is of 49155 rows and no per-layer
    # norm scales; held: 49408 rows a table and 24 x 2 norm scales of 1024
    assert pg["total"] == 1384913920 + (49408 - 49155) * 1024 * 2 \
        + 24 * 2 * 1024
    assert pg["active"] == pg["dense"] + 24 * 8 * 3 * 1024 * 512
    assert pg["embed"] == 49408 * 1024 and pg["attention_layers"] == 24
    # every weight in bf16 but the f32 router, the token table left out
    assert pg["weight_bytes"] == 2 * (pg["total"] - pg["embed"]) \
        + 24 * 1024 * 32 * 2
    # K/V: 24 layers x 2 x 8 heads x 64 x 2 B = 49 152 B a token, no state
    assert counts.cache_bytes_per_token(ref) == 49152
    assert counts.state_bytes_per_session(ref) == 0
    t = counts.train_step(ref, 4, 4096)
    attn = 4 * 64 * 16 * 4 * (4096 * 4097 // 2) * 24
    assert t["flops"] == 3.0 * (2 * pg["active"] * 16384 + attn)
    d = counts.decode_step(ref, 256, 3840)
    assert d["bytes"] == pg["weight_bytes"] + 256 * 1024 * 2 \
        + 256 * 3841 * 49152 + 256 * 49408 * 2
    assert d["flops"] == 2 * pg["active"] * 256 \
        + 4 * 64 * 16 * 256 * (3840 + 1) * 24
    assert counts.least_seconds(d["flops"], d["bytes"]) == \
        d["bytes"] / counts.HBM_BYTES_PER_S


def test_counts_bound_the_programs_tally():
    """The model FLOPs of a training step are at most what the program's
    own dry-run tally counts it running (it runs every expert's capacity,
    and recomputes under remat), and not far below it."""
    from repro_torch.launch.dryrun import run_step
    from repro_torch.models import LM
    from harness import weights
    from smallcells import small_cell
    cell, port = small_cell("granite-moe.train_4k")
    ref = reference_class(cell.config)(cell.config["config"])
    model = LM(port.replace(use_flash=True))
    params = weights.make(ref.param_layout(), 1, 0, "cpu")
    toks = torch.randint(0, 500, (2, 65))
    cache = model.init_cache(2, 64, "cpu")
    with torch.no_grad():
        tally, _, _ = run_step(model.prefill,
                               (params, {"tokens": toks[:, :64]}, cache), 2)
    ours = counts.model_flops(ref, 2 * 64, 2, 64)
    assert ours <= tally.flops <= 4 * ours, (ours, tally.flops)
