"""The port's model on a real world of 4 gloo ranks on the CPU (a (2, 2)
``("data", "model")`` mesh): dense and hybrid serve under the default
rules, sequence parallelism and the sequence-sharded KV cache
(``decode_cache_shard="seq"``), and train one step under sequence
parallelism, each equal to the same run on plain tensors, also under
``use_flash`` (the kernels' branches on each rank's shards); a bare
DTensor cache written across two ranks' shards; and the train driver on the
mesh: its losses and final parameters against the plain run, a checkpoint
of mesh state restored onto another mesh and into plain tensors, and a run
with an injected failure against the clean run. The world is spawned once
for the module (``tests/_torch_multirank.py`` holds the cases); each case
is a test of its own."""

import pytest

torch = pytest.importorskip("torch")

from _torch_multirank import CASES, run_world  # noqa: E402


@pytest.fixture(scope="module")
def verdicts(tmp_path_factory):
    d = tmp_path_factory.mktemp("multirank")
    return run_world(CASES, str(d / "verdicts.json"), str(d / "store"))


@pytest.mark.parametrize("case", CASES)
def test_four_ranks_equal_plain_tensors(verdicts, case):
    assert case in verdicts, f"{case} did not run"
    assert verdicts[case] is None, (
        f"on torch {verdicts['torch']}: {verdicts[case]}")
