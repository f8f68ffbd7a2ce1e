"""The port's model on DTensors, the whisper (audio) families: train, prefill
and decode of the smoke config on meta DTensors under every sharding
profile (``tests/test_torch_dryrun_models.py`` says why and how)."""

import pytest

pytest.importorskip("torch")

from _torch_dryrun import PROFILES, check_steps, fake_mesh  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def fresh_sharding_cache():
    D.clear_sharding_cache()


@pytest.fixture
def mesh():
    yield from fake_mesh()


@pytest.mark.parametrize("profile", sorted(PROFILES))
@pytest.mark.parametrize("family", ['audio'])
def test_steps_run_on_meta_dtensors(mesh, family, profile):
    check_steps(mesh, family, profile)
