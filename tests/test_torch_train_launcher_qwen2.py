"""The launcher's train matrix (``tests/train_launcher_cases.py``) for
qwen2-1.5b: staged against eager, streamed against serial, both against
the reference, over accumulation 1/2 x compression on/off."""

import pytest

import train_launcher_cases as cases

ARCHS = ("qwen2-1.5b",)


@pytest.fixture
def modelling_reference(monkeypatch):
    cases.modelling_reference(monkeypatch)


@pytest.mark.parametrize("accum,compress", cases.MATRIX)
@pytest.mark.parametrize("arch", ARCHS)
def test_staged_launcher_matches_eager_and_reference(modelling_reference,
                                                     arch, accum, compress):
    cases.staged_launcher_matches_eager_and_reference(arch, accum, compress)


@pytest.mark.parametrize("accum,compress", cases.MATRIX)
@pytest.mark.parametrize("arch", ARCHS)
def test_streamed_launcher_matches_serial_and_reference(
        modelling_reference, monkeypatch, arch, accum, compress):
    cases.streamed_launcher_matches_serial_and_reference(
        monkeypatch, arch, accum, compress)
