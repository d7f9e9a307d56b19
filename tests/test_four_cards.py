"""chip_smoke.py --four-cards, rehearsed on four virtual CPU devices: each
sharded deployment on the 4-device mesh agrees with one device within the
tolerance chip_smoke.py states for the card. On the CPU one device is
reproducible and the chain-sharded deployment is bitwise equal too."""

import importlib.util
import os

import pytest

import jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("case", range(2), ids=["ragged-10k", "mala-100k"])
def test_four_device_mesh_matches_one_device(case, capsys):
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 simulated devices")
    cs = _chip_smoke()
    name, shards = cs.FOUR_CARD_CASES[case]
    cs.four_cards(
        cases=[(name, shards)], scale=0.001,
        schedule=dict(warmup=6, draws=6, segment_size=6,
                      log_every_segment=False),
    )
    out = capsys.readouterr().out
    assert f"mesh chains x groups = {shards[0]} x {shards[1]}" in out
    assert f"{name} 1-card vs 1-card: bitwise=True" in out
    if shards[1] == 1:
        assert f"{name} 4-card vs 1-card: bitwise=True" in out
    assert f"{name}: 4-card vs 1-card worst_frac=" in out and ": ok" in out
