"""The yardstick's arithmetic against the kernel table of PERF.md (the port's
``chip_smoke.py`` phase 3 at the same shapes): FLOP and least time."""

import sys
import os

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from benchmark import work  # noqa: E402


@pytest.mark.parametrize("name, got, flop_g, bound_ms, by", [
    ("k1 B=80 O=100", lambda: work.pair_tail_work(80, 100, 256, 300, 8), 126.7, 0.745,
     "operations"),
    ("k2 B=80 O=100", lambda: work.pair_tail_work(80, 100, 256, 300, 8, backward=True), 380.2,
     2.234, "operations"),
    ("k3 U=8 bf16", lambda: work.pair_mlp_work(8, 100, [256, 300], 2), 12.3, 0.0745,
     "operations"),
    ("k4 B=80 U=8 bf16", lambda: work.shared_contract_work(80, 8, 100, 300, 8, "bfloat16"),
     3.84, 0.0221, "bytes"),
])
def test_kernel_work_matches_the_table(name, got, flop_g, bound_ms, by):
    w = got()
    assert w["flop"] / 1e9 == pytest.approx(flop_g, rel=1e-3), name
    assert w["bound_s"] * 1e3 == pytest.approx(bound_ms, rel=2e-3), name
    assert w["bound_by"] == by


def test_peaks():
    assert work.PEAK_FLOPS["float32"] == pytest.approx(165e12)
    assert work.PEAK_FLOPS["bfloat16"] == pytest.approx(989e12)


def test_model_flop_counts_pairs_once_per_image():
    from benchmark.reference.config import Config

    cfg = Config.from_yaml(os.path.join(work.__file__.rsplit("/", 1)[0], "configs",
                                        "dfol-cur7.yaml"))
    one, two = work.image_flop(cfg, 50), work.image_flop(cfg, 100)
    assert 3.0 < two / one < 4.0  # the pairs grow fourfold, the objects twofold
    # h2 over 100 x 100 pairs at H=256, E=300: 2 * 1e4 * 256 * 300 FLOP at least
    assert two > 2 * 100 * 100 * 256 * 300
    q = work.question_flop(cfg, 100, rel_slots=2, calibrator_steps=6)
    assert q == pytest.approx(2 * 100 * 100 * 2 * 300 + 6 * 8 * 50 * (300 + 1 + 17 + 50))
