"""The FLOP and byte counters against hand counts at the cells' shapes."""
import json

import pytest

from bench import counters
from bench.harness import ROOT


def _cfg(name):
    return json.loads((ROOT / "bench" / "configs" / f"{name}.json")
                      .read_text())


def test_parallax_lm_step():
    cfg = _cfg("parallax-lm")
    lstm = 4 * 2048 * (512 + 512) + 2048 * 512          # gates + projection
    head = 800_000 * 512
    assert counters.matmul_params(cfg) == lstm + head == 419_037_184
    flops = counters.train_step_flops(cfg, 128, 20)
    assert flops == 6 * (lstm + head) * 2560
    assert flops == pytest.approx(6.44e12, rel=1e-3)
    assert 6 * lstm * 2560 == pytest.approx(0.145e12, rel=1e-2)
    assert counters.attention_flops(cfg, 128, 20) == 0


def test_phi3_eight_layers_step():
    cfg = _cfg("phi3-medium-14b-8l")
    d, f, hd = 5120, 17920, 128
    layer = 2 * d * 40 * hd + 2 * d * 10 * hd + 3 * d * f
    assert counters.matmul_params(cfg) == 8 * layer + 32_064 * d
    mm = 6 * (8 * layer + 32_064 * d) * 4096
    att = 3 * 8 * 4 * hd * 512 * 512 * 40 * 8
    assert counters.train_step_flops(cfg, 8, 512) == mm + att
    assert mm == pytest.approx(71.04e12, rel=1e-3)
    assert att == pytest.approx(1.03e12, rel=1e-2)


def test_dp4_counts_one_ranks_rows():
    cfg = _cfg("parallax-lm")
    assert counters.train_step_flops(cfg, 128, 20) * 4 == \
        counters.train_step_flops(cfg, 512, 20)


def test_embed_kernel_bytes_at_main_shape():
    # (800,000, 512) bf16 table, a 2,560-row buffer holding 566 ids
    assert counters.gather_bytes(2560, 566, 1024) == \
        4 * 2560 + 566 * 1024 + 2560 * 1024 == 3_211_264
    assert counters.scatter_bytes(2560, 566, 1024, 800_000, 512) == \
        4 * 2560 + 566 * 1024 + 800_000 * 512 * 4 == 1_638_989_824
    assert counters.least_seconds(1_638_989_824) == \
        pytest.approx(0.489e-3, rel=1e-3)
    # a buffer holds no more distinct ids than its rows
    assert counters.gather_bytes(100, 566, 1024) == \
        4 * 100 + 100 * 1024 + 100 * 1024


def test_peaks_are_the_data_sheet():
    assert counters.PEAK_BF16_FLOPS == 989e12
    assert counters.PEAK_HBM_BYTES_PER_S == 3.35e12
