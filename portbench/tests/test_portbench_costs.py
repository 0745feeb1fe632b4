"""The frozen work counts against closed forms at one shape."""
import pytest

from portbench import costs

DIMS = costs.Dims(layers=60, d_model=7168, heads=56, kv_heads=8,
                  head_dim=128, d_ff=20480, vocab=64000, block_size=16)


def test_paged_decode_work():
    f, b = costs.decode_attention_work(DIMS, 1000)
    assert f == 60 * 4 * 1000 * 56 * 128
    mb = 63                                     # ceil(1000 / 16)
    assert b == 60 * (2 * 56 * 128 * 2 + mb * 4 + 4 + 1000 * 8 * 128 * 2 * 2)


def test_causal_prefill_work():
    n = 1200
    f, b = costs.prefill_attention_work(DIMS, n)
    assert f == 60 * 4 * (n * (n + 1) // 2) * 56 * 128
    assert b == 60 * (2 * n * 56 * 128 + 2 * n * 8 * 128) * 2


def test_flash_window_and_offset():
    f, _ = costs.flash_flops_and_bytes(1, 4, 8, 2, 1, 16, causal=True,
                                       window=3, q_offset=4, itemsize=2)
    # queries at 4..7 each see 3 keys
    assert f == 4 * 12 * 2 * 16


def test_model_flops_and_row_bytes():
    per_layer = 7168 * (56 * 128) * 2 + 2 * 7168 * (8 * 128) + 3 * 7168 * 20480
    assert DIMS.layer_matmul_params == per_layer
    assert costs.decode_model_flops(DIMS, 100) == pytest.approx(
        2 * per_layer * 60 + 60 * 4 * 100 * 56 * 128 + 2 * 7168 * 64000)
    assert costs.prefill_model_flops(DIMS, 10) == pytest.approx(
        2 * per_layer * 60 * 10 + 60 * 4 * 55 * 56 * 128 + 2 * 7168 * 64000)
    assert DIMS.row_bytes == 3_932_160


def test_least_seconds_takes_the_larger_bound():
    assert costs.least_seconds(989e12, 0) == pytest.approx(1.0)
    assert costs.least_seconds(0, 3.35e12) == pytest.approx(1.0)
