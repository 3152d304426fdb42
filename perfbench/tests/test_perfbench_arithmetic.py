"""The frozen FLOP and byte counts at a small shape worked by hand."""

import pytest

from perfbench.harness import arithmetic as A

CFG = {"hidden_width": 4, "mp_num": 2, "num_face_types": 5, "face_out": 6,
       "step_scalar": False}


def test_mlp_flops():
    # 2 x rows x (in*h + h*h + h*out)
    assert A.mlp_flops(3, 10, 4, 4) == 2 * 3 * (40 + 16 + 16)


def test_step_flops():
    # encoder 432 + 160, two blocks of (224 + 480), decoder 336
    assert A.step_flops(CFG, cells=2, faces=3) == 592 + 2 * 704 + 336


def test_step_scalar_widens_the_block_inputs():
    assert A.block_widths(CFG) == (6, 12)
    assert A.block_widths({**CFG, "step_scalar": True}) == (7, 13)


def test_block_bound():
    b = A.block_bound(CFG, cells=2, faces=3, vertices=4)
    # K1 288, K2 240, K3 84 bytes; 480 + 224 + 12 FLOPs
    assert b["bytes"] == 288 + 240 + 84
    assert b["flops"] == 480 + 224 + 12
    assert b["seconds"] == pytest.approx(612 / A.PEAK_BYTES_PER_S)


def test_production_block_is_bound_by_bytes():
    cfg = {**CFG, "hidden_width": 128, "mp_num": 15}
    b = A.block_bound(cfg, cells=110_000, faces=165_000, vertices=55_000)
    assert b["bytes"] / A.PEAK_BYTES_PER_S > b["flops"] / A.PEAK_BF16_FLOPS
    assert 200e6 < b["bytes"] < 300e6
