"""The roofline's and the MFU's work counts against hand-worked values."""

import pytest

from port_bench import harness, roofline


def cfg(name):
    return harness.load_json(harness.HERE / "configs" / f"{name}.json")


def test_generator256_forward_flops():
    # 2 x in x out x k^2 x input pixels per stage, then the 4x4 conv:
    # 256*128*9*1, 128*64*16*9, 64*32*16*36, 32*16*16*144, 16*2*16*676,
    # 2*1*16*2601 multiply-adds
    pr = cfg("mlegan-gen256-4bin")["prior"]
    want = 2 * (294912 + 1179648 + 1179648 + 1179648 + 346112 + 83232)
    assert roofline.generator_flops(pr["z_dim"], pr["stages"],
                                    pr["final_conv"]) == want == 8526400


def test_onebit_pair_per_launch():
    B, R, K, P = 256, 2, 64, 2601
    fb, ff = roofline.onebit_fwd(B, R, K, P)
    bb, bf = roofline.onebit_bwd(B, R, K, P)
    assert ff == 256 * (665856 + 2829888)
    assert bf == 256 * (1997568 + 3828672)
    # codes 1 B an entry, S and C in f32, one f32 per map out
    assert fb == 42_614_784 + 4 * (1_331_712 + 32_768) + 1024
    assert bb == fb + 4 * (1_331_712 + 32_768)
    # at these shapes the forward is bound by bytes, the backward by
    # operations
    assert fb / roofline.PEAK_BYTES_S > ff / roofline.PEAK_F32_FLOP_S
    assert bf / roofline.PEAK_F32_FLOP_S > bb / roofline.PEAK_BYTES_S


def test_lowrank_solve_work():
    w = roofline.lowrank_solve(cfg("lowrank-1bit-r2"), 256)
    passes = 500 * 256 * (3495744 + 5826240)        # 1.193 TFLOP
    assert passes == 1_193_213_952_000
    assert passes < w["flops"] < 1.01 * passes       # Adam, projection
    fwd = roofline.least_s(*roofline.onebit_fwd(256, 2, 64, 2601))
    bwd = roofline.least_s(*roofline.onebit_bwd(256, 2, 64, 2601))
    assert w["likelihood_least_s"] == pytest.approx(500 * (fwd + bwd))
    assert w["likelihood_least_s"] == pytest.approx(
        500 * (48_073_728 / 3.35e12 + 1_491_517_440 / 67e12))


def test_mlegan_map_work():
    c = cfg("mlegan-gen256-4bin")
    observed = 16_646
    w = roofline.mlegan_map(c, observed)
    g = 8526400
    # per iteration: the Z step's forward and data gradient, S = G(Z);
    # R = 2 samples each; one forward first; 402 candidates x 2 searched
    conv = g * (2 * (500 * 3 + 1) + 2 * 402)
    lik = (1000 * observed * (4 + 29) + 1000 * observed * (12 + 35)
           + 2 * 201 * observed * 33)
    assert w["flops"] == conv + lik
    assert 30e9 < w["flops"] < 40e9
    # B=1 passes are bound by bytes: W, U 8 B an entry of 64 x 2601
    fwd = (4 * (2 * 2601 + 64 * 2) + 8 * 64 * 2601 + 4) / 3.35e12
    assert roofline.least_s(*roofline.bounds_fwd(1, 2, 64, 2601,
                                                 observed)) == fwd
