"""The frozen operation and byte counts reproduce the bounds the port's
kernels were measured against (b256 t24, H100 SXM peaks): K1 0.0715 ms by
operations; K2's sites 0.0451 ms (fp32 -> fp32) and 0.0282 ms (fp32 ->
int8, int8 -> fp32) by bytes. The models' operations per output pixel are
the known ones (sr x4 about 1.56 MFLOP, fast x4 about 0.54 MOP)."""

import json
import math

import pytest
from conftest import ROOT

from perfbench.reference import fast, sr
from perfbench.roofline import k1, k2
from perfbench.roofline.convnet import ideal_seconds
from perfbench.roofline.peaks import bound_s, peaks

H100 = peaks("NVIDIA H100 80GB HBM3")


def test_peaks_by_product_name():
    assert H100["product"] == "H100" and H100["bfloat16"] == 989e12
    assert peaks("NVIDIA H100 PCIe")["bytes"] == 2.0e12
    assert peaks("some other card")["product"] == "H100"


def test_k1_bound_at_b256_t24():
    t, by = bound_s(*k1.work(256, 24, 24), H100["bfloat16"], H100["bytes"])
    assert by == "operations"
    assert round(t * 1e3, 4) == 0.0715


@pytest.mark.parametrize("variant, ms", [("fp32 -> fp32", 0.0451), ("fp32 -> int8", 0.0282),
                                         ("int8 -> fp32", 0.0282)])
def test_k2_bounds_at_b256_t24(variant, ms):
    t, by = bound_s(*k2.work(variant, 256, 24, 24, 128, 128), H100["int8"], H100["bytes"])
    assert by == "bytes"
    assert round(t * 1e3, 4) == ms


def ops_per_output_pixel(convs, scale):
    return sum(2 * k * k * ci * co * res * res for _, ci, co, k, res in convs) / scale ** 2


def _config(name):
    return json.loads((ROOT / "perfbench" / "configs" / f"{name}.json").read_text())


def test_model_operations():
    cfg = _config("sr_x4")
    assert ops_per_output_pixel(sr.convs(cfg), 4) == pytest.approx(1.567e6, rel=1e-3)
    cfg = _config("fast_x4_int8")
    assert ops_per_output_pixel(fast.convs(cfg), 4) == pytest.approx(0.5418e6, rel=1e-3)


def test_ideal_time_takes_each_conv_at_its_precision():
    cfg = _config("fast_x4_int8")
    prec = fast.conv_precisions(cfg)
    assert sorted(set(prec.values())) == ["bfloat16", "int8"]
    assert sum(v == "int8" for v in prec.values()) == 29
    t = ideal_seconds(fast.convs(cfg), prec, H100, 1)
    trunk = 29 * 2 * 9 * 128 * 128 / 1979e12
    ends = (2 * 9 * 3 * 128 + 2 * 9 * 128 * 48) / 989e12
    assert t == pytest.approx(trunk + ends, rel=1e-9)


def test_parameter_count_of_sr_x4():
    """The fused graph's count: the published 11,883,587 less the BN
    parameters folded away (each RRDB conv's scale, bias and two
    statistics, where the fused conv gains a bias)."""
    n = sum(math.prod(s) for s in sr.param_shapes(_config("sr_x4")).values())
    bn_convs = [c for c in sr.convs(_config("sr_x4")) if c[0].startswith(("rrdb", "trunk"))]
    # BN (scale, bias) replaced by the conv bias: one fewer vector per conv
    assert n == 11883587 - sum(co for _, _, co, _, _ in bn_convs)
