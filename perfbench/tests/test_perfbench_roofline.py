"""The robust-K work count against a count by hand."""
from perfbench import roofline


def test_szv_cross_term_and_total():
    ng, nao, nip = 110592, 216, 3456
    flops, nbytes = roofline.robust_k_work(ng, nao, nip)
    cross = 4 * ng * nao * nip
    assert cross == 330225942528            # 3.30e11 flop, as chip_smoke.py reckons
    gemms = (2 * nip * nao * nao            # B = aoRg D, once
             + 2 * nip * nao * nao          # T1 = aoRg^T C
             + 2 * nip * nip * nao          # M = B aoRg^T
             + 2 * nip * nip * nao + 2 * nip * nao * nao)   # K_isdf
    assert flops == cross + gemms
    assert nbytes == 8 * (ng * nao + nip * ng + nip * nao + nip * nip + 2 * nao * nao)
    t, by = roofline.least_seconds(flops, nbytes)
    assert by == "operations"
    assert abs(t - flops / 67e12) < 1e-15
    assert 5.0e-3 < t < 5.2e-3


def test_bytes_bound_when_work_is_thin():
    t, by = roofline.least_seconds(1.0, 3.35e12)
    assert by == "bytes" and abs(t - 1.0) < 1e-12
