"""The per-layer metric readers on recorded run statistics and a made-up
device trace."""

import pytest

import harness
from roofline import kernels, peaks

STATS = [{"stages": [
    {"stage": "align_decon", "seconds": 2.5, "reads": 4000,
     "whitelist_s": 1.9, "phase_s": {"read": 0.05, "step": 0.3,
                                     "assemble": 0.2, "slow": 0.1}},
    {"stage": "barcode_match", "seconds": 0.2, "reads": 3000},
    {"stage": "dedup", "seconds": 0.05},
    {"stage": "genome_tag", "seconds": 3.0, "index_s": 0.01,
     "align_s": 0.5, "cigar_s": 2.2, "write_s": 0.3}]}]


def run(stats=STATS, reads=None, device=None):
    return {"stats": stats, "reads": reads if reads is not None else
            4000 * len(stats), "device": device}


def read(name, r):
    return harness.load_metric(name).read(r)


def test_runstats_readers():
    two = STATS * 2
    r = run(two)
    assert read("whitelist_s", r) == pytest.approx(1.9)
    assert read("step_ms_per_kread", r) == pytest.approx(0.6e3 / 8)
    assert read("assemble_ms_per_kread", r) == pytest.approx(0.4e3 / 8)
    assert read("match_ms_per_kread", r) == pytest.approx(0.4e3 / 8)
    assert read("genome_ms_per_kread", r) == pytest.approx(6.0e3 / 8)
    assert read("genome_cigar_ms_per_kread", r) == pytest.approx(4.4e3 / 8)
    # nothing to read: no clonotyper, no trace
    assert read("clonotypes_ms_per_kread", r) is None
    for m in ("k1_roofline", "k4_roofline", "device_idle_pct"):
        assert read(m, r) is None
    assert read("step_ms_per_kread", run([], 0)) is None


def test_device_readers():
    k1 = [((2048, 1024), 60000, False), ((512, 4096), 30000, True)]
    k4 = [((236, 96), 9000, (16, 737280))]
    least1 = sum(kernels.least_seconds(*kernels.k1(*a)) for a in k1)
    least4 = kernels.least_seconds(*kernels.k4(*k4[0]))
    dev = {"busy_s": 0.5, "window_s": 10.0,
           "kernel_ns": {"void chain_dp_kernel<false>(int)": 100_000,
                         "void chain_dp_kernel<true>(int)": 60_000,
                         "void verify_kernel<16>(signed char)": 9_000_000,
                         "elementwise": 5},
           "kernel_n": {"void chain_dp_kernel<false>(int)": 1,
                        "void chain_dp_kernel<true>(int)": 1,
                        "void verify_kernel<16>(signed char)": 1,
                        "elementwise": 7},
           "launches": {"k1": k1, "k4": k4}}
    r = run(device=dev)
    assert read("device_idle_pct", r) == pytest.approx(95.0)
    assert read("k1_roofline", r) == pytest.approx(100 * least1 / 160e-6)
    assert read("k4_roofline", r) == pytest.approx(100 * least4 / 9e-3)
    # a launch recorded but not traced: nothing is read
    dev["launches"]["k1"] = k1 + k1[:1]
    assert read("k1_roofline", r) is None


def test_roofline_arithmetic():
    # K1: bytes-bound at the fused step's shape
    nb, ni = kernels.k1((2048, 1024), 67884, False)
    assert nb == 2048 * 1024 * 13 + 67884 * 12
    assert ni == 67884 * 64 * 16
    assert kernels.least_seconds(nb, ni) == nb / peaks.HBM_BYTES_PER_S
    # K4: one instruction a DP cell
    nb, ni = kernels.k4((2, 96), 100, (16, 1000))
    assert ni == 100 * 16 * 1000
    assert peaks.LANE_INSTR_PER_S == pytest.approx(33.45e12, rel=1e-3)
