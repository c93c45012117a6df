"""The per-layer readers and the profiled stretch's summary, on made-up
records (the numbers themselves come only from the card)."""

import pytest

from cardbench import cells, roofline, trace

CARD = {"kind": "NVIDIA H100 80GB HBM3", "clock_max_mhz": 1980.0, "power_limit_w": 700.0}
PEAK = 132 * 64 * 1980e6


def _records():
    return [{"spans_ms": {"miller_loop": [20.0, 22.0, 21.0], "final_exp": [30.0, 31.0, 29.0], "call": [70.0, 71.0, 72.0],
                          "to_affine": [3.0, 3.0, 3.0], "precompute": [10.0, 10.0, 10.0]},
             "enqueue_ms": [20.0, 25.0, 30.0], "launches": [489, 489, 489],
             "profile": {"busy_s": 0.9, "window_s": 1.0, "calls": 8, "nccl": {"kernels": 8, "median_s": 0.0005}}}]


def _read(name, pairs=65536, output="gt_per_pair", ranks=1):
    return cells.reader(name).read(_records(), {"pairs": pairs, "ranks": ranks, "output": output, "card": CARD})


def test_stage_times_and_host_readers():
    assert _read("stage_ms.miller_loop") == 21.0 and _read("stage_ms.final_exp") == 30.0
    assert _read("enqueue_ms") == 25.0 and _read("launches_per_batch") == 489
    assert _read("device_idle_pct") == pytest.approx(10.0) and _read("gather_ms") == pytest.approx(0.5)


def test_rooflines_count_the_references_work_at_the_published_peak():
    work = roofline.products_per_pair()
    bound = work["miller_loop"] * 272 * 65536 / PEAK * 1e3
    assert _read("miller_loop_roofline") == pytest.approx(100 * bound / 21.0)
    bound = work["final_exp"] * 272 * 65536 / PEAK * 1e3
    assert _read("final_exp_roofline") == pytest.approx(100 * bound / 30.0)
    total = sum(work.values()) * 272 * 65536 / PEAK * 1e3
    assert _read("pairing_mfu") == pytest.approx(100 * total / 71.0)
    with_fold = (sum(work.values()) * 65536 + (65535 + 3) * 54) * 272 / PEAK * 1e3
    assert _read("pairing_mfu", output="gt_product", ranks=4) == pytest.approx(100 * with_fold / 71.0)


def test_readers_find_nothing_without_their_records_or_an_unknown_card():
    empty = {"pairs": 8, "ranks": 1, "output": "gt_per_pair", "card": {"kind": "cpu"}}
    for name in ("stage_ms.to_affine", "miller_loop_roofline", "device_idle_pct", "gather_ms", "launches_per_batch"):
        assert cells.reader(name).read([{"spans_ms": {}, "profile": {}, "launches": []}], empty) is None
    assert cells.reader("miller_loop_roofline").read(_records(), empty) is None


def test_summary_of_a_profiled_stretch():
    kernels = [(0, 10, "k_fq12_mul"), (12, 20, "ncclDevKernel_AllGather"), (25, 30, "k_fq12_mul"),
               (31, 33, "ncclDevKernel_AllGather"), (34, 35, "ncclDevKernel_AllGather")]
    host = [(0, 40, "cardbench.call"), (9, 14, "aten::cat"), (19, 26, "cardbench.wait")]
    s = trace.summarize(kernels, host, 2)
    assert s["busy_s"] == pytest.approx(26e-6) and s["window_s"] == pytest.approx(35e-6)
    assert s["kernels_s"]["k_fq12_mul"] == pytest.approx(15e-6)
    assert s["nccl"] == {"kernels": 3, "median_s": pytest.approx(2e-6)}
    assert s["gaps_s"]["call / aten::cat"] == pytest.approx(2e-6) and s["gaps_s"]["wait"] == pytest.approx(5e-6)
    assert trace.summarize([], host, 2) == {}
