"""The spreads of a set of runs and the rules that choose the window and
the bounds from them, on hand-made runs."""

from __future__ import annotations

import json

import pytest

from port_bench.core import spread


def test_the_run_farthest_from_the_median_is_left_out():
    runs = [100, 101, 102, 103, 104, 140]          # median 102.5
    assert spread.trimmed_range(runs) == pytest.approx(4 / 102.5)
    low = [60, 101, 102, 103, 104, 105]            # median 102.5
    assert spread.trimmed_range(low) == pytest.approx(4 / 102.5)


def test_a_tie_leaves_out_one_of_the_two():
    runs = [1, 2, 3, 4, 5, 6]                      # 1 and 6 lie 2.5 from 3.5
    assert spread.trimmed_range(runs) == pytest.approx(4 / 3.5)


def test_six_equal_runs_spread_by_nothing():
    runs = [7.5] * 6
    assert spread.trimmed_range(runs) == 0
    assert spread.quartile_spread(runs) == 0
    assert spread.bound([("a", runs), ("a", runs)])["bound"] == spread.LOWEST


def test_quartile_spread_takes_python_s_quartiles():
    runs = [10, 20, 30, 40, 50, 60]
    # statistics.quantiles(n=4), 'exclusive': 17.5 and 52.5
    assert spread.quartile_spread(runs) == pytest.approx(35 / 35)


def test_the_longer_window_is_taken_only_where_it_narrows_and_is_allowed():
    assert spread.choose_window({51: 0.30, 102: 0.19}, longest=102) == 102
    assert spread.choose_window({51: 0.30, 102: 0.21}, longest=102) == 51
    assert spread.choose_window({51: 0.30, 102: 0.10}) == 51      # over 51 s


def test_the_bound_is_the_largest_of_its_three_terms_rounded_up():
    a = [100, 100, 101, 101, 102, 102]       # quartiles 100 and 102, median 101
    b = [101] * 6
    got = spread.bound([("x", a), ("x", b)])
    assert got["quartile_spread"] == pytest.approx(2 / 101)
    assert got["trimmed_range"] == pytest.approx(2 / 101)      # one 102 left out
    assert got["median_gap"] == 0
    assert got["wanted"] == pytest.approx(5 * 2 / 101)
    assert got["bound"] == 0.10 and not got["held_at_highest"]
    # two sets of one cell whose medians lie far apart
    far = spread.bound([("x", b), ("x", [121.2] * 6)])
    assert far["median_gap"] == pytest.approx(0.2) and far["bound"] == 0.2
    # sets of two cells are not compared
    assert spread.bound([("x", b), ("y", [121.2] * 6)])["median_gap"] == 0
    # a spread that wants more than the highest bound is held at it
    wide = spread.bound([("x", [100, 100, 101, 101, 102, 140])])
    assert wide["bound"] == spread.HIGHEST and wide["held_at_highest"]
    assert spread.bound([("x", b)], lowest=0.25)["bound"] == 0.25


def test_the_report_reads_runs(tmp_path, capsys):
    runs = tmp_path / "runs.jsonl"
    with runs.open("w") as f:
        for call in (1, 2):
            for seconds in (51, 102):
                for k in range(6):
                    f.write(json.dumps({
                        "cell": "c", "call": call, "seconds": seconds, "seed": k,
                        "metrics": {"reads_per_s": 1000 + 10 * k, "setup_s": 50 + k},
                        "host_probe_s": [0.4, 0.5]}) + "\n")
    spread.main(str(runs))
    out = capsys.readouterr().out
    assert "window 51" in out and "host probe 0.4-0.5 s" in out
    assert "'bound': 0.25" in out
