"""Unit tests for benchmarks/run_benchmarks.py's rev-gated min-merge.

The results file keeps each row's MINIMUM time across sessions (the
least-contended window on a multi-tenant chip), but rows measured on
DIFFERENT implementations must never merge -- that is what the rev
fields guard.  These tests pin that contract for both the main table
(keyed by (filter, level)) and the extended cases (keyed by case label).
"""

import importlib.util
import os
import sys

import pytest

_RB = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "benchmarks", "run_benchmarks.py")


@pytest.fixture(scope="module")
def rb():
    spec = importlib.util.spec_from_file_location("run_benchmarks", _RB)
    mod = importlib.util.module_from_spec(spec)
    # run_benchmarks imports repo-root bench.py via its own sys.path insert
    sys.modules["run_benchmarks"] = mod
    spec.loader.exec_module(mod)
    return mod


def test_min_merge_keeps_faster_previous_row(rb):
    rows = [{"filter": "box", "level": 2, "rev": 2, "time_ms": 0.7,
             "wall_s": 3.0}]
    prev = [{"filter": "box", "level": 2, "rev": 2, "time_ms": 0.5,
             "wall_s": 9.0}]
    rb._merge_rows(rows, prev, ("filter", "level"))
    assert rows[0]["time_ms"] == 0.5
    # wall_s reports THIS run's cost, not the historical minimum's
    assert rows[0]["wall_s"] == 3.0


def test_min_merge_keeps_faster_new_row(rb):
    rows = [{"filter": "box", "level": 2, "rev": 2, "time_ms": 0.4}]
    prev = [{"filter": "box", "level": 2, "rev": 2, "time_ms": 0.5}]
    rb._merge_rows(rows, prev, ("filter", "level"))
    assert rows[0]["time_ms"] == 0.4


def test_rev_mismatch_discards_stale_minimum(rb):
    """A row whose timed implementation changed (rev bump) must NOT
    inherit a faster minimum measured on the old code."""
    rows = [{"filter": "gaussian", "level": 4, "rev": 3, "time_ms": 0.45}]
    prev = [{"filter": "gaussian", "level": 4, "rev": 2, "time_ms": 0.30}]
    rb._merge_rows(rows, prev, ("filter", "level"))
    assert rows[0]["time_ms"] == 0.45


def test_missing_rev_in_previous_file_defaults_to_global(rb):
    """Entries written before per-row revs carry the file's global
    impl_rev implicitly; they merge with same-rev rows only."""
    label = "gaussian r15 L4 (maxdiff<=1)"
    # extended case with a bumped rev: old rev-less entry must not merge
    ext = [{"case": label, "rev": rb._ext_rev(label), "time_ms": 0.47}]
    prev = [{"case": label, "time_ms": 0.30}]
    assert rb._ext_rev(label) != rb._IMPL_REV  # guards the scenario itself
    rb._merge_rows(ext, prev, ("case",))
    assert ext[0]["time_ms"] == 0.47
    # and an un-bumped case still min-merges with a rev-less entry
    ext2 = [{"case": "other", "rev": rb._ext_rev("other"), "time_ms": 0.9}]
    prev2 = [{"case": "other", "time_ms": 0.6}]
    rb._merge_rows(ext2, prev2, ("case",))
    assert ext2[0]["time_ms"] == 0.6


def test_row_rev_overrides_stay_ahead_of_global(rb):
    """The module-level assert guards this; re-state it as a test so a
    future _IMPL_REV bump that forgets to clear overrides fails loudly."""
    vals = list(rb._ROW_REV_OVERRIDES.values()) + list(
        rb._EXT_REV_OVERRIDES.values())
    assert all(v > rb._IMPL_REV for v in vals)

def test_pool_identical_programs(rb, monkeypatch):
    """Rows whose timed callables lowered to the byte-identical program
    share the session min (their samples are exchangeable); distinct
    programs never pool."""
    import bench

    fps = {("box", 2): "AAA", ("box", 4): "AAA", ("gaussian", 2): "BBB"}
    monkeypatch.setattr(
        bench, "program_fingerprint", lambda f, l, img: fps[(f, l)])
    rows = [
        {"filter": "box", "level": 2, "time_ms": 0.28,
         "reference_ms": 2.766, "speedup_vs_reference": 9.9},
        {"filter": "box", "level": 4, "time_ms": 0.45,
         "reference_ms": 2.766, "speedup_vs_reference": 6.1},
        {"filter": "gaussian", "level": 2, "time_ms": 0.31,
         "reference_ms": 0.953, "speedup_vs_reference": 3.1},
    ]
    rb._pool_identical_programs(rows, img=None)
    assert rows[1]["time_ms"] == 0.28
    assert rows[1]["pooled"] is True
    assert rows[1]["speedup_vs_reference"] == round(2.766 / 0.28, 3)
    assert "pooled" not in rows[0]          # the group min itself
    assert "pooled" not in rows[2]          # singleton group untouched
    assert rows[2]["time_ms"] == 0.31


def test_pool_survives_fingerprint_failure(rb, monkeypatch):
    import bench

    def boom(f, l, img):
        raise RuntimeError("no device")

    monkeypatch.setattr(bench, "program_fingerprint", boom)
    rows = [{"filter": "box", "level": 2, "time_ms": 0.28,
             "reference_ms": 2.766, "speedup_vs_reference": 9.9}]
    rb._pool_identical_programs(rows, img=None)   # must not raise
    assert rows[0]["time_ms"] == 0.28


def test_merge_drops_stale_pooled_flag(rb):
    """When a stored (directly measured) min beats this session's pooled
    value, the row must not keep claiming its number came from pooling."""
    rows = [{"filter": "box", "level": 4, "rev": 2, "time_ms": 0.30,
             "pooled": True}]
    prev = [{"filter": "box", "level": 4, "rev": 2, "time_ms": 0.25}]
    rb._merge_rows(rows, prev, ("filter", "level"))
    assert rows[0]["time_ms"] == 0.25
    assert "pooled" not in rows[0]


def test_fingerprint_mismatch_blocks_merge_even_at_same_rev(rb, capsys):
    """ADVICE r2: 'identical rev => identical program' is only as good as
    the manual rev-bump discipline.  A stored row whose persisted
    fingerprint differs from today's must not merge (and must warn) even
    when the revs match -- exchangeability is checked, not assumed."""
    rows = [{"filter": "box", "level": 2, "rev": 2, "time_ms": 0.7,
             "sessions": [0.7], "fingerprint": "NEW"}]
    prev = [{"filter": "box", "level": 2, "rev": 2, "time_ms": 0.3,
             "sessions": [0.3], "fingerprint": "OLD"}]
    rb._merge_rows(rows, prev, ("filter", "level"))
    assert rows[0]["time_ms"] == 0.7
    assert rows[0]["sessions"] == [0.7]  # history discarded too
    assert "missed rev bump" in capsys.readouterr().out
    # A prev row WITHOUT a stored fingerprint (pre-dispersion format)
    # still merges on the rev gate alone.
    rows2 = [{"filter": "box", "level": 2, "rev": 2, "time_ms": 0.7,
              "sessions": [0.7], "fingerprint": "NEW"}]
    prev2 = [{"filter": "box", "level": 2, "rev": 2, "time_ms": 0.3}]
    rb._merge_rows(rows2, prev2, ("filter", "level"))
    assert rows2[0]["time_ms"] == 0.3


def test_merge_accumulates_session_history(rb):
    rows = [{"filter": "box", "level": 2, "rev": 2, "time_ms": 0.7,
             "sessions": [0.7], "fingerprint": "F"}]
    prev = [{"filter": "box", "level": 2, "rev": 2, "time_ms": 0.3,
             "sessions": [0.5, 0.3], "fingerprint": "F"}]
    rb._merge_rows(rows, prev, ("filter", "level"))
    assert rows[0]["sessions"] == [0.5, 0.3, 0.7]
    assert rows[0]["time_ms"] == 0.3
    rb._finalize_dispersion(rows)
    assert rows[0]["median_ms"] == 0.5
    assert rows[0]["n_sessions"] == 3


def test_merge_pre_dispersion_prev_contributes_one_sample(rb):
    """A stored row predating `sessions` contributes its time_ms as one
    direct sample -- unless it was pooled (the min wasn't its own)."""
    rows = [{"filter": "box", "level": 2, "rev": 2, "time_ms": 0.7,
             "sessions": [0.7]}]
    prev = [{"filter": "box", "level": 2, "rev": 2, "time_ms": 0.3}]
    rb._merge_rows(rows, prev, ("filter", "level"))
    assert rows[0]["sessions"] == [0.3, 0.7]

    rows2 = [{"filter": "box", "level": 4, "rev": 2, "time_ms": 0.7,
              "sessions": [0.7]}]
    prev2 = [{"filter": "box", "level": 4, "rev": 2, "time_ms": 0.3,
              "pooled": True}]
    rb._merge_rows(rows2, prev2, ("filter", "level"))
    assert rows2[0]["sessions"] == [0.7]
    assert rows2[0]["time_ms"] == 0.3  # the pooled min still merges


def test_session_history_is_capped(rb):
    rows = [{"filter": "box", "level": 2, "rev": 2, "time_ms": 0.7,
             "sessions": [0.7]}]
    prev = [{"filter": "box", "level": 2, "rev": 2, "time_ms": 0.1,
             "sessions": [0.1 * i for i in range(1, 40)]}]
    rb._merge_rows(rows, prev, ("filter", "level"))
    assert len(rows[0]["sessions"]) == rb._MAX_SESSIONS
    assert rows[0]["sessions"][-1] == 0.7  # newest sample survives the cap


def test_pooled_rows_record_source(rb, monkeypatch):
    """ADVICE r2: a pooled row names the row its min came from."""
    import bench

    monkeypatch.setattr(bench, "program_fingerprint",
                        lambda f, l, img: "SAME")
    rows = [
        {"filter": "box", "level": 2, "time_ms": 0.28,
         "reference_ms": 2.766, "speedup_vs_reference": 9.9},
        {"filter": "box", "level": 4, "time_ms": 0.45,
         "reference_ms": 2.766, "speedup_vs_reference": 6.1},
    ]
    rb._pool_identical_programs(rows, img=None)
    assert rows[1]["pooled_from"] == "box L2"
    assert "pooled_from" not in rows[0]
    # Fingerprints persisted on the rows for the merge gate.
    assert rows[0]["fingerprint"] == "SAME"
    assert rows[1]["fingerprint"] == "SAME"


def test_finalize_dispersion_defaults(rb):
    """Rows without history (fresh file) get a 1-sample median equal to
    their own measurement; speedups computed from the median too."""
    rows = [{"filter": "box", "level": 2, "time_ms": 0.4,
             "reference_ms": 2.0, "speedup_vs_reference": 5.0}]
    rb._finalize_dispersion(rows)
    assert rows[0]["median_ms"] == 0.4
    assert rows[0]["n_sessions"] == 1
    assert rows[0]["speedup_median"] == 5.0


def test_box_l2_l4_fingerprints_match_at_bench_radius():
    """The concrete pooling case: the blurs' L2 and L4 trace identically
    (one kernel serves both), Sobel's do not (level 2 quantizes gray)."""
    import numpy as np

    import bench

    img = np.zeros((40, 48, 3), np.uint8)
    assert bench.program_fingerprint("box", 2, img) == \
        bench.program_fingerprint("box", 4, img)
    assert bench.program_fingerprint("gaussian", 2, img) == \
        bench.program_fingerprint("gaussian", 4, img)
    assert bench.program_fingerprint("sobel", 2, img) != \
        bench.program_fingerprint("sobel", 4, img)


def test_fingerprint_trace_deterministic_and_gpu_path(monkeypatch):
    """The jaxpr fingerprint must be (a) identical across repeated traces
    in one process and (b) box-L2==L4 on the compiled GPU path too
    (interpret=False), which jaxpr tracing proves without a card."""
    import numpy as np

    import bench
    from gpu_image_processing.runtime import dispatch

    img = np.zeros((40, 48, 3), np.uint8)
    assert bench.program_fingerprint("box", 2, img) == \
        bench.program_fingerprint("box", 2, img)

    # Trace the interpret=False kernels (what the GPU serves); tracing them
    # needs no GPU, only executing them would.
    monkeypatch.setattr(dispatch, "use_interpret", lambda: False)
    assert bench.program_fingerprint("box", 2, img) == \
        bench.program_fingerprint("box", 4, img)
    assert bench.program_fingerprint("sobel", 2, img) != \
        bench.program_fingerprint("sobel", 4, img)


def test_post_merge_pooling_shares_historical_min(rb, monkeypatch):
    """After the rev-gated merge, fingerprint-identical rows share the
    stored least-contended min too (identical now + per-row rev-unchanged
    history => identical throughout the rev, so old samples exchange)."""
    import bench

    monkeypatch.setattr(bench, "program_fingerprint",
                        lambda f, l, img: "SAME")
    rows = [
        {"filter": "box", "level": 2, "rev": 2, "time_ms": 0.80,
         "reference_ms": 2.766, "speedup_vs_reference": 3.5},
        {"filter": "box", "level": 4, "rev": 2, "time_ms": 0.82,
         "reference_ms": 2.766, "speedup_vs_reference": 3.4},
    ]
    prev = [
        {"filter": "box", "level": 2, "rev": 2, "time_ms": 0.2856},
        {"filter": "box", "level": 4, "rev": 2, "time_ms": 0.4555},
    ]
    rb._merge_rows(rows, prev, ("filter", "level"))
    rb._pool_identical_programs(rows, img=None)
    assert rows[0]["time_ms"] == 0.2856
    assert rows[1]["time_ms"] == 0.2856
    assert rows[1]["pooled"] is True


def test_finalize_dispersion_pools_medians_across_identical_programs(rb):
    """Fingerprint-identical rows must median over the UNION of their
    session samples (the min already pools; a median over disjoint
    per-row lists would republish the window-luck artifact on the
    headline number)."""
    rows = [
        {"filter": "box", "level": 2, "time_ms": 0.3, "reference_ms": 2.766,
         "sessions": [0.3, 0.32], "fingerprint": "fp-same"},
        {"filter": "box", "level": 4, "time_ms": 0.3, "reference_ms": 2.766,
         "sessions": [0.9, 0.95], "fingerprint": "fp-same"},
        {"filter": "sobel", "level": 2, "time_ms": 0.2, "reference_ms": 0.528,
         "sessions": [0.2], "fingerprint": "fp-other"},
    ]
    rb._finalize_dispersion(rows)
    # union [0.3, 0.32, 0.9, 0.95] -> median 0.61 for BOTH box rows
    assert rows[0]["median_ms"] == rows[1]["median_ms"] == 0.61
    assert rows[0]["median_pooled_over"] == 4
    # own direct histories stay per-row
    assert rows[0]["sessions"] == [0.3, 0.32]
    assert rows[1]["sessions"] == [0.9, 0.95]
    assert rows[0]["n_sessions"] == 2
    # singleton fingerprint group: plain per-row median, no pooled marker
    assert rows[2]["median_ms"] == 0.2
    assert "median_pooled_over" not in rows[2]
